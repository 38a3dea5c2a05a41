"""The routed turning fractions' share of their roofline, in %: the least
time the traced steps' calls need on the scenario's routing tables
(``bounds.turning_fractions``) over the in-situ device time of the
kernels that carry them."""

from portbench.bounds.turning_fractions import least_seconds_call

KERNELS = ("turning_fractions_kernel",)


def read(ctx):
    seconds, count = ctx.trace.device_seconds(KERNELS)
    if not count or ctx.reference is None or ctx.reference.scn.routing is None:
        return None
    scn = ctx.reference.scn
    od_per_replica = ctx.cell.traffic["driver"] == "env"
    # a traced segment inside an episode: every receiving flow is set
    need = ctx.trace.steps * least_seconds_call(scn.routing, scn.max_deg, ctx.batch, 0,
                                                od_per_replica)
    return 100.0 * need / seconds
