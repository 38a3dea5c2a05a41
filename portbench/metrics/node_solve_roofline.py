"""The node solve's share of its roofline, in %: the least time the
traced steps' calls need on the scenario (``bounds.node_solve``) over the
in-situ device time of the kernel that carries them.  None where no such
kernel ran (the plain version's eager operations are not it)."""

from portbench.bounds.node_solve import least_seconds_call

KERNELS = ("node_solve_kernel",)


def read(ctx):
    seconds, count = ctx.trace.device_seconds(KERNELS)
    if not count or ctx.reference is None:
        return None
    per_replica = ctx.cell.traffic["driver"] == "env"
    need = ctx.trace.steps * least_seconds_call(ctx.reference.scn, ctx.batch, per_replica)
    return 100.0 * need / seconds
