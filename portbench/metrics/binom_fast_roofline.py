"""The fast binomial's share of its roofline, in %: the least time the
samples of the traced steps need (``bounds.binom_fast``) over the in-situ
device time of the kernels that carry them."""

from portbench.bounds.binom_fast import least_seconds_step

KERNELS = ("binom_fast_kernel",)


def read(ctx):
    seconds, count = ctx.trace.device_seconds(KERNELS)
    if not count or ctx.reference is None or ctx.reference.scn.binomial_mode != "fast":
        return None
    scn = ctx.reference.scn
    need = ctx.trace.steps * least_seconds_step(ctx.batch, scn.n_links,
                                                not scn.act_statically_zero)
    return 100.0 * need / seconds
