"""Device milliseconds per batch step of the engine step's span
``engine.history``: the fused history reads (phase 0)."""

from portbench.spans import device_ms_per_step


def read(ctx):
    return device_ms_per_step(ctx.trace, ("engine.history",))
