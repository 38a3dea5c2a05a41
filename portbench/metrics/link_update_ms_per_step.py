"""Device milliseconds per batch step of the engine step's span
``engine.link_update``: the ring writes and the state updates (phases
5-6)."""

from portbench.spans import device_ms_per_step


def read(ctx):
    return device_ms_per_step(ctx.trace, ("engine.link_update",))
