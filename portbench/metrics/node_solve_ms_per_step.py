"""Device milliseconds per batch step of the engine step's span
``engine.node_solve``: the node merge/diverge solve (phase 4)."""

from portbench.spans import device_ms_per_step


def read(ctx):
    return device_ms_per_step(ctx.trace, ("engine.node_solve",))
