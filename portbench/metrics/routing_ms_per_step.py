"""Device milliseconds per batch step of the engine step's span
``engine.routing``: the routed turning fractions (phase 2), with the
default capacities and the OD column."""

from portbench.spans import device_ms_per_step


def read(ctx):
    return device_ms_per_step(ctx.trace, ("engine.routing",))
