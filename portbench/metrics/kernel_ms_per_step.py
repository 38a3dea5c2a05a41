"""Device milliseconds per batch step: the union of the device operations'
intervals in the traced segment over the steps issued in it."""


def read(ctx):
    if not ctx.trace.kernels:
        return None
    return ctx.trace.busy_s() * 1e3 / ctx.trace.steps
