"""The device's idle share of the traced segment, in %: one minus the union
of the device operations' intervals over the segment's host wall, the
steps dispatched ahead and synchronized once at its end."""


def read(ctx):
    if not ctx.trace.kernels:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
