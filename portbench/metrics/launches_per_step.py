"""Kernel launches per batch step: the ``cudaLaunch*`` / ``cuLaunch*``
records of the traced segment over its steps."""


def read(ctx):
    if not ctx.trace.launches:
        return None
    return ctx.trace.launches / ctx.trace.steps
