"""Set-up seconds: from the process's start to the first timed step
(imports, the CUDA context, the scenario build, the warm-up)."""


def read(ctx):
    return ctx.setup_s
