"""Env-steps per second: replicas (or worlds) times the batch steps
completed over the whole window, every step dispatched ahead and the
window closed by one synchronize."""


def read(ctx):
    return ctx.window.timed_steps * ctx.batch / ctx.window_s
