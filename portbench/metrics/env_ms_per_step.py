"""Device milliseconds per RL step of the env's own work: the operations
under ``env.step`` and outside ``engine.step`` (actions, rewards,
observations, the lockstep guard)."""

from portbench.spans import device_ms_per_step

ENV_SPANS = ("env.step", "env.actions", "env.rewards", "env.observations")


def read(ctx):
    return device_ms_per_step(ctx.trace, ENV_SPANS)
