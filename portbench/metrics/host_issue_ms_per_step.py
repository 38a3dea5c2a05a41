"""Host milliseconds to issue one step: the mean host duration of the
driver's outermost program span (``engine.step``; in the env,
``env.step``) in the traced segment, less its time blocked on a full
launch queue, waiting for the card."""

from portbench.spans import host_issue_ms


def read(ctx):
    return host_issue_ms(ctx.trace)
