"""Seconds the program spent building its scenario: its kept spans
``scenario.build``, summed over the run."""

from portbench.spans import kept_seconds


def read(ctx):
    return kept_seconds("scenario.build")
