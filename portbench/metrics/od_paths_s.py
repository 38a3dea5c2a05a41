"""Seconds of the scenario build spent enumerating the OD pairs' paths:
the program's kept spans ``scenario.od_paths``, summed over the run."""

from portbench.spans import kept_seconds


def read(ctx):
    return kept_seconds("scenario.od_paths")
