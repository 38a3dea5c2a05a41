"""The reference's driver loops on the port (the counterparts of
``examples/``): each module has a ``build`` of its scenario, a ``run`` at
the shipped network and horizon (on the card unless given
``device="cpu"``; a ``steps`` argument cuts the horizon), and a command
line, ``python -m pednstream_tpu_torch.examples.<name>``.  What they save
goes under ``outputs/`` (or their ``out`` argument)."""

import time

import torch


def timed(fn, device):
    """``fn()`` and its wall seconds, the card drained before each reading
    of the clock."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    result = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return result, time.perf_counter() - t0
