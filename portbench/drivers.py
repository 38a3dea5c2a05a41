"""What a cell's traffic file asks of the program, and of the reference.

A traffic file (``portbench/traffic/<mix>.json``) holds the mix's
parameters and names its ``driver``, a module found by that name,
``portbench/traffic/<driver>.py``, which holds two classes:

- ``Driver(config, traffic, device)`` drives the program through its own
  entry points.  ``horizon`` steps make an episode; ``begin(seed)`` seeds
  every generator of the window, ``reset()`` starts an episode, ``step()``
  dispatches one step of the whole batch; ``start_record(rows)``,
  ``snapshot(rows)`` and ``captured_step(rows)`` keep what the check
  compares of the replicas ``rows``; ``release()`` frees the state.
- ``Reference(config, traffic, device)`` works the same out again from the
  raw files (:class:`portbench.check.StepReference`), and names the
  ``faults`` that the cell can have (:func:`portbench.check.plant`).

Every input is made from the seed: the same seed gives the same episodes.
Two drivers stand: ``rollout`` (lockstep stochastic replicas through
``engine.simulate_batched``) and ``env`` (randomized worlds through
``PedNetEnvCore.batch_step_randomized``).
"""

import contextlib
from typing import Dict, Optional

import numpy as np
import torch


def derived_seeds(seed: int, n: int) -> list:
    """``n`` independent 63-bit seeds from the run's ``seed``."""
    words = np.random.SeedSequence(int(seed)).generate_state(n, np.uint64)
    return [int(w) & (2 ** 63 - 1) for w in words]


def seed_demand(config: dict) -> None:
    """Seeds numpy's global stream with the configuration's ``demand_seed``,
    where it has one, before a scenario build: a dataset that ships without a
    seed draws its Poisson demand curves from that stream."""
    if config.get("demand_seed") is not None:
        np.random.seed(int(config["demand_seed"]))


@contextlib.contextmanager
def capture(engine_module, rows: Optional[torch.Tensor], into: Dict[str, list]):
    """While entered, every routed turning-fractions result and every
    binomial sample of ``engine_module``'s step is appended (the replicas
    ``rows`` of it, copied; all of it when ``rows`` is None) to
    ``into["phi"]`` and ``into["binom"]``.  With ``rows``, an exact
    binomial's inputs over the whole batch go to ``into["binom_in"]``: a
    thread of ``torch.binomial`` draws for several elements in turn, as
    many draws as each needs, so replaying its stream for some rows takes
    every row's counts."""
    names = ("turning_fractions_step", "_binom")
    saved = {n: getattr(engine_module, n) for n in names}

    def keep(x):
        return x.clone() if rows is None else x[rows].clone()

    def phi(*args, **kwargs):
        out = saved["turning_fractions_step"](*args, **kwargs)
        into.setdefault("phi", []).append(keep(out))
        return out

    def binom(n, p, gen, stochastic, mode="exact"):
        out = saved["_binom"](n, p, gen, stochastic, mode)
        into.setdefault("binom", []).append(keep(out))
        if rows is not None and stochastic and mode == "exact":
            # the whole batch's inputs, to replay torch.binomial's stream
            into.setdefault("binom_in", []).append((n.clone(), p.clone()))
        return out

    engine_module.turning_fractions_step, engine_module._binom = phi, binom
    try:
        yield into
    finally:
        for n, f in saved.items():
            setattr(engine_module, n, f)


def make_driver(config: dict, traffic: dict, device):
    from portbench import spec

    return spec.traffic_module(traffic["driver"]).Driver(config, traffic, device)


def make_reference(config: dict, traffic: dict, device):
    from portbench import spec

    return spec.traffic_module(traffic["driver"]).Reference(config, traffic, device)
