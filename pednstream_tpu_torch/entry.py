"""Driver entry point (the counterpart of ``entry()`` in
``__graft_entry__.py``; its other half, ``dryrun_multichip``, is
``dryrun_multichip_torch.py``).

``entry() -> (fn, example_args)``: one stochastic engine step of the
flagship scenario, melbourne (the largest bundled real-world network),
on the card unless asked for the CPU, with its ``torch.Generator`` bound.

Run:  python -m pednstream_tpu_torch.entry [--device cpu]
"""

import argparse

import torch

from .device import DEFAULT
from .engine import make_step
from .generator import NetworkEnvGenerator


def entry(device=DEFAULT, seed: int = 0):
    """``(fn, (state,))``: ``fn(state)`` is one stochastic step of melbourne
    (one replica, the shipped configuration) returning the new state; the
    step's draws come from a generator seeded with ``seed``.  The rings of
    ``state`` advance in place, as every step of the port's engine does."""
    scn = NetworkEnvGenerator(device=device).create_network("melbourne")
    ep = scn.engine_params
    state = scn.init_state()
    step = make_step(scn, stochastic=True, record=False,
                     gen=torch.Generator(device=scn.device).manual_seed(seed))

    def fn(st):
        new_state, _ = step(ep, st)
        return new_state

    return fn, (state,)


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default=DEFAULT, help="cuda (default) or cpu")
    fn, args = entry(p.parse_args().device)
    out = fn(*args)
    print("entry ok:", out.t)
