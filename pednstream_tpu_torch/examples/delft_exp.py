"""Delft real-world network full-horizon run with wall-clock timing
(reference examples/delft_exp.py / big_network.py; the counterpart of
``examples/delft_exp.py``): one stochastic replica on the card, the clock
read after the card has drained.

Run:  python -m pednstream_tpu_torch.examples.delft_exp [--device cpu]
"""

import argparse

import torch

from ..device import DEFAULT
from ..engine import simulate
from ..generator import NetworkEnvGenerator
from . import timed


def build(device=DEFAULT):
    return NetworkEnvGenerator(device=device).create_network("delft")


def run(device=DEFAULT, steps=None, seed=0):
    scn = build(device)
    print(f"delft: {scn.n_nodes} nodes, {scn.n_links} directed links")
    steps = scn.simulation_steps - 1 if steps is None else steps
    gen = torch.Generator(device=scn.device).manual_seed(seed)
    (final, _), dt = timed(lambda: simulate(scn, scn.engine_params, scn.init_state(), steps,
                                            gen, stochastic=True, record=False), scn.device)
    print("Simulation time: {:.2f}".format(dt))
    return {"scn": scn, "final": final, "steps": steps, "batch": 1, "seconds": dt}


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default=DEFAULT)
    run(p.parse_args().device)
