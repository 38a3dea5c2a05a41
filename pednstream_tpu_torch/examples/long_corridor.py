"""Bidirectional corridor simulation (reference examples/long_corridor.py;
the counterpart of ``examples/long_corridor.py``).

Six-node chain with Poisson demand entering from both ends; runs the
full horizon on the card, saves reference-format outputs (:func:`run`),
and renders a density snapshot and link evolution (:func:`render`, which
needs matplotlib).

Run:  python -m pednstream_tpu_torch.examples.long_corridor [--device cpu] [--no-render]
"""

import argparse
import os

import numpy as np
import torch

from ..device import DEFAULT
from ..engine import simulate
from ..io import OutputHandler
from ..scenario import build_scenario
from . import timed

ADJ = np.array([
    [0, 1, 0, 0, 0, 0],
    [1, 0, 1, 0, 0, 0],
    [0, 1, 0, 1, 0, 0],
    [0, 0, 1, 0, 1, 0],
    [0, 0, 0, 1, 0, 1],
    [0, 0, 0, 0, 1, 0],
])
PARAMS = {
    "unit_time": 10,
    "simulation_steps": 600,
    "seed": 42,
    "default_link": {
        "length": 100, "width": 2, "free_flow_speed": 1.1,
        "k_critical": 2, "k_jam": 6, "fd_type": "yperman", "bi_factor": 1,
    },
    "demand": {
        "origin_0": {"peak_lambda": 25, "base_lambda": 5},
        "origin_5": {"peak_lambda": 25, "base_lambda": 5},
    },
}


def build(device=DEFAULT):
    return build_scenario(ADJ, PARAMS, origin_nodes=[5, 0], device=device)


def run(device=DEFAULT, steps=None, out="outputs", seed=0):
    scn = build(device)
    steps = PARAMS["simulation_steps"] - 1 if steps is None else steps
    gen = torch.Generator(device=scn.device).manual_seed(seed)
    (final, traj), dt = timed(lambda: simulate(scn, scn.engine_params, scn.init_state(), steps,
                                               gen, stochastic=True, record=True), scn.device)
    print(f"Simulation time: {dt:.2f}s")
    handler = OutputHandler(base_dir=out, simulation_dir="long_corridor")
    handler.save_scenario_state(scn, traj)
    print(f"saved to {handler.simulation_dir}")
    return {"scn": scn, "final": final, "traj": traj, "steps": steps, "batch": 1,
            "seconds": dt, "saved": str(handler.simulation_dir)}


def render(simulation_dir: str, time_step: int = 300):
    """A density snapshot at ``time_step`` and three links' evolution, as
    PNGs in ``simulation_dir``."""
    from ..viz import NetworkVisualizer

    viz = NetworkVisualizer(simulation_dir=simulation_dir)
    paths = [os.path.join(simulation_dir, f"density_t{time_step}.png"),
             os.path.join(simulation_dir, "link_evolution.png")]
    viz.visualize_network_state(time_step, edge_property="density", save_path=paths[0])
    viz.plot_link_evolution(["0-1", "2-3", "4-5"], save_path=paths[1])
    print("rendered snapshots")
    return paths


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default=DEFAULT)
    p.add_argument("--no-render", action="store_true")
    a = p.parse_args()
    res = run(a.device)
    if not a.no_render:
        render(res["saved"])
