"""3x3 grid with multi-OD k-shortest-path routing (reference
examples/nine_node.py; the counterpart of ``examples/nine_node.py``): a
stochastic run through t = T, saved, then scored by the offline metrics.

Run:  python -m pednstream_tpu_torch.examples.nine_node [--device cpu]
"""

import argparse

import numpy as np
import torch

from ..device import DEFAULT
from ..engine import simulate
from ..io import OutputHandler
from ..scenario import build_scenario
from . import timed

PARAMS = {
    "unit_time": 10,
    "simulation_steps": 600,
    "seed": 7,
    "path_finder": {"k_paths": 3, "temp": 5, "alpha": 1, "beta": 0.5, "omega": 0.8},
    "default_link": {
        "length": 100, "width": 3, "free_flow_speed": 1.1,
        "k_critical": 2, "k_jam": 6,
    },
    "demand": {
        "origin_0": {"pattern": "gaussian_peaks", "peak_lambda": 20, "base_lambda": 8},
        "origin_2": {"pattern": "gaussian_peaks", "peak_lambda": 15, "base_lambda": 5},
    },
}
OD_FLOWS = {(0, 8): 10, (2, 6): 5, (0, 6): 3}


def adjacency():
    adj = np.zeros((9, 9), dtype=int)

    def conn(a, b):
        adj[a, b] = adj[b, a] = 1

    for r in range(3):
        for c in range(3):
            n = 3 * r + c
            if c < 2:
                conn(n, n + 1)
            if r < 2:
                conn(n, n + 3)
    return adj


def build(device=DEFAULT):
    return build_scenario(adjacency(), PARAMS, origin_nodes=[0, 2], destination_nodes=[8, 6],
                          od_flows=dict(OD_FLOWS), device=device)


def run(device=DEFAULT, steps=None, out="outputs", seed=0):
    """Through t = T (``simulation_steps`` steps, so the final cumulative
    column the offline metrics read is populated), or ``steps``."""
    from ..rl.metrics import evaluate_run

    scn = build(device)
    steps = PARAMS["simulation_steps"] if steps is None else steps
    gen = torch.Generator(device=scn.device).manual_seed(seed)
    (final, traj), dt = timed(lambda: simulate(scn, scn.engine_params, scn.init_state(), steps,
                                               gen, stochastic=True, record=True), scn.device)
    print("OD paths:", dict(scn.path_builder.od_paths))
    handler = OutputHandler(base_dir=out, simulation_dir="nine_node")
    handler.save_scenario_state(scn, traj)
    metrics = evaluate_run(str(handler.simulation_dir))
    for name, m in metrics.items():
        print(name, {k: round(v, 3) for k, v in m.items() if isinstance(v, (int, float))})
    return {"scn": scn, "final": final, "traj": traj, "steps": steps, "batch": 1,
            "seconds": dt, "saved": str(handler.simulation_dir), "metrics": metrics}


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default=DEFAULT)
    run(p.parse_args().device)
