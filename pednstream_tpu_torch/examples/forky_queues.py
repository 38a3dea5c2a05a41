"""Diverging queues at a fork (reference examples/forky_queues.py; the
counterpart of ``examples/forky_queues.py``): a single inflow splitting
into two branches with different capacities.

Run:  python -m pednstream_tpu_torch.examples.forky_queues [--device cpu]
"""

import argparse

import numpy as np
import torch

from ..device import DEFAULT
from ..engine import simulate
from ..scenario import build_scenario
from . import timed

PARAMS = {
    "unit_time": 10, "simulation_steps": 400, "seed": 4,
    "path_finder": {"k_paths": 2, "temp": 5, "alpha": 1, "beta": 0.5, "omega": 0.8},
    "default_link": {"length": 100, "width": 3, "free_flow_speed": 1.1,
                     "k_critical": 2, "k_jam": 6},
    "links": {"1_3": {"width": 1.0}},  # narrow branch
    "demand": {"origin_0": {"peak_lambda": 30, "base_lambda": 12}},
}


def adjacency():
    # 0 -> 1 -> {2 (wide), 3 (narrow)} -> 4
    adj = np.zeros((5, 5), dtype=int)
    for a, b in [(0, 1), (1, 2), (1, 3), (2, 4), (3, 4)]:
        adj[a, b] = adj[b, a] = 1
    return adj


def build(device=DEFAULT):
    return build_scenario(adjacency(), PARAMS, origin_nodes=[0], destination_nodes=[4],
                          device=device)


def run(device=DEFAULT, steps=399, seed=0):
    scn = build(device)
    gen = torch.Generator(device=scn.device).manual_seed(seed)
    (final, traj), dt = timed(lambda: simulate(scn, scn.engine_params, scn.init_state(), steps,
                                               gen, stochastic=True, record=True), scn.device)
    dens = traj.density[:, 0].cpu().numpy()
    wide = scn.topo.link_id_to_idx[(1, 2)]
    narrow = scn.topo.link_id_to_idx[(1, 3)]
    print(f"wide branch peak density {dens[:, wide].max():.2f}; "
          f"narrow branch peak density {dens[:, narrow].max():.2f} "
          f"(logit routing shifts flow toward the wide branch)")
    return {"scn": scn, "final": final, "traj": traj, "steps": steps, "batch": 1,
            "seconds": dt, "wide_peak": float(dens[:, wide].max()),
            "narrow_peak": float(dens[:, narrow].max())}


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default=DEFAULT)
    run(p.parse_args().device)
