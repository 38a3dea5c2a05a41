"""Custom demand function (reference examples/spike.py; the counterpart of
``examples/spike.py``): register a user-defined demand pattern by name
(network.py:88-93, od_manager.py:75-85).

Run:  python -m pednstream_tpu_torch.examples.spike [--device cpu]
"""

import argparse

import numpy as np

from ..device import DEFAULT
from ..engine import simulate
from ..scenario import build_scenario
from . import timed

PARAMS = {
    "unit_time": 10, "simulation_steps": 300, "seed": 2,
    "default_link": {"length": 100, "width": 2, "free_flow_speed": 1.1,
                     "k_critical": 2, "k_jam": 6},
    "demand": {"origin_0": {"pattern": "spike_demand"}},
}


def spike_demand(origin_id: int, params=None) -> np.ndarray:
    """A flat base load with one sharp synchronized spike."""
    T = params["simulation_steps"]
    demand = np.full(T, 3.0)
    demand[T // 3 : T // 3 + 15] = 60.0
    return demand


def adjacency():
    adj = np.zeros((4, 4), dtype=int)
    for a, b in [(0, 1), (1, 2), (2, 3)]:
        adj[a, b] = adj[b, a] = 1
    return adj


def build(device=DEFAULT):
    return build_scenario(adjacency(), PARAMS, origin_nodes=[0], destination_nodes=[3],
                          demand_pattern=[spike_demand], device=device)


def run(device=DEFAULT, steps=299):
    scn = build(device)
    (final, traj), dt = timed(lambda: simulate(scn, scn.engine_params, scn.init_state(), steps,
                                               record=True), scn.device)
    dens = traj.density[:, 0].cpu().numpy()
    print(f"peak density after spike: {dens.max():.2f} ped/m^2 at step {dens.max(1).argmax()}")
    return {"scn": scn, "final": final, "traj": traj, "steps": steps, "batch": 1,
            "seconds": dt, "peak_density": float(dens.max()),
            "peak_step": int(dens.max(1).argmax())}


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default=DEFAULT)
    run(p.parse_args().device)
