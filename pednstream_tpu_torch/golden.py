"""Replay of the golden fixtures in float64 exact-parity mode.

The fixtures (``tests/golden/*.npz``) were made by running the original
PedNStream code in deterministic mode.  Each holds its scenario (an
adjacency matrix with its params, or the name of a dataset under
``data/``), the step count and the per-link fields it recorded.
:func:`golden_errors` builds the scenario as ``tests/test_golden_parity.py``
builds it for the JAX package, runs it deterministically with
``ftype=torch.float64, exact_parity=True`` and returns the max abs error
of each recorded field.
"""

import json
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch

from .device import DEFAULT
from .engine import simulate
from .generator import NetworkEnvGenerator
from .scenario import Scenario, build_scenario

TOL = 1e-5  # the parity target tests/test_golden_parity.py holds the JAX package to

# fixture field -> (StepOutputs attr, column offset relative to step t);
# sending/receiving are stored at index t-1 during step t (node.py:178,206)
FIELDS = {
    "inflow": ("inflow", 0),
    "outflow": ("outflow", 0),
    "num_pedestrians": ("num_peds", 0),
    "density": ("density", 0),
    "speed": ("speed", 0),
    "travel_time": ("travel_time", 0),
    "cumulative_inflow": ("cum_in", 0),
    "cumulative_outflow": ("cum_out", 0),
    "sending_flow": ("sending", -1),
    "receiving_flow": ("receiving", -1),
}


def fixture_args(path) -> Tuple[dict, int, "np.lib.npyio.NpzFile"]:
    """``(build_scenario arguments, steps T, fixture)`` of the fixture at
    ``path``.  Seeds NumPy's global generator as the fixture's build did
    (the demand and path draws read it)."""
    g = np.load(Path(path), allow_pickle=True)
    meta = json.loads(str(g["meta"]))
    if "adj" in meta:
        params = meta["params"]
        od_flows = {tuple(map(int, k.split("_"))): v
                    for k, v in meta.get("od_flows", {}).items()} or None
        np.random.seed(params.get("seed", 42))
        args = dict(adjacency_matrix=np.array(meta["adj"]), params=params,
                    origin_nodes=meta["origins"],
                    destination_nodes=meta.get("dests") or [], od_flows=od_flows)
        return args, params["simulation_steps"], g
    # the real-world networks, built from data/ as the generator does
    np.random.seed(42)
    # host arrays only: the generator builds nothing here
    return NetworkEnvGenerator(device="cpu").scenario_args(Path(path).stem), meta["steps"], g


def golden_errors(path, device=DEFAULT) -> Tuple[Dict[str, float], Scenario, int]:
    """Run the fixture at ``path`` on ``device`` for its ``T - 1`` steps;
    returns ``(max abs error per recorded field, scenario, T)``."""
    args, T, g = fixture_args(path)
    scn = build_scenario(**args, ftype=torch.float64, exact_parity=True, device=device)
    keys = [f"{u}_{v}" for (u, v) in scn.topo.link_nodes.tolist()]
    order = [keys.index(k) for k in list(g["link_keys"])]
    _, outs = simulate(scn, scn.engine_params, scn.init_state(1), T - 1)
    errors = {}
    for field, (attr, off) in FIELDS.items():
        if field not in g:
            continue
        mine = getattr(outs, attr)[:, 0].cpu().numpy()[:, order]
        ref = (g[field][:, 0:T - 1] if off else g[field][:, 1:T]).T
        errors[field] = float(np.abs(mine - ref).max())
    return errors, scn, T
