"""Delft-adjacency exploration runs with ad-hoc parameters (the
counterpart of ``examples/big_network.py``, itself the counterpart of
BOTH reference scripts examples/big_network.py (custom default_link on
the delft graph, origins [0, 8]) and examples/big_network_directions.py
(multi-OD with explicit od_flows and a per-origin demand override)).  The
macosx matplotlib animation is replaced by the zero-dependency
interactive HTML map export.

Run:  python -m pednstream_tpu_torch.examples.big_network              # big_network semantics
      python -m pednstream_tpu_torch.examples.big_network --directions # ..._directions semantics
"""

import argparse
import json
import os
from pathlib import Path

import numpy as np
import torch

from ..device import DEFAULT
from ..engine import simulate
from ..io.output_handler import OutputHandler
from ..scenario import build_scenario
from . import timed

DATA = str(Path(__file__).resolve().parents[2] / "data" / "delft")


def scenario_args(directions: bool = False):
    """``(adj, params, origins, dests, od_flows, pos, sim_name)`` of either
    variant."""
    with open(os.path.join(DATA, "node_positions.json")) as f:
        pos = {str(k): np.asarray(v) for k, v in json.load(f).items()}
    adj = np.load(os.path.join(DATA, "adj_matrix.npy"))
    # ad-hoc exploration parameters (reference big_network.py body)
    params = {
        "unit_time": 10,
        "simulation_steps": 500,
        "assign_flows_type": "classic",
        "default_link": {
            "length": 50, "width": 1, "free_flow_speed": 1.5,
            "k_critical": 2, "k_jam": 10, "activity_probability": 0.0,
        },
        "seed": 0,
    }
    if directions:
        # big_network_directions.py: five origins, four destinations,
        # constant od_flows, heavier demand at origin 136
        params["demand"] = {"origin_136": {"peak_lambda": 25, "base_lambda": 5}}
        origins, dests = [136, 0, 5, 177, 29], [8, 100, 213, 69]
        od_flows = {(0, 8): 8, (0, 100): 8, (5, 8): 8, (5, 100): 8}
        sim_name = "delft_directions"
    else:
        origins, dests = [0, 8], None
        od_flows = None
        sim_name = "delft_big_network"
    return adj, params, origins, dests, od_flows, pos, sim_name


def build(directions: bool = False, device=DEFAULT):
    adj, params, origins, dests, od_flows, pos, _ = scenario_args(directions)
    return build_scenario(adj, params, origins, dests, od_flows=od_flows, pos=pos,
                          device=device)


def run(directions: bool = False, device=DEFAULT, steps=None, out="outputs", html=None,
        seed=0):
    sim_name = scenario_args(directions)[-1]
    scn = build(directions, device)
    print(f"delft: {scn.n_nodes} nodes, {scn.n_links} directed links")
    steps = scn.simulation_steps - 1 if steps is None else steps
    gen = torch.Generator(device=scn.device).manual_seed(seed)
    (final, outs), dt = timed(lambda: simulate(scn, scn.engine_params, scn.init_state(), steps,
                                               gen, stochastic=True, record=True), scn.device)
    print("Simulation time: {:.2f}".format(dt))
    handler = OutputHandler(base_dir=out, simulation_dir=sim_name)
    handler.save_scenario_state(scn, outs)
    print(f"saved {handler.simulation_dir}")
    if html:
        from ..viz.html_export import export_interactive_html

        path = export_interactive_html(simulation_dir=str(handler.simulation_dir),
                                       out_path=html, title=sim_name)
        print(f"wrote {path}")
    return {"scn": scn, "final": final, "traj": outs, "steps": steps, "batch": 1,
            "seconds": dt, "saved": str(handler.simulation_dir)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--directions", action="store_true",
                    help="multi-OD variant (big_network_directions.py)")
    ap.add_argument("--html", default=None, metavar="OUT.html",
                    help="also export the interactive HTML map")
    ap.add_argument("--device", default=DEFAULT)
    args = ap.parse_args(argv)
    return run(args.directions, args.device, html=args.html)


if __name__ == "__main__":
    main()
