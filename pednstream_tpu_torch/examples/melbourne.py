"""Melbourne real-world network, full horizon (reference
examples/Melbourne.py; the counterpart of ``examples/melbourne.py``):
341 nodes / 938 directed links with measured corridor lengths and
sensor-calibrated demand, one stochastic replica on the card.

Run:  python -m pednstream_tpu_torch.examples.melbourne [--device cpu] [--steps N]
"""

import argparse
import os

import numpy as np
import torch

from ..device import DEFAULT
from ..engine import simulate
from ..generator import NetworkEnvGenerator
from ..io import OutputHandler
from . import timed


def make_sensor_demand(data_dir: str):
    """Per-origin demand from the Melbourne pedestrian sensor feed
    (reference examples/Melbourne.py:19-34): minute counts spread to the
    10 s simulation step, looked up via the sensor->node mapping.
    Registered as a custom pattern; an origin uses it when its demand
    config names ``node_demand_from_data``."""
    import pandas as pd

    data = pd.read_csv(os.path.join(data_dir, "melbourne.csv"))
    sensor_node_df = pd.read_csv(os.path.join(data_dir, "sensor_node_df.csv"))

    def node_demand_from_data(origin_node, params=None):
        nearest = sensor_node_df[sensor_node_df["node_id"] == origin_node]["sensor_id"].values[0]
        minute_counts = data[data["Location_ID"] == nearest]["Direction_1"]
        return np.ceil(np.repeat(minute_counts.values / 6, 6))

    return node_demand_from_data


def build(device=DEFAULT):
    gen = NetworkEnvGenerator(device=device)
    data_dir = str(gen._dataset_dir("melbourne"))
    custom = []
    # the sensor->node mapping file is not bundled with the reference
    # dataset (its own Melbourne.py example fails on this); use the
    # sensor feed only when both files exist
    if all(os.path.exists(os.path.join(data_dir, f))
           for f in ("melbourne.csv", "sensor_node_df.csv")):
        custom = [make_sensor_demand(data_dir)]
    return gen.create_network("melbourne", custom_demand_functions=custom)


def run(device=DEFAULT, steps=None, out="outputs", seed=0):
    """The whole horizon (``simulation_steps - 1`` loading steps, or
    ``steps``) stochastic and recorded, saved under ``out/melbourne``."""
    scn = build(device)
    print(f"melbourne: {scn.n_nodes} nodes, {scn.n_links} directed links")
    steps = scn.simulation_steps - 1 if steps is None else steps
    gen = torch.Generator(device=scn.device).manual_seed(seed)
    (final, traj), dt = timed(lambda: simulate(scn, scn.engine_params, scn.init_state(), steps,
                                               gen, stochastic=True, record=True), scn.device)
    print(f"Simulation time: {dt:.2f}")
    handler = OutputHandler(base_dir=out, simulation_dir="melbourne")
    handler.save_scenario_state(scn, traj)
    print(f"saved to {handler.simulation_dir}")
    return {"scn": scn, "final": final, "traj": traj, "steps": steps, "batch": 1,
            "seconds": dt, "saved": str(handler.simulation_dir)}


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default=DEFAULT)
    p.add_argument("--steps", type=int, default=None)
    a = p.parse_args()
    run(a.device, a.steps)
