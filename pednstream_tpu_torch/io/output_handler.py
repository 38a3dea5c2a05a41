"""Reference-format simulation output persistence (the counterpart of
``pednstream_tpu/io/output_handler.py``).

Writes the same three JSON artifacts as the reference OutputHandler
(handlers/output_handler.py:27-93) — ``link_data.json`` (full per-link
time series + parameters + gate/separator width series),
``node_data.json`` (demand + link ids), ``network_params.json`` — plus
the optional ``time_series.csv`` (:95-118), byte for byte what the JAX
package's handler writes from the same numbers, so the reference's offline
metrics and visualizers (and this package's) read any engine's runs
interchangeably.

Input is a Scenario and the trajectory of one replica (``B = 1``): either
the ``StepOutputs`` of tensors stacked ``[T, 1, ...]`` by
``simulate(..., record=True)``, or a list of StepOutputs collected step by
step (``[1, ...]`` entries) or by the PettingZoo env (``[action_gap, 1,
...]`` entries).  Each field is joined on its device and moved to the
host once, in its own dtype.
"""

import json
from datetime import datetime
from pathlib import Path
from typing import Dict, List, Union

import numpy as np
import torch

from ..scenario import Scenario
from ..state import StepOutputs
from ..topology import parse_controllers


def _host_history(history) -> Dict[str, np.ndarray]:
    """``{field: numpy [T, ...]}`` of a recorded run, the replica axis
    dropped: one device-to-host copy per field."""
    out = {}
    for name in StepOutputs.__dataclass_fields__:
        if isinstance(history, StepOutputs):
            x = getattr(history, name)
        else:
            xs = [getattr(h, name) for h in history]
            # entries with a leading action_gap axis are joined along
            # time, single steps stacked
            x = torch.cat(xs) if history[0].density.dim() == 3 else torch.stack(xs)
        if x.shape[1] != 1:
            raise ValueError(f"a saved run is one replica's; {name} has shape {tuple(x.shape)}")
        out[name] = x[:, 0].cpu().numpy()
    return out

class OutputHandler:
    def __init__(self, base_dir="outputs", simulation_dir=None):
        self.base_dir = Path(base_dir)
        self.timestamp = datetime.now().strftime("%Y%m%d_%H%M%S")
        if simulation_dir is not None:
            self.simulation_dir = self.base_dir / simulation_dir
        else:
            self.simulation_dir = self.base_dir / f"sim_{self.timestamp}"
        self.simulation_dir.mkdir(parents=True, exist_ok=True)

    # -- save -----------------------------------------------------------------

    def save_scenario_state(
        self,
        scn: Scenario,
        history: Union[StepOutputs, List[StepOutputs]],
        save_time_series: bool = False,
    ):
        """Persist a recorded run in the reference's JSON layout."""
        h = _host_history(history)
        n_steps = h["density"].shape[0]
        T = scn.simulation_steps
        if n_steps > T:
            # an env whose action_gap does not divide the horizon steps a
            # few engine steps past simulation_steps before reporting
            # done; the reference layout holds exactly T+1 columns, so
            # drop the overshoot
            h = {k: v[:T] for k, v in h.items()}
            n_steps = T
        topo = scn.topo
        lp = topo.link_params

        def series(name, init=0.0, fill=None):
            """Full T+1 array: index 0 = initial value, t = step t output."""
            E = scn.n_links
            arr = np.full((E, T + 1), fill if fill is not None else 0.0)
            arr[:, 0] = init
            arr[:, 1 : n_steps + 1] = h[name].T
            return arr

        tt0 = scn.travel_time0.cpu().numpy()
        density = series("density")
        link_flow = series("link_flow")
        speed = series("speed")
        travel_time = series("travel_time")
        travel_time[:, 0] = tt0
        inflow = series("inflow")
        outflow = series("outflow")
        num_peds = series("num_peds")
        cum_in = series("cum_in")
        cum_out = series("cum_out")
        # sending/receiving are written at index t-1 during step t with a
        # -1 init sentinel (link.py:16-17)
        sending = -np.ones((scn.n_links, T + 1))
        sending[:, 0:n_steps] = h["sending"].T
        receiving = -np.ones((scn.n_links, T + 1))
        receiving[:, 0:n_steps] = h["receiving"].T
        back_gate = np.tile(np.asarray(lp.width)[:, None], (1, T + 1))
        back_gate[:, 1 : n_steps + 1] = h["back_gate"].T
        back_gate[:, 0] = back_gate[:, 1]
        sep_w = np.tile((np.asarray(lp.width) / 2)[:, None], (1, T + 1))
        sep_w[:, 1 : n_steps + 1] = h["sep_width"].T
        sep_w[:, 0] = sep_w[:, 1]

        _, _, gaters, _ = parse_controllers(scn.params)

        link_data = {}
        for e, (u, v) in enumerate(topo.link_nodes):
            u, v = int(u), int(v)
            entry = {
                "density": density[e].tolist(),
                "link_flow": link_flow[e].tolist(),
                "speed": speed[e].tolist(),
                "travel_time": travel_time[e].tolist(),
                "inflow": inflow[e].tolist(),
                "outflow": outflow[e].tolist(),
                "num_pedestrians": num_peds[e].tolist(),
                "cumulative_inflow": cum_in[e].tolist(),
                "cumulative_outflow": cum_out[e].tolist(),
                "sending_flow": sending[e].tolist(),
                "receiving_flow": receiving[e].tolist(),
                "parameters": {
                    "length": float(lp.length[e]),
                    "width": float(lp.width[e]),
                    "free_flow_speed": float(lp.free_flow_speed[e]),
                    "k_critical": float(lp.k_critical[e]),
                    "k_jam": float(lp.k_jam[e]),
                },
            }
            if u in gaters:
                entry["back_gate_width"] = back_gate[e].tolist()
            if lp.is_separator[e]:
                entry["is_separator"] = True
                entry["separator_width"] = sep_w[e].tolist()
            link_data[f"{u}-{v}"] = entry

        demand = scn.engine_params.demand.cpu().numpy()
        node_data = {}
        for n in range(topo.n_nodes):
            in_ids, out_ids = [], []
            if topo.has_virtual[n]:
                in_ids.append(f"virtual_in_{n}")
                out_ids.append(f"virtual_out_{n}")
            for k in range(topo.max_deg):
                e_in = int(topo.in_link_idx[n, k])
                e_out = int(topo.out_link_idx[n, k])
                if e_in >= 0:
                    in_ids.append(f"{int(topo.link_nodes[e_in][0])}_{int(topo.link_nodes[e_in][1])}")
                if e_out >= 0:
                    out_ids.append(f"{int(topo.link_nodes[e_out][0])}_{int(topo.link_nodes[e_out][1])}")
            node_data[str(n)] = {
                "demand": demand[n].tolist() if topo.has_virtual[n] else [],
                "incoming_links": in_ids,
                "outgoing_links": out_ids,
            }

        od_paths = {}
        if scn.path_builder is not None:
            od_paths = {
                f"{o}-{d}": paths
                for (o, d), paths in scn.path_builder.od_paths.items()
            }
        network_params = {
            "simulation_steps": scn.simulation_steps,
            "unit_time": scn.unit_time,
            "destination_nodes": scn.destination_nodes,
            "origin_nodes": scn.origin_nodes,
            "od_paths": od_paths,
        }

        self._save_json(link_data, "link_data.json")
        self._save_json(node_data, "node_data.json")
        self._save_json(network_params, "network_params.json")

        if save_time_series:
            self.save_time_series(scn, h, n_steps)

    def save_time_series(self, scn: Scenario, h: dict, n_steps: int):
        """CSV time series (output_handler.py:95-118)."""
        import csv

        topo = scn.topo
        with open(self.simulation_dir / "time_series.csv", "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(
                ["time_step", "link_id", "density", "speed", "inflow", "outflow",
                 "num_pedestrians", "cumulative_inflow", "cumulative_outflow"]
            )
            for e, (u, v) in enumerate(topo.link_nodes):
                for t in range(min(n_steps, scn.simulation_steps)):
                    w.writerow(
                        [t, f"{int(u)}-{int(v)}", h["density"][t, e], h["speed"][t, e],
                         h["inflow"][t, e], h["outflow"][t, e], h["num_peds"][t, e],
                         h["cum_in"][t, e], h["cum_out"][t, e]]
                    )

    def _save_json(self, data, filename):
        with open(self.simulation_dir / filename, "w") as f:
            json.dump(data, f, indent=2)

    # -- load -----------------------------------------------------------------

    @staticmethod
    def load_simulation(simulation_dir: str) -> dict:
        """Load a saved run (output_handler.py:126-148); reads runs written
        by this package or by the reference interchangeably."""
        data = {}
        p = Path(simulation_dir)
        for filename in ["link_data.json", "node_data.json", "network_params.json"]:
            fp = p / filename
            if fp.exists():
                with open(fp) as f:
                    data[filename.replace(".json", "")] = json.load(f)
        return data
