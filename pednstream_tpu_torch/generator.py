"""Dataset loading (the loading half of ``pednstream_tpu/generator.py``,
reference src/utils/env_loader.py:21-158).

Loads a named scenario directory under the repository's ``data/`` (its
``sim_params.yaml`` plus an optional ``adj_matrix.npy``,
``edge_distances.pkl`` and ``node_positions.json``), applies override
layering and compiles a :class:`~pednstream_tpu_torch.scenario.Scenario`
on the requested device.  Domain randomization is a later slice.
"""

import json
import pickle
from pathlib import Path
from typing import Callable, List, Optional

import numpy as np

from .config import load_config
from .scenario import Scenario, build_scenario

DATA_ROOT = Path(__file__).resolve().parent.parent / "data"


class NetworkEnvGenerator:
    """Build scenarios from dataset directories."""

    def __init__(self, data_dir: Optional[str] = None,
                 history_window: Optional[int] = None, device="cpu"):
        self.data_root = Path(data_dir) if data_dir else DATA_ROOT
        self.history_window = history_window
        self.device = device
        self.network_data = None
        self.config = None
        self._loaded_dataset = None
        self.scenario: Optional[Scenario] = None

    def _dataset_dir(self, name: str) -> Path:
        d = self.data_root / name
        if not (d / "sim_params.yaml").exists():
            raise FileNotFoundError(f"Network data file not found: {d / 'sim_params.yaml'}")
        return d

    def load_network_data(self, data_path: str) -> dict:
        """Load a scenario directory's contents (env_loader.py:34-79)."""
        d = self._dataset_dir(data_path)
        self.config = load_config(str(d / "sim_params.yaml"))

        edge_distances = None
        if (d / "edge_distances.pkl").exists():
            # a file shipped with the repository's datasets
            with open(d / "edge_distances.pkl", "rb") as f:
                edge_distances = pickle.load(f)

        if "adjacency_matrix" in self.config:
            adjacency_matrix = self.config["adjacency_matrix"]
        else:
            adjacency_matrix = np.load(d / "adj_matrix.npy")

        node_positions = None
        if (d / "node_positions.json").exists():
            with open(d / "node_positions.json") as f:
                node_positions = {str(node): pos for node, pos in json.load(f).items()}

        return {
            "adjacency_matrix": adjacency_matrix,
            "edge_distances": edge_distances,
            "node_positions": node_positions,
        }

    def create_network(
        self,
        dataset: str,
        custom_demand_functions: Optional[List[Callable]] = None,
        od_flows: Optional[dict] = None,
        link_params_overrides: Optional[dict] = None,
        demand_params_overrides: Optional[dict] = None,
        verbose: bool = False,
    ) -> Scenario:
        """Create a Scenario from saved data with override layering
        (env_loader.py:81-158).  ``verbose`` is accepted for API parity and
        unused."""
        args = self.scenario_args(dataset, custom_demand_functions, od_flows,
                                  link_params_overrides, demand_params_overrides)
        self.scenario = build_scenario(**args, history_window=self.history_window,
                                       device=self.device)
        return self.scenario

    def scenario_args(
        self,
        dataset: str,
        custom_demand_functions: Optional[List[Callable]] = None,
        od_flows: Optional[dict] = None,
        link_params_overrides: Optional[dict] = None,
        demand_params_overrides: Optional[dict] = None,
    ) -> dict:
        """The dataset's ``build_scenario`` arguments after override
        layering: ``adjacency_matrix``, ``params``, ``origin_nodes``,
        ``destination_nodes``, ``demand_pattern``, ``od_flows`` and ``pos``
        (the arguments both packages' ``build_scenario`` take)."""
        # reload when asked for another dataset: a cached config from a
        # previous name must never stand in for the requested scenario
        if self.network_data is None or self._loaded_dataset != dataset:
            self.network_data = self.load_network_data(dataset)
            self._loaded_dataset = dataset

        if link_params_overrides:
            links = self.config["params"].setdefault("links", {})
            for link_id, params in link_params_overrides.items():
                links.setdefault(link_id, {}).update(params)

        if od_flows:
            self.config["od_flows"] = od_flows

        if demand_params_overrides:
            demand = self.config["params"].setdefault("demand", {})
            for origin_key, params in demand_params_overrides.items():
                demand.setdefault(origin_key, {}).update(params)

        self.config["params"].setdefault("links", {})
        self._inject_edge_distances()

        return {
            "adjacency_matrix": self.network_data["adjacency_matrix"],
            "params": self.config["params"],
            "origin_nodes": self.config.get("origin_nodes", []),
            "destination_nodes": self.config.get("destination_nodes", []),
            "demand_pattern": custom_demand_functions,
            "od_flows": self.config.get("od_flows", None),
            "pos": self.network_data.get("node_positions"),
        }

    def _inject_edge_distances(self) -> None:
        """Write measured corridor lengths into per-link params
        (env_loader.py:126-144)."""
        if not self.network_data["edge_distances"]:
            return
        default_link_params = self.config["params"]["default_link"]
        for (u, v), distance in self.network_data["edge_distances"].items():
            link_id = f"{u}_{v}"
            link_specific = self.config["params"]["links"].get(link_id, {})
            final_params = dict(default_link_params)
            final_params.update(link_specific)
            final_params["length"] = distance
            self.config["params"]["links"][link_id] = final_params
            if f"{v}_{u}" not in self.config["params"]["links"]:
                self.config["params"]["links"][f"{v}_{u}"] = final_params
