"""Scenario loading from the repository's raw network files (a frozen copy
of the program's host build): a named directory under ``data/`` (its
``sim_params.yaml`` plus an optional ``adj_matrix.npy``,
``edge_distances.pkl`` and ``node_positions.json``), override layering,
and the superset topology whose OD nodes open and close per replica.
"""

import json
import pickle
from pathlib import Path
from typing import Callable, List, Optional

import numpy as np

from .config import load_config
from .scenario import Scenario, build_scenario, resolve

# the raw network files that the program reads too
DATA_ROOT = Path(__file__).resolve().parents[2] / "data"


class NetworkEnvGenerator:
    """Build (and randomize) scenarios from dataset directories."""

    def __init__(self, data_dir: Optional[str] = None, ftype=None,
                 exact_parity: bool = False, history_window: Optional[int] = None,
                 device="cpu"):
        self.data_root = Path(data_dir) if data_dir else DATA_ROOT
        self.ftype = ftype
        self.exact_parity = exact_parity
        self.history_window = history_window
        self.device = resolve(device)
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

    def _build_kwargs(self) -> dict:
        kwargs = {"exact_parity": self.exact_parity, "history_window": self.history_window,
                  "device": self.device}
        if self.ftype is not None:
            kwargs["ftype"] = self.ftype
        return kwargs

    def _load(self, dataset: str) -> None:
        # reload when asked for another dataset: a cached config from a
        # previous name must never stand in for the requested scenario
        if self.network_data is None or self._loaded_dataset != dataset:
            self.network_data = self.load_network_data(dataset)
            self._loaded_dataset = dataset

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
        self._load(dataset)

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
        (env_loader.py:126-144); shared by create_network and
        build_od_randomizable."""
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

    def build_od_randomizable(self, dataset: str, hop: int = 2,
                              **build_kwargs) -> Scenario:
        """Scenario whose OD-node set randomizes per replica on the device
        instead of through the reference's host-side rebuild
        (env_loader.py:261-359).

        Computes the k-hop candidate pools the reference's OD edit moves
        draw from (``generate_random_od_nodes``), builds the superset
        topology with ``build_scenario(od_candidates=...)`` and leaves
        per-replica activation to ``randomize.randomize_engine_params``.
        """
        self._load(dataset)
        adj = np.asarray(self.network_data["adjacency_matrix"])
        controller_nodes = self._controller_nodes()
        origins = list(self.config.get("origin_nodes", []))
        dests = list(self.config.get("destination_nodes", []))

        def khop(node_list):
            nb = set()
            for node in node_list:
                nb.update(np.where(adj[node, :] == 1)[0].tolist())
            if hop == 2:
                hop2 = set()
                for n in nb:
                    hop2.update(np.where(adj[n, :] == 1)[0].tolist())
                nb.update(hop2)
            return nb

        cand_o = sorted(int(n) for n in khop(origins)
                        if n not in origins and n not in controller_nodes)
        cand_d = sorted(int(n) for n in khop(dests)
                        if n not in dests and n not in controller_nodes)
        kwargs = self._build_kwargs()
        kwargs.update(build_kwargs)
        self.config["params"].setdefault("links", {})
        self._inject_edge_distances()
        return build_scenario(
            adjacency_matrix=self.network_data["adjacency_matrix"],
            params=self.config["params"],
            origin_nodes=origins,
            destination_nodes=dests,
            od_flows=self.config.get("od_flows", None),
            pos=self.network_data.get("node_positions"),
            od_candidates=(cand_o, cand_d),
            **kwargs,
        )

    def _controller_nodes(self) -> set:
        controllers = self.config["params"].get("controllers", {}) or {}
        nodes = set(map(int, controllers.get("nodes", []) or []))
        for link in controllers.get("links", []) or []:
            a, b = link.split("-")
            nodes.add(int(a))
            nodes.add(int(b))
        return nodes
