"""Dataset loading and host-side domain randomization (the counterpart of
``pednstream_tpu/generator.py``, reference src/utils/env_loader.py:21-424).

Loads a named scenario directory under the repository's ``data/`` (its
``sim_params.yaml`` plus an optional ``adj_matrix.npy``,
``edge_distances.pkl`` and ``node_positions.json``), applies override
layering and compiles a :class:`~pednstream_tpu_torch.scenario.Scenario`
on the requested device.  Randomization reproduces the reference's
perturbations (k-hop OD-node edits, OD flow weights, capacity/speed
incidents on 20% of corridors, demand patterns) with the same global
``np.random`` call sequences as the JAX package; ``build_od_randomizable``
builds the superset topology that :mod:`~pednstream_tpu_torch.randomize`
opens and closes per replica instead.
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
    """Build (and randomize) scenarios from dataset directories."""

    def __init__(self, data_dir: Optional[str] = None, ftype=None,
                 exact_parity: bool = False, history_window: Optional[int] = None,
                 device="cpu"):
        self.data_root = Path(data_dir) if data_dir else DATA_ROOT
        self.ftype = ftype
        self.exact_parity = exact_parity
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
        self.scenario = build_scenario(**args, **self._build_kwargs())
        return self.scenario

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

    def randomize_network(self, dataset: str, seed: Optional[int] = None,
                          verbose: bool = False) -> Scenario:
        """Randomized scenario (env_loader.py:160-181)."""
        self._load(dataset)
        self.generate_random_od_nodes(seed)
        reset_link_params = self.generate_random_link_params(seed)
        reset_od_flows = self.generate_random_od_flows(seed)
        reset_demand_params = self.generate_random_demand_params(seed)
        return self.create_network(
            dataset,
            od_flows=reset_od_flows,
            link_params_overrides=reset_link_params,
            demand_params_overrides=reset_demand_params,
            verbose=verbose,
        )

    # -- randomization primitives (env_loader.py:183-424) --------------------

    def _controller_nodes(self) -> set:
        controllers = self.config["params"].get("controllers", {}) or {}
        nodes = set(map(int, controllers.get("nodes", []) or []))
        for link in controllers.get("links", []) or []:
            a, b = link.split("-")
            nodes.add(int(a))
            nodes.add(int(b))
        return nodes

    def generate_random_demand_params(self, seed: Optional[int] = None) -> dict:
        if seed is not None:
            np.random.seed(seed)
        origin_nodes = self.config.get("origin_nodes", [])
        demand_params = {}
        available = ["gaussian_peaks", "constant", "sudden_demand"]
        for origin in origin_nodes:
            pattern = np.random.choice(available)
            base_lambda = np.random.uniform(2.0, 10.0)
            peak_lambda = np.random.uniform(10.0, 30.0)
            if peak_lambda < base_lambda + 5:
                peak_lambda = base_lambda + 5
            demand_params[f"origin_{origin}"] = {
                "pattern": str(pattern),
                "base_lambda": float(base_lambda),
                "peak_lambda": float(peak_lambda),
                "seed": seed,
            }
        return demand_params

    def generate_random_od_flows(self, seed: Optional[int] = None) -> dict:
        if seed is not None:
            np.random.seed(seed)
        origin_nodes = self.config.get("origin_nodes", [])
        destination_nodes = self.config.get("destination_nodes", [])
        simulation_steps = self.config["params"]["simulation_steps"]
        od_flows = {}
        for o in origin_nodes:
            for d in destination_nodes:
                if o == d:
                    continue
                base_weight = np.random.uniform(1.0, 10.0)
                od_flows[(o, d)] = np.full(simulation_steps + 1, base_weight)
        return od_flows

    def generate_random_od_nodes(self, seed: Optional[int] = None) -> dict:
        """Perturb origin/destination sets by k-hop neighbourhood edits
        (env_loader.py:261-359); controller nodes excluded."""
        if seed is not None:
            np.random.seed(seed)
        original_origins = list(self.config.get("origin_nodes", []))
        original_destinations = list(self.config.get("destination_nodes", []))
        adj = np.asarray(self.network_data["adjacency_matrix"])
        controller_nodes = self._controller_nodes()

        def get_neighbors(node_list, hop=1):
            neighbors = set()
            for node in node_list:
                neighbors.update(np.where(adj[node, :] == 1)[0].tolist())
            if hop == 2:
                hop2 = set()
                for n in neighbors:
                    hop2.update(np.where(adj[n, :] == 1)[0].tolist())
                neighbors.update(hop2)
            return list(neighbors)

        new_origins = original_origins.copy()
        if np.random.random() < 0.5:
            cands = [n for n in get_neighbors(new_origins, hop=2)
                     if n not in new_origins and n not in controller_nodes]
            if cands:
                k = np.random.randint(1, min(2, len(cands) + 1))
                new_origins.extend(int(x) for x in np.random.choice(cands, k, replace=False))
        if len(new_origins) > 1 and np.random.random() < 0.5:
            k = np.random.randint(1, min(2, len(new_origins)))
            drop = np.random.choice(len(new_origins), k, replace=False)
            new_origins = [o for i, o in enumerate(new_origins) if i not in drop]
        if np.random.random() < 0.5:
            swap = np.random.choice(new_origins)
            valid = [n for n in get_neighbors([swap], hop=2)
                     if n not in new_origins and n not in controller_nodes]
            if valid:
                new_origins[new_origins.index(swap)] = int(np.random.choice(valid))

        new_destinations = original_destinations.copy()
        if np.random.random() < 0.5:
            cands = [n for n in get_neighbors(new_destinations, hop=2)
                     if n not in new_destinations and n not in controller_nodes]
            if cands:
                k = np.random.randint(1, min(3, len(cands) + 1))
                new_destinations.extend(int(x) for x in np.random.choice(cands, k, replace=False))
        if len(new_destinations) > len(new_origins) and np.random.random() < 0.5:
            removable = [d for d in new_destinations if d not in new_origins]
            if removable:
                k = np.random.randint(1, min(2, len(removable) + 1))
                to_remove = [int(x) for x in np.random.choice(removable, k, replace=False)]
                new_destinations = [d for d in new_destinations if d not in to_remove]

        new_origins = [int(x) for x in new_origins]
        new_destinations = [int(x) for x in new_destinations]
        self.config["origin_nodes"] = new_origins
        self.config["destination_nodes"] = new_destinations
        return {"origin_nodes": new_origins, "destination_nodes": new_destinations}

    def generate_random_link_params(self, seed: Optional[int] = None) -> dict:
        """Local incidents: capacity / speed drops on ~20% of corridors
        (env_loader.py:363-424)."""
        if seed is not None:
            np.random.seed(seed)
        if self.network_data.get("edge_distances"):
            valid_links = [f"{u}_{v}" for (u, v) in self.network_data["edge_distances"].keys()
                           if u < v]
        else:
            adj = np.asarray(self.network_data["adjacency_matrix"])
            rows, cols = np.where(adj == 1)
            valid_links = [f"{u}_{v}" for u, v in zip(rows, cols) if u < v]

        defaults = self.config["params"]["default_link"]
        links = self.config["params"].get("links", {})
        link_overrides = {}
        n_change = int(len(valid_links) * 0.2)
        if n_change > 0:
            targets = np.random.choice(valid_links, n_change, replace=False)
            for link_id in targets:
                params = {}
                current = links.get(link_id, {})
                if np.random.random() < 0.5:
                    factor = np.random.uniform(0.6, 1.2)
                    cur_kc = current.get("k_critical", defaults["k_critical"])
                    cur_kj = current.get("k_jam", defaults["k_jam"])
                    params["k_critical"] = max(0.5, cur_kc * factor)
                    params["k_jam"] = max(params["k_critical"] * 2.0, cur_kj * factor)
                if np.random.random() < 0.5:
                    cur_ffs = current.get("free_flow_speed", defaults["free_flow_speed"])
                    params["free_flow_speed"] = cur_ffs * np.random.uniform(0.6, 0.9)
                if params:
                    link_overrides[link_id] = params
        return link_overrides
