"""YAML scenario configuration loading (host-side).

The same loader as ``pednstream_tpu/config.py``, kept in the port because
importing that package loads JAX.  The YAML layout is
``network:{adjacency_matrix? | grid?, origin_nodes, destination_nodes?}``,
``simulation:{simulation_steps, unit_time, assign_flows_type?, seed?,
path_finder?}``, ``default_link``, optional ``links``, ``demand``,
``controllers`` and ``od_flows`` (keys "o_d").
"""

from typing import Any, Dict

import numpy as np
import yaml


def grid_adjacency(rows: int, cols: int) -> np.ndarray:
    """4-neighbour grid adjacency (``network: grid: {rows, cols}``)."""
    n = rows * cols
    adj = np.zeros((n, n), dtype=np.int8)
    idx = np.arange(n).reshape(rows, cols)
    right = np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], axis=1)
    down = np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], axis=1)
    edges = np.concatenate([right, down])
    adj[edges[:, 0], edges[:, 1]] = 1
    adj[edges[:, 1], edges[:, 0]] = 1
    return adj


def load_config(config_path: str) -> dict:
    """Load a scenario YAML into the params dict consumed by build_scenario:
    ``{'params': {...}, 'origin_nodes': [...], 'destination_nodes': [...]}``
    plus optional ``'adjacency_matrix'`` and ``'od_flows'`` ({(o, d): flow}).
    """
    with open(config_path, "r") as f:
        config = yaml.safe_load(f)

    sim = config["simulation"]
    params = {
        "simulation_steps": sim["simulation_steps"],
        "unit_time": sim["unit_time"],
        "assign_flows_type": sim.get("assign_flows_type", "classic"),
        "seed": sim.get("seed", None),
        "path_finder": sim.get("path_finder", {}),
        "default_link": config["default_link"],
        "links": config.get("links", {}) or {},
        "demand": config.get("demand", {}) or {},
        "controllers": config.get("controllers", {}) or {},
    }

    result = {
        "params": params,
        "origin_nodes": config["network"]["origin_nodes"],
        "destination_nodes": config["network"].get("destination_nodes", []),
    }

    if "adjacency_matrix" in config["network"]:
        result["adjacency_matrix"] = np.array(config["network"]["adjacency_matrix"])
    elif "grid" in config["network"]:
        g = config["network"]["grid"]
        result["adjacency_matrix"] = grid_adjacency(int(g["rows"]), int(g["cols"]))

    if config.get("od_flows"):
        result["od_flows"] = {
            tuple(map(int, od_pair.split("_"))): flow
            for od_pair, flow in config["od_flows"].items()
        }

    return result


def validate_config(config: Dict[str, Any]) -> None:
    """Validate raw (unflattened) YAML config structure
    (reference src/utils/config.py:53-78)."""
    required_fields = {
        "network": ["origin_nodes"],
        "simulation": ["simulation_steps", "unit_time"],
        "default_link": ["length", "width", "free_flow_speed", "k_critical", "k_jam"],
    }
    for section, fields in required_fields.items():
        if section not in config:
            raise ValueError(f"Missing required section: {section}")
        for field in fields:
            if field not in config[section]:
                raise ValueError(f"Missing required field: {field} in section {section}")
