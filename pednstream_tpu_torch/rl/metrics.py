"""Offline evaluation metrics over saved simulation runs (numpy and JSON
on the host: the metrics of ``pednstream_tpu/rl/metrics.py``, value for
value).

Same metric definitions and JSON layout as the reference's offline
library (rl/rl_utils.py:770-1510); runs written by either engine are
accepted since the OutputHandler formats match.
"""

import json
from pathlib import Path
from typing import Dict

import numpy as np


def _load(sim_dir, *names):
    out = []
    p = Path(sim_dir)
    for name in names:
        fp = p / f"{name}.json"
        if not fp.exists():
            raise FileNotFoundError(f"{name}.json not found in {sim_dir}")
        with open(fp) as f:
            out.append(json.load(f))
    return out if len(out) > 1 else out[0]


def compute_network_throughput(simulation_dir: str) -> dict:
    """Completed demand / total demand (rl_utils.py:770-876)."""
    network_params, node_data, link_data = _load(
        simulation_dir, "network_params", "node_data", "link_data"
    )
    origin_nodes = network_params.get("origin_nodes", [])
    destination_nodes = set(network_params.get("destination_nodes", []))

    total_demand = 0.0
    for origin_id in origin_nodes:
        demand = node_data.get(str(origin_id), {}).get("demand", [])
        if demand:
            total_demand += sum(demand)

    completed_demand = 0.0
    for link_key, link_info in link_data.items():
        try:
            _, end_node = map(int, link_key.split("-"))
        except ValueError:
            continue
        if end_node in destination_nodes:
            cum_out = link_info.get("cumulative_outflow", [])
            if cum_out:
                completed_demand += cum_out[-1]

    throughput = completed_demand / total_demand if total_demand > 0 else 0.0
    return {
        "throughput": throughput,
        "completed_demand": completed_demand,
        "total_demand": total_demand,
        "completion_rate": throughput,
    }


def compute_network_travel_time(simulation_dir: str) -> dict:
    """Mean per-link travel time over OD-path links (rl_utils.py:879-959)."""
    link_data, network_params = _load(simulation_dir, "link_data", "network_params")
    od_links = set()
    for _, paths in network_params.get("od_paths", {}).items():
        for path in paths:
            for i in range(len(path) - 1):
                od_links.add(f"{path[i]}-{path[i + 1]}")

    link_avgs = []
    for link_key, link_info in link_data.items():
        if od_links and link_key not in od_links:
            continue
        tts = [tt for tt in link_info.get("travel_time", []) if tt is not None and tt >= 0]
        if tts:
            link_avgs.append(np.mean(tts))
    return {
        "avg_travel_time": float(np.mean(link_avgs)) if link_avgs else 0.0,
        "num_links": len(link_avgs),
    }


def compute_total_network_delay(simulation_dir: str) -> dict:
    """Person-seconds of delay: N(t)*(1 - T_ff/T(t))*dt summed
    (rl_utils.py:962-1066)."""
    network_params, link_data = _load(simulation_dir, "network_params", "link_data")
    unit_time = network_params.get("unit_time", 1.0)

    total_delay = 0.0
    total_person_time = 0.0
    num_links = 0
    for link_info in link_data.values():
        params = link_info.get("parameters", {})
        length, ffs = params.get("length"), params.get("free_flow_speed")
        if length is None or ffs is None or ffs <= 0:
            continue
        t_ff = length / ffs
        peds = link_info.get("num_pedestrians", [])
        tts = link_info.get("travel_time", [])
        for n, tt in zip(peds, tts):
            if n is None or tt is None or tt <= 0:
                continue
            total_delay += n * max(0.0, 1 - t_ff / tt) * unit_time
            total_person_time += n * unit_time
        num_links += 1
    return {
        "total_delay": total_delay,
        "delay_intensity": total_delay / total_person_time if total_person_time > 0 else 0.0,
        "total_person_time": total_person_time,
        "num_links": num_links,
    }


def compute_average_travel_time_spent(simulation_dir: str) -> dict:
    """Total person-time / trips entered (rl_utils.py:1069-1172)."""
    network_params, link_data = _load(simulation_dir, "network_params", "link_data")
    unit_time = network_params.get("unit_time", 1.0)
    origin_nodes = set(network_params.get("origin_nodes", []))
    if not origin_nodes:
        raise ValueError("No origin nodes found in network parameters")

    total_person_time = sum(
        n * unit_time
        for link_info in link_data.values()
        for n in link_info.get("num_pedestrians", [])
        if n is not None and n >= 0
    )

    total_trips = 0.0
    num_origin_links = 0
    for link_key, link_info in link_data.items():
        try:
            start_node = int(link_key.split("-")[0])
        except ValueError:
            continue
        if start_node in origin_nodes:
            cum_in = link_info.get("cumulative_inflow", [])
            if cum_in:
                total_trips += cum_in[-1]
                num_origin_links += 1
    return {
        "avg_travel_time_spent": total_person_time / total_trips if total_trips > 0 else 0.0,
        "total_person_time": total_person_time,
        "total_trips": total_trips,
        "num_origin_links": num_origin_links,
    }


def compute_served_trips_rate(simulation_dir: str) -> dict:
    """Destination outflow / origin inflow (rl_utils.py:1175-1282)."""
    network_params, link_data = _load(simulation_dir, "network_params", "link_data")
    origin_nodes = set(network_params.get("origin_nodes", []))
    destination_nodes = set(network_params.get("destination_nodes", []))
    if not origin_nodes:
        raise ValueError("No origin nodes found in network parameters")
    if not destination_nodes:
        raise ValueError("No destination nodes found in network parameters")

    total_inflow = total_outflow = 0.0
    n_origin = n_dest = 0
    for link_key, link_info in link_data.items():
        try:
            u, v = map(int, link_key.split("-"))
        except ValueError:
            continue
        if u in origin_nodes and link_info.get("cumulative_inflow"):
            total_inflow += link_info["cumulative_inflow"][-1]
            n_origin += 1
        if v in destination_nodes and link_info.get("cumulative_outflow"):
            total_outflow += link_info["cumulative_outflow"][-1]
            n_dest += 1
    return {
        "served_trips_rate": total_outflow / total_inflow if total_inflow > 0 else 0.0,
        "total_inflow": total_inflow,
        "total_outflow": total_outflow,
        "num_origin_links": n_origin,
        "num_destination_links": n_dest,
    }


def compute_agent_local_metrics(simulation_dir: str, dataset: str = None,
                                scenario=None, spec=None) -> dict:
    """Per-agent average density over connected links
    (rl_utils.py:1285-1411)."""
    link_data = _load(simulation_dir, "link_data")
    if spec is None or scenario is None:
        if dataset is None:
            raise ValueError("dataset parameter is required to compute agent local metrics")
        from ..env.agents import build_agent_spec
        from ..generator import NetworkEnvGenerator

        # only the topology is read: build it on the host
        scenario = NetworkEnvGenerator(device="cpu").create_network(dataset, verbose=False)
        spec = build_agent_spec(scenario)

    topo = scenario.topo
    agent_metrics = {}
    for agent_id in spec.agent_ids:
        connected = []
        if spec.agent_types[agent_id] == "gate":
            node = spec.gate_nodes[spec.gate_ids.index(agent_id)]
            for k in range(topo.max_deg):
                for idx_arr in (topo.in_link_idx, topo.out_link_idx):
                    e = int(idx_arr[node, k])
                    if e >= 0:
                        u, v = topo.link_nodes[e]
                        connected.append(f"{int(u)}-{int(v)}")
        else:
            fwd = int(spec.sep_fwd_link[spec.sep_ids.index(agent_id)])
            rev = int(topo.reverse_idx[fwd])
            for e in (fwd, rev):
                u, v = topo.link_nodes[e]
                connected.append(f"{int(u)}-{int(v)}")

        link_dens, link_norm = {}, {}
        for key in connected:
            if key not in link_data:
                continue
            info = link_data[key]
            dens = [d for d in info.get("density", []) if d is not None and d >= 0]
            k_jam = info.get("parameters", {}).get("k_jam", 1.0)
            if dens:
                link_dens[key] = float(np.mean(dens))
                link_norm[key] = link_dens[key] / k_jam
        if link_dens:
            agent_metrics[agent_id] = {
                "avg_density": float(np.mean(list(link_dens.values()))),
                "avg_normalized_density": float(np.mean(list(link_norm.values()))),
                "num_links": len(link_dens),
                "link_densities": link_dens,
                "link_normalized_densities": link_norm,
            }
        else:
            agent_metrics[agent_id] = {
                "avg_density": 0.0, "avg_normalized_density": 0.0,
                "num_links": 0, "link_densities": {},
                "link_normalized_densities": {},
            }
    return agent_metrics


def compute_network_congestion_metric(simulation_dir: str) -> dict:
    """Excess-density * area * dt congestion integral
    (rl_utils.py:1414-1510)."""
    link_data = _load(simulation_dir, "link_data")
    try:
        network_params = _load(simulation_dir, "network_params")
        unit_time = network_params.get("unit_time", 1.0)
    except FileNotFoundError:
        unit_time = 1.0

    total_congestion = 0.0
    total_area_time = 0.0
    congested_steps = 0
    total_steps = 0
    for link_info in link_data.values():
        params = link_info.get("parameters", {})
        k_jam = params.get("k_jam", 1.0)
        k_critical = params.get("k_critical", 1.0)
        area = params.get("length", 1.0) * params.get("width", 1.0)
        densities = link_info.get("density", [])
        if not densities or k_jam <= 0:
            continue
        for d in densities:
            if d is None or d < 0:
                continue
            area_time = area * unit_time
            total_area_time += area_time
            total_steps += 1
            if d > k_critical:
                congested_steps += 1
                total_congestion += (d - k_critical) * area_time
    return {
        "congestion_time": total_congestion,
        "avg_congestion_density": total_congestion / total_area_time if total_area_time else 0.0,
        "congestion_fraction": congested_steps / total_steps if total_steps else 0.0,
        "total_area_time": total_area_time,
    }


ALL_METRICS = {
    "throughput": compute_network_throughput,
    "travel_time": compute_network_travel_time,
    "delay": compute_total_network_delay,
    "travel_time_spent": compute_average_travel_time_spent,
    "served_trips": compute_served_trips_rate,
    "congestion": compute_network_congestion_metric,
}


def evaluate_run(simulation_dir: str) -> Dict[str, dict]:
    """All offline metrics for one saved run."""
    return {name: fn(simulation_dir) for name, fn in ALL_METRICS.items()}
