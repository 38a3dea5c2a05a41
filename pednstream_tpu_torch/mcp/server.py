"""MCP service layer: LLM-driven simulation control.

Same tool surface as the reference FastMCP server (mcp/mcp_server.py:
135-1014): create_environment (with deep config overrides), stepwise /
resumable run_simulation, save_outputs, visualize_snapshot, animate,
get_status, list_simulations, cancel_simulation, sim:// data resources,
and the config-authoring suite (list_config_schema, validate_config,
upsert_config, read_config).

Tools are plain functions over a thread-locked SimulationManager, so
they are fully usable and testable without an MCP runtime;
``build_server()`` wires them into FastMCP when that package is
installed.

The counterpart of ``pednstream_tpu/mcp/server.py`` over the port's
generator, scenario, engine, output handler and visualizers.  A simulation
lives on the device ``create_environment`` is given (the card unless the
caller asks for the CPU), one replica with full-horizon rings, and carries
its own ``torch.Generator``; ``run_simulation`` only enqueues work while it
steps and synchronizes once before it replies.
"""

import json
import re
import threading
import uuid
from dataclasses import dataclass, field
from datetime import datetime
from enum import Enum
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..device import DEFAULT


class SimulationStatus(str, Enum):
    CREATED = "CREATED"
    RUNNING = "RUNNING"
    COMPLETED = "COMPLETED"
    FAILED = "FAILED"
    CANCELLED = "CANCELLED"


@dataclass
class SimulationState:
    sim_id: str
    config_name: str
    status: SimulationStatus = SimulationStatus.CREATED
    current_step: int = 0
    total_steps: int = 0
    error: Optional[str] = None
    created_at: str = field(default_factory=lambda: datetime.now().isoformat())
    scenario: Any = None
    engine_state: Any = None
    history: list = field(default_factory=list)
    output_dir: Optional[str] = None
    step_fn: Any = None  # (params, state) -> (state, outputs), gen bound
    gen: Any = None  # the simulation's torch.Generator, on its device
    device: Any = None  # torch.device the scenario and state live on
    # serializes the step loop: the step advances the state's rings in
    # place, so two threads stepping the same sim would race on them
    # (the HTTP transport is a ThreadingHTTPServer)
    run_lock: Any = field(default_factory=threading.Lock)

    def to_dict(self):
        return {
            "sim_id": self.sim_id,
            "config_name": self.config_name,
            "status": self.status.value,
            "current_step": self.current_step,
            "total_steps": self.total_steps,
            "error": self.error,
            "created_at": self.created_at,
            "output_dir": self.output_dir,
        }


class SimulationManager:
    """Thread-locked simulation registry (mcp_server.py:80-132)."""

    def __init__(self, base_output_dir: str = "outputs"):
        self.base_output_dir = Path(base_output_dir)
        self._sims: Dict[str, SimulationState] = {}
        self._lock = threading.Lock()

    def create_simulation(self, config_name: str) -> SimulationState:
        with self._lock:
            sim_id = str(uuid.uuid4())[:8]
            sim = SimulationState(sim_id=sim_id, config_name=config_name)
            self._sims[sim_id] = sim
            return sim

    def get(self, sim_id: str) -> SimulationState:
        with self._lock:
            sim = self._sims.get(sim_id)
        if sim is None:
            raise KeyError(f"Unknown simulation: {sim_id}")
        return sim

    def list(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [s.to_dict() for s in self._sims.values()]


_manager = SimulationManager()


def _deep_update(base: dict, override: dict) -> dict:
    for k, v in (override or {}).items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            _deep_update(base[k], v)
        else:
            base[k] = v
    return base


# -- simulation tools (mcp_server.py:207-491) ----------------------------------


def create_environment(config_name: str, overrides: Dict[str, Any] = None,
                       data_dir: Optional[str] = None,
                       device: str = DEFAULT) -> Dict[str, Any]:
    """Create a simulation environment from a named dataset with optional
    deep config overrides (mcp_server.py:157-223).

    The scenario and its state are built on ``device``; a CUDA device on a
    machine with no card fails the simulation, it does not run elsewhere."""
    from ..generator import NetworkEnvGenerator
    from ..scenario import build_scenario

    sim = _manager.create_simulation(config_name)
    try:
        gen = NetworkEnvGenerator(data_dir=data_dir, device=device)
        # load through the generator's own cache, so create_network below
        # builds from the config the overrides were merged into
        gen._load(config_name)
        if overrides:
            cfg = {"params": gen.config["params"],
                   "origin_nodes": gen.config["origin_nodes"],
                   "destination_nodes": gen.config["destination_nodes"]}
            _deep_update(cfg, overrides)
            gen.config["params"] = cfg["params"]
            gen.config["origin_nodes"] = cfg["origin_nodes"]
            gen.config["destination_nodes"] = cfg["destination_nodes"]
        scn = gen.create_network(config_name)
        sim.scenario = scn
        sim.device = scn.device
        sim.engine_state = scn.init_state(batch=1)
        sim.gen = torch.Generator(device=scn.device).manual_seed(0)
        sim.total_steps = int(scn.simulation_steps)
        sim.current_step = 0
        return {"sim_id": sim.sim_id, "status": sim.status.value,
                "num_nodes": int(scn.n_nodes), "num_links": int(scn.n_links),
                "simulation_steps": int(scn.simulation_steps)}
    except Exception as e:
        sim.status = SimulationStatus.FAILED
        sim.error = str(e)
        return {"sim_id": sim.sim_id, "status": sim.status.value, "error": str(e)}


def run_simulation(sim_id: str, steps: int = None, until: int = None) -> Dict[str, Any]:
    """Advance a simulation, resumable (mcp_server.py:225-277): run
    ``steps`` more steps or until absolute step ``until``.

    Stepping goes through a step function cached on the simulation (made
    at the first call, the simulation's generator bound).  On the card the
    loop only enqueues work; one synchronize before the reply makes
    ``current_step`` the steps finished and turns a device error into this
    call's ``FAILED``."""
    from ..engine import make_step

    sim = _manager.get(sim_id)
    if sim.status in (SimulationStatus.FAILED, SimulationStatus.CANCELLED):
        return {"sim_id": sim_id, "status": sim.status.value, "error": sim.error}
    scn = sim.scenario
    if not sim.run_lock.acquire(blocking=False):
        # another request is already stepping this sim; in-place rings
        # make concurrent stepping unsafe, so report instead of racing
        return {"sim_id": sim_id, "status": SimulationStatus.RUNNING.value,
                "current_step": sim.current_step,
                "total_steps": sim.total_steps,
                "note": "step loop busy in another request"}
    try:
        # compute end INSIDE the critical section: a concurrent request
        # finishing between a read of current_step and the acquire would
        # otherwise make steps=N advance fewer than N steps
        end = sim.total_steps - 1
        if until is not None:
            end = min(until, sim.total_steps - 1)
        elif steps is not None:
            end = min(sim.current_step + steps, sim.total_steps - 1)
        sim.status = SimulationStatus.RUNNING
        if sim.step_fn is None:
            sim.step_fn = make_step(scn, stochastic=True, record=True,
                                    donate=True, gen=sim.gen)
        while sim.current_step < end:
            if sim.status == SimulationStatus.CANCELLED:
                break
            st, out = sim.step_fn(scn.engine_params, sim.engine_state)
            # reassign BEFORE any other work: the previous state's rings
            # were advanced in place, so the registry must never keep a
            # reference to it past this call — even if a later statement
            # raises
            sim.engine_state = st
            sim.history.append(out)
            sim.current_step += 1
        if sim.device.type == "cuda":
            # the loop only enqueued: wait once, so the reply counts steps
            # finished and a device error fails this call, not a later one
            torch.cuda.synchronize(sim.device)
        if sim.current_step >= sim.total_steps - 1:
            sim.status = SimulationStatus.COMPLETED
        elif sim.status != SimulationStatus.CANCELLED:
            sim.status = SimulationStatus.CREATED  # paused, resumable
        return {"sim_id": sim_id, "status": sim.status.value,
                "current_step": sim.current_step, "total_steps": sim.total_steps}
    except Exception as e:
        sim.status = SimulationStatus.FAILED
        sim.error = str(e)
        return {"sim_id": sim_id, "status": sim.status.value, "error": str(e)}
    finally:
        sim.run_lock.release()


def save_outputs(sim_id: str, include_time_series: bool = True) -> Dict[str, Any]:
    """Persist the run so far (mcp_server.py:279-326)."""
    from ..io.output_handler import OutputHandler

    sim = _manager.get(sim_id)
    if not sim.history:
        return {"sim_id": sim_id, "error": "no steps recorded yet"}
    handler = OutputHandler(base_dir=str(_manager.base_output_dir),
                            simulation_dir=f"mcp_{sim_id}")
    handler.save_scenario_state(sim.scenario, sim.history,
                                save_time_series=include_time_series)
    sim.output_dir = str(handler.simulation_dir)
    return {"sim_id": sim_id, "output_dir": sim.output_dir,
            "files": ["link_data.json", "node_data.json", "network_params.json"]
            + (["time_series.csv"] if include_time_series else [])}


def visualize_snapshot(sim_id: str, time_step: int, edge_property: str = "density",
                       save_name: str = None) -> Dict[str, Any]:
    """Render a network snapshot to PNG (mcp_server.py:327-377)."""
    import matplotlib

    matplotlib.use("Agg")
    from ..viz.visualizer import NetworkVisualizer

    sim = _manager.get(sim_id)
    viz = NetworkVisualizer(scenario=sim.scenario, history=sim.history,
                            pos=sim.scenario.pos)
    out_dir = _manager.base_output_dir / f"mcp_{sim_id}"
    out_dir.mkdir(parents=True, exist_ok=True)
    name = save_name or f"snapshot_{edge_property}_t{time_step}.png"
    path = out_dir / name
    viz.visualize_network_state(time_step, edge_property=edge_property,
                                save_path=str(path))
    return {"sim_id": sim_id, "image_path": str(path)}


def animate(sim_id: str, start_time: int = 0, end_time: int = None,
            edge_property: str = "density", fps: int = 10) -> Dict[str, Any]:
    """Render an animation GIF (mcp_server.py:378-440)."""
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib.animation import PillowWriter

    from ..viz.visualizer import NetworkVisualizer

    sim = _manager.get(sim_id)
    viz = NetworkVisualizer(scenario=sim.scenario, history=sim.history,
                            pos=sim.scenario.pos)
    ani = viz.animate_network(start_time=start_time, end_time=end_time,
                              edge_property=edge_property)
    out_dir = _manager.base_output_dir / f"mcp_{sim_id}"
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"animation_{edge_property}.gif"
    ani.save(str(path), writer=PillowWriter(fps=fps))
    return {"sim_id": sim_id, "animation_path": str(path)}


def export_interactive_map(sim_id: str, save_name: str = None,
                           max_frames: int = 600) -> Dict[str, Any]:
    """Export a standalone interactive HTML map (SVG + time slider, no
    external dependencies) of the simulation so far — the service-side
    replacement for the reference's Streamlit/folium dashboard view."""
    from ..viz.html_export import export_interactive_html

    sim = _manager.get(sim_id)
    if not sim.history:
        return {"sim_id": sim_id, "error": "no steps recorded yet"}
    out_dir = _manager.base_output_dir / f"mcp_{sim_id}"
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / (save_name or "interactive_map.html")
    export_interactive_html(scenario=sim.scenario, history=sim.history,
                            out_path=str(path), title=sim.config_name,
                            max_frames=max_frames)
    return {"sim_id": sim_id, "html_path": str(path)}


def get_status(sim_id: str) -> Dict[str, Any]:
    return _manager.get(sim_id).to_dict()


def list_simulations() -> Dict[str, Any]:
    return {"simulations": _manager.list()}


def cancel_simulation(sim_id: str) -> Dict[str, Any]:
    sim = _manager.get(sim_id)
    sim.status = SimulationStatus.CANCELLED
    return {"sim_id": sim_id, "status": sim.status.value}


# -- resources (mcp_server.py:493-554) ------------------------------------------


def _resource(sim_id: str, filename: str) -> str:
    sim = _manager.get(sim_id)
    if not sim.output_dir:
        save_outputs(sim_id)
    path = Path(sim.output_dir) / filename
    return path.read_text()


def get_link_data(sim_id: str) -> str:
    return _resource(sim_id, "link_data.json")


def get_node_data(sim_id: str) -> str:
    return _resource(sim_id, "node_data.json")


def get_network_params(sim_id: str) -> str:
    return _resource(sim_id, "network_params.json")


def get_time_series(sim_id: str) -> str:
    return _resource(sim_id, "time_series.csv")


# -- config authoring (mcp_server.py:564-906) -------------------------------------

_SCHEMA = {
    "network": {
        "adjacency_matrix": "2D 0/1 list (symmetric); or provide adj_matrix.npy",
        "origin_nodes": "list[int], required",
        "destination_nodes": "list[int]",
    },
    "simulation": {
        "simulation_steps": "int, required",
        "unit_time": "number (seconds per step), required",
        "assign_flows_type": "'classic' | 'optimal'",
        "seed": "int | null",
        "path_finder": {"k_paths": "int", "temp": "float", "alpha": "float",
                        "beta": "float", "omega": "float", "std_dev": "float"},
    },
    "default_link": {
        "length": "m", "width": "m", "free_flow_speed": "m/s",
        "k_critical": "ped/m^2", "k_jam": "ped/m^2", "gamma": "float",
        "fd_type": "'yperman'|'greenshields'|'smulders'",
        "activity_probability": "0..1", "bi_factor": "float",
        "speed_noise_std": "float",
    },
    "links": {"'u_v'": "per-corridor overrides of default_link"},
    "controllers": {"enabled": "bool", "nodes": "list[int] (gaters)",
                    "links": "list['u-v'] (separators)"},
    "demand": {"origin_<id>": {"pattern": "gaussian_peaks|constant|sudden_demand",
                               "peak_lambda": "float", "base_lambda": "float"}},
    "od_flows": {"'o_d'": "scalar weight or array[T+1]"},
}

_EXAMPLE_YAML = """\
network:
  adjacency_matrix: [[0, 1], [1, 0]]
  origin_nodes: [0]
  destination_nodes: [1]
simulation:
  simulation_steps: 100
  unit_time: 10
default_link:
  length: 100
  width: 3
  free_flow_speed: 1.1
  k_critical: 2
  k_jam: 6
demand:
  origin_0:
    pattern: gaussian_peaks
    peak_lambda: 20
    base_lambda: 5
"""


def list_config_schema() -> Dict[str, Any]:
    """Canonical scenario schema + example (mcp_server.py:757-790)."""
    return {"schema": _SCHEMA, "example_yaml": _EXAMPLE_YAML}


def normalize_config(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """Normalize a config to the canonical nested (YAML-file) form
    (role of the reference's _normalize_config, mcp_server.py:564-717,
    which canonicalizes between its flat loader form and the nested
    file form).

    Accepts either shape:
      * nested file form: network/simulation/default_link/links/
        controllers/demand/od_flows sections
      * flat loader form: {'params': {simulation_steps, unit_time,
        default_link, links, ...}, 'origin_nodes': [...], ...}
    plus stray legacy top-level keys (origin_nodes, adjacency_matrix,
    simulation_steps at top level), and returns the nested form that
    upsert_config writes and load_config reads.
    """
    from copy import deepcopy

    cfg = deepcopy(cfg) if isinstance(cfg, dict) else {}
    out: Dict[str, Any] = {}

    params = cfg.get("params") if isinstance(cfg.get("params"), dict) else {}
    sim_src = cfg.get("simulation") if isinstance(cfg.get("simulation"), dict) else {}
    net_src = cfg.get("network") if isinstance(cfg.get("network"), dict) else {}

    # network block: explicit section wins; legacy top-level keys fill in
    network: Dict[str, Any] = dict(net_src)
    for k in ("origin_nodes", "destination_nodes", "adjacency_matrix"):
        if k not in network and k in cfg:
            network[k] = cfg[k]
    if network:
        out["network"] = network

    # simulation block from (in order): nested section, flat params,
    # stray top-level scalars
    simulation: Dict[str, Any] = dict(sim_src)
    for k in ("simulation_steps", "unit_time", "assign_flows_type", "seed",
              "path_finder"):
        if k not in simulation:
            if k in params:
                simulation[k] = params[k]
            elif k in cfg and not isinstance(cfg.get(k), dict):
                simulation[k] = cfg[k]
    if "path_finder" in simulation and not isinstance(simulation["path_finder"], dict):
        simulation.pop("path_finder")
    if simulation:
        out["simulation"] = simulation

    for k in ("default_link", "links", "controllers", "demand", "od_flows"):
        v = cfg.get(k, params.get(k))
        if isinstance(v, dict) and (v or k in ("links",)):
            out[k] = v
    return out


def _validate_struct(cfg: Dict[str, Any]) -> List[Dict[str, str]]:
    errors = []

    def err(path, msg):
        errors.append({"path": path, "message": msg})

    if "network" not in cfg:
        err("network", "missing section")
    else:
        if "origin_nodes" not in cfg["network"]:
            err("network.origin_nodes", "required")
        adj = cfg["network"].get("adjacency_matrix")
        if adj is not None:
            a = np.asarray(adj)
            if a.ndim != 2 or a.shape[0] != a.shape[1]:
                err("network.adjacency_matrix", "must be square 2D")
    if "simulation" not in cfg:
        err("simulation", "missing section")
    else:
        for k in ("simulation_steps", "unit_time"):
            if k not in cfg["simulation"]:
                err(f"simulation.{k}", "required")
    if "default_link" not in cfg:
        err("default_link", "missing section")
    else:
        dl = cfg["default_link"]
        for k in ("length", "width", "free_flow_speed", "k_critical", "k_jam"):
            if k not in dl:
                err(f"default_link.{k}", "required")
            elif not isinstance(dl[k], (int, float)) or dl[k] <= 0:
                err(f"default_link.{k}", "must be a positive number")
        if ("k_critical" in dl and "k_jam" in dl
                and isinstance(dl["k_jam"], (int, float))
                and isinstance(dl["k_critical"], (int, float))
                and dl["k_jam"] <= dl["k_critical"]):
            err("default_link.k_jam", "must exceed k_critical")

    key_re = re.compile(r"^\d+_\d+$")
    links = cfg.get("links")
    if links is not None:
        if not isinstance(links, dict):
            err("links", "must be a map of 'u_v' -> overrides")
        else:
            for lk, lconf in links.items():
                if not key_re.match(str(lk)):
                    err(f"links.{lk}", "key should be 'u_v' (integer node ids)")
                if not isinstance(lconf, dict):
                    err(f"links.{lk}", "link override must be an object")
    of = cfg.get("od_flows")
    if of is not None:
        if not isinstance(of, dict):
            err("od_flows", "must be a map of 'o_d' -> weight")
        else:
            for k, v in of.items():
                if not key_re.match(str(k)):
                    err(f"od_flows.{k}", "key should be 'o_d' (integer node ids)")
                if not isinstance(v, (int, float, list)) or (
                        isinstance(v, (int, float)) and v < 0):
                    err(f"od_flows.{k}", "must be a non-negative number or array")
    sim = cfg.get("simulation", {})
    if isinstance(sim, dict) and "simulation_steps" in sim:
        ss = sim["simulation_steps"]
        if not isinstance(ss, int) or ss <= 0:
            err("simulation.simulation_steps", "must be a positive integer")
    return errors


def validate_config(config: Dict[str, Any] = None, yaml_text: str = None) -> Dict[str, Any]:
    """Validate a scenario config dict or YAML text, after legacy-key
    normalization (mcp_server.py:564-717,792-829)."""
    import yaml as _yaml

    if config is None and yaml_text is None:
        return {"valid": False, "errors": [{"path": "", "message": "no config given"}]}
    if config is None:
        try:
            config = _yaml.safe_load(yaml_text)
        except Exception as e:
            return {"valid": False, "errors": [{"path": "", "message": f"YAML parse: {e}"}]}
    config = normalize_config(config or {})
    errors = _validate_struct(config)
    return {"valid": not errors, "errors": errors, "normalized": config}


def _sanitize_name(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_\-]", "_", name)


def upsert_config(name: str, config: Dict[str, Any] = None, yaml_text: str = None,
                  data_dir: str = "data") -> Dict[str, Any]:
    """Write a scenario config to the dataset directory
    (mcp_server.py:854-892)."""
    import yaml as _yaml

    result = validate_config(config, yaml_text)
    if not result["valid"]:
        return {"saved": False, **result}
    config = result["normalized"]  # write the canonical nested form
    name = _sanitize_name(name)
    d = Path(data_dir) / name
    d.mkdir(parents=True, exist_ok=True)
    with open(d / "sim_params.yaml", "w") as f:
        _yaml.safe_dump(config, f, sort_keys=False)
    return {"saved": True, "name": name, "path": str(d / "sim_params.yaml")}


def read_config(name: str, data_dir: str = "data") -> Dict[str, Any]:
    """Read a stored scenario config (mcp_server.py:893-906)."""
    import yaml as _yaml

    path = Path(data_dir) / _sanitize_name(name) / "sim_params.yaml"
    if not path.exists():
        # fall back to the bundled reference datasets
        from ..generator import DATA_ROOT

        alt = DATA_ROOT / name / "sim_params.yaml"
        if alt.exists():
            path = alt
    if not path.exists():
        return {"found": False, "name": name}
    with open(path) as f:
        return {"found": True, "name": name, "config": _yaml.safe_load(f)}


TOOLS = {
    "create_environment": create_environment,
    "run_simulation": run_simulation,
    "save_outputs": save_outputs,
    "visualize_snapshot": visualize_snapshot,
    "animate": animate,
    "export_interactive_map": export_interactive_map,
    "get_status": get_status,
    "list_simulations": list_simulations,
    "cancel_simulation": cancel_simulation,
    "list_config_schema": list_config_schema,
    "normalize_config": normalize_config,
    "validate_config": validate_config,
    "upsert_config": upsert_config,
    "read_config": read_config,
}

RESOURCES = {
    "sim://{sim_id}/link_data": get_link_data,
    "sim://{sim_id}/node_data": get_node_data,
    "sim://{sim_id}/network_params": get_network_params,
    "sim://{sim_id}/time_series": get_time_series,
}


def build_server(name: str = "pednstream-torch"):
    """Wire the tools into a FastMCP server (requires `fastmcp`)."""
    try:
        from fastmcp import FastMCP
    except ImportError as e:
        raise ImportError(
            "fastmcp is not installed; the tool functions in "
            "pednstream_tpu_torch.mcp.server are directly callable without it"
        ) from e
    mcp = FastMCP(name)
    for tool in TOOLS.values():
        mcp.tool(tool)
    for uri, fn in RESOURCES.items():
        mcp.resource(uri)(fn)
    return mcp


if __name__ == "__main__":
    build_server().run()
