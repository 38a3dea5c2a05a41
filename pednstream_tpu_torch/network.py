"""Object-style Network facade for reference-API migration (the counterpart
of ``pednstream_tpu/network.py``).

Users of the reference drive an object graph:

    net = Network(adj, params, origin_nodes=[5, 0])
    for t in range(1, T):
        net.network_loading(t)
    net.links[(2, 3)].density  # full time series
    net.links[(2, 3)].back_gate_width = 1.0

This facade reproduces that surface over the functional engine: each
``network_loading`` call advances the engine step on one replica
(``B = 1``, on ``device``) and records the step's outputs; ``links[(u, v)]`` returns a view assembling reference-layout
time-series arrays on demand; gate/separator setters write into the
control state with the same cross-coupling semantics (link.py:102-126,
462-478).  For high-throughput work use the functional API directly
(``simulate`` / batched envs) — this facade synchronizes with the host
every step by design, exactly like the reference.  A ``seed`` drives the
``torch.Generator`` of the stochastic steps where the JAX facade takes a
PRNG key.
"""

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .device import DEFAULT
from .engine import step_fn
from .io.output_handler import OutputHandler
from .scenario import Scenario, build_scenario


class LinkView:
    """Reference-Link-shaped view over a live simulation."""

    _SERIES = {
        "density": ("density", 0.0), "speed": ("speed", 0.0),
        "travel_time": ("travel_time", None), "inflow": ("inflow", 0.0),
        "outflow": ("outflow", 0.0), "num_pedestrians": ("num_peds", 0.0),
        "cumulative_inflow": ("cum_in", 0.0), "cumulative_outflow": ("cum_out", 0.0),
        "link_flow": ("link_flow", 0.0),
        "sending_flow": ("sending", -1.0), "receiving_flow": ("receiving", -1.0),
    }

    def __init__(self, net: "Network", e: int):
        self._net = net
        self._e = e
        lp = net.scenario.topo.link_params
        self.link_id = "{}_{}".format(*net.scenario.topo.link_nodes[e])
        self.length = float(lp.length[e])
        self.width = float(lp.width[e])
        self.free_flow_speed = float(lp.free_flow_speed[e])
        self.k_critical = float(lp.k_critical[e])
        self.k_jam = float(lp.k_jam[e])
        self.is_separator = bool(lp.is_separator[e])

    def __getattr__(self, name):
        if name in self._SERIES:
            field, init = self._SERIES[name]
            return self._net._series(self._e, field, init)
        raise AttributeError(name)

    # control surface (same coupling as link.py:102-126, 462-478)
    @property
    def back_gate_width(self) -> float:
        return float(self._net.state.back_gate[0, self._e])

    @back_gate_width.setter
    def back_gate_width(self, value: float):
        self._net._set_back_gate(self._e, value)

    @property
    def front_gate_width(self) -> float:
        rev = int(self._net.scenario.topo.reverse_idx[self._e])
        return float(self._net.state.back_gate[0, rev])

    @front_gate_width.setter
    def front_gate_width(self, value: float):
        rev = int(self._net.scenario.topo.reverse_idx[self._e])
        self._net._set_back_gate(rev, value)

    @property
    def separator_width(self) -> float:
        return float(self._net.state.sep_width[0, self._e])

    @separator_width.setter
    def separator_width(self, value: float):
        self._net._set_separator(self._e, value)


class Network:
    """Reference-compatible constructor and stepping API
    (src/LTM/network.py:56-121,266-287)."""

    def __init__(
        self,
        adjacency_matrix: np.ndarray,
        params: dict,
        origin_nodes: List[int],
        destination_nodes: Optional[List[int]] = None,
        demand_pattern: Optional[List[Callable]] = None,
        od_flows: Optional[dict] = None,
        pos: Optional[dict] = None,
        verbose: bool = False,
        seed: int = 0,
        stochastic: bool = True,
        scenario: Optional[Scenario] = None,
        device=DEFAULT,
    ):
        self.scenario = scenario or build_scenario(
            adjacency_matrix, params, origin_nodes, destination_nodes or [],
            od_flows=od_flows, demand_pattern=demand_pattern, pos=pos, device=device,
        )
        self.params = self.scenario.params
        self.simulation_steps = self.scenario.simulation_steps
        self.unit_time = self.scenario.unit_time
        self.origin_nodes = self.scenario.origin_nodes
        self.destination_nodes = self.scenario.destination_nodes
        self.pos = self.scenario.pos
        self.path_finder = self.scenario.path_builder
        self.od_manager = self.scenario.od_manager
        self.stochastic = stochastic

        self.state = self.scenario.init_state(1)
        self._gen = torch.Generator(device=self.scenario.device).manual_seed(seed)
        self._history = []  # one StepOutputs [1, ...] per step, on the device
        self._host_history = (0, {})  # the fields _series has pulled, by step count
        self.links: Dict[Tuple[int, int], LinkView] = {
            (int(u), int(v)): LinkView(self, e)
            for e, (u, v) in enumerate(self.scenario.topo.link_nodes)
        }

    # -- stepping ------------------------------------------------------------

    def network_loading(self, time_step: int):
        """Advance one step; time_step must be the next step (sequential
        driving, as in the reference loop)."""
        expected = int(self.state.t)
        if time_step != expected:
            raise ValueError(
                f"network_loading({time_step}) out of order; next step is {expected}"
            )
        self.state, out = step_fn(
            self.scenario, self.scenario.engine_params, self.state,
            gen=self._gen, stochastic=self.stochastic, record=True,
        )
        self._history.append(out)

    def update_turning_fractions_per_node(self, node_ids: List[int],
                                          new_turning_fractions: np.ndarray):
        """Install fixed turning fractions for given nodes
        (network.py:250-255): the flat [edge_num] row-major off-diagonal
        layout of the reference."""
        topo = self.scenario.topo
        M = topo.max_deg
        phi_base = self.scenario.engine_params.phi_base
        phi = phi_base.cpu().numpy().copy()
        for i, n in enumerate(node_ids):
            m = int(topo.node_arity[n])
            flat = np.asarray(new_turning_fractions[i]).reshape(m, m - 1)
            for r in range(m):
                c = 0
                for j in range(m):
                    if j == r:
                        continue
                    phi[n, r, j] = flat[r, c]
                    c += 1
        self.scenario.engine_params = self.scenario.engine_params.replace(
            phi_base=torch.as_tensor(phi, device=phi_base.device).to(phi_base.dtype)
        )

    # -- control writes ----------------------------------------------------------

    def _set_back_gate(self, e: int, value: float):
        back_gate = self.state.back_gate.clone()
        back_gate[0, e] = value
        self.state = self.state.replace(back_gate=back_gate)

    def _set_separator(self, e: int, value: float):
        topo = self.scenario.topo
        rev = int(topo.reverse_idx[e])
        total = float(topo.link_params.width[e])
        pair = torch.tensor([value, total - value], dtype=self.state.sep_width.dtype,
                            device=self.state.sep_width.device)
        sep_width, back_gate = self.state.sep_width.clone(), self.state.back_gate.clone()
        sep_width[0, [e, rev]] = pair
        back_gate[0, [e, rev]] = pair
        self.state = self.state.replace(sep_width=sep_width, back_gate=back_gate)

    # -- data access ---------------------------------------------------------------

    def _series(self, e: int, field: str, init) -> np.ndarray:
        """Assemble the reference-layout [T+1] series for one link.  A
        field's history is joined on the device and copied to the host
        once per step count, whichever links are then read."""
        T = self.simulation_steps
        n = len(self._history)
        if self._host_history[0] != n:
            self._host_history = (n, {})
        cache = self._host_history[1]
        if n and field not in cache:
            cache[field] = torch.stack(
                [getattr(h, field)[0] for h in self._history]).cpu().numpy()
        if field in ("sending", "receiving"):
            arr = -np.ones(T + 1)
            if n:
                arr[0:n] = cache[field][:, e]
            return arr
        arr = np.zeros(T + 1)
        if field == "travel_time":
            arr[0] = float(self.scenario.travel_time0[e])
        if n:
            arr[1 : n + 1] = cache[field][:, e]
        return arr

    @property
    def nodes(self) -> Dict[int, dict]:
        """Lightweight node info (demand + link ids)."""
        topo = self.scenario.topo
        demand = self.scenario.engine_params.demand.cpu().numpy()
        out = {}
        for nid in range(topo.n_nodes):
            out[nid] = {
                "node_id": nid,
                "demand": demand[nid] if topo.has_virtual[nid] else None,
                "is_origin": nid in self.origin_nodes,
                "is_destination": nid in self.destination_nodes,
            }
        return out

    def save(self, base_dir="outputs", simulation_dir=None):
        handler = OutputHandler(base_dir=base_dir, simulation_dir=simulation_dir)
        handler.save_scenario_state(self.scenario, self._history)
        return handler.simulation_dir

    def visualize(self, **kwargs):
        from .viz.visualizer import NetworkVisualizer

        viz = NetworkVisualizer(
            scenario=self.scenario,
            history=self._history if self._history else None,
            pos=self.pos,
        )
        return viz.visualize_network_state(
            max(len(self._history), 0), edge_property="density", **kwargs
        )
