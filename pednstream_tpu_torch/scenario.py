"""Scenario: compiled static topology, engine parameters and the state
factory (the counterpart of ``pednstream_tpu/scenario.py``).

``build_scenario`` compiles the adjacency matrix, link parameters,
controller configuration, demand curves, OD tables and routing turn
tables on the host with NumPy, exactly as the JAX package does, and then
places the static index tensors, :class:`EngineParams` and the routing
tables on one ``device``.  Decisions that the JAX engine takes at trace
time from concrete NumPy constants are taken here once, at build time,
from the same host arrays, so the step never reads a device value back.

Flows run in ``ftype``: float32 (the batched fast path) or float64 with
``exact_parity=True`` (the anchor that reproduces the reference's golden
trajectories).  Both binomial samplers (``"exact"``, the default, and
``"fast"``), both node solves (``"classic"`` and the host LP
``"optimal"``) and the ``od_candidates`` superset build for in-batch OD
randomization are supported.
"""

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from .demand import ODManager, build_demand_table
from .device import DEFAULT, resolve
from .ops.node_solve import NodeTables
from .ops.routing import RoutingKernelTables
from .routing import PathSetBuilder, RoutingTables, build_routing_tables
from .state import EngineParams, NetworkState
from .topology import TopologySpec, build_topology, parse_controllers
from .tracing import kept_span

_NP = {torch.float32: np.float32, torch.float64: np.float64}


def derive_link_constants(length, free_flow_speed, k_critical, k_jam, unit_time) -> dict:
    """Per-link constants derived from the physical parameters
    (link.py:61-91), on tensors of any leading shape.  At build time the
    inputs are the float64 link parameters, as in the reference; under
    per-replica randomization (``randomize``) they are the perturbed
    parameters in their own dtype, as in the JAX package."""
    f32 = torch.float32
    max_tt = length / 0.05  # jam travel-time clamp (link.py:63)
    tt0 = torch.minimum(length / free_flow_speed, max_tt)  # link.py:83
    capacity = free_flow_speed * k_critical
    shockwave = capacity / (k_jam - k_critical)  # link.py:61
    return {
        "max_travel_time": max_tt.to(f32),
        "travel_time0": tt0.to(f32),
        # free-flow travel time divided BEFORE the f32 cast: in the
        # reference's free-flow FD branch the speed stays a Python float
        # (functions.py:120-121), so length/speed divides in f64
        "tt_freeflow32": (length / free_flow_speed).to(f32),
        "free_flow_tau": torch.round(tt0.to(f32) / unit_time).to(torch.int32),
        "tau_shockwave": torch.round(length / (shockwave * unit_time)).to(torch.int32),
    }


def _link_constants(lp, unit_time) -> dict:
    """``derive_link_constants`` of the float64 link parameters."""
    return derive_link_constants(*(torch.from_numpy(np.asarray(x, dtype=np.float64)) for x in (
        lp.length, lp.free_flow_speed, lp.k_critical, lp.k_jam)), unit_time)


def _build_phi_base(topo: TopologySpec, ftype) -> np.ndarray:
    """Equal turning fractions 1/(dest_num-1) off-diagonal
    (network.py:269-271), in the flow dtype."""
    M = topo.max_deg
    eye = np.eye(M, dtype=bool)
    valid = topo.slot_valid[:, :, None] & topo.slot_valid[:, None, :] & ~eye[None]
    m = topo.node_arity.astype(np.float64)
    inv = 1.0 / np.maximum(m - 1.0, 1.0)
    return np.where(valid, inv[:, None, None], 0.0).astype(_NP[ftype])


class Scenario:
    """Static scenario: index tensors and static per-link values on
    ``device``, the nominal :class:`EngineParams`, and the state factory."""

    def __init__(
        self,
        topo: TopologySpec,
        params: dict,
        origin_nodes: List[int],
        destination_nodes: List[int],
        engine_params: EngineParams,
        routing: Optional[RoutingTables],
        path_builder: Optional[PathSetBuilder],
        od_manager: Optional[ODManager],
        device,
        pos: Optional[dict] = None,
        ftype=torch.float32,
        exact_parity: bool = False,
        history_window: Optional[int] = None,
        binomial_mode: str = "exact",
        track_inflow_ring: bool = True,
    ):
        if binomial_mode not in ("exact", "fast"):
            raise ValueError(f"binomial_mode must be 'exact' or 'fast', got {binomial_mode!r}")
        self.device = torch.device(device)
        self.exact_parity = exact_parity
        self.history_window = history_window
        self.binomial_mode = binomial_mode
        # Accepted for the JAX signature.  The port always maintains the
        # inflow ring: its history read (ops.fused_history_reads) takes
        # the diffusion taps from it, as the JAX engine does under
        # use_pallas, where it ignores this flag too.
        self.track_inflow_ring = track_inflow_ring
        self.topo = topo
        self.params = params
        self.origin_nodes = list(origin_nodes)
        self.destination_nodes = list(destination_nodes or [])
        self.pos = pos
        self.ftype = ftype
        self.path_builder = path_builder
        self.od_manager = od_manager
        self.routing = routing

        self.simulation_steps = int(params["simulation_steps"])
        self.unit_time = float(params["unit_time"])
        self.assign_flows_type = params.get("assign_flows_type", "classic")
        self.big_m = 1e6  # destination virtual receiving flow (node.py:22)

        lp = topo.link_params
        self.n_nodes = topo.n_nodes
        self.n_links = topo.n_links
        self.max_deg = topo.max_deg
        N, M = self.n_nodes, self.max_deg

        def dev(a, dtype=None):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

        # static index tensors (int64 where they index)
        self.reverse_idx = dev(topo.reverse_idx, torch.int64)
        self.in_link_idx = dev(topo.in_link_idx, torch.int64)
        self.out_link_idx = dev(topo.out_link_idx, torch.int64)
        self.slot_valid = dev(topo.slot_valid)
        self.has_virtual = dev(topo.has_virtual)
        self.is_otoo = dev(topo.is_otoo)
        self.node_arity = dev(topo.node_arity)
        self.end_node = dev(topo.end_node, torch.int64)
        self.end_slot = dev(topo.end_slot, torch.int64)
        self.start_node = dev(topo.start_node, torch.int64)
        self.start_slot = dev(topo.start_slot, torch.int64)
        self.is_separator = dev(lp.is_separator)
        self.fd_type = dev(lp.fd_type)
        # staged so that init_state copies nothing from the host (the
        # trainers reset states inside sync-free rollouts)
        self.width0 = dev(lp.width).to(ftype)
        # -1 sentinels resolved once: clamped gather indices + validity
        self.in_safe = self.in_link_idx.clamp(min=0)
        self.out_safe = self.out_link_idx.clamp(min=0)
        self.in_valid = self.in_link_idx >= 0
        self.out_valid = self.out_link_idx >= 0
        self.virt_slot = self.has_virtual[:, None] & (
            torch.arange(M, device=self.device)[None, :] == 0)
        # write-back gathers into the flattened [N*M] node-slot axis
        self.end_flat = self.end_node * M + self.end_slot
        self.start_flat = self.start_node * M + self.start_slot
        # the node solve's and the routing kernels' tables (ops.node_solve,
        # ops.routing)
        self.node_tables = NodeTables(
            topo, () if routing is None else routing.routed_ids.cpu().numpy(), self.device)
        self.routing_kernel_tables = (None if routing is None
                                      else RoutingKernelTables(routing, M))
        # reverse-occupancy thinning probability (link.py:382) in the flow
        # dtype: JAX's weak-typed 0.9 takes the dtype of the float-cast
        # pedestrian count it multiplies (engine.py:374,414)
        self.p_reverse = torch.tensor(0.9, dtype=ftype, device=self.device)

        derived = _link_constants(lp, self.unit_time)
        self.travel_time0 = dev(derived["travel_time0"])
        self.tau_shockwave = dev(derived["tau_shockwave"])

        # build-time form of the JAX engine's trace-time test
        # (engine.py:336-339): no link has activity stays, so the
        # activity draw is skipped entirely
        self.act_statically_zero = bool(np.all(lp.activity_probability <= 0))

        T = self.simulation_steps
        if history_window is not None:
            if history_window < 16:
                raise ValueError("history_window must be >= 16")
            self.H = int(min(history_window, T + 1))
        else:
            self.H = T + 1
        self.windowed = self.H < T + 1
        self.avg_tt_window = int(round(100 / self.unit_time))  # link.py:89

        self.engine_params = engine_params

        self.optimal_solver = None
        if self.assign_flows_type == "optimal":
            from .lp_solver import OptimalNodeSolver

            self.optimal_solver = OptimalNodeSolver(topo)
        # set by build_scenario for an od_candidates build (see there)
        self.od_randomizable = False

    def init_state(self, batch: int = 1, device=None) -> NetworkState:
        """Initial state of ``batch`` identical replicas (scenario.py:174-214).

        Flows, cumulative curves, rings, the previous sending/receiving
        flows, gates and virtual counters are in ``ftype``; pedestrian
        counts, densities, speeds and travel times are float32."""
        device = self.device if device is None else torch.device(device)
        f = self.ftype
        f32 = torch.float32
        E, N, H, W, B = self.n_links, self.n_nodes, self.H, self.avg_tt_window, batch

        def zeros(*shape, dtype=f):
            return torch.zeros((B,) + shape, dtype=dtype, device=device)

        def per_link(x):
            return x.to(device).expand(B, E).clone()

        width = self.width0.to(device)
        is_sep = self.is_separator.to(device)
        gate = torch.where(is_sep, width / 2, width)
        tt0 = self.travel_time0
        return NetworkState(
            t=1,
            cum_in_ring=zeros(H, E),
            cum_out_ring=zeros(H, E),
            inflow_ring=zeros(H, E),
            tt_ring=tt0.to(device).expand(B, W, E).clone(),
            cum_in=zeros(E),
            cum_out=zeros(E),
            inflow=zeros(E),
            outflow=zeros(E),
            num_peds=zeros(E, dtype=f32),
            density=zeros(E, dtype=f32),
            speed=zeros(E, dtype=f32),
            travel_time=per_link(tt0),
            link_flow=zeros(E, dtype=f32),
            avg_tt=per_link(tt0),
            tt_run_sum=per_link(tt0),
            sending_prev=-torch.ones((B, E), dtype=f, device=device),
            recv_prev=-torch.ones((B, E), dtype=f, device=device),
            back_gate=per_link(gate),
            sep_width=per_link(gate),
            virt_dep=zeros(N),
            virt_arr=zeros(N),
            virt_dep_cum=zeros(N),
            virt_arr_cum=zeros(N),
        )


@kept_span("scenario.build")
def build_scenario(
    adjacency_matrix: np.ndarray,
    params: dict,
    origin_nodes: List[int],
    destination_nodes: Optional[List[int]] = None,
    od_flows: Optional[dict] = None,
    demand_pattern: Optional[List[Callable]] = None,
    pos: Optional[dict] = None,
    ftype=torch.float32,
    exact_parity: bool = False,
    history_window: Optional[int] = None,
    binomial_mode: str = "exact",
    track_inflow_ring: bool = True,
    od_candidates: Optional[Tuple[List[int], List[int]]] = None,
    device=DEFAULT,
) -> Scenario:
    """Compile a scenario (reference Network.__init__, network.py:56-121).

    The arguments are those of ``pednstream_tpu.build_scenario`` less its
    Pallas switches, plus ``device``.  demand_pattern: optional list of
    custom demand callables registered by __name__ (network.py:88-93).

    od_candidates: optional ``(candidate_origins, candidate_destinations)``.
    Topology, demand curves and routing tables are then built over the
    union of nominal and candidate OD nodes, with the candidates closed
    (zero demand row, zero od_table rows, zero virtual receiving) until
    :mod:`~pednstream_tpu_torch.randomize` opens them per replica.

    The build is kept as the span ``scenario.build``, its path enumeration
    as ``scenario.od_paths`` (:func:`~pednstream_tpu_torch.tracing.kept_spans`).
    """
    device = resolve(device)
    if ftype not in _NP:
        raise TypeError(f"ftype must be torch.float32 or torch.float64, got {ftype}")
    destination_nodes = list(destination_nodes or [])
    cand_origins: List[int] = []
    cand_dests: List[int] = []
    if od_candidates is not None:
        cand_origins = [n for n in od_candidates[0] if n not in origin_nodes]
        cand_dests = [n for n in od_candidates[1] if n not in destination_nodes]
    origins_eff = list(origin_nodes) + cand_origins
    dests_eff = destination_nodes + cand_dests
    topo = build_topology(adjacency_matrix, params, origins_eff, dests_eff)

    # demand curves, generated in node-creation order for RNG parity;
    # candidate origins draw from a separate seeded pass so the nominal
    # origins' curves stay those of the plain build
    T = int(params["simulation_steps"])
    virtual_nodes = [n for n in topo.node_creation_order if topo.has_virtual[n]]
    custom = {f.__name__: f for f in (demand_pattern or [])}
    demands = build_demand_table(T, params, list(origin_nodes), virtual_nodes, custom)
    if cand_origins:
        params_cand = dict(params)
        params_cand["seed"] = int(params.get("seed") or 0) + 10007
        demands_cand = build_demand_table(T, params_cand, cand_origins, virtual_nodes, custom)
        for node_id in cand_origins:
            if node_id in demands_cand:
                demands[node_id] = demands_cand[node_id]
    demand_table = np.zeros((topo.n_nodes, T + 1), dtype=np.float64)
    for node_id, arr in demands.items():
        demand_table[node_id, : len(arr)] = arr[: T + 1]

    od_manager = None
    routing = None
    builder = None
    od_pairs: List[Tuple[int, int]] = []
    od_table = np.zeros((0, T + 1), dtype=np.float64)
    if dests_eff:
        od_manager = ODManager(T)
        od_manager.init_od_flows(origins_eff, dests_eff, od_flows)
        od_pairs, od_table = od_manager.dense_table()

        _, controller_nodes, _, controller_links = parse_controllers(params)
        builder = PathSetBuilder(topo, params, controller_nodes, controller_links)
        builder.find_od_paths(od_pairs)
        routing = build_routing_tables(topo, builder, od_pairs, ftype, device,
                                       exact_parity)

    lp = topo.link_params
    derived = _link_constants(lp, float(params["unit_time"]))

    # nominal OD activation: candidates start closed
    N = topo.n_nodes
    nominal_o = np.zeros(N, dtype=bool)
    nominal_o[list(origin_nodes)] = True
    nominal_d = np.zeros(N, dtype=bool)
    nominal_d[destination_nodes] = True
    od_po = np.asarray([p[0] for p in od_pairs], dtype=np.int64)
    od_pd = np.asarray([p[1] for p in od_pairs], dtype=np.int64)
    if od_candidates is None:
        # plain build: every virtual-link node keeps its big-M slot (node.py:187)
        virt_recv = np.where(np.asarray(topo.has_virtual), 1e6, 0.0)
        demand_nominal = demand_table
        od_table_nominal = od_table
    else:
        virt_recv = np.where(np.asarray(topo.has_virtual) & (nominal_o | nominal_d), 1e6, 0.0)
        demand_nominal = demand_table * nominal_o[:, None]
        od_table_nominal = od_table * (nominal_o[od_po] & nominal_d[od_pd])[:, None]

    def dev(a, dtype=ftype):
        return torch.as_tensor(a, device=device).to(dtype)

    ep = EngineParams(
        length=dev(lp.length),
        width=dev(lp.width),
        free_flow_speed=dev(lp.free_flow_speed),
        k_critical=dev(lp.k_critical),
        k_jam=dev(lp.k_jam),
        gamma=dev(lp.gamma),
        bi_factor=dev(lp.bi_factor),
        activity_probability=dev(lp.activity_probability),
        speed_noise_std=dev(lp.speed_noise_std),
        demand=dev(demand_nominal),
        od_table=dev(od_table_nominal),
        phi_base=dev(_build_phi_base(topo, ftype)),
        virt_recv=dev(virt_recv),
        max_travel_time=dev(derived["max_travel_time"], torch.float32),
        travel_time0=dev(derived["travel_time0"], torch.float32),
        tt_freeflow32=dev(derived["tt_freeflow32"], torch.float32),
        free_flow_tau=dev(derived["free_flow_tau"], torch.int32),
        tau_shockwave=dev(derived["tau_shockwave"], torch.int32),
    )

    scn = Scenario(
        topo=topo,
        params=params,
        origin_nodes=list(origin_nodes),
        destination_nodes=destination_nodes,
        engine_params=ep,
        routing=routing,
        path_builder=builder,
        od_manager=od_manager,
        device=device,
        pos=pos,
        ftype=ftype,
        exact_parity=exact_parity,
        history_window=history_window,
        binomial_mode=binomial_mode,
        track_inflow_ring=track_inflow_ring,
    )
    # OD randomization metadata, host arrays as in the JAX package
    # (read by randomize.py)
    scn.od_randomizable = od_candidates is not None
    if scn.od_randomizable:
        cand_o_mask = np.zeros(N, dtype=bool)
        cand_o_mask[cand_origins] = True
        cand_d_mask = np.zeros(N, dtype=bool)
        cand_d_mask[cand_dests] = True
        scn.nominal_origin_mask = nominal_o
        scn.nominal_dest_mask = nominal_d
        scn.candidate_origin_mask = cand_o_mask
        scn.candidate_dest_mask = cand_d_mask
        scn.demand_full = demand_table
        scn.od_pair_origin = od_po
        scn.od_pair_dest = od_pd
        scn.od_table_full = od_table
    return scn
