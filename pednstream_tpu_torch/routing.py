"""Route choice: host-side path/turn-table precompute and the per-step
logit turning fractions on tensors.

The host half (:class:`PathSetBuilder`, :func:`build_routing_tables`) is
the NumPy/networkx code of ``pednstream_tpu/routing.py``; the port keeps
its own copy because importing that package loads JAX.  What differs is
how the per-step segment sums are laid out: the JAX fast path sums with
static one-hot matrices (a matmul rides the TPU's MXU), which the GPU does
not need.  Here every segment -- a softmax group, an (up, od) mixing
group, a compact phi slot -- gets a static padded member table
``[segments, Q, L]`` (entry ids in ascending order, -1 padding), and
:func:`segment_sum` walks it in one padded loop over ``L``.  The rows
``Q`` fix the order: one left-to-right row for the exact-parity path,
and for the fast path the lanes in which XLA's CPU GEMV adds the one-hot
product, so the sum is the JAX package's bit for bit (at one replica;
``GEMV_LANES``).  The order is static, so the sum is deterministic on the
GPU, where ``index_add_``/``scatter_add_`` use float atomics whose order
changes from run to run.

On CUDA tensors :func:`turning_fractions_step` is one launch of the
hand-written kernel of ``csrc/routing.cu`` (``ops.routing``), which walks
the same tables in the same order, each routed node's ranges found through
``RoutingTables.node_offsets``; :func:`turning_fractions_step_plain` is its
plain version, which CPU tensors take.
"""

from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

import networkx as nx
import numpy as np
import torch

from .device import DEFAULT, resolve
from .ops import turning_fractions
from .state import _Tensors
from .topology import TopologySpec
from .tracing import kept_span


# --------------------------------------------------------------------------
# Host-side: path enumeration and static turn tables
# --------------------------------------------------------------------------

def enumerate_shortest_simple_paths(graph, origin, dest, max_paths=None):
    """K shortest simple paths by total weight (path_finder.py:114-142)."""
    try:
        paths_iter = nx.shortest_simple_paths(graph, origin, dest, weight="weight")
    except nx.NetworkXException:
        return []
    paths = []
    try:
        for path in paths_iter:
            paths.append(path)
            if max_paths is not None and len(paths) >= max_paths:
                break
    except nx.NetworkXNoPath:
        return []
    return paths


class PathSetBuilder:
    """Host path enumeration with controller detour expansion.

    Mirrors PathFinder.find_od_paths / expand_controller_paths
    (path_finder.py:199-458) with the hardcoded detour settings
    ('penalize' mode, penalty factor 2, max 3 detour paths per neighbour,
    path_finder.py:172-175).
    """

    def __init__(
        self,
        topo: TopologySpec,
        params: Optional[dict],
        controller_nodes: Optional[Set[int]],
        controller_links: Optional[List[str]],
    ):
        path_params = (params or {}).get("path_finder", {}) or {}
        self.k_paths = path_params.get("k_paths", 3)
        self.temp = path_params.get("temp", 0.1)
        self.alpha = path_params.get("alpha", 1.0)
        self.beta = path_params.get("beta", 0.05)
        self.omega = path_params.get("omega", 0.05)
        self.std_dev = path_params.get("std_dev", 0)
        self.detour_penalty_factor = 2
        self.max_detour_paths = 3

        self.topo = topo
        self.controller_nodes = set(controller_nodes or set())
        self.controllers_enabled = bool(controller_nodes or controller_links)

        self.graph = nx.DiGraph()
        for e, (u, v) in enumerate(topo.link_nodes):
            self.graph.add_edge(int(u), int(v), weight=float(topo.link_params.length[e]))

        self.od_paths: Dict[Tuple[int, int], List[List[int]]] = {}
        self.nodes_in_paths: Set[int] = set()
        self.node_to_od_pairs: Dict[int, Set[Tuple[int, int]]] = {}

    @kept_span("scenario.od_paths")
    def find_od_paths(self, od_pairs) -> None:
        for origin, dest in od_pairs:
            paths = enumerate_shortest_simple_paths(
                self.graph, origin, dest, max_paths=self.k_paths
            )
            self.od_paths[(origin, dest)] = paths
            for path in paths:
                for node in path:
                    self.nodes_in_paths.add(node)
                    self.node_to_od_pairs.setdefault(node, set()).add((origin, dest))

        if self.controllers_enabled:
            for node in sorted(self.controller_nodes):
                for od_pair in sorted(self.node_to_od_pairs.get(node, set())):
                    self._expand_controller_paths(node, od_pair)

        # dedup (path_finder.py:236-254)
        for od_pair, paths in self.od_paths.items():
            normalized = [tuple(int(x) for x in p) for p in paths]
            if len(set(normalized)) != len(normalized):
                seen, unique = set(), []
                for p in normalized:
                    if p not in seen:
                        seen.add(p)
                        unique.append(list(p))
                self.od_paths[od_pair] = unique

    def _outgoing_neighbors(self, node_id: int) -> Set[int]:
        k0 = 1 if self.topo.has_virtual[node_id] else 0
        return {
            int(m)
            for m in self.topo.slot_neighbor[node_id, k0:]
            if int(m) >= 0
        }

    def _expand_controller_paths(self, node_id: int, od_pair) -> None:
        """Detour expansion at a controller node (path_finder.py:304-458)."""
        origin, dest = od_pair
        paths = self.od_paths[od_pair]
        new_paths: List[List[int]] = []

        all_outgoing = self._outgoing_neighbors(node_id)

        modified = self.graph.copy()
        all_od_edges: Dict[Tuple[int, int], float] = {}
        for p in paths:
            for i in range(len(p) - 1):
                edge = (p[i], p[i + 1])
                if edge not in all_od_edges:
                    try:
                        all_od_edges[edge] = nx.shortest_path_length(
                            self.graph, p[i + 1], dest, weight="weight"
                        )
                    except nx.NetworkXNoPath:
                        all_od_edges[edge] = 0
        if all_od_edges:
            max_dist = max(all_od_edges.values())
            for (u, v), dist_to_dest in all_od_edges.items():
                if modified.has_edge(u, v):
                    if max_dist > 0:
                        dyn = 1.0 + (self.detour_penalty_factor - 1.0) * (
                            dist_to_dest / max_dist
                        )
                    else:
                        dyn = self.detour_penalty_factor
                    modified[u][v]["weight"] = modified[u][v].get("weight", 1) * dyn

        for path in paths:
            if node_id not in path:
                continue
            node_idx = path.index(node_id)
            if node_id == dest:
                continue
            up_node = -1 if node_id == origin else (path[node_idx - 1] if node_idx > 0 else -1)
            on_path_down = path[node_idx + 1] if node_idx < len(path) - 1 else None

            for neighbor in all_outgoing:
                if neighbor == on_path_down or neighbor == up_node:
                    continue
                if neighbor in set(path[:node_idx]):
                    continue
                detours = enumerate_shortest_simple_paths(
                    modified, neighbor, dest, max_paths=self.max_detour_paths
                )
                if not detours:
                    continue
                prefix_and_current = set(path[: node_idx + 1])
                for suffix in detours:
                    if set(suffix[1:]) & prefix_and_current:
                        continue
                    new_path = path[: node_idx + 1] + suffix
                    existing = set(tuple(p) for p in self.od_paths[od_pair])
                    if tuple(new_path) not in existing:
                        new_paths.append(new_path)

        if new_paths:
            self.od_paths[od_pair].extend(new_paths)
            for new_path in new_paths:
                for node in new_path:
                    self.nodes_in_paths.add(node)
                    self.node_to_od_pairs.setdefault(node, set()).add(od_pair)

    def path_distance(self, path, start_idx=0) -> float:
        """Remaining distance along path (path_finder.py:284-300)."""
        dist = 0.0
        for i in range(start_idx, len(path) - 1):
            dist += self.graph.edges[(path[i], path[i + 1])]["weight"]
        return dist


@dataclass
class RoutingTables(_Tensors):
    """Flat tables for the per-step turning-fraction update, as tensors.

    K turn entries, one per (node, od, up, down) candidate turn; U
    "(node, up, od)" entries for the P(od|up) flow mixing; G softmax groups
    over (node, od, up); UG groups over (node, up); NR routed nodes.  The
    fields down to ``routed_ids`` are those of the JAX ``RoutingTables``
    (less its one-hot matrices); the rest are the port's padded segment
    tables and static per-step constants.
    """

    te_dist: torch.Tensor  # [K] f64 remaining distance of the turn
    te_group: torch.Tensor  # [K] (node, od, up) softmax group id
    te_uo_idx: torch.Tensor  # [K] index into uo entries
    te_down_link: torch.Tensor  # [K] directed link (node -> down), -1 virtual
    te_phi_idx: torch.Tensor  # [K] node*M*M + up_slot*M + down_slot
    group_dist_sum: torch.Tensor  # [G] f64
    uo_od: torch.Tensor  # [U] od pair index
    uo_group: torch.Tensor  # [U] (node, up) group id
    uo_group_count: torch.Tensor  # [UG] f64 entries per group
    routed_mask: torch.Tensor  # [N] bool
    temp: float
    alpha: float
    beta: float
    omega: float
    routed_ids: torch.Tensor  # [NR] sorted routed node ids

    # padded segment tables [segments, Q, L] (``_members``): member entry
    # ids in ascending order per summation lane, -1 pad
    group_members: torch.Tensor  # [G, Q, Lg] turn entries of each softmax group
    uo_group_members: torch.Tensor  # [UG, Q, Lu] uo entries of each (node, up)
    te_phi_c: torch.Tensor  # [K] compact phi slot r*M*M + up*M + down
    phi_c_members: torch.Tensor  # [NR*M*M, Q, Lp] turn entries of each slot

    # static per-step constants in the flow dtype
    dist_util: torch.Tensor  # [K] alpha * te_dist / (group_dist_sum + 1e-6)
    uo_inv_count: torch.Tensor  # [U] 1 / entries of the entry's group
    offdiag_uniform: torch.Tensor  # [NR, M, M] guard fallback 1/(arity-1)

    # each routed node's first turn entry, softmax group, uo entry and
    # (node, up) group (``NODE_TABLES`` order; row NR holds the totals):
    # the kernel's block for a node reads only its own ranges
    node_offsets: torch.Tensor  # [NR + 1, 4] int64

    num_groups: int
    num_uo_groups: int
    num_entries: int
    num_routed: int
    node_max: Tuple[int, int, int, int]  # the most of each range a node holds



# XLA's CPU backend, under the flags the JAX package's tests set (SSE4.2,
# no FMA), sums the fast path's one-hot products ``vals @ onehot`` as a
# row-major GEMV of 128-bit vectors: entry k of K adds into lane ``k % W``
# (W = 4 float32, 2 float64) while ``k < K - K % W``, each lane left to
# right from 0, the rest into a scalar epilogue; then the lanes pairwise,
# ``((l0 + l2) + (l1 + l3))``, and the epilogue last.  A fixed function of
# the entries' positions, so the member tables carry it.
GEMV_LANES = {torch.float32: 4, torch.float64: 2}


def _members(seg_ids: np.ndarray, num: int, lanes: int = 0) -> np.ndarray:
    """Padded member table ``[num, Q, L]``, -1 padding: with ``lanes == 0``
    one row per segment (``Q = 1``), its entries in ascending order, added
    left to right; else ``Q = lanes + 1`` rows, the entries of each GEMV
    lane and then of the epilogue, each in ascending order
    (:func:`segment_sum` combines them in XLA's order)."""
    K = len(seg_ids)
    if lanes:
        tail = K - K % lanes
        row = np.where(np.arange(K) < tail, np.arange(K) % lanes, lanes)
    else:
        row = np.zeros(K, dtype=np.int64)
    Q = lanes + 1
    counts = np.zeros((num, Q), dtype=np.int64)
    np.add.at(counts, (seg_ids, row), 1)
    out = -np.ones((num, Q, max(int(counts.max(initial=0)), 1)), dtype=np.int64)
    fill = np.zeros((num, Q), dtype=np.int64)
    for i, (s, q) in enumerate(zip(seg_ids, row)):
        out[s, q, fill[s, q]] = i
        fill[s, q] += 1
    return out


# the ranges of ``RoutingTables.node_offsets``' columns
NODE_TABLES = ("entries", "groups", "uo_entries", "uo_groups")


def _node_offsets(node_of: List[np.ndarray], num_routed: int) -> np.ndarray:
    """``[NR + 1, len(node_of)]`` starts of each routed node's range in
    each table, from the node of every row of the table.  The build emits
    the rows node by node, so each range is contiguous; checked."""
    out = np.zeros((num_routed + 1, len(node_of)), dtype=np.int64)
    for j, nodes in enumerate(node_of):
        if np.any(np.diff(nodes) < 0):
            raise AssertionError(f"the {NODE_TABLES[j]} of a routed node are not contiguous")
        out[:, j] = np.searchsorted(nodes, np.arange(num_routed + 1))
    return out


def build_routing_tables(
    topo: TopologySpec,
    builder: PathSetBuilder,
    od_pairs: List[Tuple[int, int]],
    ftype=torch.float32,
    device=DEFAULT,
    exact_parity: bool = False,
) -> Optional[RoutingTables]:
    """Compile turn tables from enumerated paths.

    Mirrors PathFinder.calculate_turn_probabilities (path_finder.py:460-559):
    per routed node (source_num > 2 and on some path), for each relevant OD
    pair, each (up, down) turn keeps the *shortest* remaining distance over
    all paths realizing it; ods_in_turns / up_od_probs record which OD pairs
    use each turn / upstream arm.  The segment tables add left to right
    for the exact-parity path (the reference's ``np.add.at`` order) and in
    the JAX fast path's GEMV order otherwise (``GEMV_LANES``).
    """
    device = resolve(device)
    od_index = {p: i for i, p in enumerate(od_pairs)}
    nb2slot = topo.neighbor_to_slot
    M = topo.max_deg

    te_rows = []  # (node, od_idx, up, down, dist)
    routed_nodes = []
    for node_id in sorted(builder.nodes_in_paths):
        if int(topo.node_arity[node_id]) <= 2:
            continue
        relevant = builder.node_to_od_pairs.get(node_id, set())
        node_turns: Dict[Tuple[int, int], Dict[Tuple[int, int], float]] = {}
        for od_pair in relevant:
            origin, dest = od_pair
            od_turn_distances: Dict[Tuple[int, int], float] = {}
            for path in builder.od_paths[od_pair]:
                if node_id not in path:
                    continue
                node_idx = path.index(node_id)
                if node_id == origin:
                    turn = (-1, path[node_idx + 1])
                elif node_id == dest:
                    turn = (path[node_idx - 1], -1)
                elif node_idx < len(path) - 1:
                    turn = (path[node_idx - 1], path[node_idx + 1])
                else:
                    continue
                remaining = builder.path_distance(path, start_idx=node_idx)
                if turn not in od_turn_distances or remaining < od_turn_distances[turn]:
                    od_turn_distances[turn] = remaining
            if od_turn_distances:
                node_turns[od_pair] = od_turn_distances
        if not node_turns:
            continue
        routed_nodes.append(node_id)
        for od_pair, turns in node_turns.items():
            for (up, down), dist in turns.items():
                te_rows.append((node_id, od_index[od_pair], up, down, dist))

    if not te_rows:
        return None

    # softmax groups: (node, od, up); uo groups: (node, up)
    group_ids: Dict[Tuple[int, int, int], int] = {}
    uo_entry_ids: Dict[Tuple[int, int, int], int] = {}  # (node, up, od) -> entry
    uo_group_ids: Dict[Tuple[int, int], int] = {}

    te_dist, te_group, te_uo_idx, te_down_link, te_phi_idx = [], [], [], [], []
    uo_od_l, uo_group_l = [], []

    for (node_id, od_i, up, down, dist) in te_rows:
        gkey = (node_id, od_i, up)
        if gkey not in group_ids:
            group_ids[gkey] = len(group_ids)
        uekey = (node_id, up, od_i)
        if uekey not in uo_entry_ids:
            uo_entry_ids[uekey] = len(uo_entry_ids)
            ugkey = (node_id, up)
            if ugkey not in uo_group_ids:
                uo_group_ids[ugkey] = len(uo_group_ids)
            uo_od_l.append(od_i)
            uo_group_l.append(uo_group_ids[ugkey])

        up_slot = nb2slot[node_id][up]
        down_slot = nb2slot[node_id][down]
        dlink = -1 if down == -1 else topo.link_id_to_idx[(node_id, down)]
        te_dist.append(dist)
        te_group.append(group_ids[gkey])
        te_uo_idx.append(uo_entry_ids[uekey])
        te_down_link.append(dlink)
        te_phi_idx.append(node_id * M * M + up_slot * M + down_slot)

    G = len(group_ids)
    UG = len(uo_group_ids)
    te_dist = np.array(te_dist, dtype=np.float64)
    te_group = np.array(te_group, dtype=np.int64)
    group_dist_sum = np.zeros(G, dtype=np.float64)
    np.add.at(group_dist_sum, te_group, te_dist)
    uo_group = np.array(uo_group_l, dtype=np.int64)
    uo_group_count = np.zeros(UG, dtype=np.float64)
    np.add.at(uo_group_count, uo_group, 1.0)

    routed_mask = np.zeros(topo.n_nodes, dtype=bool)
    routed_mask[routed_nodes] = True
    routed_ids = np.array(routed_nodes, dtype=np.int64)  # sorted by build
    NR = len(routed_ids)
    node_to_c = {int(n): i for i, n in enumerate(routed_ids)}
    te_phi_idx = np.array(te_phi_idx, dtype=np.int64)
    te_phi_c = np.array(
        [node_to_c[int(p // (M * M))] * M * M + int(p % (M * M)) for p in te_phi_idx],
        dtype=np.int64)

    # static pieces of the logit utility and the guard in the flow dtype,
    # staged as the JAX step stages them (every operand cast to it first)
    fd = {torch.float32: np.float32, torch.float64: np.float64}[ftype]
    dist_util = (fd(builder.alpha) * te_dist.astype(fd)
                 / (group_dist_sum[te_group].astype(fd) + fd(1e-6)))
    uo_inv_count = fd(1.0) / uo_group_count[uo_group].astype(fd)
    sv = topo.slot_valid[routed_ids]
    offdiag = sv[:, :, None] & sv[:, None, :] & ~np.eye(M, dtype=bool)[None]
    inv = fd(1.0) / np.maximum(topo.node_arity[routed_ids].astype(fd) - fd(1.0), fd(1.0))
    offdiag_uniform = np.where(offdiag, inv[:, None, None], fd(0.0)).astype(fd)

    te_node = te_phi_c // (M * M)
    uo_node = np.zeros(len(uo_od_l), dtype=np.int64)
    uo_node[np.array(te_uo_idx, dtype=np.int64)] = te_node
    group_node = np.zeros(G, dtype=np.int64)
    group_node[te_group] = te_node
    uo_group_node = np.zeros(UG, dtype=np.int64)
    uo_group_node[uo_group] = uo_node
    node_offsets = _node_offsets([te_node, group_node, uo_node, uo_group_node], NR)

    lanes = 0 if exact_parity else GEMV_LANES[ftype]
    t = lambda a: torch.as_tensor(a, device=device)
    return RoutingTables(
        te_dist=t(te_dist),
        te_group=t(te_group),
        te_uo_idx=t(np.array(te_uo_idx, dtype=np.int64)),
        te_down_link=t(np.array(te_down_link, dtype=np.int64)),
        te_phi_idx=t(te_phi_idx),
        group_dist_sum=t(group_dist_sum),
        uo_od=t(np.array(uo_od_l, dtype=np.int64)),
        uo_group=t(uo_group),
        uo_group_count=t(uo_group_count),
        routed_mask=t(routed_mask),
        temp=float(builder.temp),
        alpha=float(builder.alpha),
        beta=float(builder.beta),
        omega=float(builder.omega),
        routed_ids=t(routed_ids),
        group_members=t(_members(te_group, G, lanes)),
        uo_group_members=t(_members(uo_group, UG, lanes)),
        te_phi_c=t(te_phi_c),
        phi_c_members=t(_members(te_phi_c, NR * M * M, lanes)),
        dist_util=t(dist_util),
        uo_inv_count=t(uo_inv_count),
        offdiag_uniform=t(offdiag_uniform),
        node_offsets=t(node_offsets),
        num_groups=G,
        num_uo_groups=UG,
        num_entries=len(te_rows),
        num_routed=NR,
        node_max=tuple(int(x) for x in np.diff(node_offsets, axis=0).max(axis=0)),
    )


# --------------------------------------------------------------------------
# Per-step turning fractions
# --------------------------------------------------------------------------

def segment_sum(vals: torch.Tensor, members: torch.Tensor) -> torch.Tensor:
    """``out[..., s]`` = the sum of ``vals[..., members[s]]`` over the valid
    members of a ``[S, Q, L]`` table (``_members``): each of the Q rows
    added left to right in one padded walk over L, then the rows combined
    in XLA's GEMV order (``Q = 1``: the row itself)."""
    safe = members.clamp(min=0)
    valid = members >= 0
    out = torch.where(valid[..., 0], vals[..., safe[..., 0]], 0.0)
    for col in range(1, members.shape[-1]):
        out = out + torch.where(valid[..., col], vals[..., safe[..., col]], 0.0)
    lanes = members.shape[1] - 1
    if lanes == 4:
        return ((out[..., 0] + out[..., 2]) + (out[..., 1] + out[..., 3])) + out[..., 4]
    if lanes == 2:
        return (out[..., 0] + out[..., 1]) + out[..., 2]
    return out[..., 0]


# XLA's CPU float32 exp (the Cephes polynomial, each step rounded on its
# own, subnormal results flushed to zero), the constants as XLA emits them
_EXP_LO, _EXP_HI = -87.80000305175781, 88.80000305175781
_LOG2E = 1.4426950216293335
_LN2_HI, _LN2_LO = 0.693359375, -0.00021219444170128554
_EXP_P = (0.00019875691214110702, 0.001398199936375022, 0.008333452045917511,
          0.04166579619050026, 0.1666666567325592, 0.5)
_F32_TINY = 1.1754943508222875e-38


def exp_like_xla(x: torch.Tensor) -> torch.Tensor:
    """``exp(x)`` as the JAX package computes it: bitwise XLA's CPU float32
    exp for float32 ``x`` (torch's differs by an ulp on ~4 % of the logit
    utilities), ``torch.exp`` for float64."""
    if x.dtype != torch.float32:
        return torch.exp(x)
    x = torch.clamp(x, _EXP_LO, _EXP_HI)
    n = torch.clamp(torch.floor(x * _LOG2E + 0.5), -127.0, 127.0)
    r = (x - _LN2_HI * n) - _LN2_LO * n
    y = r * _EXP_P[0] + _EXP_P[1]
    for p in _EXP_P[2:]:
        y = y * r + p
    y = (y * (r * r) + r) + 1.0
    y = y * ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    return torch.where(y < _F32_TINY, 0.0, y)


def seq_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim`` added left to right, ``((x0 + x1) + x2) + ...``: the
    order of the reference's NumPy sums over these short axes, on every
    device (``torch.sum`` fixes no order)."""
    parts = x.unbind(dim)
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    return out


def _turn_contributions(rt: RoutingTables, density_for_routing, recv_prev, cap_default,
                        od_flow_t):
    """Per turn entry ``P(down | up, od) * P(od | up)`` ``[B, K]`` in the
    tables' flow dtype ``f`` (path_finder.py:561-689).  Dtype staging
    mirrors path_finder.py:561-589: densities are float32 state and
    ``beta * norm_densities`` stays float32; the rest is in ``f``."""
    f = rt.dist_util.dtype
    # P(od | up): od-flow-weighted shares per (node, up) group
    # (path_finder.py:599-615); od_flow_t is [P] or per replica [B, P]
    w = od_flow_t[..., rt.uo_od].to(f)
    tot_g = segment_sum(w, rt.uo_group_members)[..., rt.uo_group]
    p_uo = torch.where(tot_g > 0, w / torch.where(tot_g > 0, tot_g, 1.0), rt.uo_inv_count)

    # P(down | up, od): logit over candidate turns (path_finder.py:561-589)
    ld = rt.te_down_link
    safe = ld.clamp(min=0)
    real = ld >= 0
    dens = torch.where(real, density_for_routing[:, safe].to(torch.float32), 0.0)
    rp = recv_prev[:, safe]
    cap = torch.where(real, torch.where(rp >= 0, rp, cap_default[:, safe]), 100.0).to(f)
    norm_d = torch.clamp(dens - 2.0, min=0.0) / (10.0 - 2.0)  # :581
    cap_sum = segment_sum(cap, rt.group_members)
    util = ((rt.dist_util + (rt.beta * norm_d).to(f))
            - rt.omega * cap / (cap_sum[:, rt.te_group] + 1e-6))
    z = exp_like_xla(-rt.temp * util)
    p_turn = z / segment_sum(z, rt.group_members)[:, rt.te_group]
    return p_turn * p_uo[..., rt.te_uo_idx]


def turning_fractions_step_plain(
    rt: RoutingTables,
    max_deg: int,
    density_for_routing: torch.Tensor,  # [B, E] link.get_density(t-1), f32
    recv_prev: torch.Tensor,  # [B, E] receiving_flow[t-2], -1 sentinel if unset
    cap_default: torch.Tensor,  # [B, E] back_gate * k_c * v_f * dt
    od_flow_t: torch.Tensor,  # [P] or [B, P] od flows at time t
) -> torch.Tensor:
    """Plain PyTorch version of :func:`turning_fractions_step`, on any
    device: :func:`_turn_contributions`, the phi segment sum and the row
    guard as eager ops, each segment sum one padded column at a time."""
    M = max_deg
    contrib = _turn_contributions(rt, density_for_routing, recv_prev, cap_default,
                                  od_flow_t)
    B = contrib.shape[0]
    phi = segment_sum(contrib, rt.phi_c_members).reshape(B, rt.num_routed, M, M)

    # row-normalization guard (check_fractions, path_finder.py:691-715);
    # XLA reduces the short slot axis left to right
    rowsum = seq_sum(phi, -1).unsqueeze(-1)
    need_fix = torch.abs(rowsum - 1.0) > 1e-3
    pos = rowsum > 1e-6
    phi_norm = phi / torch.where(pos, rowsum, 1.0)
    return torch.where(need_fix & pos, phi_norm,
                       torch.where(need_fix & ~pos, rt.offdiag_uniform, phi))


def turning_fractions_step(
    rt: RoutingTables,
    max_deg: int,
    density_for_routing: torch.Tensor,  # [B, E] link.get_density(t-1), f32
    recv_prev: torch.Tensor,  # [B, E] receiving_flow[t-2], -1 sentinel if unset
    cap_default: torch.Tensor,  # [B, E] back_gate * k_c * v_f * dt
    od_flow_t: torch.Tensor,  # [P] or [B, P] od flows at time t
) -> torch.Tensor:
    """Compact turning fractions ``phi_c[B, NR, M, M]`` of the routed
    nodes (``routed_ids``), after the row-normalization guard.

    The fast path of ``pednstream_tpu.routing.turning_fractions_step``
    (``exact=False, compact=True``), in the tables' flow dtype:
    P(down|up,od) by a logit over the candidate turns of each (node, od,
    up) group, times the od-flow share P(od|up), summed into phi slots
    (path_finder.py:561-715).
    The caller (``engine._node_solve``) re-solves just these rows; the
    other nodes keep ``phi_base``.

    On CUDA tensors this is one launch of the kernel of
    ``csrc/routing.cu`` (``ops.turning_fractions``); on CPU tensors it is
    :func:`turning_fractions_step_plain`.  Both give the same bits.  Any
    other device raises.
    """
    dev = density_for_routing.device.type
    if dev == "cuda":
        return turning_fractions(rt, max_deg, density_for_routing, recv_prev, cap_default,
                                 od_flow_t)
    if dev == "cpu":
        return turning_fractions_step_plain(rt, max_deg, density_for_routing, recv_prev,
                                            cap_default, od_flow_t)
    raise ValueError(f"turning_fractions_step has no kernel for device {dev!r}")


def turning_fractions_dense(
    rt: RoutingTables,
    phi_c: torch.Tensor,  # [B, NR, M, M] turning_fractions_step's rows
    phi_base: torch.Tensor,  # [N, M, M] or [B, N, M, M] in the flow dtype
) -> torch.Tensor:
    """Dense turning fractions ``phi[B, N, M, M]`` in the dtype of
    ``phi_base``: the exact path of ``pednstream_tpu.routing.
    turning_fractions_step`` (``exact=True``), which the exact-parity mode
    and the ``"optimal"`` solve take.

    The JAX exact path sums every phi slot and guards every node, then
    keeps ``phi_base`` wherever a node is not routed.  A routed node's rows
    are the compact ones (the same segment sums, the same guard with the
    node's own slots and arity, ``offdiag_uniform``), so the caller computes
    them with :func:`turning_fractions_step` and they are placed here at
    ``routed_ids``.  Every sum is added left to right in the reference's
    order on the exact-parity tables (``Q = 1``).
    """
    B, _, M, _ = phi_c.shape
    phi = phi_base.expand(B, phi_base.shape[-3], M, M).clone()
    phi[:, rt.routed_ids] = phi_c.to(phi_base.dtype)
    return phi
