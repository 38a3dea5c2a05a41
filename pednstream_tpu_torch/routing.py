"""Route choice: the host-side path enumeration and turn-table compiler.

The host half of ``pednstream_tpu/routing.py`` (:class:`PathSetBuilder`,
:func:`build_routing_tables`): its NumPy/networkx code, which the port
keeps a copy of because importing that package loads JAX.  What differs is
how the per-step segment sums are laid out: the JAX fast path sums with
static one-hot matrices (a matmul rides the TPU's MXU), which the GPU does
not need.  Here every segment -- a softmax group, an (up, od) mixing
group, a compact phi slot -- gets a static padded member table
``[segments, Q, L]`` (entry ids in ascending order, -1 padding,
:func:`_members`), whose rows ``Q`` fix the order of the sum: one
left-to-right row for the exact-parity path, and for the fast path the
lanes in which XLA's CPU GEMV adds the one-hot product (``GEMV_LANES``).

The per-step turning fractions that read these tables are the op
``ops.turning_fractions`` (``ops/routing.py``): its kernel, its plain
version and the kernel's own tables.
"""

from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

import networkx as nx
import numpy as np
import torch

from .device import DEFAULT, resolve
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

    num_groups: int
    num_uo_groups: int
    num_entries: int
    num_routed: int


# XLA's CPU backend, under the flags the JAX package's tests set (SSE4.2,
# no FMA), sums the fast path's one-hot products ``vals @ onehot`` as a
# row-major GEMV of 128-bit vectors: entry k of K adds into lane ``k % W``
# (W = 4 float32, 2 float64) while ``k < K - K % W``, each lane left to
# right from 0, the rest into a scalar epilogue; then the lanes pairwise,
# ``((l0 + l2) + (l1 + l3))``, and the epilogue last.  A fixed function of
# the entries' positions, so the member tables carry it.
GEMV_LANES = {torch.float32: 4, torch.float64: 2}


def _gemv_rows(K: int, lanes: int) -> np.ndarray:
    """The row of each of K ids in a member table: its GEMV lane, or
    ``lanes`` (the epilogue) from ``K - K % lanes`` on; row 0 with
    ``lanes == 0``."""
    if not lanes:
        return np.zeros(K, dtype=np.int64)
    tail = K - K % lanes
    return np.where(np.arange(K) < tail, np.arange(K) % lanes, lanes)


def _members(seg_ids: np.ndarray, num: int, lanes: int = 0) -> np.ndarray:
    """Padded member table ``[num, Q, L]``, -1 padding: with ``lanes == 0``
    one row per segment (``Q = 1``), its entries in ascending order, added
    left to right; else ``Q = lanes + 1`` rows, the entries of each GEMV
    lane and then of the epilogue, each in ascending order
    (``ops.routing.segment_sum`` combines them in XLA's order)."""
    row = _gemv_rows(len(seg_ids), lanes)
    Q = lanes + 1
    counts = np.zeros((num, Q), dtype=np.int64)
    np.add.at(counts, (seg_ids, row), 1)
    out = -np.ones((num, Q, max(int(counts.max(initial=0)), 1)), dtype=np.int64)
    fill = np.zeros((num, Q), dtype=np.int64)
    for i, (s, q) in enumerate(zip(seg_ids, row)):
        out[s, q, fill[s, q]] = i
        fill[s, q] += 1
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

    lanes = 0 if exact_parity else GEMV_LANES[ftype]
    members = (_members(te_group, G, lanes), _members(uo_group, UG, lanes),
               _members(te_phi_c, NR * M * M, lanes))
    te_uo_idx = np.array(te_uo_idx, dtype=np.int64)
    te_down_link = np.array(te_down_link, dtype=np.int64)
    uo_od = np.array(uo_od_l, dtype=np.int64)
    t = lambda a: torch.as_tensor(a, device=device)
    return RoutingTables(
        te_dist=t(te_dist),
        te_group=t(te_group),
        te_uo_idx=t(te_uo_idx),
        te_down_link=t(te_down_link),
        te_phi_idx=t(te_phi_idx),
        group_dist_sum=t(group_dist_sum),
        uo_od=t(uo_od),
        uo_group=t(uo_group),
        uo_group_count=t(uo_group_count),
        routed_mask=t(routed_mask),
        temp=float(builder.temp),
        alpha=float(builder.alpha),
        beta=float(builder.beta),
        omega=float(builder.omega),
        routed_ids=t(routed_ids),
        group_members=t(members[0]),
        uo_group_members=t(members[1]),
        te_phi_c=t(te_phi_c),
        phi_c_members=t(members[2]),
        dist_util=t(dist_util),
        uo_inv_count=t(uo_inv_count),
        offdiag_uniform=t(offdiag_uniform),
        num_groups=G,
        num_uo_groups=UG,
        num_entries=len(te_rows),
        num_routed=NR,
    )
