"""The routed turning fractions of a step (the counterpart of the XLA-fused
``pednstream_tpu/routing.py:405-515``).

:func:`turning_fractions` computes the compact turning fractions of the
routed nodes: the logit turn shares, the od-flow shares, the phi segment
sums and the row guard.  On CUDA tensors it launches the hand-written
kernels of ``csrc/routing.cu``; on CPU tensors it runs
:func:`turning_fractions_step_plain`, their plain PyTorch version.  Both
add the same members in the same order and give the same bits.

Every segment -- a softmax group, an (up, od) mixing group, a compact phi
slot -- is summed through the static padded member tables ``[segments, Q,
L]`` of ``RoutingTables`` (``routing._members``), which :func:`segment_sum`
walks in one padded loop over ``L``.  The rows ``Q`` fix the order: one
left-to-right row for the exact-parity path, and for the fast path the
lanes in which XLA's CPU GEMV adds the JAX package's one-hot products, so
the sum is the JAX package's bit for bit (at one replica;
``routing.GEMV_LANES``).  The order is static, so the sum is deterministic
on the GPU, where ``index_add_``/``scatter_add_`` use float atomics whose
order changes from run to run.

Two designs of the kernel compute it, and the batch alone picks one: from
``LANE_TILE`` replicas (a warp) on the streamed design, a block per (routed
node's up slot, 32 replicas) and a replica a lane, its warps sharing the
unit's softmax groups out chunk by chunk (:func:`lane_warps` sets how many
from the batch and the tables), after a copy of per-replica od flows to a
``[P, B]`` buffer; below it the walk, a block per (routed node, replica).
Each has a float32 and a float64 instantiation,
picked by the tables' flow dtype.  The kernels read the scenario's
:class:`RoutingKernelTables`, built with it: each routed node's ranges of
the routing tables for the walk, and the codes by which the streamed
design adds the entries in ascending id.
"""

import ctypes
import functools
from typing import List

import numpy as np
import torch

from ..routing import RoutingTables, _gemv_rows
from ._build import launch, library

_ENTRY = {torch.float32: "routing_turning_fractions",
          torch.float64: "routing_turning_fractions_f64"}
# the walk's blocks: threads each, and the shared memory one may take
THREADS = 128
MAX_SHARED_BYTES = 232448
# the streamed design's replicas a block, a replica a lane; it runs from
# this many replicas on, where every lane of the first warp holds one
LANE_TILE = 32
# the most entries a chunk of a unit's groups holds (one entry code a lane)
LANE_CHUNK = 32
# the streamed design's warps a block: at most its kernel's launch bounds
# allow, and at least enough that an SM's 32 blocks hold more warps than
# one-warp blocks would, where a unit has the groups to share out
LANE_WARPS_MAX, LANE_WARPS_MIN = 8, 2
# warps of the streamed kernel an SM holds (at its 48 registers a thread)
WARPS_PER_SM = 40


# --------------------------------------------------------------------------
# The plain version
# --------------------------------------------------------------------------

def segment_sum(vals: torch.Tensor, members: torch.Tensor) -> torch.Tensor:
    """``out[..., s]`` = the sum of ``vals[..., members[s]]`` over the valid
    members of a ``[S, Q, L]`` table (``routing._members``): each of the Q
    rows added left to right in one padded walk over L, then the rows
    combined in XLA's GEMV order (``Q = 1``: the row itself)."""
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
    scn,
    density_for_routing: torch.Tensor,  # [B, E] link.get_density(t-1), f32
    recv_prev: torch.Tensor,  # [B, E] receiving_flow[t-2], -1 sentinel if unset
    cap_default: torch.Tensor,  # [B, E] back_gate * k_c * v_f * dt
    od_flow_t: torch.Tensor,  # [P] or [B, P] od flows at time t
) -> torch.Tensor:
    """Plain PyTorch version of :func:`turning_fractions`, on any device:
    :func:`_turn_contributions`, the phi segment sum and the row guard as
    eager ops, each segment sum one padded column at a time."""
    rt, M = scn.routing, scn.max_deg
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


def turning_fractions_dense(
    rt: RoutingTables,
    phi_c: torch.Tensor,  # [B, NR, M, M] turning_fractions' rows
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
    them with :func:`turning_fractions` and they are placed here at
    ``routed_ids``.  Every sum is added left to right in the reference's
    order on the exact-parity tables (``Q = 1``).
    """
    B, _, M, _ = phi_c.shape
    phi = phi_base.expand(B, phi_base.shape[-3], M, M).clone()
    phi[:, rt.routed_ids] = phi_c.to(phi_base.dtype)
    return phi


# --------------------------------------------------------------------------
# The kernel's tables
# --------------------------------------------------------------------------

# the ranges of ``RoutingKernelTables.node_offsets``' columns
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


def _short_rows(members: np.ndarray) -> np.ndarray:
    """``[S]`` bit q set where row q of a member table holds fewer members
    than the table's width: the rows whose walk adds +0.0 once more."""
    short = (members >= 0).sum(-1) < members.shape[-1]
    return (short << np.arange(members.shape[1])).sum(-1).astype(np.int32)


def _sum_plan(rows, short: int, Q: int):
    """How a segment of at most four members, member i in GEMV row
    ``rows[i]`` (ascending id), sums to the bits of its Q row accumulators
    combined in XLA's order with +0.0 on its short rows (the kernel's
    ``rows_sum``): a tree over the members alone, as ``a``, ``a + b``,
    ``(a + b) + c``, ``((a + b) + c) + d`` or (``balanced``) ``(a + b) +
    (c + d)``, each addition commutative, then ``+0.0`` where a row is
    short (``zfix``), else ``-0.0``.  An empty row adds -0.0 to what it
    meets, which changes nothing; a +0.0 anywhere changes only a -0.0 sum,
    into +0.0, which the final ``+0.0`` does.  Returns the members in the
    order the tree takes them, ``balanced`` and ``zfix``."""
    rows_of = [None] * Q
    for i, q in enumerate(rows):
        rows_of[q] = i if rows_of[q] is None else (rows_of[q], i)

    def add(x, y):
        return y if x is None else x if y is None else (x, y)

    def leaves(t):
        return [t] if isinstance(t, int) else leaves(t[0]) + leaves(t[1])

    def chain(t):  # up to three leaves as (a + b) + c
        if isinstance(t, int) or len(leaves(t)) == 2:
            return leaves(t)
        pair, one = (t[1], t[0]) if isinstance(t[0], int) else t
        return leaves(pair) + [one]

    r = rows_of
    tree = (add(add(add(r[0], r[2]), add(r[1], r[3])), r[4]) if Q == 5
            else add(add(r[0], r[1]), r[2]) if Q == 3 else r[0])
    if len(rows) < 4:
        return chain(tree), False, short != 0
    if len(leaves(tree[0])) == 2:
        return leaves(tree[0]) + leaves(tree[1]), True, short != 0
    three, one = tree if len(leaves(tree[0])) == 3 else tree[::-1]
    return chain(three) + [one], False, short != 0


def _lane_tables(te_phi_c, te_group, te_uo_idx, te_down_link, uo_od, uo_group, node_offsets,
                 members, M, lanes) -> dict:
    """The codes by which ``csrc/routing.cu``'s streamed kernel adds the
    entries in ascending id into per-(segment, GEMV row) accumulators, the
    order of the member tables ``members`` (the group, uo group and phi
    tables).

    Its unit of work is a routed node's up slot: a softmax group (node,
    od, up), a (node, up) group and a phi row all lie in one, and so does
    the guard's row.  The tables list the entries and the groups unit by
    unit, each in ascending id; a group's entries then lie together (they
    share a (node, od) run, which holds no other entry of the unit).  The
    build numbers softmax groups and uo entries alike, by first appearance,
    so ``te_group == te_uo_idx`` (checked).  Per entry: its down slot and
    GEMV row, in bits 0-4 and 5-7.  Per group: its od pair; its entries,
    its uo entry's GEMV row and its short rows (``_short_rows``) in bits
    0-7, 8-10 and 11-15, and where it has at most four entries the plan of
    its sums (:func:`_sum_plan`: ``balanced`` and ``zfix``) in bits 16 and
    17; its first entry, counted from its unit's first; where it has at
    most four entries, a byte each from bit 0 in the order its sums take
    them, each entry's down slot and its place in the group in bits 0-4
    and 5-6 (else 0: the kernel reads the entries' codes from their table
    and keeps accumulators).  Per unit: its first group and first entry,
    and its (node, up) group (-1 where the slot has no entry)."""
    K, G = len(te_group), len(uo_od)
    NR, MM = len(node_offsets) - 1, M * M
    if not np.array_equal(te_group, te_uo_idx):
        raise AssertionError("softmax groups and uo entries are numbered apart")
    if M > 32:
        raise AssertionError(f"max_deg {M}: the codes hold slots of at most 32")
    node = np.repeat(np.arange(NR), np.diff(node_offsets[:, 0]))
    slot = te_phi_c % MM
    unit = node * M + slot // M
    by_unit = np.argsort(unit, kind="stable")
    count = np.bincount(te_group, minlength=G)
    group_unit = np.zeros(G, dtype=np.int64)
    group_unit[te_group] = unit
    groups = np.argsort(group_unit, kind="stable")
    if (np.any(group_unit[te_group] != unit)
            or not np.array_equal(te_group[by_unit], np.repeat(groups, count[groups]))):
        raise AssertionError("a softmax group's entries do not lie together in its up slot")
    units = np.arange(NR * M + 1)
    first_g = np.searchsorted(group_unit[groups], units)
    first_k = np.searchsorted(unit[by_unit], units)
    ug = np.where(first_g[:-1] < first_g[1:], uo_group[groups[np.minimum(first_g[:-1], G - 1)]],
                  -1)
    down = -np.ones((NR, M), dtype=np.int64)
    down[node, slot % M] = te_down_link
    if np.any(down[node, slot % M] != te_down_link):
        raise AssertionError("a down slot of a routed node names two links")
    short = _short_rows(members[0]).astype(np.int64)[groups]
    code = (count | _gemv_rows(G, lanes) << 8)[groups] | short << 11
    entry_d, entry_row = (slot % M)[by_unit], _gemv_rows(K, lanes)[by_unit]
    n = count[groups]
    start = np.cumsum(n) - n
    packed = np.zeros(G, dtype=np.int64)
    plans = {}
    for i in np.flatnonzero(n <= 4):
        s = start[i]
        key = (tuple(entry_row[s:s + n[i]].tolist()), int(short[i]))
        if key not in plans:
            plans[key] = _sum_plan(*key, lanes + 1)
        order, balanced, zfix = plans[key]
        packed[i] = sum((int(entry_d[s + j]) | j << 5) << 8 * k for k, j in enumerate(order))
        code[i] |= balanced << 16 | zfix << 17
    return dict(
        lane_entry=(entry_d | entry_row << 5).astype(np.int32),
        lane_group=np.stack([uo_od[groups], code, start - first_k[group_unit[groups]],
                             packed.astype(np.uint32).view(np.int32)], 1).astype(np.int32),
        lane_unit=np.stack([first_g, first_k, np.r_[ug, -1]], 1).astype(np.int32),
        lane_order=np.argsort(-np.diff(first_k), kind="stable").astype(np.int32),
        lane_down_link=down.astype(np.int32),
        lane_uo_short=_short_rows(members[1]), lane_phi_short=_short_rows(members[2]),
        by_unit=by_unit, group_max=int(count.max(initial=0)),
        unit_groups=int(np.diff(first_g).max(initial=0)))


class KernelArgs(ctypes.Structure):
    """The C entry points' argument block (``RoutingArgs`` in
    ``csrc/routing.cu``): every field 8 bytes wide, so the layout has no
    padding on either side."""

    _fields_ = [(name, ctypes.c_void_p if kind == "p" else
                 ctypes.c_double if kind == "d" else ctypes.c_longlong)
                for name, kind in (
                    ("density", "p"), ("density_sb", "i"), ("density_se", "i"),
                    ("recv_prev", "p"), ("recv_prev_sb", "i"), ("recv_prev_se", "i"),
                    ("cap_default", "p"), ("cap_default_sb", "i"), ("cap_default_se", "i"),
                    ("od_flow", "p"), ("od_flow_sb", "i"), ("od_flow_sp", "i"),
                    ("te_down_link", "p"), ("te_group", "p"), ("te_uo_idx", "p"),
                    ("dist_util", "p"), ("uo_od", "p"), ("uo_group", "p"),
                    ("uo_inv_count", "p"), ("group_members", "p"),
                    ("uo_group_members", "p"), ("phi_c_members", "p"),
                    ("node_offsets", "p"), ("offdiag_uniform", "p"), ("out", "p"),
                    ("B", "i"), ("NR", "i"), ("M", "i"), ("Q", "i"),
                    ("Lg", "i"), ("Lu", "i"), ("Lp", "i"),
                    ("max_entries", "i"), ("max_groups", "i"), ("max_uo_entries", "i"),
                    ("max_uo_groups", "i"), ("threads", "i"), ("shared_bytes", "i"),
                    ("beta", "d"), ("neg_temp", "d"), ("omega", "d"),
                    ("lanes", "i"), ("lane_entry", "p"), ("lane_group", "p"),
                    ("lane_unit", "p"), ("lane_order", "p"), ("lane_down_link", "p"),
                    ("lane_uo_short", "p"), ("lane_phi_short", "p"),
                    ("lane_dist_util", "p"), ("P", "i"), ("od_by_pair", "p"))]


# the routing tables the kernels read, and the kernel tables
_ROUTING_TABLES = ("te_down_link", "te_group", "te_uo_idx", "dist_util", "uo_od", "uo_group",
                   "uo_inv_count", "group_members", "uo_group_members", "phi_c_members",
                   "offdiag_uniform")
_LANE_TABLES = ("lane_entry", "lane_group", "lane_unit", "lane_order", "lane_down_link",
                "lane_uo_short", "lane_phi_short", "lane_dist_util")


class RoutingKernelTables:
    """The tables the routing kernels read beside the ``RoutingTables``
    ``rt`` of nodes with ``max_deg`` slots, built from its host arrays on
    its device:

    - ``node_offsets`` ``[NR + 1, 4]`` int64: each routed node's first turn
      entry, softmax group, uo entry and (node, up) group (``NODE_TABLES``
      order; row NR holds the totals), so that the walk's block for a node
      reads only its own ranges; ``node_max`` the most of each range a
      node holds;
    - the streamed design's codes (:func:`_lane_tables`), int32, entries
      and groups listed by unit, a routed node's up slot: ``lane_entry
      [K]`` (down slot, GEMV row), ``lane_group [G, 4]`` (od pair; entries,
      uo row, short rows; first entry in the unit; entry codes of a group
      of at most four), ``lane_unit [NR*M + 1, 3]`` (first
      group, first entry, (node, up) group), ``lane_order [NR*M]`` (units,
      most entries first), ``lane_down_link [NR, M]`` (down link of each
      down slot, -1 none), ``lane_uo_short [UG]`` and ``lane_phi_short
      [NR*M*M]`` (rows short of the table's width, a bit a row);
      ``lane_dist_util [K]``, ``dist_util`` by unit in the flow dtype;
      ``group_max``, the most entries a softmax group holds, and
      ``unit_groups``, the most groups a unit holds;
    - ``args``, the kernels' argument block with every field that follows
      from the tables filled in, and ``rows_shared_bytes``, the shared
      memory of a block of the walk.

    The tables are checked as they are built; tables the kernels cannot
    take raise."""

    def __init__(self, rt: RoutingTables, max_deg: int):
        def host(x):
            return x.cpu().numpy()

        f, dev = rt.dist_util.dtype, rt.dist_util.device
        if f not in _ENTRY:
            raise TypeError(f"the routing tables are {f}, expected float32 or float64")
        Q = rt.group_members.shape[1]
        if (Q not in (1, 3, 5)
                or {rt.uo_group_members.shape[1], rt.phi_c_members.shape[1]} != {Q}):
            raise ValueError(f"member tables with {Q} rows per segment: the kernel sums 1, "
                             f"3 or 5 (float64 or float32 GEMV lanes)")
        M, NR = max_deg, rt.num_routed
        te_group, te_uo_idx, te_phi_c, uo_group = (
            host(x) for x in (rt.te_group, rt.te_uo_idx, rt.te_phi_c, rt.uo_group))
        te_node = te_phi_c // (M * M)
        uo_node = np.zeros(rt.uo_od.numel(), dtype=np.int64)
        uo_node[te_uo_idx] = te_node
        group_node = np.zeros(rt.num_groups, dtype=np.int64)
        group_node[te_group] = te_node
        uo_group_node = np.zeros(rt.num_uo_groups, dtype=np.int64)
        uo_group_node[uo_group] = uo_node
        node_offsets = _node_offsets([te_node, group_node, uo_node, uo_group_node], NR)
        members = tuple(host(x) for x in (rt.group_members, rt.uo_group_members,
                                           rt.phi_c_members))
        lane = _lane_tables(te_phi_c, te_group, te_uo_idx, host(rt.te_down_link),
                            host(rt.uo_od), uo_group, node_offsets, members, M, Q - 1)

        self.routing = rt  # the argument block points into its tensors
        self.max_deg, self.num_routed, self.rows = M, NR, Q
        self.dtype, self.device = f, dev
        self.node_offsets = torch.as_tensor(node_offsets, device=dev)
        self.node_max = tuple(int(x) for x in np.diff(node_offsets, axis=0).max(axis=0))
        self.group_max, self.unit_groups = lane.pop("group_max"), lane.pop("unit_groups")
        if self.group_max > LANE_CHUNK:
            raise AssertionError(f"a softmax group of {self.group_max} entries: a chunk of the "
                                 f"streamed design holds {LANE_CHUNK}")
        lane["lane_dist_util"] = host(rt.dist_util)[lane.pop("by_unit")]
        for name, x in lane.items():
            setattr(self, name, torch.as_tensor(x, device=dev))

        a = KernelArgs()
        for owner, names in ((rt, _ROUTING_TABLES), (self, ("node_offsets",) + _LANE_TABLES)):
            for name in names:
                x = getattr(owner, name)
                if x.device != dev:
                    raise ValueError(f"routing table {name} is on {x.device}, dist_util on "
                                     f"{dev}")
                if not x.is_contiguous():
                    raise ValueError(f"routing table {name} is not contiguous")
                want = (f if x.is_floating_point() else torch.int32 if name in _LANE_TABLES
                        else torch.int64)
                if x.dtype != want:
                    raise TypeError(f"routing table {name} is {x.dtype}, expected {want}")
                setattr(a, name, x.data_ptr())
        a.NR, a.M, a.Q, a.threads = NR, M, Q, THREADS
        a.Lg, a.Lu, a.Lp = (x.shape[2] for x in (rt.group_members, rt.uo_group_members,
                                                  rt.phi_c_members))
        a.max_entries, a.max_groups, a.max_uo_entries, a.max_uo_groups = self.node_max
        a.beta, a.neg_temp, a.omega = rt.beta, -rt.temp, rt.omega
        self.args = a
        self.rows_shared_bytes = shared_bytes(self)


# --------------------------------------------------------------------------
# The kernel
# --------------------------------------------------------------------------

def shared_bytes(tabs: RoutingKernelTables) -> int:
    """Shared memory of one block of the walk: a node's uo entries (w, then
    P(od|up)), (node, up) sums, turn entries twice (capacity, then the
    contribution; the utility term, then exp), softmax-group sums, its M x
    M phi slots and one partial sum per (segment, lane) of the widest
    walk."""
    entries, groups, uo_entries, uo_groups = tabs.node_max
    MM = tabs.max_deg * tabs.max_deg
    words = (uo_entries + uo_groups + 2 * entries + groups + MM
             + tabs.rows * max(groups, uo_groups, MM))
    return words * tabs.lane_dist_util.element_size()


def lane_bytes(tabs: RoutingKernelTables) -> int:
    """Shared memory of a block of the streamed design, whatever its warps:
    per replica its down slots' capacity and density terms, its phi row's
    accumulators ``[M, Q]``, the (node, up) sum's Q rows and a chunk's
    ``LANE_CHUNK`` contributions."""
    words = tabs.max_deg * (2 + tabs.rows) + tabs.rows + LANE_CHUNK
    return LANE_TILE * words * tabs.lane_dist_util.element_size()


def lane_warps(tabs: RoutingKernelTables, batch: int, device) -> int:
    """Warps a unit (a routed node's up slot) of the streamed design gets
    for 32 replicas, a power of two: ``LANE_WARPS_MIN``, or more where the
    units and replica tiles alone leave the card short of ``WARPS_PER_SM``
    warps an SM; at most ``LANE_WARPS_MAX`` and the most groups a unit
    holds (the warps share its groups out)."""
    units = tabs.num_routed * tabs.max_deg * -(-batch // LANE_TILE)
    want = max(LANE_WARPS_MIN, _sm_count(device) * WARPS_PER_SM / units)
    most = min(LANE_WARPS_MAX, tabs.unit_groups)
    warps = 1
    while warps < want and 2 * warps <= most:
        warps *= 2
    return warps


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _geometry(tabs: RoutingKernelTables, B: int, device):
    """The design a batch of ``B`` takes and its block: ``(warps, shared
    bytes)``, warps 0 for the walk.  The streamed design from a warp of
    replicas on (where its block fits), else the walk."""
    warps = lane_warps(tabs, B, device) if B >= LANE_TILE else 0
    if warps and lane_bytes(tabs) <= MAX_SHARED_BYTES:
        return warps, lane_bytes(tabs)
    return 0, tabs.rows_shared_bytes


def lane_occupancy(tabs: RoutingKernelTables, batch: int, device) -> dict:
    """The streamed kernel at the block ``batch`` replicas give it on the
    CUDA ``device`` (``lane_warps``, ``lane_bytes``): its registers a
    thread, its local (spilled) bytes a thread, the blocks and warps an SM
    holds, as the CUDA runtime reports them for the built kernel."""
    warps, smem = _geometry(tabs, batch, device)
    if not warps:
        raise ValueError(f"B={batch} takes the walk, not the streamed design")
    args = KernelArgs.from_buffer_copy(tabs.args)
    args.lanes, args.shared_bytes = warps, smem
    out = (ctypes.c_int * 3)()
    entry = _ENTRY[tabs.dtype].replace("turning_fractions", "lanes_occupancy")
    with torch.cuda.device(device):
        err = getattr(library(), entry)(ctypes.addressof(args), ctypes.addressof(out), None)
    if err:
        raise RuntimeError(f"{entry} failed: CUDA error {err}")
    return {"warps": warps, "shared_bytes": smem, "registers": out[0], "local_bytes": out[1],
            "blocks_per_sm": out[2], "warps_per_sm": out[2] * warps}


def _launch(tabs: RoutingKernelTables, density, recv_prev, cap_default, od_flow_t):
    dev, f = density.device, tabs.dtype
    if tabs.device != dev:
        raise ValueError(f"the routing tables are on {tabs.device}, the operands on {dev}")
    if density.dim() != 2:
        raise ValueError(f"density_for_routing has shape {tuple(density.shape)}, "
                         f"expected [B, E]")
    B, E = density.shape
    warps, smem = _geometry(tabs, B, dev)
    lanes = warps > 0
    if smem > MAX_SHARED_BYTES:
        raise ValueError(f"a routed node needs {smem} B of shared memory, more than a "
                         f"block may take ({MAX_SHARED_BYTES})")
    if not lanes and B > 65535:
        raise ValueError(f"B={B} replicas: the walk's grid takes at most 65535")
    # the plain version casts these first (density to float32, the rest to
    # the flow dtype)
    if density.dtype != torch.float32:
        density = density.to(torch.float32)
    recv_prev, cap_default, od_flow_t = (x if x.dtype == f else x.to(f)
                                         for x in (recv_prev, cap_default, od_flow_t))
    if od_flow_t.dim() not in (1, 2) or (od_flow_t.dim() == 2 and od_flow_t.shape[0] != B):
        raise ValueError(f"od_flow_t has shape {tuple(od_flow_t.shape)}, expected [P] "
                         f"or [{B}, P]")
    if od_flow_t.device != dev:
        raise ValueError(f"od_flow_t is on {od_flow_t.device}, the tables on {dev}")

    M = tabs.max_deg
    out = torch.empty((B, tabs.num_routed, M, M), dtype=f, device=dev)
    if B == 0:
        return out
    args = KernelArgs.from_buffer_copy(tabs.args)
    for name, x in (("density", density), ("recv_prev", recv_prev),
                    ("cap_default", cap_default)):
        if x.device != dev or tuple(x.shape) != (B, E):
            raise ValueError(f"{name} is {tuple(x.shape)} on {x.device}, expected "
                             f"({B}, {E}) on {dev}")
        setattr(args, name, x.data_ptr())
        setattr(args, name + "_sb", x.stride(0))
        setattr(args, name + "_se", x.stride(1))
    args.od_flow, args.P = od_flow_t.data_ptr(), od_flow_t.shape[-1]
    args.od_flow_sb, args.od_flow_sp = ((0, od_flow_t.stride(0)) if od_flow_t.dim() == 1
                                        else od_flow_t.stride())
    args.out, args.B, args.shared_bytes, args.lanes = out.data_ptr(), B, smem, warps
    # the streamed design reads per-replica od flows from a [P, B] copy
    od_by_pair = (torch.empty((args.P, B), dtype=f, device=dev)
                  if lanes and od_flow_t.dim() == 2 else None)
    if od_by_pair is not None:
        args.od_by_pair = od_by_pair.data_ptr()
    counts = [(turning_fractions.launches, str(f).removeprefix("torch.")),
              (turning_fractions.launches_by_design, "lanes" if lanes else "rows")]
    if lanes:
        counts.append((turning_fractions.launches_by_warps, warps))
    launch("turning_fractions", _ENTRY[f], dev, ctypes.addressof(args), counts=counts)
    return out


def turning_fractions(
    scn,
    density_for_routing: torch.Tensor,  # [B, E] link.get_density(t-1), f32
    recv_prev: torch.Tensor,  # [B, E] receiving_flow[t-2], -1 sentinel if unset
    cap_default: torch.Tensor,  # [B, E] back_gate * k_c * v_f * dt
    od_flow_t: torch.Tensor,  # [P] or [B, P] od flows at time t
) -> torch.Tensor:
    """Compact turning fractions ``phi_c [B, NR, M, M]`` of the routed nodes
    (``routed_ids``) of the scenario ``scn``, after the row-normalization
    guard, in the flow dtype of its routing tables.

    The fast path of ``pednstream_tpu.routing.turning_fractions_step``
    (``exact=False, compact=True``): P(down|up,od) by a logit over the
    candidate turns of each (node, od, up) group, times the od-flow share
    P(od|up), summed into phi slots (path_finder.py:561-715).  The caller
    (the engine's node solve) re-solves just these rows; the other nodes
    keep ``phi_base``.

    On CUDA tensors this launches the kernels of ``csrc/routing.cu`` for the
    tables' dtype (built at first use) on the current stream, on the
    scenario's :class:`RoutingKernelTables`: one launch, and one more that
    copies per-replica od flows for the streamed design.  From
    ``LANE_TILE`` replicas on it runs the streamed design with
    ``lane_warps`` warps a unit, below it the walk (also where a block of
    the streamed design would not fit).  A call is counted once in
    ``turning_fractions.launches`` under the dtype's name, once in
    ``turning_fractions.launches_by_design`` under the design's,
    ``"lanes"`` or ``"rows"``, and a streamed call once in
    ``turning_fractions.launches_by_warps`` under its warps a block; a
    failed launch raises.  ``density_for_
    routing``, ``recv_prev`` and ``cap_default`` may have any strides on
    the card.  On CPU tensors it runs :func:`turning_fractions_step_plain`.
    Both give the same bits.  Any other device raises.
    """
    dev = density_for_routing.device.type
    if dev == "cuda":
        return _launch(scn.routing_kernel_tables, density_for_routing, recv_prev, cap_default,
                       od_flow_t)
    if dev == "cpu":
        return turning_fractions_step_plain(scn, density_for_routing, recv_prev, cap_default,
                                            od_flow_t)
    raise ValueError(f"turning_fractions has no kernel for device {dev!r}")


# calls per flow dtype, per design: the streamed one ("lanes") or the walk
# ("rows"), and the streamed calls per warps a block
turning_fractions.launches = {"float32": 0, "float64": 0}
turning_fractions.launches_by_design = {"lanes": 0, "rows": 0}
turning_fractions.launches_by_warps = {1: 0, 2: 0, 4: 0, 8: 0}
