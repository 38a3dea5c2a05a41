"""The routed turning fractions in one kernel launch (the counterpart of
the XLA-fused ``pednstream_tpu/routing.py:405-515``).

:func:`turning_fractions` computes what
``routing.turning_fractions_step_plain`` computes -- the logit turn
shares, the od-flow shares, the phi segment sums and the row guard, every
sum in the member tables' order -- with the hand-written CUDA kernels of
``csrc/routing.cu``.  It takes CUDA tensors only;
``routing.turning_fractions_step`` dispatches, to it on the card and to
the plain version on the CPU.  Two designs compute it, and the batch
alone picks one: from ``LANE_TILE`` replicas (a warp) on the streamed
design, a block per (routed node's up slot, 32 replicas) and a replica a
lane, after a copy of per-replica od flows to a ``[P, B]`` buffer; below
it the walk, a block per (routed node, replica).  Each has a float32 and a float64
instantiation, picked by the tables' flow dtype; all agree with the plain
version bit for bit.
"""

import ctypes
import functools
import threading

import torch

_ENTRY = {torch.float32: "routing_turning_fractions",
          torch.float64: "routing_turning_fractions_f64"}
_COUNT_LOCK = threading.Lock()
# the walk's blocks: threads each, and the shared memory one may take
THREADS = 128
MAX_SHARED_BYTES = 232448
# the streamed design's replicas a block, a replica a lane; it runs from
# this many replicas on, where every lane of the first warp holds one
LANE_TILE = 32
# warps of the streamed kernel an SM holds (at its 58-64 registers a thread)
WARPS_PER_SM = 32


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
                    ("lane_dist_util", "p"), ("group_max", "i"), ("P", "i"),
                    ("od_by_pair", "p"))]

_TABLES = ("te_down_link", "te_group", "te_uo_idx", "dist_util", "uo_od", "uo_group",
           "uo_inv_count", "group_members", "uo_group_members", "phi_c_members",
           "node_offsets", "offdiag_uniform")
_LANE_TABLES = ("lane_entry", "lane_group", "lane_unit", "lane_order", "lane_down_link",
                "lane_uo_short", "lane_phi_short", "lane_dist_util")


def shared_bytes(rt, max_deg: int) -> int:
    """Shared memory of one block of the walk: a node's uo entries (w, then
    P(od|up)), (node, up) sums, turn entries twice (capacity, then the
    contribution; the utility term, then exp), softmax-group sums, its M x
    M phi slots and one partial sum per (segment, lane) of the widest
    walk."""
    entries, groups, uo_entries, uo_groups = rt.node_max
    Q = rt.group_members.shape[1]
    MM = max_deg * max_deg
    words = (uo_entries + uo_groups + 2 * entries + groups + MM
             + Q * max(groups, uo_groups, MM))
    return words * rt.dist_util.element_size()


def lane_bytes(rt, max_deg: int, warps: int = 1) -> int:
    """Shared memory of a block of the streamed design with ``warps`` warps:
    per replica its down slots' capacity and density terms, its phi row's
    accumulators ``[M, Q]`` and each warp's z of a softmax group."""
    Q = rt.group_members.shape[1]
    words = max_deg * (2 + Q) + warps * rt.group_max
    return LANE_TILE * words * rt.dist_util.element_size()


def lane_warps(rt, max_deg: int, batch: int, device) -> int:
    """Warps a unit (a routed node's up slot) of the streamed design gets
    for 32 replicas: 1 where the units and replica tiles alone give the
    card its warps, else the power of two that does, up to the unit's phi
    accumulators (a warp owns some), the heaviest unit's entries and 32."""
    units = rt.num_routed * max_deg * -(-batch // LANE_TILE)
    want = _sm_count(device) * WARPS_PER_SM / units
    most = min(32, max_deg * rt.group_members.shape[1], rt.unit_max)
    warps = 1
    while warps < want and 2 * warps <= most:
        warps *= 2
    return warps


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _fixed_fields(rt, max_deg: int):
    """The argument block's fields that follow from the tables ``rt`` and
    ``max_deg`` alone, and the shared memory of a block of each design;
    the tables are checked first.  Made at the first call on ``rt`` and
    kept with it (routing tables are built whole and not changed after)."""
    kept = rt.__dict__.get("_kernel_fields")
    if kept is not None and kept[0] == max_deg:
        return kept[1]
    f, dev = rt.dist_util.dtype, rt.dist_util.device
    if f not in _ENTRY:
        raise TypeError(f"the routing tables are {f}, expected float32 or float64")
    Q = rt.group_members.shape[1]
    if Q not in (1, 3, 5) or {rt.uo_group_members.shape[1], rt.phi_c_members.shape[1]} != {Q}:
        raise ValueError(f"member tables with {Q} rows per segment: the kernel sums 1, "
                         f"3 or 5 (float64 or float32 GEMV lanes)")
    fields = KernelArgs()
    for name in _TABLES + _LANE_TABLES:
        x = getattr(rt, name)
        if x.device != dev:
            raise ValueError(f"routing table {name} is on {x.device}, dist_util on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"routing table {name} is not contiguous")
        want = (f if x.is_floating_point() else torch.int32 if name in _LANE_TABLES
                else torch.int64)
        if x.dtype != want:
            raise TypeError(f"routing table {name} is {x.dtype}, expected {want}")
        setattr(fields, name, x.data_ptr())
    (fields.NR, fields.M, fields.Q, fields.Lg, fields.Lu, fields.Lp, fields.threads,
     fields.group_max) = (rt.num_routed, max_deg, Q, rt.group_members.shape[2],
                          rt.uo_group_members.shape[2], rt.phi_c_members.shape[2], THREADS,
                          rt.group_max)
    (fields.max_entries, fields.max_groups, fields.max_uo_entries,
     fields.max_uo_groups) = rt.node_max
    fields.beta, fields.neg_temp, fields.omega = rt.beta, -rt.temp, rt.omega
    kept = fields, shared_bytes(rt, max_deg)
    rt.__dict__["_kernel_fields"] = (max_deg, kept)
    return kept


def turning_fractions(rt, max_deg: int, density_for_routing, recv_prev, cap_default,
                      od_flow_t):
    """Compact turning fractions ``phi_c [B, NR, M, M]`` in the flow dtype
    of the ``RoutingTables`` ``rt``, as ``routing.
    turning_fractions_step_plain`` defines them, with the kernels of
    ``csrc/routing.cu`` for the tables' dtype (built at first use) on the
    current stream: one launch, and one more that copies per-replica od
    flows for the streamed design.

    ``density_for_routing``, ``recv_prev`` and ``cap_default`` are ``[B,
    E]`` CUDA tensors (any strides), ``od_flow_t`` is ``[P]`` shared by the
    replicas or ``[B, P]``; the tables lie on the operands' device.  From
    ``LANE_TILE`` replicas on it runs the streamed design with
    ``lane_warps`` warps a unit, below it the walk (also where a block of
    the streamed design would not fit).
    A call is counted once in ``turning_fractions.launches`` under the
    dtype's name and once in ``turning_fractions.launches_by_design`` under
    the design's, ``"lanes"`` or ``"rows"``; a failed launch raises, and so
    does a tensor off the card.
    """
    from ._build import library

    density = density_for_routing
    dev = density.device
    if dev.type != "cuda":
        raise ValueError(f"turning_fractions runs on CUDA tensors, not {dev.type!r} ones "
                         f"(routing.turning_fractions_step runs the plain version there)")
    fixed, rows_smem = _fixed_fields(rt, max_deg)
    f = rt.dist_util.dtype
    if rt.dist_util.device != dev:
        raise ValueError(f"the routing tables are on {rt.dist_util.device}, the operands "
                         f"on {dev}")
    if density.dim() != 2:
        raise ValueError(f"density_for_routing has shape {tuple(density.shape)}, "
                         f"expected [B, E]")
    B, E = density.shape
    # the design, by the batch: the streamed one from a warp of replicas on
    # (where its block fits), else the walk
    warps = lane_warps(rt, max_deg, B, dev) if B >= LANE_TILE else 0
    smem = lane_bytes(rt, max_deg, warps)
    lanes = warps > 0 and smem <= MAX_SHARED_BYTES
    if not lanes:
        smem = rows_smem
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

    out = torch.empty((B, rt.num_routed, max_deg, max_deg), dtype=f, device=dev)
    if B == 0:
        return out
    args = KernelArgs.from_buffer_copy(fixed)
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
    args.out, args.B, args.shared_bytes = out.data_ptr(), B, smem
    args.lanes = warps if lanes else 0
    # the streamed design reads per-replica od flows from a [P, B] copy
    od_by_pair = (torch.empty((args.P, B), dtype=f, device=dev)
                  if lanes and od_flow_t.dim() == 2 else None)
    if od_by_pair is not None:
        args.od_by_pair = od_by_pair.data_ptr()
    fn = getattr(library(), _ENTRY[f])
    if dev.index == torch.cuda.current_device():
        err = fn(ctypes.addressof(args), torch._C._cuda_getCurrentRawStream(dev.index))
    else:
        with torch.cuda.device(dev):
            err = fn(ctypes.addressof(args), torch._C._cuda_getCurrentRawStream(dev.index))
    if err != 0:
        raise RuntimeError(f"turning_fractions launch failed: CUDA error {err}")
    with _COUNT_LOCK:
        turning_fractions.launches[str(f).removeprefix("torch.")] += 1
        turning_fractions.launches_by_design["lanes" if lanes else "rows"] += 1
    return out


# calls per flow dtype, and per design: the streamed one ("lanes") or the
# walk ("rows")
turning_fractions.launches = {"float32": 0, "float64": 0}
turning_fractions.launches_by_design = {"lanes": 0, "rows": 0}
