"""The routed turning fractions in one kernel launch (the counterpart of
the XLA-fused ``pednstream_tpu/routing.py:405-515``).

:func:`turning_fractions` computes what
``routing.turning_fractions_step_plain`` computes -- the logit turn
shares, the od-flow shares, the phi segment sums and the row guard, every
sum in the member tables' order -- in one launch of the hand-written CUDA
kernel of ``csrc/routing.cu``.  It takes CUDA tensors only;
``routing.turning_fractions_step`` dispatches, to it on the card and to
the plain version on the CPU.  The kernel has a float32 and a float64
instantiation, picked by the tables' flow dtype; both agree with the plain
version bit for bit.
"""

import ctypes
import threading

import torch

_ENTRY = {torch.float32: "routing_turning_fractions",
          torch.float64: "routing_turning_fractions_f64"}
_COUNT_LOCK = threading.Lock()
# the kernel's blocks: threads each, and the shared memory one may take
THREADS = 128
MAX_SHARED_BYTES = 232448


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
                    ("beta", "d"), ("neg_temp", "d"), ("omega", "d"))]


def shared_bytes(rt, max_deg: int) -> int:
    """Shared memory of one block: a node's uo entries (w, then P(od|up)),
    (node, up) sums, turn entries twice (capacity, then the contribution;
    the utility term, then exp), softmax-group sums, its M x M phi slots
    and one partial sum per (segment, lane) of the widest walk."""
    entries, groups, uo_entries, uo_groups = rt.node_max
    Q = rt.group_members.shape[1]
    MM = max_deg * max_deg
    words = (uo_entries + uo_groups + 2 * entries + groups + MM
             + Q * max(groups, uo_groups, MM))
    return words * rt.dist_util.element_size()


def _strides(name, x, shape, dev):
    """The (replica, link) strides of a ``[B, E]`` operand."""
    if x.device != dev:
        raise ValueError(f"{name} is on {x.device}, the tables on {dev}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    return x.stride(0), x.stride(1)


def turning_fractions(rt, max_deg: int, density_for_routing, recv_prev, cap_default,
                      od_flow_t):
    """Compact turning fractions ``phi_c [B, NR, M, M]`` in the flow dtype
    of the ``RoutingTables`` ``rt``, as ``routing.
    turning_fractions_step_plain`` defines them, in one launch of the
    kernel of ``csrc/routing.cu`` for the tables' dtype (built at first
    use) on the current stream.

    ``density_for_routing``, ``recv_prev`` and ``cap_default`` are ``[B,
    E]`` CUDA tensors (any strides), ``od_flow_t`` is ``[P]`` shared by the
    replicas or ``[B, P]``; the tables lie on the operands' device.  The
    launch is counted in ``turning_fractions.launches`` under the dtype's
    name; a failed launch raises, and so does a tensor off the card.
    """
    from ._build import library

    density, f = density_for_routing, rt.dist_util.dtype
    dev = density.device
    if dev.type != "cuda":
        raise ValueError(f"turning_fractions runs on CUDA tensors, not {dev.type!r} ones "
                         f"(routing.turning_fractions_step runs the plain version there)")
    if f not in _ENTRY:
        raise TypeError(f"the routing tables are {f}, expected float32 or float64")
    if density.dim() != 2:
        raise ValueError(f"density_for_routing has shape {tuple(density.shape)}, "
                         f"expected [B, E]")
    B, E = density.shape
    Q = rt.group_members.shape[1]
    if Q not in (1, 3, 5) or {rt.uo_group_members.shape[1], rt.phi_c_members.shape[1]} != {Q}:
        raise ValueError(f"member tables with {Q} rows per segment: the kernel sums 1, "
                         f"3 or 5 (float64 or float32 GEMV lanes)")
    if B > 65535:
        raise ValueError(f"B={B} replicas: the kernel's grid takes at most 65535")
    for name in ("te_down_link", "te_group", "te_uo_idx", "uo_od", "uo_group",
                 "group_members", "uo_group_members", "phi_c_members", "node_offsets",
                 "dist_util", "uo_inv_count", "offdiag_uniform"):
        x = getattr(rt, name)
        if x.device != dev:
            raise ValueError(f"routing table {name} is on {x.device}, the operands on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"routing table {name} is not contiguous")
        want = f if x.is_floating_point() else torch.int64
        if x.dtype != want:
            raise TypeError(f"routing table {name} is {x.dtype}, expected {want}")
    smem = shared_bytes(rt, max_deg)
    if smem > MAX_SHARED_BYTES:
        raise ValueError(f"a routed node needs {smem} B of shared memory, more than a "
                         f"block may take ({MAX_SHARED_BYTES})")
    # the plain version casts these first (density to float32, the rest to
    # the flow dtype); a cast of matching dtype is the tensor itself
    density = density.to(torch.float32)
    recv_prev, cap_default, od_flow_t = (x.to(f) for x in (recv_prev, cap_default, od_flow_t))
    if od_flow_t.dim() not in (1, 2) or (od_flow_t.dim() == 2 and od_flow_t.shape[0] != B):
        raise ValueError(f"od_flow_t has shape {tuple(od_flow_t.shape)}, expected [P] "
                         f"or [{B}, P]")
    od_sb, od_sp = ((0, od_flow_t.stride(0)) if od_flow_t.dim() == 1
                    else (od_flow_t.stride(0), od_flow_t.stride(1)))
    strides = [_strides(name, x, (B, E), dev) for name, x in (
        ("density_for_routing", density), ("recv_prev", recv_prev),
        ("cap_default", cap_default))]
    if od_flow_t.device != dev:
        raise ValueError(f"od_flow_t is on {od_flow_t.device}, the tables on {dev}")

    NR, M = rt.num_routed, max_deg
    out = torch.empty((B, NR, M, M), dtype=f, device=dev)
    if B == 0:
        return out
    n = rt.node_max
    args = KernelArgs(
        density.data_ptr(), *strides[0], recv_prev.data_ptr(), *strides[1],
        cap_default.data_ptr(), *strides[2], od_flow_t.data_ptr(), od_sb, od_sp,
        rt.te_down_link.data_ptr(), rt.te_group.data_ptr(), rt.te_uo_idx.data_ptr(),
        rt.dist_util.data_ptr(), rt.uo_od.data_ptr(), rt.uo_group.data_ptr(),
        rt.uo_inv_count.data_ptr(), rt.group_members.data_ptr(),
        rt.uo_group_members.data_ptr(), rt.phi_c_members.data_ptr(),
        rt.node_offsets.data_ptr(), rt.offdiag_uniform.data_ptr(), out.data_ptr(),
        B, NR, M, Q, rt.group_members.shape[2], rt.uo_group_members.shape[2],
        rt.phi_c_members.shape[2], *n, THREADS, smem, rt.beta, -rt.temp, rt.omega)
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
    return out


# kernel launches per flow dtype
turning_fractions.launches = {"float32": 0, "float64": 0}
