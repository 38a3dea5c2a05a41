"""The node merge/diverge solve in one kernel launch (the counterpart of the
XLA-fused ``pednstream_tpu/engine.py:446`` ``_classic_solve`` and ``:458``
``_node_solve``).

:func:`node_solve` is the engine step's node solve (``engine._node_solve``).
On CUDA tensors it launches the hand-written CUDA kernel of
``csrc/node_solve.cu`` for every classic solve -- the fast path's compact
turning fractions and the dense ``phi`` of exact parity, float32 or float64
flows; on CPU tensors, and for the ``"optimal"`` solve's host LP, it runs
:func:`node_solve_plain`, its plain PyTorch version.  The kernel and the
plain version agree bit for bit on the card.

The kernel reads the scenario's :class:`NodeTables`, built with it: each
node's in- and out-links by slot, its routed row, its kind and arity, and
the order in which a replica's threads take the nodes.
"""

import ctypes
import threading

import numpy as np
import torch

_ENTRY = {torch.float32: "node_solve", torch.float64: "node_solve_f64"}
_COUNT_LOCK = threading.Lock()
# the largest max degree M the kernel takes
MAX_SLOTS = 32
# launch plans a scenario keeps, one per operand layout (a batch, a dtype,
# the strides); past this many they are dropped and made again
MAX_PLANS = 64


class NodeTables:
    """The static node tables the kernel reads, built from the topology
    ``topo`` and the routed node ids (``RoutingTables.routed_ids``, empty
    when nothing is routed), int32 on ``device``:

    - ``in_link`` / ``out_link`` ``[N, M]``: the link ending / starting at
      each slot, -1 for a virtual or padded slot;
    - ``routed_pos`` ``[N]``: a routed node's row of the compact turning
      fractions, -1 elsewhere;
    - ``node_flags`` ``[N]``: bit 0 a OneToOne node, bit 1 a virtual pair,
      from bit 2 on the node's arity (its valid slots, the first of its M);
    - ``order`` ``[N]``: the node ids in the order a replica's threads take
      them, the classic-allocation nodes first (the largest arity first, so
      that a warp's nodes do alike work), then the OneToOne ones, each group
      by id.

    Each link must end at exactly one (node, slot) and start at exactly
    one, the slots that ``end_node``/``end_slot`` and ``start_node``/
    ``start_slot`` name: the kernel writes each node's flows at its own
    links.  A table that breaks this raises.  ``plans`` keeps the launch
    plans of :func:`kernel_args` by operand layout."""

    def __init__(self, topo, routed_ids, device):
        N, M, E = topo.n_nodes, topo.max_deg, topo.n_links
        in_link = np.asarray(topo.in_link_idx, dtype=np.int32).reshape(N, M)
        out_link = np.asarray(topo.out_link_idx, dtype=np.int32).reshape(N, M)
        for name, table, node, slot in (("in", in_link, topo.end_node, topo.end_slot),
                                        ("out", out_link, topo.start_node, topo.start_slot)):
            links = np.sort(table[table >= 0])
            if not (np.array_equal(links, np.arange(E))
                    and np.array_equal(table[np.asarray(node), np.asarray(slot)],
                                       np.arange(E))):
                raise ValueError(f"the {name}-link table does not give each of the {E} "
                                 f"links exactly one (node, slot)")
        routed = np.asarray(routed_ids, dtype=np.int64).reshape(-1)
        routed_pos = np.full(N, -1, dtype=np.int32)
        routed_pos[routed] = np.arange(routed.size, dtype=np.int32)
        valid = np.asarray(topo.slot_valid, dtype=bool).reshape(N, M)
        arity = valid.sum(axis=1).astype(np.int32)
        if not np.array_equal(valid, np.arange(M)[None, :] < arity[:, None]):
            raise ValueError("a node's valid slots are not the first of its M")
        otoo = np.asarray(topo.is_otoo, dtype=bool)
        flags = (otoo.astype(np.int32) | (np.asarray(topo.has_virtual, dtype=np.int32) << 1)
                 | (arity << 2))
        # the classic nodes by arity, largest first, then the OneToOne ones
        order = np.lexsort((np.arange(N), np.where(otoo, 0, -arity), otoo)).astype(np.int32)

        def dev(a):
            return torch.as_tensor(a, dtype=torch.int32, device=device).contiguous()

        self.n_nodes, self.max_deg, self.n_links = N, M, E
        self.num_routed = int(routed.size)
        self.in_link, self.out_link = dev(in_link), dev(out_link)
        self.routed_pos, self.node_flags, self.order = dev(routed_pos), dev(flags), dev(order)
        self.plans = {}


class KernelArgs(ctypes.Structure):
    """The C entry points' argument block (``NodeSolveArgs`` in
    ``csrc/node_solve.cu``): every field 8 bytes wide, so the layout has no
    padding on either side."""

    _fields_ = [(name, ctypes.c_void_p if kind == "p" else ctypes.c_longlong)
                for name, kind in (
                    ("S", "p"), ("S_sb", "i"), ("S_se", "i"),
                    ("R", "p"), ("R_sb", "i"), ("R_se", "i"),
                    ("demand", "p"), ("demand_sb", "i"), ("demand_sn", "i"),
                    ("virt_recv", "p"), ("virt_recv_sb", "i"), ("virt_recv_sn", "i"),
                    ("phi_base", "p"), ("phi_base_sb", "i"),
                    ("phi_c", "p"), ("phi_c_sb", "i"),
                    ("order", "p"), ("node_flags", "p"), ("routed_pos", "p"),
                    ("in_link", "p"), ("out_link", "p"),
                    ("inflow", "p"), ("outflow", "p"), ("virt_dep", "p"), ("virt_arr", "p"),
                    ("B", "i"), ("E", "i"), ("N", "i"), ("M", "i"), ("NR", "i"),
                    ("seq_sum", "i"))]


def _per_replica(name, shape, stride, B: int, inner: tuple):
    """The replica stride of an operand of ``shape`` and ``stride``, which
    is ``inner`` (shared by the replicas, stride 0) or ``[B or 1, *inner]``."""
    shape, n = tuple(shape), len(inner)
    if shape[-n:] != inner or len(shape) not in (n, n + 1):
        raise ValueError(f"{name} has shape {shape}, expected {inner} or [{B}, *{inner}]")
    if len(shape) == n or shape[0] == 1:
        return 0
    if shape[0] != B:
        raise ValueError(f"{name} has {shape[0]} replicas, S has {B}")
    return stride[0]


def _rows_dense(x, inner: tuple) -> bool:
    """Whether the trailing ``inner`` dims of ``x`` are dense."""
    want, step = [], 1
    for d in reversed(inner):
        want.append(step)
        step *= d
    return tuple(x.stride()[-len(inner):]) == tuple(reversed(want))


class _Plan:
    """What a launch on operands of one layout needs beside their
    pointers: the argument block with every stride and size filled in,
    whether the phi operands must be made dense first, the bytes between
    two time columns of the demand table (0 where a per-replica step's
    columns are gathered), the outputs' places in their one buffer, and the
    entry point."""

    __slots__ = ("args", "copy_phi", "copy_phi_c", "column_bytes", "outputs", "words", "entry")


def _plan(scn, S, R, demand, in_place: bool, virt_recv, phi, phi_c, seq: bool) -> _Plan:
    """The launch plan for these operands (``demand`` the demand table read
    a column in place where ``in_place``, else the step's ``[B, N]``
    columns; ``phi`` the rows of the nodes that no ``phi_c`` row covers:
    ``phi_base``, or the dense phi); raises on operands the kernel does not
    take."""
    tabs = scn.node_tables
    dev = S.device
    N, M = scn.n_nodes, scn.max_deg
    if M > MAX_SLOTS:
        raise ValueError(f"max degree {M}: the node solve kernel holds at most {MAX_SLOTS} "
                         f"slots")
    if S.dim() != 2 or tuple(R.shape) != tuple(S.shape):
        raise ValueError(f"S and R have shapes {tuple(S.shape)} and {tuple(R.shape)}, "
                         f"expected [B, E] both")
    B, E = S.shape
    if E != tabs.n_links or (N, M) != (tabs.n_nodes, tabs.max_deg):
        raise ValueError(f"operands over {E} links, node tables over {tabs.n_links} links, "
                         f"{tabs.n_nodes} nodes of {tabs.max_deg} slots")
    if S.dtype not in _ENTRY:
        raise TypeError(f"S is {S.dtype}: the node solve kernel takes float32 or float64")
    NR = tabs.num_routed
    ops = {"S": S, "R": R, "demand": demand, "virt_recv": virt_recv, "phi": phi,
           "phi_c": phi_c}
    for name, x in ops.items():
        if x is None:
            continue
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, S on {dev}")
        if x.dtype != S.dtype:
            raise TypeError(f"{name} is {x.dtype}, S is {S.dtype}: the node solve kernel "
                            f"takes one flow dtype")
    if tabs.in_link.device != dev:
        raise ValueError(f"the node tables are on {tabs.in_link.device}, the operands on {dev}")
    plan = _Plan()
    plan.copy_phi = not _rows_dense(phi, (N, M, M))
    phi = phi.contiguous() if plan.copy_phi else phi
    plan.copy_phi_c = phi_c is not None and not _rows_dense(phi_c, (NR, M, M))
    phi_c = phi_c.contiguous() if plan.copy_phi_c else phi_c
    if phi_c is not None and tuple(phi_c.shape) != (B, NR, M, M):
        raise ValueError(f"phi_c has shape {tuple(phi_c.shape)}, expected ({B}, {NR}, {M}, "
                         f"{M})")
    a = KernelArgs()
    for name in ("order", "node_flags", "routed_pos", "in_link", "out_link"):
        setattr(a, name, getattr(tabs, name).data_ptr())
    a.S_sb, a.S_se = S.stride()
    a.R_sb, a.R_se = R.stride()
    shape, stride = demand.shape, demand.stride()
    plan.column_bytes = 0
    if in_place:  # drop the time axis: the step's column is read in place
        shape, stride = shape[:-1], stride[:-1]
        plan.column_bytes = demand.stride(-1) * demand.element_size()
    a.demand_sb = _per_replica("demand_t", shape, stride, B, (N,))
    a.demand_sn = stride[-1]
    a.virt_recv_sb = _per_replica("virt_recv", virt_recv.shape, virt_recv.stride(), B, (N,))
    a.virt_recv_sn = virt_recv.stride(-1)
    a.phi_base_sb = _per_replica("phi", phi.shape, phi.stride(), B, (N, M, M))
    a.phi_c_sb = 0 if phi_c is None else phi_c.stride(0)
    a.B, a.E, a.N, a.M, a.NR, a.seq_sum = B, E, N, M, NR, int(seq)
    plan.args = a
    # inflow, outflow, virt_dep, virt_arr: dense rows, one after another
    plan.outputs = tuple(((B, n), (n, 1), off) for n, off in
                         ((E, 0), (E, B * E), (N, 2 * B * E), (N, 2 * B * E + B * N)))
    plan.words = 2 * B * (E + N)
    plan.entry = _ENTRY[S.dtype]
    return plan


def _layout(x):
    return None if x is None else (x.dtype, x.device, x.shape, x.stride())


def kernel_args(scn, ep, t, S, R, phi_c=None, phi=None):
    """The kernel's argument block for these operands, its outputs
    ``(inflow, outflow, virt_dep, virt_arr)`` (views of one buffer,
    allocated, not written) and the name of the entry point; raises on
    operands the kernel does not take.  A dense ``phi`` (exact parity)
    solves every node with its rows, and the column sums are then added
    left to right as ``scn.exact_parity`` asks; without it ``phi_base``
    and the routed rows ``phi_c`` are taken.  A shared step's demand column
    is read in place, a per-replica step's gathered.  The plan of an
    operand layout is made once and kept on the scenario's node tables."""
    from ..engine import _column

    demand = ep.demand
    in_place = not isinstance(t, torch.Tensor)
    if in_place:  # the column _column would take, by its offset
        column = min(max(t - 1, 0), demand.shape[-1] - 1)
    else:
        demand, column = _column(demand, t - 1), 0  # [B, N]
    if phi is None:
        rows, seq = ep.phi_base, False
    else:
        rows, phi_c, seq = phi, None, scn.exact_parity
    plans = scn.node_tables.plans
    key = (seq, in_place, _layout(S), _layout(R), _layout(demand), _layout(ep.virt_recv),
           _layout(rows), _layout(phi_c))
    plan = plans.get(key)
    if plan is None:
        plan = _plan(scn, S, R, demand, in_place, ep.virt_recv, rows, phi_c, seq)
        if len(plans) >= MAX_PLANS:
            plans.clear()
        plans[key] = plan
    if plan.copy_phi:
        rows = rows.contiguous()
    if plan.copy_phi_c:
        phi_c = phi_c.contiguous()
    buf = torch.empty(plan.words, dtype=S.dtype, device=S.device)
    outs = tuple(buf.as_strided(*place) for place in plan.outputs)
    args = KernelArgs.from_buffer_copy(plan.args)
    args.S, args.R = S.data_ptr(), R.data_ptr()
    args.demand = demand.data_ptr() + column * plan.column_bytes
    args.virt_recv, args.phi_base = ep.virt_recv.data_ptr(), rows.data_ptr()
    args.phi_c = None if phi_c is None else phi_c.data_ptr()
    base, item = buf.data_ptr(), buf.element_size()
    args.inflow, args.outflow, args.virt_dep, args.virt_arr = (
        base + item * off for _, _, off in plan.outputs)
    return args, outs, plan.entry


def _launch(scn, ep, t, S, R, phi_c, phi):
    from ._build import library

    # the operands the block points into stay referenced until the launch
    # has taken it: demand_t and any dense copy are held by this frame
    args, outs, entry = kernel_args(scn, ep, t, S, R, phi_c, phi)
    dev = S.device
    fn = getattr(library(), entry)
    if dev.index == torch.cuda.current_device():
        err = fn(ctypes.addressof(args), torch._C._cuda_getCurrentRawStream(dev.index))
    else:
        with torch.cuda.device(dev):
            err = fn(ctypes.addressof(args), torch._C._cuda_getCurrentRawStream(dev.index))
    if err != 0:
        raise RuntimeError(f"node_solve launch failed: CUDA error {err}")
    with _COUNT_LOCK:
        node_solve.launches[str(S.dtype).removeprefix("torch.")] += 1
    return outs


def node_solve(scn, ep, t, S, R, phi_c=None, phi=None):
    """Padded merge/diverge over all nodes of ``scn`` at once, as
    :func:`node_solve_plain` defines it: returns ``(inflow_e, outflow_e,
    virt_dep, virt_arr)``, ``[B, E]`` and ``[B, N]``.

    On CUDA tensors it launches the kernel of ``csrc/node_solve.cu`` (built
    at first use) on the current stream, for the fast path and for the
    dense ``phi`` of exact parity alike, and counts the call in
    ``node_solve.launches`` under the flow dtype's name; a failed launch
    raises, and so do operands it cannot take (a dtype other than float32
    or float64, operands of mixed dtypes, shapes that disagree with the
    scenario's node tables).  The ``"optimal"`` solve's dense phi goes to
    the host LP, and CPU tensors take the plain version.  Any other device
    raises."""
    dev = S.device.type
    if dev == "cuda" and not (phi is not None and scn.assign_flows_type == "optimal"):
        return _launch(scn, ep, t, S, R, phi_c, phi)
    if dev in ("cuda", "cpu"):
        return node_solve_plain(scn, ep, t, S, R, phi_c, phi)
    raise ValueError(f"node_solve has no kernel for device {dev!r}")


# kernel launches, by flow dtype
node_solve.launches = {"float32": 0, "float64": 0}


def _classic_solve(dem_mat, r_pad, exact: bool = False):
    """'classic' proportional supply allocation (node.py:272-300) over any
    leading axes: ``dem_mat [..., M, M]``, ``r_pad [..., M]``.  ``exact``
    adds the column sums left to right (the sums of the floored ``g`` are
    of whole numbers, exact in any order)."""
    if exact:
        from ..routing import seq_sum

        col_sums = seq_sum(dem_mat, -2).unsqueeze(-2)
    else:
        col_sums = dem_mat.sum(dim=-2, keepdim=True)
    share = dem_mat / torch.where(col_sums != 0, col_sums, 1e-5)
    supply = r_pad.unsqueeze(-2) * share
    g = torch.floor(torch.minimum(dem_mat, supply))
    q_in = torch.clamp(g.sum(dim=-1), min=0.0)  # outflow of incoming slot i
    q_out = torch.clamp(g.sum(dim=-2), min=0.0)  # inflow to outgoing slot j
    return q_in, q_out


def _host_lp(scn, s_pad, r_pad, phi):
    """The ``"optimal"`` LP solve (node.py:248-271) on the host, replica by
    replica, as the JAX engine's ``pure_callback`` runs it."""
    phi = phi.expand(s_pad.shape[:1] + phi.shape[-3:])
    s_np, r_np, phi_np = (x.cpu().numpy() for x in (s_pad, r_pad, phi))
    q = [scn.optimal_solver(s_np[b], r_np[b], phi_np[b]) for b in range(s_np.shape[0])]
    q_in, q_out = (torch.as_tensor(np.stack([qq[i] for qq in q]), device=s_pad.device)
                   .to(s_pad.dtype) for i in (0, 1))
    return q_in, q_out


def node_solve_plain(scn, ep, t, S, R, phi_c=None, phi=None):
    """Padded merge/diverge over all nodes at once (node.py:164-300).

    Gathers per-node sending/receiving vectors ``[B, N, M]`` (with the
    origin-demand and destination big-M virtual slot 0) and solves
    OneToOne nodes by the crossing rule.  The others take the classic
    allocation, on one of:

    - ``phi [B, N, M, M]``, dense turning fractions (exact-parity mode, with
      the column sums added in order; the ``"optimal"`` solve sends this
      phi to the host LP instead);
    - ``phi_base``, with the NR routed nodes re-solved on their dynamic
      ``phi_c [B, NR, M, M]`` and written over the result.

    The flows are then gathered back to the link axis.
    """
    from ..engine import _column

    B = S.shape[0]
    N, M = scn.n_nodes, scn.max_deg
    demand_t = _column(ep.demand, t - 1)  # node.py:176; [N] or per replica [B, N]

    s_pad = torch.where(scn.in_valid, S[:, scn.in_safe], 0.0)
    s_pad = torch.where(scn.virt_slot, demand_t[..., None], s_pad)
    s_pad = torch.where(scn.slot_valid, s_pad, 0.0)
    r_pad = torch.where(scn.out_valid, R[:, scn.out_safe], 0.0)
    r_pad = torch.where(scn.virt_slot, ep.virt_recv[..., None], r_pad)
    r_pad = torch.where(scn.slot_valid, r_pad, 0.0)

    if phi is not None and scn.assign_flows_type == "optimal":
        q_in_reg, q_out_reg = _host_lp(scn, s_pad, r_pad, phi)
    elif phi is not None:
        q_in_reg, q_out_reg = _classic_solve(phi * s_pad.unsqueeze(-1), r_pad,
                                             exact=scn.exact_parity)
    else:
        q_in_reg, q_out_reg = _classic_solve(ep.phi_base * s_pad.unsqueeze(-1), r_pad)
    if phi_c is not None:
        ids = scn.routing.routed_ids
        q_in_c, q_out_c = _classic_solve(phi_c * s_pad[:, ids].unsqueeze(-1), r_pad[:, ids])
        q_in_reg[:, ids] = q_in_c
        q_out_reg[:, ids] = q_out_c

    # OneToOne crossing solve (node.py:230-242): slot k <-> slot 1-k
    s2, r2 = s_pad[..., :2], r_pad[..., :2]
    pad = torch.zeros((B, N, M - 2), dtype=s_pad.dtype, device=s_pad.device)
    q_in_oto = torch.cat([torch.minimum(s2, r2.flip(-1)), pad], dim=-1)
    q_out_oto = torch.cat([torch.minimum(s2.flip(-1), r2), pad], dim=-1)
    otoo = scn.is_otoo[:, None]
    q_in = torch.where(otoo, q_in_oto, q_in_reg)
    q_out = torch.where(otoo, q_out_oto, q_out_reg)

    # write-back: each directed link is incoming to exactly one node and
    # outgoing from exactly one node (node.py:146-162)
    outflow_e = q_in.reshape(B, N * M)[:, scn.end_flat]
    inflow_e = q_out.reshape(B, N * M)[:, scn.start_flat]
    virt_dep = torch.where(scn.has_virtual, q_in[..., 0], 0.0)
    virt_arr = torch.where(scn.has_virtual, q_out[..., 0], 0.0)
    return inflow_e, outflow_e, virt_dep, virt_arr
