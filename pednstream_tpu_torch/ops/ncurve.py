"""N-curve history reads (the counterpart of ``pednstream_tpu/ops/ncurve.py``
and of the lookback in ``pednstream_tpu/engine.py:155-197``).

Each engine step reads per-link history at per-link time offsets from the
time-major rings ``[B, H, E]`` (time index i lives at row ``i % H``): the
cumulative-inflow lookback (link.py:260-288), the cumulative-outflow
shockwave lookback (link.py:380) and the four lagged inflows of the
diffusion term (link.py:199-214).  The offsets and the diffusion
coefficients follow from the step's travel times (:func:`lookback`).

:func:`fused_history_reads` does the lookback and all three reads in one
hand-written CUDA kernel (``csrc/ncurve.cu``) on a CUDA tensor, and in
:func:`fused_history_reads_plain`, its plain PyTorch version, on a CPU
tensor.  The kernel has a float32 and a float64 instantiation, picked by
the rings' dtype; both agree with the plain version bit for bit.  The
step ``t`` is an int shared by the batch, or an int32 ``[B]`` tensor when
the replicas sit at different times (JAX's ``vmap`` over a per-replica
``t``): the same kernel then reads each replica's own time.
:func:`fused_history_reads_ref` is the plain reads alone, given the
indices and coefficients.
"""

import torch

from ._build import launch

_F32 = torch.float32
_I32 = torch.int32
# the kernel's entry point for each ring dtype
_ENTRY = {torch.float32: "ncurve_history_reads", torch.float64: "ncurve_history_reads_f64"}
# the launch count's key for a per-replica t
PER_REPLICA_T = "_per_replica_t"
# rows per window of XLA's CPU tree reduction (float32 diffusion sum order)
SLOT_WINDOW = 32


def reciprocal_f32(c: float) -> float:
    """``1 / c`` rounded to float32, as XLA folds it: the JAX step's float32
    divisions by a constant (``avg_tt / unit_time``, ``run_sum / W``) are
    compiled as multiplies by this reciprocal."""
    one = torch.ones((), dtype=_F32)
    return float(one / torch.full((), c, dtype=_F32))


def lookback(avg_tt, gamma, tau_shockwave, t, H: int, unit_time: float, windowed: bool):
    """The step's lookback (``pednstream_tpu.engine._lookback_state`` and
    the index arithmetic of ``_fused_hist``) on tensors.

    ``avg_tt`` is float32 ``[B, E]``; ``gamma`` (any float dtype) and
    ``tau_shockwave`` (int32) are ``[E]`` or ``[B, E]``; ``t`` is an int or
    an int32 ``[B]`` tensor (the index arithmetic stays int32).  Returns
    ``(tau, coefs, idx_ci, base, idx_co)``: ``tau = round(avg_tt /
    unit_time)`` (half to even), clamped to ``H - 6`` when ``windowed``;
    the float32 diffusion coefficients ``[B, 4, E]`` ``(F, F m, F m², F m³)``
    with ``F = 1 / (1 + gamma avg_tt)``, ``m = 1 - F``; ``idx_ci = max(t -
    tau, 0)``, ``base = t - 1 - tau`` and ``idx_co = max(t - tau_s, 0)``
    with ``tau_s`` clamped to ``H - 1`` when ``windowed``, each int32
    ``[B, E]``.
    """
    if gamma.dtype == _F32:
        tau = torch.round(avg_tt * reciprocal_f32(unit_time)).to(_I32)
    else:
        # a tensor divisor: a Python scalar divides by its reciprocal on CUDA
        tau = torch.round(avg_tt / avg_tt.new_full((), unit_time)).to(_I32)
    tau_shock = tau_shockwave
    if windowed:
        # bounded N-curve and shockwave lookbacks: stay inside the ring
        tau = torch.clamp(tau, max=H - 6)
        tau_shock = torch.clamp(tau_shock, max=H - 1)
    F = 1.0 / (1.0 + gamma.to(_F32) * avg_tt)
    one_m_f = 1.0 - F
    sq = one_m_f * one_m_f
    coefs = torch.stack([F, F * one_m_f, F * sq, F * (sq * one_m_f)], dim=1)
    if isinstance(t, torch.Tensor):
        t = t.unsqueeze(1)  # [B, 1] against the per-link lags
    idx_ci = torch.clamp(t - tau, min=0)  # = ts + 1 - tau
    base = t - 1 - tau  # diffusion lag base
    idx_co = torch.clamp(t - tau_shock, min=0).expand_as(idx_ci)
    return tau, coefs, idx_ci, base, idx_co


def _slot_order_sum(terms, base, H: int):
    """The four diffusion terms summed as the JAX package's float32 read
    sums them: ``(inflow_ring * coef).sum(axis=0)`` over the ring's rows
    (``pednstream_tpu/ops/ncurve.py:34-56`` and the Pallas body :129-150),
    which XLA's CPU backend splits into windows of ``SLOT_WINDOW`` rows
    (the reduced axis padded to a whole number of windows, the lower half
    of the padding in front) and then sums the windows' partial sums.

    The terms' slots ``(base - k) mod H`` are consecutive, so in ascending
    slot order they are lags 3, 2, 1, 0 rotated where the slots wrap past
    row 0; a window boundary splits them into at most two runs, each
    summed left to right, then the two run sums added.  A split after the
    third term gives the plain left-to-right sum again.  Zero terms (lags
    before time 0) add nothing wherever they fall."""
    base_slot = torch.where(base >= 0, torch.remainder(base, H), 0)
    rot = torch.clamp(3 - base_slot, min=0).unsqueeze(1)  # 0 unless the slots wrap
    j = torch.arange(4, device=base.device).view(1, 4, 1)
    lag = 3 - (j + rot) % 4  # [B, 4, E]: the lag of the j-th slot in ascending order
    s0, s1, s2, s3 = torch.stack(terms, dim=1).gather(1, lag).unbind(1)
    left = ((s0 + s1) + s2) + s3
    if H <= SLOT_WINDOW:
        return left
    pad_low = (-H % SLOT_WINDOW) // 2
    window = torch.div(torch.remainder(base_slot.unsqueeze(1) - lag, H) + pad_low,
                       SLOT_WINDOW, rounding_mode="floor")
    run = (window == window[:, :1]).sum(1)  # length of the first run
    return torch.where(run == 1, s0 + ((s1 + s2) + s3),
                       torch.where(run == 2, (s0 + s1) + (s2 + s3), left))


def fused_history_reads_ref(cum_in_ring, cum_out_ring, inflow_ring,
                            idx_ci, idx_co, base, coefs, H: int):
    """The three reads alone, on any device.

    Rings ``[B, H, E]``; ``idx_ci``, ``idx_co``, ``base`` ``[B, E]`` int;
    ``coefs`` ``[B, 4, E]``.  Returns ``(ci, co, diff)``, each ``[B, E]``:
    ``ci = cum_in_ring[idx_ci mod H]`` and ``co = cum_out_ring[idx_co mod H]``
    (0 where the index is negative), and ``diff`` the sum of
    ``tk = coefs[k] * inflow_ring[(base - k) mod H]`` (0 where base - k < 0).
    Float32 rings (the fast path) sum the four terms in the JAX package's
    slot order (:func:`_slot_order_sum`); float64 rings (the exact-parity
    path) in the reference's lag order ``((t0 + t1) + t2) + t3``
    (``pednstream_tpu/engine.py:304-314``), the float32 coef widened first.
    """
    def read(ring, idx):
        slot = torch.remainder(idx, H).to(torch.int64)
        val = ring.gather(1, slot.unsqueeze(1)).squeeze(1)
        return torch.where(idx >= 0, val, 0.0)

    ci = read(cum_in_ring, idx_ci)
    co = read(cum_out_ring, idx_co)
    terms = [torch.where(base - k >= 0, coefs[:, k] * read(inflow_ring, base - k), 0.0)
             for k in range(4)]
    if inflow_ring.dtype == torch.float64:
        diff = ((terms[0] + terms[1]) + terms[2]) + terms[3]
    else:
        diff = _slot_order_sum(terms, base, H)
    return ci, co, diff


def fused_history_reads_plain(cum_in_ring, cum_out_ring, inflow_ring, avg_tt, gamma,
                              tau_shockwave, t, unit_time: float, windowed: bool):
    """Plain PyTorch version of the kernel, on any device:
    :func:`lookback`, then :func:`fused_history_reads_ref`."""
    B, H, E = cum_in_ring.shape
    _, coefs, idx_ci, base, idx_co = lookback(avg_tt.expand(B, E), gamma, tau_shockwave, t, H,
                                              unit_time, windowed)
    return fused_history_reads_ref(cum_in_ring, cum_out_ring, inflow_ring,
                                   idx_ci, idx_co, base, coefs, H)


def _replica_stride(name, x, dtype, B, E, dev) -> int:
    """The replica stride (0 or E) of a per-link operand ``[E]`` or
    ``[B, E]`` with unit stride along the links; raises on anything else."""
    if x.device != dev:
        raise ValueError(f"{name} is on {x.device}, the rings on {dev}")
    if x.dtype != dtype:
        raise TypeError(f"{name} is {x.dtype}, expected {dtype}")
    if tuple(x.shape) == (E,) and (E <= 1 or x.stride(0) == 1):
        return 0
    if tuple(x.shape) != (B, E):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected ({E},) or ({B}, {E})")
    if E > 1 and x.stride(1) != 1:
        raise ValueError(f"{name} is not contiguous along the links")
    if B == 1 or x.stride(0) == 0:
        return 0
    if x.stride(0) != E:
        raise ValueError(f"{name} has replica stride {x.stride(0)}, expected 0 or {E}")
    return E


def _check(cum_in_ring, cum_out_ring, inflow_ring, avg_tt, gamma, tau_shockwave, t):
    """Validates the operands; returns the replica strides of avg_tt,
    gamma and tau_shockwave."""
    dtype, dev = cum_in_ring.dtype, cum_in_ring.device
    if dtype not in _ENTRY:
        raise TypeError(f"cum_in_ring is {dtype}, expected float32 or float64")
    if cum_in_ring.dim() != 3:
        raise ValueError(f"rings must be [B, H, E], cum_in_ring has shape "
                         f"{tuple(cum_in_ring.shape)}")
    B, H, E = cum_in_ring.shape
    for name, ring in (("cum_in_ring", cum_in_ring), ("cum_out_ring", cum_out_ring),
                       ("inflow_ring", inflow_ring)):
        if ring.device != dev:
            raise ValueError(f"{name} is on {ring.device}, the rings on {dev}")
        if ring.dtype != dtype:
            raise TypeError(f"{name} is {ring.dtype}, expected {dtype}")
        if ring.shape != cum_in_ring.shape:
            raise ValueError(f"{name} has shape {tuple(ring.shape)}, expected {(B, H, E)}")
        if not ring.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if isinstance(t, torch.Tensor):
        if t.device != dev:
            raise ValueError(f"t is on {t.device}, the rings on {dev}")
        if t.dtype != _I32:
            raise TypeError(f"t is {t.dtype}, expected {_I32}")
        if tuple(t.shape) != (B,) or not t.is_contiguous():
            raise ValueError(f"t has shape {tuple(t.shape)} and strides {t.stride()}, "
                             f"expected a contiguous ({B},)")
    return (_replica_stride("avg_tt", avg_tt, _F32, B, E, dev),
            _replica_stride("gamma", gamma, dtype, B, E, dev),
            _replica_stride("tau_shockwave", tau_shockwave, _I32, B, E, dev))


def _launch(cum_in_ring, cum_out_ring, inflow_ring, avg_tt, gamma, tau_shockwave, strides,
            t, unit_time, windowed):
    B, H, E = cum_in_ring.shape
    if B > 65535:
        raise ValueError(f"B={B} replicas: the kernel's grid takes at most 65535")
    dev, dtype = cum_in_ring.device, cum_in_ring.dtype
    out = torch.empty((3, B, E), dtype=dtype, device=dev)
    # a per-replica t goes as a pointer (the scalar is then unused), a
    # shared one as the scalar beside a null pointer
    per_replica = isinstance(t, torch.Tensor)
    name = str(dtype).removeprefix("torch.") + (PER_REPLICA_T if per_replica else "")
    launch("fused_history_reads", _ENTRY[dtype], dev,
           cum_in_ring.data_ptr(), cum_out_ring.data_ptr(), inflow_ring.data_ptr(),
           avg_tt.data_ptr(), strides[0], gamma.data_ptr(), strides[1],
           tau_shockwave.data_ptr(), strides[2], out.data_ptr(), B, H, E,
           0 if per_replica else t, t.data_ptr() if per_replica else None,
           unit_time if dtype == torch.float64 else reciprocal_f32(unit_time), int(windowed),
           counts=[(fused_history_reads.launches, name)])
    return out.unbind(0)


def fused_history_reads(cum_in_ring, cum_out_ring, inflow_ring, avg_tt, gamma,
                        tau_shockwave, t, unit_time: float, windowed: bool):
    """The step's lookback and its three history reads in one pass.

    Rings are ``[B, H, E]``, all float32 or all float64, contiguous;
    ``avg_tt`` is float32, ``gamma`` of the rings' dtype and
    ``tau_shockwave`` int32, each ``[E]`` or ``[B, E]`` (contiguous along the
    links, replica stride 0 or E: a broadcast view is taken as it is); all
    on one device.  ``t`` is the step being executed: an int shared by the
    batch, or an int32 ``[B]`` tensor on the rings' device, one time per
    replica.  ``unit_time`` is the step length and ``windowed`` whether the
    rings hold fewer rows than the horizon.  An unbatched call (``[H, E]``
    rings, ``[E]`` operands, an int ``t`` or a tensor of one element) is
    promoted to ``B = 1`` and its results squeezed.  Returns ``(ci, co,
    diff)``, each ``[B, E]`` in the rings' dtype, as
    :func:`fused_history_reads_plain` defines them.

    On a CUDA tensor this launches the kernel of ``csrc/ncurve.cu`` for the
    rings' dtype (built at first use) on the calling thread's current
    stream and counts the launch (under a lock, so concurrent threads all
    count) in
    ``fused_history_reads.launches`` under the dtype's name, with
    ``PER_REPLICA_T`` appended when ``t`` is a tensor; a failed launch raises.
    On a CPU tensor it runs :func:`fused_history_reads_plain`.  Any other
    device, dtype, shape or layout raises.
    """
    rings = (cum_in_ring, cum_out_ring, inflow_ring)
    per_link = (avg_tt, gamma, tau_shockwave)
    unbatched = cum_in_ring.dim() == 2
    if unbatched:
        rings = tuple(x.unsqueeze(0) for x in rings)
    strides = _check(*rings, *per_link, t)
    dev = rings[0].device.type
    if dev == "cuda":
        out = _launch(*rings, *per_link, strides, t, unit_time, windowed)
    elif dev == "cpu":
        out = fused_history_reads_plain(*rings, *per_link, t, unit_time, windowed)
    else:
        raise ValueError(f"fused_history_reads has no kernel for device {dev!r}")
    return tuple(o[0] for o in out) if unbatched else tuple(out)


# kernel launches per ring dtype, those with a per-replica t apart
fused_history_reads.launches = {name + form: 0 for name in ("float32", "float64")
                                for form in ("", PER_REPLICA_T)}
