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

_F32 = torch.float32
_I32 = torch.int32
# the kernel's entry point for each ring dtype
_ENTRY = {torch.float32: "ncurve_history_reads", torch.float64: "ncurve_history_reads_f64"}
# the launch count's key for a per-replica t
PER_REPLICA_T = "_per_replica_t"


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


def fused_history_reads_ref(cum_in_ring, cum_out_ring, inflow_ring,
                            idx_ci, idx_co, base, coefs, H: int):
    """The three reads alone, on any device.

    Rings ``[B, H, E]``; ``idx_ci``, ``idx_co``, ``base`` ``[B, E]`` int;
    ``coefs`` ``[B, 4, E]``.  Returns ``(ci, co, diff)``, each ``[B, E]``:
    ``ci = cum_in_ring[idx_ci mod H]`` and ``co = cum_out_ring[idx_co mod H]``
    (0 where the index is negative), and
    ``diff = ((t0 + t1) + t2) + t3`` with
    ``tk = coefs[k] * inflow_ring[(base - k) mod H]`` (0 where base - k < 0);
    float32 coefs times float64 rings widen the coef first.
    """
    def read(ring, idx):
        slot = torch.remainder(idx, H).to(torch.int64)
        val = ring.gather(1, slot.unsqueeze(1)).squeeze(1)
        return torch.where(idx >= 0, val, 0.0)

    ci = read(cum_in_ring, idx_ci)
    co = read(cum_out_ring, idx_co)
    diff = None
    for k in range(4):
        lag = base - k
        term = torch.where(lag >= 0, coefs[:, k] * read(inflow_ring, lag), 0.0)
        diff = term if diff is None else diff + term
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
    from ._build import library

    B, H, E = cum_in_ring.shape
    if B > 65535:
        raise ValueError(f"B={B} replicas: the kernel's grid takes at most 65535")
    dev, dtype = cum_in_ring.device, cum_in_ring.dtype
    out = torch.empty((3, B, E), dtype=dtype, device=dev)
    fn = getattr(library(), _ENTRY[dtype])
    # a per-replica t goes as a pointer (the scalar is then unused), a
    # shared one as the scalar beside a null pointer
    per_replica = isinstance(t, torch.Tensor)
    args = (cum_in_ring.data_ptr(), cum_out_ring.data_ptr(), inflow_ring.data_ptr(),
            avg_tt.data_ptr(), strides[0], gamma.data_ptr(), strides[1],
            tau_shockwave.data_ptr(), strides[2], out.data_ptr(), B, H, E,
            0 if per_replica else t, t.data_ptr() if per_replica else None,
            unit_time, int(windowed))
    if dev.index == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(dev.index))
    else:
        with torch.cuda.device(dev):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(dev.index))
    if err != 0:
        raise RuntimeError(f"fused_history_reads launch failed: CUDA error {err}")
    name = str(dtype).removeprefix("torch.") + (PER_REPLICA_T if per_replica else "")
    fused_history_reads.launches[name] += 1
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
    rings' dtype (built at first use) and counts the launch in
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
