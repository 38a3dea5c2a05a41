"""The step's N-curve history reads in plain PyTorch: the lookback, the
cumulative-inflow and shockwave reads and the four-tap diffusion sum, in
the float32 slot order that the program's fused read reproduces.  A
frozen copy of the program's plain version of that read."""

import torch

_F32 = torch.float32
_I32 = torch.int32
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
