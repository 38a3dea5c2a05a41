"""N-curve history reads (the counterpart of ``pednstream_tpu/ops/ncurve.py``).

Each engine step reads per-link history at per-link time offsets from the
time-major rings ``[B, H, E]`` (time index i lives at row ``i % H``): the
cumulative-inflow lookback (link.py:260-288), the cumulative-outflow
shockwave lookback (link.py:380) and the four lagged inflows of the
diffusion term (link.py:199-214).  :func:`fused_history_reads` does all
three in one hand-written CUDA kernel (``csrc/ncurve.cu``) on a CUDA tensor,
and in :func:`fused_history_reads_ref`, its plain PyTorch version, on a CPU
tensor.  The kernel has a float32 and a float64 instantiation, picked by
the rings' dtype; both agree with the plain version bit for bit.
"""

import torch

_F32 = torch.float32
_I32 = torch.int32
# the kernel's entry point for each ring dtype
_ENTRY = {torch.float32: "ncurve_fused_history_reads",
          torch.float64: "ncurve_fused_history_reads_f64"}


def fused_history_reads_ref(cum_in_ring, cum_out_ring, inflow_ring,
                            idx_ci, idx_co, base, coefs, H: int):
    """Plain PyTorch version of the kernel, on any device.

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


def _check(cum_in_ring, cum_out_ring, inflow_ring, idx_ci, idx_co, base, coefs, H):
    dev = cum_in_ring.device
    ring_dtype = cum_in_ring.dtype
    if ring_dtype not in _ENTRY:
        raise TypeError(f"cum_in_ring is {ring_dtype}, expected float32 or float64")
    B, H_ring, E = cum_in_ring.shape
    if H_ring != H:
        raise ValueError(f"rings hold {H_ring} rows, H={H}")
    operands = {
        "cum_in_ring": (cum_in_ring, ring_dtype, (B, H, E)),
        "cum_out_ring": (cum_out_ring, ring_dtype, (B, H, E)),
        "inflow_ring": (inflow_ring, ring_dtype, (B, H, E)),
        "idx_ci": (idx_ci, _I32, (B, E)),
        "idx_co": (idx_co, _I32, (B, E)),
        "base": (base, _I32, (B, E)),
        "coefs": (coefs, _F32, (B, 4, E)),
    }
    for name, (x, dtype, shape) in operands.items():
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, the rings on {dev}")
        if x.dtype != dtype:
            raise TypeError(f"{name} is {x.dtype}, expected {dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
        if not x.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


def _launch(cum_in_ring, cum_out_ring, inflow_ring, idx_ci, idx_co, base, coefs, H):
    from ._build import library

    B, _, E = cum_in_ring.shape
    dev, dtype = cum_in_ring.device, cum_in_ring.dtype
    ci, co, diff = (torch.empty((B, E), dtype=dtype, device=dev) for _ in range(3))
    with torch.cuda.device(dev):
        err = getattr(library(), _ENTRY[dtype])(
            cum_in_ring.data_ptr(), cum_out_ring.data_ptr(), inflow_ring.data_ptr(),
            idx_ci.data_ptr(), idx_co.data_ptr(), base.data_ptr(), coefs.data_ptr(),
            ci.data_ptr(), co.data_ptr(), diff.data_ptr(), B, H, E,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_history_reads launch failed: CUDA error {err}")
    fused_history_reads.launches[str(dtype).removeprefix("torch.")] += 1
    return ci, co, diff


def fused_history_reads(cum_in_ring, cum_out_ring, inflow_ring,
                        idx_ci, idx_co, base, coefs, H: int):
    """All three per-step history reads in one pass.

    Rings are ``[B, H, E]``, all float32 or all float64; ``idx_ci``,
    ``idx_co`` and ``base`` are int32 ``[B, E]``; ``coefs`` is float32
    ``[B, 4, E]``; all contiguous and on one device.  An unbatched call
    (``[H, E]`` rings, ``[E]`` indices, ``[4, E]`` coefs) is promoted to
    ``B = 1`` and its results squeezed.  Returns ``(ci, co, diff)``, each
    ``[B, E]`` in the rings' dtype, as :func:`fused_history_reads_ref`
    defines them.

    On a CUDA tensor this launches the kernel of ``csrc/ncurve.cu`` for the
    rings' dtype (built at first use) and counts the launch in
    ``fused_history_reads.launches[dtype name]``; a failed launch raises.
    On a CPU tensor it runs :func:`fused_history_reads_ref`.  Any other
    device, dtype, shape or a non-contiguous operand raises.
    """
    args = [cum_in_ring, cum_out_ring, inflow_ring, idx_ci, idx_co, base, coefs]
    unbatched = cum_in_ring.dim() == 2
    if unbatched:
        args = [x.unsqueeze(0) for x in args]
    _check(*args, H)
    dev = args[0].device.type
    if dev == "cuda":
        out = _launch(*args, H)
    elif dev == "cpu":
        out = fused_history_reads_ref(*args, H)
    else:
        raise ValueError(f"fused_history_reads has no kernel for device {dev!r}")
    return tuple(o[0] for o in out) if unbatched else out


# kernel launches per ring dtype
fused_history_reads.launches = {"float32": 0, "float64": 0}
