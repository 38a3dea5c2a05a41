"""The fast binomial sampler (the counterpart of the XLA-fused
``pednstream_tpu/engine.py:109-152``, ``_binom(mode="fast")``).

:func:`binom_fast` samples from its random inputs in one launch of the
hand-written CUDA kernel of ``csrc/binom.cu`` on CUDA tensors, and runs
:func:`binom_fast_plain`, its plain PyTorch version, on CPU tensors.  The
two agree bit for bit on the card.
"""

import torch

from ._build import launch
from .ncurve import reciprocal_f32

_F32 = torch.float32
FAST_BINOM_EXACT_N = 16
_F32_TINY = 1.1754943508222875e-38  # the smallest normal float32


def _ftz(x):
    """A non-negative ``x`` with its subnormal values flushed to zero."""
    return torch.where(x < _F32_TINY, 0.0, x)


def binom_fast_plain(nf, p, u, z):
    """The hybrid binomial sampler of ``pednstream_tpu.engine._binom``
    (mode='fast') as a pure function of its random inputs, on any device.

    ``nf`` holds whole non-negative trial counts, ``p`` the success
    probabilities, ``u`` one uniform [0, 1) and ``z`` one standard normal
    per element.  For n <= 16 the sample is the exact inverse CDF of u,
    walking the pmf by its term recursion; above, it is the normal
    approximation round(n p + sqrt(n p (1-p)) z) clipped to [0, n].  The
    recursion's division by ``k + 1`` is a multiply by the float32
    reciprocal, as XLA compiles the JAX sampler's division by a constant
    (and as CUDA divides a float32 tensor by a Python scalar), and its
    subnormal values are flushed to zero, as the JAX package's runtime does
    (XLA's CPU runtime sets flush-to-zero; a TPU has no subnormals): for p
    near 1, ``(1 - p)^n`` and the first terms of the walk are subnormal.
    """
    pc = torch.clamp(p, 0.0, 1.0)
    q = 1.0 - pc
    ratio = _ftz(pc / torch.clamp(q, min=1e-12))
    pmf = _ftz(torch.pow(q, nf))  # P[X = 0]
    cdf = pmf
    cnt = torch.zeros_like(nf)
    for k in range(FAST_BINOM_EXACT_N):
        # u >= P[X <= k]  =>  the sample exceeds k
        cnt = cnt + ((u >= cdf) & (nf > k)).to(nf.dtype)
        pmf = _ftz(_ftz(pmf * ((nf - k) * reciprocal_f32(k + 1.0))) * ratio)
        pmf = torch.where(nf >= k + 1.0, pmf, 0.0)
        cdf = cdf + pmf
    mu = nf * pc
    sigma = torch.sqrt(torch.clamp(mu * (1.0 - pc), min=0.0))
    gauss = torch.minimum(torch.clamp(torch.round(mu + sigma * z), min=0.0), nf)
    return torch.where(nf <= FAST_BINOM_EXACT_N, cnt, gauss)


def _p_period(p, shape) -> int:
    """How often ``p`` repeats over the elements of ``shape`` when it
    broadcasts as a trailing block (a scalar, ``[E]`` against ``[B, E]``,
    the whole shape); 0 when it does not."""
    dims = list(p.shape)
    while dims and dims[0] == 1:
        dims.pop(0)
    if not p.is_contiguous() or len(dims) > len(shape):
        return 0
    if dims != list(shape[len(shape) - len(dims):]):
        return 0
    return max(p.numel(), 1)


def _launch(nf, p, u, z):
    dev = nf.device
    for name, x in (("nf", nf), ("p", p), ("u", u), ("z", z)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, nf on {dev}")
        if x.dtype != _F32:
            raise TypeError(f"{name} is {x.dtype}, expected {_F32}")
    for name, x in (("u", u), ("z", z)):
        if x.shape != nf.shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, nf {tuple(nf.shape)}")
    nf, u, z = (x.contiguous() for x in (nf, u, z))
    period = _p_period(p, nf.shape)
    if not period:
        raise ValueError(f"p of shape {tuple(p.shape)} and strides {p.stride()} does not "
                         f"repeat as a contiguous trailing block of {tuple(nf.shape)}")
    out = torch.empty_like(nf)
    launch("binom_fast", "binom_fast", dev, nf.data_ptr(), p.data_ptr(), period, u.data_ptr(),
           z.data_ptr(), out.data_ptr(), nf.numel(), counts=[(binom_fast.launches, "float32")])
    return out


def binom_fast(nf, p, u, z):
    """A fast binomial sample per element of ``nf``, as
    :func:`binom_fast_plain` defines it: float32 ``nf``, ``u``, ``z`` of one
    shape and ``p`` broadcasting against them as a contiguous trailing block
    (a scalar, a row per link, the whole shape), on one device.

    On a CUDA tensor this launches the kernel of ``csrc/binom.cu`` (built at
    first use) on the current stream and counts the launch in
    ``binom_fast.launches["float32"]``; a failed launch raises.  On a CPU
    tensor it runs the plain version.  Any other device raises.
    """
    dev = nf.device.type
    if dev == "cuda":
        return _launch(nf, p, u, z)
    if dev == "cpu":
        return binom_fast_plain(nf, p, u, z)
    raise ValueError(f"binom_fast has no kernel for device {dev!r}")


# kernel launches (one float32 instantiation)
binom_fast.launches = {"float32": 0}
