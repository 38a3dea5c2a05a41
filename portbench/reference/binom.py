"""The fast binomial sampler in plain PyTorch, a pure function of its
uniform and normal inputs: a frozen copy of the program's plain version."""

import torch

from .history import reciprocal_f32

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
