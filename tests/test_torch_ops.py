"""The port's fused N-curve history read (ops/ncurve.py) on the CPU: its
plain version against the JAX package's Pallas kernel run in interpret
mode (float32) and against the JAX exact path's four ring reads (float64),
the exact summation order the CUDA kernels also use, and the wrapper's
checks.  The kernels themselves run only on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pednstream_tpu.engine import _ring_read
from pednstream_tpu.ops import fused_history_reads as jax_fused
from pednstream_tpu_torch.ops import fused_history_reads, fused_history_reads_ref

torch.set_num_threads(1)


@pytest.fixture
def x64_on():
    """float64 JAX arrays for one test, restored afterwards (the session
    ``x64`` fixture would leave them on for every later test file in the
    worker)."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", prev)


def make_inputs(B=3, H=40, E=70, seed=0, ring_dtype=np.float32):
    """Rings, indices and coefs made with numpy from ``seed``.  Indices
    run from below 0 to beyond H (negative slots and the mod-H wrap); E=70
    is not a multiple of the Pallas tile.  Coefs are float32 whatever the
    rings' dtype."""
    rng = np.random.default_rng(seed)
    rings = [rng.uniform(0, 100, (B, H, E)).astype(ring_dtype) for _ in range(3)]
    idx = [rng.integers(-4, 2 * H, (B, E)).astype(np.int32) for _ in range(3)]
    coefs = rng.uniform(0, 1, (B, 4, E)).astype(np.float32)
    return rings + idx + [coefs]


def test_ref_matches_jax_pallas_interpret():
    """ci and co are plain reads: exact.  diff sums the same four products
    in another order (the Pallas kernel adds masked ring rows in slot
    order), so it matches to rtol 1e-6, a few float32 ulps."""
    arrs = make_inputs()
    H = arrs[0].shape[1]
    ci, co, diff = fused_history_reads_ref(*map(torch.from_numpy, arrs), H)
    for b in range(arrs[0].shape[0]):
        want = jax_fused(*(jnp.asarray(a[b]) for a in arrs), H, tile=32, interpret=True)
        np.testing.assert_array_equal(ci[b].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(co[b].numpy(), np.asarray(want[1]))
        np.testing.assert_allclose(diff[b].numpy(), np.asarray(want[2]), rtol=1e-6, atol=0)


def test_ref_sum_order_is_the_kernels():
    """diff is ((t0 + t1) + t2) + t3 of float32 products, each term 0
    where base - k < 0: the order csrc/ncurve.cu uses, so equality is
    exact."""
    arrs = make_inputs(B=2, H=16, E=33, seed=1)
    ci_ring, co_ring, in_ring, idx_ci, idx_co, base, coefs = arrs
    H = ci_ring.shape[1]
    _, _, diff = fused_history_reads_ref(*map(torch.from_numpy, arrs), H)
    want = np.zeros(base.shape, np.float32)
    for b in range(base.shape[0]):
        for e in range(base.shape[1]):
            acc = None
            for k in range(4):
                s = int(base[b, e]) - k
                term = (np.float32(coefs[b, k, e]) * in_ring[b, s % H, e]
                        if s >= 0 else np.float32(0))
                acc = term if acc is None else np.float32(acc + term)
            want[b, e] = acc
    np.testing.assert_array_equal(diff.numpy(), want)


def test_ref_float64_matches_jax_exact_diffusion(x64_on):
    """Float64 rings: ci and co equal JAX's ``_ring_read``, and diff equals
    the JAX exact path's four separate inflow reads summed in the
    reference's order, float32 coefs widened (engine.py:307-314), bit for
    bit."""
    arrs = make_inputs(B=2, H=37, E=50, seed=5, ring_dtype=np.float64)
    ci_ring, co_ring, in_ring, idx_ci, idx_co, base, _ = arrs
    H = ci_ring.shape[1]
    rng = np.random.default_rng(6)
    gamma = rng.uniform(0.001, 0.1, (2, 50)).astype(np.float32)
    avg_tt = rng.uniform(5, 400, (2, 50)).astype(np.float32)
    for b in range(2):
        # the JAX exact path's coefficients and sum (engine.py:307-314)
        F = jnp.float32(1.0) / (jnp.float32(1.0) + jnp.asarray(gamma[b]) * jnp.asarray(avg_tt[b]))
        one_m_f = jnp.float32(1.0) - F
        infl = [_ring_read(jnp.asarray(in_ring[b]), jnp.asarray(base[b]) - k, H)
                for k in range(4)]
        want = (((F * infl[0] + (F * one_m_f) * infl[1]) + (F * one_m_f ** 2) * infl[2])
                + (F * one_m_f ** 3) * infl[3])
        coefs = np.stack([np.asarray(F), np.asarray(F * one_m_f), np.asarray(F * one_m_f ** 2),
                          np.asarray(F * one_m_f ** 3)])
        assert coefs.dtype == np.float32 and np.asarray(want).dtype == np.float64
        ci, co, diff = fused_history_reads_ref(
            *(torch.from_numpy(a[b:b + 1]) for a in arrs[:6]),
            torch.from_numpy(coefs[None]), H)
        assert diff.dtype == torch.float64
        np.testing.assert_array_equal(diff[0].numpy(), np.asarray(want))
        np.testing.assert_array_equal(
            ci[0].numpy(), np.asarray(_ring_read(jnp.asarray(ci_ring[b]),
                                                 jnp.asarray(idx_ci[b]), H)))
        np.testing.assert_array_equal(
            co[0].numpy(), np.asarray(_ring_read(jnp.asarray(co_ring[b]),
                                                 jnp.asarray(idx_co[b]), H)))


@pytest.mark.parametrize("ring_dtype", [np.float32, np.float64])
def test_wrapper_on_cpu_runs_the_plain_version(ring_dtype):
    args = list(map(torch.from_numpy, make_inputs(seed=2, ring_dtype=ring_dtype)))
    before = dict(fused_history_reads.launches)
    got = fused_history_reads(*args, 40)
    want = fused_history_reads_ref(*args, 40)
    for a, b in zip(got, want):
        assert a.dtype == args[0].dtype
        assert torch.equal(a, b)
    assert fused_history_reads.launches == before  # counts kernel launches only


def test_wrapper_promotes_an_unbatched_call():
    args = list(map(torch.from_numpy, make_inputs(B=1, H=20, E=9, seed=3)))
    batched = fused_history_reads(*args, 20)
    single = fused_history_reads(*(a[0] for a in args), 20)
    for a, b in zip(single, batched):
        assert a.shape == (9,)
        assert torch.equal(a, b[0])


def _bad(name):
    args = list(map(torch.from_numpy, make_inputs(B=2, H=16, E=8, seed=4)))
    H = 16
    if name == "int64 index":
        args[3] = args[3].long()
    elif name == "float64 ring":
        args[0] = args[0].double()
    elif name == "float16 rings":
        args[:3] = [a.half() for a in args[:3]]
    elif name == "float64 coefs":
        args[6] = args[6].double()
    elif name == "coefs shape":
        args[6] = args[6][:, :3]
    elif name == "non-contiguous ring":
        args[1] = args[1].transpose(1, 2).contiguous().transpose(1, 2)
    elif name == "H mismatch":
        H = 15
    elif name == "device mismatch":
        args[2] = args[2].to("meta")
    elif name == "no kernel for device":
        args = [a.to("meta") for a in args]
    return args, H


@pytest.mark.parametrize("name", ["int64 index", "float64 ring", "float16 rings",
                                  "float64 coefs", "coefs shape",
                                  "non-contiguous ring", "H mismatch",
                                  "device mismatch", "no kernel for device"])
def test_wrapper_rejects(name):
    args, H = _bad(name)
    with pytest.raises((TypeError, ValueError)):
        fused_history_reads(*args, H)
