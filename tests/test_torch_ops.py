"""The port's fused N-curve history read (ops/ncurve.py) on the CPU.

The plain reads (``fused_history_reads_ref``) against the JAX package's
Pallas kernel run in interpret mode (float32) and against the JAX exact
path's four ring reads (float64); the plain version of the whole kernel
(``lookback`` + the reads) against JAX's ``_lookback_state`` +
``_fused_hist`` on numpy-made operands and on states of a short
butterfly_scC JAX rollout; the exact summation order the CUDA kernels
also use; and the wrapper's checks.  The kernels themselves run only on
the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import copy
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pednstream_tpu import engine as jax_engine
from pednstream_tpu.engine import _ring_read
from pednstream_tpu.ops import fused_history_reads as jax_fused
from pednstream_tpu.scenario import build_scenario as jax_build
from pednstream_tpu_torch.generator import NetworkEnvGenerator
from pednstream_tpu_torch.ops import (fused_history_reads, fused_history_reads_plain,
                                      fused_history_reads_ref, lookback)

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




@pytest.fixture
def float32_jax():
    """Another test file in the same worker may have switched JAX to
    float64 for the session; these comparisons are float32."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


UNIT_TIME = 10.0


def make_operands(B=3, H=40, E=70, seed=0, ring_dtype=np.float32, per_replica=False):
    """Rings, avg_tt, gamma and tau_shockwave made with numpy from ``seed``.
    Lags run over [0, 3H): at a step t near H some bases are negative
    (``idx_ci`` clamped to 0, diffusion terms dropped) and slots wrap mod
    H.  A tenth of avg_tt sit on a half step (tau rounds half to even).
    gamma (in the rings' dtype) and tau_shockwave are ``[E]``, or ``[B, E]``
    when ``per_replica``."""
    rng = np.random.default_rng(seed)
    rings = [rng.uniform(0, 100, (B, H, E)).astype(ring_dtype) for _ in range(3)]
    avg_tt = rng.uniform(0, 3 * H * UNIT_TIME, (B, E)).astype(np.float32)
    halves = ((rng.integers(0, 3 * H, (B, E)) + 0.5) * UNIT_TIME).astype(np.float32)
    avg_tt = np.where(rng.uniform(size=(B, E)) < 0.1, halves, avg_tt)
    lead = (B,) if per_replica else ()
    gamma = rng.uniform(0.001, 0.1, lead + (E,)).astype(ring_dtype)
    tau_sw = rng.integers(0, 3 * H, lead + (E,)).astype(np.int32)
    return rings, avg_tt, gamma, tau_sw


def torch_operands(rings, avg_tt, gamma, tau_sw):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in (*rings, avg_tt, gamma, tau_sw)]


def jax_history(rings, avg_tt, gamma, tau_sw, b, t, H, T):
    """JAX's ``_lookback_state`` + ``_fused_hist`` for replica ``b`` (the
    Pallas kernel in interpret mode); ``T`` steps make the ring windowed
    when H < T + 1."""
    scn = SimpleNamespace(H=H, simulation_steps=T, unit_time=UNIT_TIME, pallas_interpret=True)
    pick = lambda x: jnp.asarray(x[b] if x.ndim == 2 else x)
    ep = SimpleNamespace(gamma=pick(gamma), tau_shockwave=pick(tau_sw))
    st = SimpleNamespace(avg_tt=jnp.asarray(avg_tt[b]), cum_in_ring=jnp.asarray(rings[0][b]),
                         cum_out_ring=jnp.asarray(rings[1][b]),
                         inflow_ring=jnp.asarray(rings[2][b]))
    return jax_engine._fused_hist(scn, ep, st, t)


def assert_matches_jax(got, tau, want):
    """ci, co and tau exact; diff to rtol 1e-6 (the Pallas kernel sums the
    four terms in slot order, the port in lag order)."""
    np.testing.assert_array_equal(tau.numpy(), np.asarray(want["tau"]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want["ci"]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want["co"]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want["diff"]), rtol=1e-6, atol=0)


@pytest.mark.parametrize("windowed", [True, False])
@pytest.mark.parametrize("per_replica", [False, True])
def test_plain_matches_jax_fused_hist(float32_jax, windowed, per_replica):
    """The plain version of the kernel against JAX's lookback and Pallas
    read, windowed (H=16 of 200 steps) and full horizon (H = T + 1 = 40),
    gamma and tau_shockwave shared or per replica, at a step where some
    bases are negative and slots wrap."""
    H, T = (16, 200) if windowed else (40, 39)
    rings, avg_tt, gamma, tau_sw = make_operands(B=3, H=H, E=70, seed=11,
                                                  per_replica=per_replica)
    t = H + 7
    ops = torch_operands(rings, avg_tt, gamma, tau_sw)
    got = fused_history_reads_plain(*ops, t, UNIT_TIME, windowed)
    tau = lookback(*ops[3:], t, H, UNIT_TIME, windowed)[0]
    base = t - 1 - tau
    assert (base < 0).any() == (not windowed)  # a windowed tau stays below t
    assert ((base >= 0) & (base >= H)).any()  # some slots wrap
    for b in range(3):
        want = jax_history(rings, avg_tt, gamma, tau_sw, b, t, H, T)
        assert_matches_jax([x[b] for x in got], tau[b], want)


@pytest.mark.parametrize("history_window", [16, None])
def test_plain_matches_jax_on_rollout_states(float32_jax, history_window):
    """States of a deterministic butterfly_scC JAX rollout (windowed H=16
    and full horizon), early (t=5: long links still have t < tau) and at
    t=41: the plain version of the kernel against JAX's lookback and
    Pallas read on the scenario's own parameters."""
    args = NetworkEnvGenerator(device="cpu").scenario_args("butterfly_scC")
    args["params"]["seed"] = 3
    js = jax_build(**copy.deepcopy(args), history_window=history_window, use_pallas=True,
                   pallas_interpret=True)
    ep = js.engine_params
    step = jax.jit(lambda ep, st: jax_engine.step_fn(js, ep, st, stochastic=False,
                                                     record=False)[0])
    st = js.init_state(jax.random.PRNGKey(0))
    windowed = js.H < js.simulation_steps + 1
    seen_negative_base = False
    for t_check in (5, 41):
        while int(st.t) < t_check:
            st = step(ep, st)
        t = int(st.t)
        leaves = [np.array(x)[None] for x in (st.cum_in_ring, st.cum_out_ring,
                                                 st.inflow_ring, st.avg_tt)]
        ops = [torch.from_numpy(a) for a in leaves]
        ops += [torch.from_numpy(np.array(ep.gamma)),
                torch.from_numpy(np.array(ep.tau_shockwave))]
        got = fused_history_reads_plain(*ops, t, js.unit_time, windowed)
        tau = lookback(*ops[3:], t, js.H, js.unit_time, windowed)[0]
        seen_negative_base |= bool((t - 1 - tau < 0).any())
        want = jax_engine._fused_hist(js, ep, st, t)
        assert_matches_jax([x[0] for x in got], tau[0], want)
    assert seen_negative_base


def test_plain_float64_matches_jax_exact_path(x64_on):
    """Float64 rings (the exact-parity path, full horizon): the plain
    version of the kernel equals JAX's ``_lookback_state`` followed by the
    exact path's four ring reads summed in the reference's order, float32
    coefs widened (engine.py:307-314), bit for bit; ci and co equal
    ``_ring_read``."""
    H = T1 = 37
    rings, avg_tt, gamma, tau_sw = make_operands(B=2, H=H, E=50, seed=5,
                                                  ring_dtype=np.float64)
    t = 30
    ops = torch_operands(rings, avg_tt, gamma, tau_sw)
    ci, co, diff = fused_history_reads_plain(*ops, t, UNIT_TIME, False)
    assert diff.dtype == torch.float64
    scn = SimpleNamespace(H=H, simulation_steps=T1 - 1, unit_time=UNIT_TIME, exact_parity=True)
    for b in range(2):
        ep = SimpleNamespace(gamma=jnp.asarray(gamma), tau_shockwave=jnp.asarray(tau_sw))
        st = SimpleNamespace(avg_tt=jnp.asarray(avg_tt[b]))
        tau, _, tau_shock = jax_engine._lookback_state(scn, ep, st, t)
        F = jnp.float32(1.0) / (jnp.float32(1.0) + jax_engine._nofma(
            scn, ep.gamma.astype(jnp.float32) * st.avg_tt))
        one_m_f = jnp.float32(1.0) - F
        base = t - 1 - tau
        infl = [_ring_read(jnp.asarray(rings[2][b]), base - k, H) for k in range(4)]
        want = (((F * infl[0] + (F * one_m_f) * infl[1]) + (F * one_m_f ** 2) * infl[2])
                + (F * one_m_f ** 3) * infl[3])
        assert np.asarray(want).dtype == np.float64
        np.testing.assert_array_equal(diff[b].numpy(), np.asarray(want))
        np.testing.assert_array_equal(ci[b].numpy(), np.asarray(
            _ring_read(jnp.asarray(rings[0][b]), jnp.maximum(0, t - tau), H)))
        np.testing.assert_array_equal(co[b].numpy(), np.asarray(
            _ring_read(jnp.asarray(rings[1][b]), jnp.maximum(t - tau_shock, 0), H)))


def test_plain_sum_order_is_the_kernels():
    """The plain version's diff is ((t0 + t1) + t2) + t3 of float32
    products of the port's coefficients (F, F m, F (m m), F ((m m) m)),
    each term 0 where base - k < 0: the arithmetic csrc/ncurve.cu does,
    step for step, so equality is exact."""
    H = 16
    rings, avg_tt, gamma, tau_sw = make_operands(B=2, H=H, E=33, seed=1)
    t = 12
    _, _, diff = fused_history_reads_plain(*torch_operands(rings, avg_tt, gamma, tau_sw), t,
                                           UNIT_TIME, False)
    f32 = np.float32
    want = np.zeros(avg_tt.shape, f32)
    for b in range(2):
        for e in range(33):
            tau = int(np.rint(f32(avg_tt[b, e]) / f32(UNIT_TIME)))
            F = f32(1) / (f32(1) + gamma[e] * avg_tt[b, e])
            m = f32(1) - F
            q = m * m
            coefs = (F, F * m, F * q, F * (q * m))
            acc = None
            for k in range(4):
                s = t - 1 - tau - k
                term = coefs[k] * rings[2][b, s % H, e] if s >= 0 else f32(0)
                acc = term if acc is None else f32(acc + term)
            want[b, e] = acc
    np.testing.assert_array_equal(diff.numpy(), want)


def test_lookback_rounds_half_to_even_and_clamps():
    """tau = round(avg_tt / unit_time) half to even (2.5 -> 2, 3.5 -> 4);
    a windowed ring clamps tau to H - 6 and the shockwave lookback to
    H - 1; idx_ci and idx_co never go below 0, base does."""
    avg_tt = torch.tensor([[25.0, 35.0, 1000.0, 0.0]])
    gamma = torch.full((4,), 0.05)
    tau_sw = torch.tensor([3, 40, 0, 15], dtype=torch.int32)
    tau, coefs, idx_ci, base, idx_co = lookback(avg_tt, gamma, tau_sw, 9, 16, 10.0, False)
    assert tau.tolist() == [[2, 4, 100, 0]]
    assert idx_ci.tolist() == [[7, 5, 0, 9]] and base.tolist() == [[6, 4, -92, 8]]
    assert idx_co.tolist() == [[6, 0, 9, 0]]
    assert coefs.shape == (1, 4, 4) and coefs.dtype == torch.float32
    tau, _, idx_ci, base, idx_co = lookback(avg_tt, gamma, tau_sw, 9, 16, 10.0, True)
    assert tau.tolist() == [[2, 4, 10, 0]]
    assert idx_co.tolist() == [[6, 0, 9, 0]]  # tau_shockwave 40 -> 15


@pytest.mark.parametrize("ring_dtype", [np.float32, np.float64])
def test_wrapper_on_cpu_runs_the_plain_version(ring_dtype):
    ops = torch_operands(*make_operands(seed=2, ring_dtype=ring_dtype))
    before = dict(fused_history_reads.launches)
    got = fused_history_reads(*ops, 47, UNIT_TIME, False)
    want = fused_history_reads_plain(*ops, 47, UNIT_TIME, False)
    for a, b in zip(got, want):
        assert a.dtype == ops[0].dtype
        assert torch.equal(a, b)
    assert fused_history_reads.launches == before  # counts kernel launches only


def test_wrapper_takes_broadcast_views():
    """avg_tt, gamma and tau_shockwave as broadcast ``[B, E]`` views
    (replica stride 0, as the engine's first steps and randomized worlds
    hand them over) give what their contiguous copies give."""
    rings, avg_tt, gamma, tau_sw = make_operands(B=3, H=16, E=20, seed=6)
    ops = torch_operands(rings, avg_tt[:1].repeat(3, 0), gamma, tau_sw)
    views = ops[:3] + [torch.from_numpy(avg_tt[0]).expand(3, -1)] + \
        [x.expand(3, -1) for x in ops[4:]]
    assert views[3].stride() == (0, 1)
    for a, b in zip(fused_history_reads(*views, 20, UNIT_TIME, True),
                    fused_history_reads(*ops, 20, UNIT_TIME, True)):
        assert torch.equal(a, b)


def test_wrapper_promotes_an_unbatched_call():
    ops = torch_operands(*make_operands(B=1, H=20, E=9, seed=3))
    batched = fused_history_reads(*ops, 25, UNIT_TIME, False)
    single = fused_history_reads(*(x[0] for x in ops[:4]), *ops[4:], 25, UNIT_TIME, False)
    for a, b in zip(single, batched):
        assert a.shape == (9,)
        assert torch.equal(a, b[0])


def _bad(name):
    ops = torch_operands(*make_operands(B=2, H=16, E=8, seed=4))
    if name == "int64 tau_shockwave":
        ops[5] = ops[5].long()
    elif name == "float64 avg_tt":
        ops[3] = ops[3].double()
    elif name == "float64 ring":
        ops[0] = ops[0].double()
    elif name == "float16 rings":
        ops[:3] = [a.half() for a in ops[:3]]
    elif name == "gamma dtype":
        ops[4] = ops[4].double()
    elif name == "gamma shape":
        ops[4] = ops[4][:7]
    elif name == "avg_tt strided":
        ops[3] = ops[3].t().contiguous().t()
    elif name == "ring shape":
        ops[2] = ops[2][:, :15]
    elif name == "non-contiguous ring":
        ops[1] = ops[1].transpose(1, 2).contiguous().transpose(1, 2)
    elif name == "device mismatch":
        ops[2] = ops[2].to("meta")
    elif name == "no kernel for device":
        ops = [a.to("meta") for a in ops]
    return ops


@pytest.mark.parametrize("name", ["int64 tau_shockwave", "float64 avg_tt", "float64 ring",
                                  "float16 rings", "gamma dtype", "gamma shape",
                                  "avg_tt strided", "ring shape", "non-contiguous ring",
                                  "device mismatch", "no kernel for device"])
def test_wrapper_rejects(name):
    with pytest.raises((TypeError, ValueError)):
        fused_history_reads(*_bad(name), 20, UNIT_TIME, True)
