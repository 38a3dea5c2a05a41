"""The port's engine (pednstream_tpu_torch.engine) against the JAX engine on
the CPU: the per-step functions on the same inputs, one full step from a
converted mid-run JAX state, a deterministic rollout, the lockstep batch,
the fast binomial sampler against scipy, and stochastic rollouts in
distribution.  Every JAX step runs with its EngineParams as a traced
argument: closed over as constants, XLA folds and reassociates the
parameter arithmetic and moves results by an ulp."""

import copy
from functools import partial

import numpy as np
import pytest
import scipy.stats
import torch

import jax
import jax.numpy as jnp

from pednstream_tpu import engine as jax_engine
from pednstream_tpu.fd import speed_from_density as jax_speed
from pednstream_tpu.routing import turning_fractions_step as jax_turning
from pednstream_tpu.scenario import build_scenario as jax_build
from pednstream_tpu_torch import engine
from pednstream_tpu_torch.fd import speed_from_density
from pednstream_tpu_torch import generator, interop
from pednstream_tpu_torch.interop import numpy_leaves
from pednstream_tpu_torch.routing import turning_fractions_step
from pednstream_tpu_torch.scenario import build_scenario

# the port runs on the card unless asked: every CPU test asks
NetworkEnvGenerator = partial(generator.NetworkEnvGenerator, device="cpu")
engine_params_from_jax = partial(interop.engine_params_from_jax, device="cpu")
network_state_from_jax = partial(interop.network_state_from_jax, device="cpu")
torch_build = partial(build_scenario, device="cpu")

torch.set_num_threads(1)

# single-step and per-function comparisons: the same float32 operations
# in the same order; rtol 1e-6 (a few ulps) leaves room only for sums
# whose order differs (the JAX one-hot matmuls, the Pallas slot-order sum)
RTOL = 1e-6


@pytest.fixture(autouse=True)
def float32_jax():
    """Another test file in the same worker may have switched JAX to
    float64 for the session; these comparisons are float32."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def scenario_args(name, seed=3):
    args = NetworkEnvGenerator().scenario_args(name)
    if args["params"].get("seed") is None:
        args["params"]["seed"] = seed  # unseeded datasets: same demand both sides
    return args


def both(name, **kwargs):
    args = scenario_args(name)
    return (jax_build(**copy.deepcopy(args), **kwargs),
            torch_build(**copy.deepcopy(args), **kwargs))


def jax_stepper(js, stochastic=False, record=True):
    step = jax.jit(lambda ep, st: jax_engine.step_fn(js, ep, st, stochastic=stochastic,
                                                     record=record))
    return lambda st: step(js.engine_params, st)


def test_speed_from_density_matches_jax():
    rng = np.random.default_rng(0)
    E = 600
    k_eff = rng.uniform(0, 8, E).astype(np.float32)
    k_eff[:20] = 0.0
    vf = rng.uniform(0.8, 1.6, E).astype(np.float32)
    kc = rng.uniform(1.5, 3.0, E).astype(np.float32)
    kj = (kc + rng.uniform(2.0, 6.0, E)).astype(np.float32)
    fd = rng.integers(0, 3, E).astype(np.int32)
    want = np.asarray(jax_speed(*map(jnp.asarray, (k_eff, vf, kc, kj, fd))))
    got = speed_from_density(*map(torch.from_numpy, (k_eff, vf, kc, kj, fd)))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)


@pytest.mark.parametrize("name", ["butterfly_scC", "melbourne", "nine_intersections"])
def test_turning_fractions_match_jax(name):
    """Compact routed phi (exact=False, compact=True) on random congestion,
    with and without OD flow (zero flow takes the 1/count share)."""
    js, ts = both(name)
    rt = js.routing
    rng = np.random.default_rng(1)
    E = ts.n_links
    for flow_scale in (1.0, 0.0):
        dens = rng.uniform(0, 6, E).astype(np.float32)
        recv = np.where(rng.uniform(size=E) < 0.3, -1.0,
                        rng.integers(0, 40, E)).astype(np.float32)
        cap = rng.uniform(5, 60, E).astype(np.float32)
        od = (np.asarray(js.engine_params.od_table[:, 7]) * flow_scale).astype(np.float32)
        want = jax_turning(rt, js.n_nodes, js.max_deg, js.node_arity, js.slot_valid,
                           jnp.asarray(dens), jnp.asarray(recv), jnp.asarray(cap),
                           jnp.asarray(od), jnp.asarray(js.engine_params.phi_base),
                           exact=False, compact=True)
        got = turning_fractions_step(ts.routing, ts.max_deg, torch.from_numpy(dens)[None],
                                     torch.from_numpy(recv)[None],
                                     torch.from_numpy(cap)[None], torch.from_numpy(od))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=RTOL, atol=1e-7)


@pytest.mark.parametrize("name", ["butterfly_scC", "melbourne"])
def test_node_solve_matches_jax(name):
    """Padded merge/diverge with the routed rows re-solved on phi_c."""
    js, ts = both(name)
    rng = np.random.default_rng(2)
    E, NR, M = ts.n_links, ts.routing.num_routed, ts.max_deg
    S = np.floor(rng.uniform(0, 30, E)).astype(np.float32)
    R = rng.uniform(0, 40, E).astype(np.float32)
    phi_c = rng.uniform(0, 1, (NR, M, M)).astype(np.float32)
    t = 9
    ep = jax.tree_util.tree_map(jnp.asarray, js.engine_params)
    want = jax_engine._node_solve(js, ep, None, t, jnp.asarray(S), jnp.asarray(R),
                                  ep.phi_base, phi_c=jnp.asarray(phi_c))
    got = engine._node_solve(ts, ts.engine_params, t, torch.from_numpy(S)[None],
                             torch.from_numpy(R)[None], torch.from_numpy(phi_c)[None])
    for name_, a, b in zip(("inflow", "outflow", "virt_dep", "virt_arr"), got, want):
        np.testing.assert_allclose(a[0].numpy(), np.asarray(b), rtol=RTOL, atol=0,
                                   err_msg=name_)


def test_step_matches_jax_from_mid_run_state():
    """melbourne, H=16: 40 deterministic JAX steps (fused Pallas read in
    interpret mode), then one step of each engine from that state."""
    args = scenario_args("melbourne")
    js = jax_build(**copy.deepcopy(args), history_window=16, use_pallas=True,
                   pallas_interpret=True)
    ts = torch_build(**copy.deepcopy(args), history_window=16)
    step = jax_stepper(js)
    st = js.init_state(jax.random.PRNGKey(0))
    for _ in range(40):
        st, _ = step(st)
    ep = engine_params_from_jax(numpy_leaves(js.engine_params))
    tst = network_state_from_jax(numpy_leaves(st))
    want_st, want = step(st)
    got_st, got = engine.step_fn(ts, ep, tst)
    assert got_st.t == int(want_st.t) == 42
    for name, b in numpy_leaves(want).items():
        np.testing.assert_allclose(getattr(got, name)[0].numpy(), b, rtol=RTOL, atol=0,
                                   err_msg=name)
    for name, b in numpy_leaves(want_st, skip=("key", "t")).items():
        np.testing.assert_allclose(getattr(got_st, name)[0].numpy(), b, rtol=RTOL, atol=0,
                                   err_msg=name)


def test_rollout_matches_jax_default_path():
    """Deterministic butterfly_scC, H=64, 120 steps, against the JAX
    engine's default XLA path (single-pass diffusion read), at the atol of
    tests/test_ops.py::test_fast_vs_parity_diffusion_in_engine."""
    js, ts = both("butterfly_scC", history_window=64)
    ep = js.engine_params
    run = jax.jit(lambda ep, st: jax_engine.simulate(js, ep, st, 120, stochastic=False,
                                                     record=False)[0])
    want = run(ep, js.init_state(jax.random.PRNGKey(0)))
    got, _ = engine.simulate(ts, ts.engine_params, ts.init_state(1), 120, record=False)
    assert float(got.num_peds.sum()) > 0
    for name in ("density", "num_peds", "cum_in", "cum_out"):
        atol = 5e-3 if name == "density" else 1.0  # one pedestrian
        np.testing.assert_allclose(getattr(got, name)[0].numpy(),
                                   np.asarray(getattr(want, name)), rtol=0, atol=atol,
                                   err_msg=name)


def test_lockstep_batch_equals_single_runs():
    """B=4 replicas with different gate widths, stepped together, equal
    the same four replicas stepped alone, exactly."""
    ts = torch_build(**scenario_args("butterfly_scC"), history_window=64)
    ep = ts.engine_params
    rng = np.random.default_rng(4)
    factors = torch.from_numpy(rng.uniform(0.4, 1.0, (4, ts.n_links)).astype(np.float32))
    batch = ts.init_state(4)
    batch = batch.replace(back_gate=batch.back_gate * factors)
    singles = [batch.replace(**{k: v[i:i + 1].clone() for k, v in vars(batch).items()
                                if isinstance(v, torch.Tensor)}) for i in range(4)]
    batch, outs = engine.simulate(ts, ep, batch, 80)
    for i, single in enumerate(singles):
        single, souts = engine.simulate(ts, ep, single, 80)
        for name, v in vars(batch).items():
            if isinstance(v, torch.Tensor):
                assert torch.equal(v[i:i + 1], getattr(single, name)), name
        assert torch.equal(outs.density[:, i:i + 1], souts.density)


def test_stochastic_step_needs_a_generator():
    ts = torch_build(**scenario_args("butterfly_scC"))
    with pytest.raises(ValueError):
        engine.step_fn(ts, ts.engine_params, ts.init_state(1), stochastic=True)


@pytest.mark.parametrize("p", [0.1, 0.5, 0.7, 0.9])
def test_binom_fast_small_n_is_the_inverse_cdf(p):
    """For n <= 16 the sampler returns scipy's binom.ppf(u), except for u
    within 1e-5 of a CDF step (the float32 pmf recursion can move a step
    by a few ulps)."""
    rng = np.random.default_rng(5)
    n = np.repeat(np.arange(17, dtype=np.float32), 3000)
    u = rng.uniform(size=n.shape).astype(np.float32)
    got = engine.binom_fast(torch.from_numpy(n), torch.tensor(p), torch.from_numpy(u),
                            torch.zeros(n.shape)).numpy()
    want = scipy.stats.binom.ppf(u.astype(np.float64), n, p)
    steps = scipy.stats.binom.cdf(np.arange(17)[None, :], n[:, None], p)
    near = (np.abs(u[:, None] - steps) < 1e-5).any(axis=1)
    assert near.mean() < 1e-3
    np.testing.assert_array_equal(got[~near], want[~near])


@pytest.mark.parametrize("n,p", [(20, 0.7), (60, 0.9), (300, 0.85)])
def test_binom_fast_large_n_moments(n, p):
    """Above 16 trials the sampler is round(n p + sqrt(n p q) z), clipped
    to [0, n]: mean n p within 5 standard errors, and variance n p q plus
    the rounding's 1/12 within 3% (the normal approximation's own error)."""
    rng = np.random.default_rng(6)
    size = 200_000
    z = rng.standard_normal(size).astype(np.float32)
    u = rng.uniform(size=size).astype(np.float32)
    got = engine.binom_fast(torch.full((size,), float(n)), torch.tensor(p),
                            torch.from_numpy(u), torch.from_numpy(z)).numpy()
    assert ((got >= 0) & (got <= n) & (got == np.round(got))).all()
    var = n * p * (1 - p)
    assert abs(got.mean() - n * p) < 5 * np.sqrt(var / size)
    assert abs(got.var() - (var + 1 / 12)) < 0.03 * var


def test_binom_draws_from_the_generator():
    """Stochastic _binom draws u then z from the generator: the same seed
    gives the same sample, and its mean is n p."""
    n = torch.full((50_000,), 12.7)
    a = engine._binom(n, torch.tensor(0.7), torch.Generator().manual_seed(7), True)
    b = engine._binom(n, torch.tensor(0.7), torch.Generator().manual_seed(7), True)
    assert torch.equal(a, b)
    assert abs(a.mean().item() - 12 * 0.7) < 5 * np.sqrt(12 * 0.21 / 50_000)
    assert torch.equal(engine._binom(n, torch.tensor(0.7), None, False),
                       torch.full((50_000,), 12.0) * 0.7)


# the 4-node corridor of tests/test_stochastic_parity.py (activity 0.1:
# all three binomial sites and no speed noise)
ADJ = np.array([[0, 1, 0, 0], [1, 0, 1, 0], [0, 1, 0, 1], [0, 0, 1, 0]])
PARAMS = {
    "unit_time": 10, "simulation_steps": 150, "seed": 1000,
    "default_link": {"length": 100, "width": 2, "free_flow_speed": 1.1,
                     "k_critical": 2, "k_jam": 6, "activity_probability": 0.1},
    "demand": {"origin_0": {"peak_lambda": 15, "base_lambda": 5}},
}
N_RUNS = 16


def test_stochastic_distribution_matches_jax():
    """Total arrivals and mean density over 16 stochastic replicas of each
    engine (the fast binomial sampler, the same demand): the means agree
    within the bands of tests/test_stochastic_parity.py (relative 0.15 and
    0.25, or z < 4)."""
    steps = PARAMS["simulation_steps"] - 1
    js = jax_build(ADJ, copy.deepcopy(PARAMS), [0], [3], binomial_mode="fast")
    run = jax.jit(jax.vmap(lambda k: jax_engine.simulate(
        js, js.engine_params, js.init_state(k), steps, stochastic=True, record=True)))
    jf, jouts = run(jax.random.split(jax.random.PRNGKey(0), N_RUNS))
    jax_arr = np.asarray(jf.virt_arr_cum).sum(axis=1)
    jax_dens = np.asarray(jouts.density).mean(axis=(1, 2))

    ts = torch_build(ADJ, copy.deepcopy(PARAMS), [0], [3], binomial_mode="fast")
    gen = torch.Generator().manual_seed(0)
    tf, touts = engine.simulate(ts, ts.engine_params, ts.init_state(N_RUNS), steps,
                                gen=gen, stochastic=True)
    our_arr = tf.virt_arr_cum.sum(dim=1).numpy()
    our_dens = touts.density.mean(dim=(0, 2)).numpy()

    assert np.unique(our_arr).size > 1  # replicas really differ
    for mine, ref, name, rel_tol in [(our_arr, jax_arr, "total arrivals", 0.15),
                                     (our_dens, jax_dens, "mean density", 0.25)]:
        m_mu, r_mu = mine.mean(), ref.mean()
        pooled_sd = np.sqrt((mine.std() ** 2 + ref.std() ** 2) / 2) + 1e-9
        rel = abs(m_mu - r_mu) / max(abs(r_mu), 1e-9)
        z = abs(m_mu - r_mu) / (pooled_sd * np.sqrt(2.0 / N_RUNS))
        assert rel < rel_tol or z < 4.0, (
            f"{name}: port {m_mu:.3f}±{mine.std():.3f} vs JAX {r_mu:.3f}±{ref.std():.3f} "
            f"(rel {rel:.3f}, z {z:.2f})")


@pytest.mark.parametrize("n,p", [(3.7, 0.7), (12.0, 0.85), (40.0, 0.9), (250.0, 0.7)])
def test_binom_exact_matches_jax_in_distribution(n, p):
    """Stochastic exact mode (``torch.binomial`` on floor(n) trials)
    against ``jax.random.binomial`` at the same (n, p), 20,000 draws each.
    Bands: each mean within 5 standard errors of floor(n) p; each variance
    within 5% of floor(n) p (1 - p) (the sample variance's relative sd is
    ~1% here); the two samples' Kolmogorov-Smirnov p-value above 1e-4."""
    size = 20_000
    nf = float(np.floor(n))
    got = engine._binom(torch.full((size,), n), torch.tensor(p),
                        torch.Generator().manual_seed(8), True, "exact").numpy()
    want = np.asarray(jax.random.binomial(jax.random.PRNGKey(8), jnp.full((size,), nf),
                                          jnp.float32(p)))
    var = nf * p * (1 - p)
    for x in (got, want):
        assert ((x >= 0) & (x <= nf) & (x == np.round(x))).all()
        assert abs(x.mean() - nf * p) < 5 * np.sqrt(var / size)
        assert abs(x.var() - var) < 0.05 * var
    assert scipy.stats.ks_2samp(got, want).pvalue > 1e-4


def test_binom_exact_is_the_default_and_seeded():
    """build_scenario samples with the exact binomial unless told
    otherwise (as the JAX package does), and one seed gives one draw."""
    ts = torch_build(**scenario_args("butterfly_scC"))
    assert ts.binomial_mode == "exact"
    n = torch.full((1000,), 9.5)
    a = engine._binom(n, torch.tensor(0.7), torch.Generator().manual_seed(3), True)
    b = engine._binom(n, torch.tensor(0.7), torch.Generator().manual_seed(3), True)
    assert torch.equal(a, b) and a.max() <= 9.0
