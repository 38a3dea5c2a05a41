"""Batches whose replicas sit at different times, on the CPU: the plain
version of the fused history read with a per-replica ``t`` against the JAX
package (``_fused_hist`` under ``jax.vmap`` and the Pallas kernel in
interpret mode, replica by replica, on indices worked out in numpy); the
engine's per-replica ring writes and column gathers; and the env core's
``batch_step`` / ``batch_step_randomized`` with ``lockstep=False`` against
the JAX core's, with the lockstep guard's poisoning.  The kernel's own
per-replica-``t`` form runs only on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import copy
import dataclasses
from functools import partial
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pednstream_tpu import engine as jax_engine
from pednstream_tpu.env.agents import build_agent_spec as jax_agent_spec
from pednstream_tpu.env.core import PedNetEnvCore as JaxEnvCore
from pednstream_tpu.generator import NetworkEnvGenerator as JaxGenerator
from pednstream_tpu.ops import fused_history_reads as jax_fused
from pednstream_tpu.randomize import randomize_engine_params_batched as jax_draws
from pednstream_tpu.scenario import build_scenario as jax_build
from pednstream_tpu_torch import concat_states, generator, interop, simulate, step_fn
from pednstream_tpu_torch.engine import _column, _write_row
from pednstream_tpu_torch.env import PedNetEnvCore, build_agent_spec
from pednstream_tpu_torch.interop import numpy_leaves
from pednstream_tpu_torch.ops import fused_history_reads, fused_history_reads_plain, lookback
from pednstream_tpu_torch.scenario import build_scenario

# the port runs on the card unless asked: every CPU test asks
NetworkEnvGenerator = partial(generator.NetworkEnvGenerator, device="cpu")
engine_params_from_jax = partial(interop.engine_params_from_jax, device="cpu")
network_state_from_jax = partial(interop.network_state_from_jax, device="cpu")
tensors_from_jax = partial(interop.tensors_from_jax, device="cpu")
torch_build = partial(build_scenario, device="cpu")

torch.set_num_threads(1)

RTOL = 1e-6  # the single-step tolerance of tests/test_torch_engine.py
UNIT_TIME = 10.0


@pytest.fixture
def float32_jax():
    """Another test file in the same worker may have switched JAX to
    float64 for the session; these comparisons are float32."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


@pytest.fixture
def x64_on():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", prev)


# -- the read ------------------------------------------------------------------

def make_operands(B, H, E, seed, ring_dtype=np.float32, per_replica=False):
    """Rings, avg_tt (lags over [0, 3H), a tenth on a half step), gamma and
    tau_shockwave (``[E]``, or ``[B, E]`` when ``per_replica``), made with
    numpy from ``seed``."""
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


def times(H):
    """Per-replica steps from 1 (every lag before time 0) over a few small
    ones to past one and two ring wraps."""
    return np.array([1, 3, 5, H + 7, 2 * H + 5], np.int32)


@pytest.mark.parametrize("windowed", [True, False])
@pytest.mark.parametrize("per_replica", [False, True])
def test_plain_per_replica_t_matches_jax_vmapped_fused_hist(float32_jax, windowed, per_replica):
    """``jax.vmap`` of JAX's lookback and Pallas read (interpret mode) over
    replicas whose ``t`` differ, against the port's plain read given the
    ``[B]`` time tensor: tau, ci and co exact; diff to rtol 1e-6 (the Pallas
    kernel sums the four terms in slot order, the port in lag order)."""
    H, T = (16, 200) if windowed else (40, 39)
    t = times(H)
    B = len(t)
    rings, avg_tt, gamma, tau_sw = make_operands(B, H, 70, seed=21, per_replica=per_replica)
    ops = torch_operands(rings, avg_tt, gamma, tau_sw)
    tt = torch.from_numpy(t)
    got = fused_history_reads_plain(*ops, tt, UNIT_TIME, windowed)
    tau, _, idx_ci, base, idx_co = lookback(*ops[3:], tt, H, UNIT_TIME, windowed)
    assert all(x.dtype == torch.int32 for x in (tau, idx_ci, base, idx_co))
    assert (base[0] <= 0).all() and (base[0] < 0).any() and (base[-1] >= H).any()

    scn = SimpleNamespace(H=H, simulation_steps=T, unit_time=UNIT_TIME, pallas_interpret=True)

    def one(ci_ring, co_ring, in_ring, att, g, ts, tb):
        st = SimpleNamespace(avg_tt=att, cum_in_ring=ci_ring, cum_out_ring=co_ring,
                             inflow_ring=in_ring)
        return jax_engine._fused_hist(scn, SimpleNamespace(gamma=g, tau_shockwave=ts), st, tb)

    axes = (0, 0, 0, 0) + ((0, 0) if per_replica else (None, None)) + (0,)
    want = jax.vmap(one, in_axes=axes)(*(jnp.asarray(a) for a in (*rings, avg_tt, gamma, tau_sw)),
                                       jnp.asarray(t))
    np.testing.assert_array_equal(tau.numpy(), np.asarray(want["tau"]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want["ci"]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want["co"]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want["diff"]), rtol=1e-6, atol=0)


def numpy_indices(avg_tt, gamma, tau_sw, t, H, windowed):
    """The lookback of ``pednstream_tpu.engine._lookback_state`` and the
    index arithmetic of ``_fused_hist`` in numpy, for replica times ``t [B]``."""
    f32 = np.float32
    tau = np.rint(avg_tt / f32(UNIT_TIME)).astype(np.int32)
    tau_s = np.broadcast_to(tau_sw, tau.shape)
    if windowed:
        tau = np.minimum(tau, H - 6)
        tau_s = np.minimum(tau_s, H - 1)
    F = f32(1.0) / (f32(1.0) + gamma.astype(f32) * avg_tt)
    m = f32(1.0) - F
    coefs = np.stack([F, F * m, F * m ** 2, F * m ** 3], axis=1)
    tb = t[:, None]
    return (np.maximum(0, tb - tau).astype(np.int32), np.maximum(tb - tau_s, 0).astype(np.int32),
            (tb - 1 - tau).astype(np.int32), coefs)


@pytest.mark.parametrize("ring_dtype", [np.float32, np.float64])
def test_plain_per_replica_t_matches_jax_kernel_on_numpy_indices(request, ring_dtype):
    """The JAX Pallas kernel takes indices, the port's read takes ``t``:
    replica by replica on indices worked out in numpy, float32 and float64
    rings, ci and co exact and diff to rtol 1e-6 (summation order)."""
    request.getfixturevalue("x64_on" if ring_dtype == np.float64 else "float32_jax")
    H = 24
    t = times(H)
    B = len(t)
    rings, avg_tt, gamma, tau_sw = make_operands(B, H, 50, seed=22, ring_dtype=ring_dtype)
    got = fused_history_reads_plain(*torch_operands(rings, avg_tt, gamma, tau_sw),
                                    torch.from_numpy(t), UNIT_TIME, False)
    idx_ci, idx_co, base, coefs = numpy_indices(avg_tt, gamma, tau_sw, t, H, False)
    for b in range(B):
        want = jax_fused(*(jnp.asarray(r[b]) for r in rings), jnp.asarray(idx_ci[b]),
                         jnp.asarray(idx_co[b]), jnp.asarray(base[b]),
                         jnp.asarray(coefs[b].astype(ring_dtype)), H, tile=32, interpret=True)
        assert np.asarray(want[2]).dtype == ring_dtype and got[2].numpy().dtype == ring_dtype
        np.testing.assert_array_equal(got[0][b].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1][b].numpy(), np.asarray(want[1]))
        np.testing.assert_allclose(got[2][b].numpy(), np.asarray(want[2]), rtol=1e-6, atol=0)


@pytest.mark.parametrize("ring_dtype", [np.float32, np.float64])
@pytest.mark.parametrize("windowed", [True, False])
def test_per_replica_t_equals_each_replicas_scalar_t(ring_dtype, windowed):
    """One call with the ``[B]`` time tensor equals, bit for bit, one call
    per replica with that replica's int ``t`` (the lockstep form), through
    the wrapper: a replica at t=1 beside one past two ring wraps."""
    H = 16 if windowed else 40
    t = times(H)
    B = len(t)
    ops = torch_operands(*make_operands(B, H, 33, seed=23, ring_dtype=ring_dtype,
                                        per_replica=True))
    before = dict(fused_history_reads.launches)
    got = fused_history_reads(*ops, torch.from_numpy(t), UNIT_TIME, windowed)
    assert fused_history_reads.launches == before  # counts kernel launches only
    for b in range(B):
        want = fused_history_reads(*(x[b:b + 1] for x in ops), int(t[b]), UNIT_TIME, windowed)
        for a, w in zip(got, want):
            assert a.dtype == ops[0].dtype
            assert torch.equal(a[b:b + 1], w)


@pytest.mark.parametrize("name", ["int64 t", "wrong length", "two axes", "strided", "device"])
def test_wrapper_rejects_a_bad_time_tensor(name):
    ops = torch_operands(*make_operands(4, 16, 8, seed=4))
    t = {"int64 t": torch.arange(1, 5),
         "wrong length": torch.arange(1, 4, dtype=torch.int32),
         "two axes": torch.ones((4, 1), dtype=torch.int32),
         "strided": torch.ones(8, dtype=torch.int32)[::2],
         "device": torch.ones(4, dtype=torch.int32, device="meta")}[name]
    with pytest.raises((TypeError, ValueError)):
        fused_history_reads(*ops, t, UNIT_TIME, True)


# -- the engine's per-replica indexing -------------------------------------------

def test_column_gathers_per_replica_and_clamps():
    """Column ``clamp(t_b, 0, T)`` per replica, from a shared ``[N, T+1]``
    table and from per-replica ``[B, N, T+1]`` tables, past both ends."""
    rng = np.random.default_rng(0)
    shared = torch.from_numpy(rng.uniform(size=(5, 11)))
    per = torch.from_numpy(rng.uniform(size=(4, 5, 11)))
    t = torch.tensor([-2, 0, 7, 15], dtype=torch.int32)
    cols = [0, 0, 7, 10]
    got_s, got_p = _column(shared, t), _column(per, t)
    assert got_s.shape == got_p.shape == (4, 5)
    for b, c in enumerate(cols):
        assert torch.equal(got_s[b], shared[:, c]) and torch.equal(got_p[b], per[b, :, c])
        assert torch.equal(_column(shared, int(t[b])), shared[:, c])
        assert torch.equal(_column(per, int(t[b]))[b], per[b, :, c])


def test_write_row_scatters_in_place():
    ring = torch.zeros(3, 5, 4)
    alias = ring
    value = torch.arange(12.0).reshape(3, 4) + 1
    _write_row(ring, torch.tensor([1, 5, 9], dtype=torch.int32), 5, value)
    assert alias is ring and ring.data_ptr() == alias.data_ptr()
    want = torch.zeros(3, 5, 4)
    for b, row in enumerate((1, 0, 4)):
        want[b, row] = value[b]
    assert torch.equal(ring, want)
    _write_row(ring, 7, 5, value)  # the shared form: row 2 of every replica
    want[:, 2] = value
    assert torch.equal(ring, want)


def scenario_args(name, seed=3):
    args = NetworkEnvGenerator().scenario_args(name)
    if args["params"].get("seed") is None:
        args["params"]["seed"] = seed  # unseeded datasets: same demand both sides
    return args


def test_het_rollout_equals_its_groups_in_lockstep():
    """Replicas at t = 1, 8 and 41 in one batch (H=16: the later groups'
    rings have wrapped, and t crosses the travel-time window W=7), stepped
    30 times with the time tensor, equal leaf for leaf and bit for bit the
    same groups stepped alone with an int ``t`` (deterministic)."""
    scn = torch_build(**scenario_args("butterfly_scC"), history_window=16)
    ep = scn.engine_params
    assert scn.avg_tt_window == 7
    parts = [simulate(scn, ep, scn.init_state(2), n, record=False)[0] for n in (0, 7, 40)]
    het = concat_states(parts)
    assert het.t.dtype == torch.int32 and het.t.tolist() == [1, 1, 8, 8, 41, 41]
    for _ in range(30):
        het, _ = step_fn(scn, ep, het)
        parts = [step_fn(scn, ep, p)[0] for p in parts]
    ref = concat_states(parts)
    for f in dataclasses.fields(het):
        assert torch.equal(getattr(het, f.name), getattr(ref, f.name)), f.name
    assert float(het.cum_out.sum()) > 0


# -- the env core against the JAX core ---------------------------------------------

def random_actions(spec, rng, scale=1.5):
    out = {}
    if spec.sep_ids:
        out["sep"] = rng.uniform(0, scale * spec.sep_total_width).astype(np.float32)
    for i, a in enumerate(spec.gate_ids):
        out[a] = rng.uniform(0, scale * spec.gate_link_widths[i]).astype(np.float32)
    return out


def batch_actions(spec, rng, B):
    one = [random_actions(spec, rng) for _ in range(B)]
    return {k: np.stack([a[k] for a in one]) for k in one[0]}


def jax_het_states(jcore, ep, steps, rng):
    """One JAX state per entry of ``steps``, each stepped that many RL steps
    under random actions, stacked into a batch whose ``t`` differ."""
    step = jax.jit(lambda st, a, ep: jcore._step_impl(st, a, ep)[0])
    states = []
    for b, n in enumerate(steps):
        st, _ = jcore.reset(jax.random.PRNGKey(b))
        e = ep if ep.length.ndim == 1 else jax.tree_util.tree_map(lambda x: x[b], ep)
        for _ in range(n):
            st = step(st, random_actions(jcore.spec, rng), e)
        states.append(st)
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *states)


def assert_step_matches(got, want, name):
    (g_st, g_obs, g_r, g_done), (w_st, w_obs, w_r, w_done) = got, want
    assert g_st.t.dtype == torch.int32
    np.testing.assert_array_equal(g_st.t.numpy(), np.asarray(w_st.t))
    np.testing.assert_array_equal(g_done.numpy(), np.asarray(w_done))
    for k, v in w_obs.items():
        np.testing.assert_allclose(g_obs[k].numpy(), np.asarray(v).reshape(g_obs[k].shape),
                                   rtol=RTOL, atol=0, err_msg=f"{name} obs {k}")
    for k, v in w_r.items():
        np.testing.assert_allclose(g_r[k].numpy(), np.asarray(v), rtol=RTOL, atol=0,
                                   err_msg=f"{name} reward {k}")
    for k, v in numpy_leaves(w_st, skip=("key", "t")).items():
        np.testing.assert_allclose(getattr(g_st, k).numpy(), v, rtol=RTOL, atol=0,
                                   err_msg=f"{name} state {k}")


def both_scenarios(name, **kw):
    args = scenario_args(name)
    js = jax_build(**copy.deepcopy(args), use_pallas=True, pallas_interpret=True, **kw)
    return js, torch_build(**copy.deepcopy(args), **kw)


@pytest.mark.parametrize("name", ["butterfly_scC", "long_corridor"])
def test_het_batch_step_matches_jax(float32_jax, name):
    """Replicas at three different times, converted from JAX states,
    through ``batch_step(lockstep=False)`` against the JAX core's, 6 RL
    steps of 2 engine steps each from the JAX batch's state, deterministic,
    rtol 1e-6."""
    js, ts = both_scenarios(name)
    kw = dict(obs_mode="option5", action_gap=2, stochastic=False, global_reward_coef=0.1)
    jcore = JaxEnvCore(js, jax_agent_spec(js), **kw)
    tcore = PedNetEnvCore(ts, build_agent_spec(ts), **kw)
    rng = np.random.default_rng(7)
    states = jax_het_states(jcore, js.engine_params, (0, 4, 13), rng)
    assert np.asarray(states.t).tolist() == [1, 9, 27]
    for _ in range(6):
        actions = batch_actions(jcore.spec, rng, 3)
        want = jcore.batch_step(states, actions, lockstep=False)
        tst = network_state_from_jax(numpy_leaves(states))
        got = tcore.batch_step(tst, tensors_from_jax(actions), lockstep=False)
        assert_step_matches(got, want, name)
        states = want[0]
    assert float(np.asarray(states.num_peds).sum()) > 0


def test_het_batch_step_randomized_matches_jax(float32_jax):
    """The same through ``batch_step_randomized(lockstep=False)`` with
    JAX-drawn per-replica EngineParams (per-replica demand and OD tables:
    the column gather's ``[B, N, T+1]`` layout)."""
    js = JaxGenerator().build_od_randomizable("butterfly_scC", use_pallas=True,
                                              pallas_interpret=True)
    ts = NetworkEnvGenerator().build_od_randomizable("butterfly_scC")
    kw = dict(obs_mode="option2", stochastic=False)
    jcore = JaxEnvCore(js, jax_agent_spec(js), **kw)
    tcore = PedNetEnvCore(ts, build_agent_spec(ts), **kw)
    eps = jax_draws(js, jax.random.PRNGKey(9), 3)
    teps = engine_params_from_jax(numpy_leaves(eps))
    assert teps.demand.dim() == 3 and teps.od_table.dim() == 3
    rng = np.random.default_rng(8)
    states = jax_het_states(jcore, eps, (2, 11, 30), rng)
    for _ in range(8):
        actions = batch_actions(jcore.spec, rng, 3)
        want = jcore.batch_step_randomized(states, actions, eps, lockstep=False)
        got = tcore.batch_step_randomized(network_state_from_jax(numpy_leaves(states)),
                                          tensors_from_jax(actions), teps, lockstep=False)
        assert_step_matches(got, want, "randomized")
        states = want[0]
    assert float(np.asarray(states.virt_arr_cum).sum()) > 0


def test_het_step_across_the_horizon_matches_jax(float32_jax):
    """One replica three steps short of the horizon beside one mid-run and
    one at the start, ``action_gap=7``: the late replica's demand and OD
    columns clamp, its ``done`` is set alone, and the step matches JAX's."""
    js, ts = both_scenarios("butterfly_scC")
    kw = dict(obs_mode="option2", action_gap=7, stochastic=False)
    jcore = JaxEnvCore(js, jax_agent_spec(js), **kw)
    tcore = PedNetEnvCore(ts, build_agent_spec(ts), **kw)
    rng = np.random.default_rng(5)
    states = jax_het_states(jcore, js.engine_params, (0, 3, 6), rng)
    t = np.asarray(states.t).copy()
    t[2] = js.simulation_steps - 3
    states = states.replace(t=jnp.asarray(t))
    actions = batch_actions(jcore.spec, rng, 3)
    want = jcore.batch_step(states, actions, lockstep=False)
    got = tcore.batch_step(network_state_from_jax(numpy_leaves(states)),
                           tensors_from_jax(actions), lockstep=False)
    assert got[3].tolist() == [False, False, True]
    assert got[0].t.tolist() == [8, 29, js.simulation_steps + 4]
    assert_step_matches(got, want, "across the horizon")


def make_env_core(**kw):
    ts = torch_build(**scenario_args("butterfly_scC"))
    return PedNetEnvCore(ts, build_agent_spec(ts), **kw)


def test_lockstep_shared_t_matches_per_replica_t():
    """The counterpart of tests/test_env.py's test of the same name: while
    all replicas share ``t``, the int-``t`` lockstep path and the
    tensor-``t`` path (``lockstep=False``) give identical states and
    rewards, stochastic draws included (atol 0)."""
    core = make_env_core(obs_mode="option2", stochastic=True)
    B = 6
    s_fast, _ = core.batch_reset(B)
    s_het, _ = core.batch_reset(B)
    s_het = s_het.replace(t=torch.full((B,), 1, dtype=torch.int32))
    actions = {"gate_2": torch.from_numpy(np.tile(
        core.spec.gate_link_widths[0][None, :].astype(np.float32), (B, 1)))}
    g_fast, g_het = (torch.Generator().manual_seed(3) for _ in range(2))
    for _ in range(12):
        s_fast, o_fast, r_fast, d_fast = core.batch_step(s_fast, actions, g_fast, lockstep=True)
        s_het, o_het, r_het, d_het = core.batch_step(s_het, actions, g_het, lockstep=False)
    assert s_het.t.tolist() == [s_fast.t] * B == [13] * B
    for name in ("density", "cum_in", "cum_in_ring", "tt_ring", "avg_tt"):
        assert torch.equal(getattr(s_fast, name), getattr(s_het, name)), name
    for k in r_fast:
        assert torch.equal(r_fast[k], r_het[k]) and torch.equal(o_fast[k], o_het[k])
    assert torch.equal(d_fast, d_het)
    assert float(s_fast.cum_in.sum()) > 0
    # a tensor-t batch in lockstep passes the guard of lockstep=True untouched
    s_ok, o_ok, r_ok, _ = core.batch_step(s_het, actions, g_het, lockstep=True)
    assert s_ok.t.tolist() == [14] * B and bool(torch.isfinite(o_ok["gate_2"]).all())


def test_lockstep_violation_poisons_outputs():
    """The counterpart of tests/test_env.py's test of the same name: a
    batch whose times differ, stepped with ``lockstep=True``, comes back
    with NaN observations and rewards and a negative clock; a well-formed
    batch through the same core stays clean."""
    core = make_env_core(obs_mode="option1", stochastic=True)
    B = 4
    states, _ = core.batch_reset(B)
    actions = {"gate_2": torch.from_numpy(np.tile(
        core.spec.gate_link_widths[0][None, :].astype(np.float32), (B, 1)))}
    states = states.replace(t=torch.tensor([4, 1, 1, 1], dtype=torch.int32))
    gen = torch.Generator().manual_seed(5)
    states, obs, rewards, done = core.batch_step(states, actions, gen)
    assert bool(torch.isnan(obs["gate_2"]).all()) and bool(torch.isnan(rewards["gate_2"]).all())
    assert states.t.dtype == torch.int32 and bool((states.t < 0).all())
    states2, _ = core.batch_reset(B)
    states2, obs2, r2, _ = core.batch_step(states2, actions, gen)
    assert not bool(torch.isnan(obs2["gate_2"]).any())


def test_interop_keeps_a_per_replica_t(float32_jax):
    """A vmapped JAX state whose ``t`` differ crosses as the int32 ``[B]``
    tensor; one whose ``t`` agree as the shared int; ``to`` and ``take``
    carry the tensor."""
    js, _ = both_scenarios("butterfly_scC")
    states = jax.vmap(js.init_state)(jax.random.split(jax.random.PRNGKey(0), 3))
    assert network_state_from_jax(numpy_leaves(states)).t == 1
    st = network_state_from_jax(numpy_leaves(states.replace(t=jnp.asarray([1, 9, 4]))))
    assert st.t.dtype == torch.int32 and st.t.tolist() == [1, 9, 4]
    assert st.to("cpu").t.tolist() == [1, 9, 4]
    sub = st.take(slice(1, 3))
    assert sub.t.tolist() == [9, 4] and sub.batch == 2
    sub.cum_in_ring += 1  # a copy: the source's rings stay
    assert float(st.cum_in_ring.sum()) == 0


def test_profiling_hetero_path_on_cpu():
    """The profiling module's ``hetero`` path (replicas set aside at
    different times, ``lockstep=False``) end to end on the CPU: no device
    kernels, and the lockstep env timed beside it in turns."""
    from pednstream_tpu_torch.profiling import run

    out = run("hetero", device="cpu", batch=8, warm=1, steps=2)
    assert out["path"] == "hetero" and out["batch"] == 8 and out["wall_ms_per_step"] > 0
    assert out["kernels_per_step"] == 0 and out["top_kernels"] == []
    turns = out["wall_ms_per_step_in_turns"]
    assert [name for name, _ in turns] == ["lockstep", "hetero", "hetero", "lockstep"]
    assert all(ms > 0 for _, ms in turns)
