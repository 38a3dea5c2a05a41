"""The port's RL environment (pednstream_tpu_torch.env) on the CPU: the
counterparts of tests/test_env.py (PettingZoo API conformance, reset
determinism, action clipping, separator coupling, the batched env), and
observations, rewards and whole RL steps against the JAX env core in
deterministic mode, with the scenario's and with JAX-drawn per-replica
EngineParams.  JAX steps take EngineParams as a jit argument and read the
rings through the Pallas kernel in interpret mode, the port's read."""

import copy

import numpy as np
import pytest
import torch

import jax

from pednstream_tpu.env.agents import build_agent_spec as jax_agent_spec
from pednstream_tpu.env.core import PedNetEnvCore as JaxEnvCore
from pednstream_tpu.generator import NetworkEnvGenerator as JaxGenerator
from pednstream_tpu.randomize import randomize_engine_params_batched as jax_draws
from pednstream_tpu.scenario import build_scenario as jax_build
from pednstream_tpu_torch.env import PedNetEnvCore, PedNetParallelEnv, build_agent_spec
from pednstream_tpu_torch.generator import NetworkEnvGenerator
from pednstream_tpu_torch.interop import (engine_params_from_jax, network_state_from_jax,
                                          numpy_leaves, tensors_from_jax)
from pednstream_tpu_torch.scenario import build_scenario as torch_build

torch.set_num_threads(1)

RTOL = 1e-6  # the single-step tolerance of tests/test_torch_engine.py


@pytest.fixture(autouse=True)
def float32_jax():
    """Another test file in the same worker may have switched JAX to
    float64 for the session; these comparisons are float32."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def make_env(**kw):
    kw.setdefault("dataset", "butterfly_scC")
    kw.setdefault("seed", 42)
    return PedNetParallelEnv(**kw)


# -- counterparts of tests/test_env.py ----------------------------------------

def test_pettingzoo_parallel_api():
    from pettingzoo.test import parallel_api_test

    parallel_api_test(make_env(obs_mode="option2"), num_cycles=30)


def test_reset_determinism():
    env = make_env(obs_mode="option2", stochastic=True)
    trajs = []
    for _ in range(2):
        env.seed(123)
        obs, _ = env.reset()
        rows = [np.concatenate([o.ravel() for o in obs.values()])]
        for _ in range(10):
            actions = {a: (env.action_space(a).low + env.action_space(a).high) / 2
                       for a in env.possible_agents}
            obs, *_ = env.step(actions)
            rows.append(np.concatenate([o.ravel() for o in obs.values()]))
        trajs.append(np.stack(rows))
    np.testing.assert_array_equal(trajs[0], trajs[1])
    assert np.abs(trajs[0][-1]).sum() > 0


def test_action_rate_clipping():
    """Gate width cannot move faster than 0.25*unit_time m/step
    (pz_pednet_env.py:84-85, builders.py:297-311)."""
    env = make_env(obs_mode="option2", stochastic=False)
    env.reset()
    links = env.spec_agents.gate_links[0]
    before = env._state.back_gate[0].numpy()[links]
    env.step({"gate_2": np.zeros(len(links), dtype=np.float32)})  # slam gates shut
    after = env._state.back_gate[0].numpy()[links]
    max_delta = 0.25 * env.scn.unit_time
    assert np.all(before - after <= max_delta + 1e-6)
    assert np.all(after >= 0)
    # each gate closes by exactly the clip, or to 0 if narrower
    np.testing.assert_allclose(after, np.maximum(before - max_delta, 0.0), atol=1e-6)


def test_separator_coupling():
    """Separator width reallocates the reverse direction to keep the total
    corridor width (link.py:462-478)."""
    env = PedNetParallelEnv("long_corridor", seed=1, stochastic=False)
    assert "sep_2_3" in env.possible_agents
    env.reset()
    fwd = env.scn.topo.link_id_to_idx[(2, 3)]
    rev = env.scn.topo.link_id_to_idx[(3, 2)]
    total = float(env.scn.topo.link_params.width[fwd])
    env.step({"sep_2_3": np.array([total - 1.5], dtype=np.float32)})
    sw = env._state.sep_width[0].numpy()
    assert abs(sw[fwd] + sw[rev] - total) < 1e-6
    bg = env._state.back_gate[0].numpy()
    assert abs(bg[fwd] - sw[fwd]) < 1e-6 and abs(bg[rev] - sw[rev]) < 1e-6


def test_batched_env():
    """Replicas step in lockstep with leading-B observations, rewards and
    done; stochastic trajectories diverge across the batch."""
    env = make_env(obs_mode="option1", stochastic=True)
    B = 8
    states, obs = env.core.batch_reset(B)
    assert obs["gate_2"].shape == (B, 3 * len(env.spec_agents.gate_links[0]))
    actions = {"gate_2": torch.from_numpy(np.tile(
        env.spec_agents.gate_link_widths[0][None, :].astype(np.float32), (B, 1)))}
    gen = torch.Generator().manual_seed(0)
    states, obs, rewards, done = env.core.batch_step(states, actions, gen)
    assert states.t == 2 and states.batch == B
    assert rewards["gate_2"].shape == (B,) and done.shape == (B,) and not done.any()
    for _ in range(30):
        states, obs, rewards, done = env.core.batch_step(states, actions, gen)
    assert not torch.allclose(states.density[0], states.density[1])
    with pytest.raises(NotImplementedError):
        env.core.batch_step(states, actions, gen, lockstep=False)


def test_reset_randomize_rebuilds_the_world():
    """reset(options={"randomize": True}) rebuilds the scenario through
    the host-side randomization (env_loader.py:160-181) and steps on."""
    env = make_env(obs_mode="option3", stochastic=False)
    nominal = env.scn
    obs, _ = env.reset(options={"randomize": True})
    assert env.scn is not nominal and env.core.scn is env.scn
    assert env.possible_agents == ["gate_2"]
    assert not all(torch.equal(getattr(env.scn.engine_params, k), v)
                   for k, v in vars(nominal.engine_params).items()
                   if getattr(env.scn.engine_params, k).shape == v.shape)
    obs, rewards, term, trunc, info = env.step({})
    assert obs["gate_2"].shape == env.observation_space("gate_2").shape
    assert np.isfinite(rewards["gate_2"]) and info["gate_2"]["step"] == 2


def test_render_and_save_wait_for_their_slice():
    env = make_env(render_mode="human")
    env.reset()
    with pytest.raises(NotImplementedError):
        env.render()
    with pytest.raises(NotImplementedError):
        env.save("run")
    assert make_env().render() is None  # no render mode: nothing to do


# -- against the JAX env core --------------------------------------------------

def scenario_args(name, seed=3):
    args = NetworkEnvGenerator().scenario_args(name)
    if args["params"].get("seed") is None:
        args["params"]["seed"] = seed  # unseeded datasets: same demand both sides
    return args


def both_scenarios(name):
    args = scenario_args(name)
    js = jax_build(**copy.deepcopy(args), use_pallas=True, pallas_interpret=True)
    ts = torch_build(**copy.deepcopy(args))
    return js, ts


def random_actions(spec, rng, scale=1.5):
    """Actions drawn beyond each agent's bounds (so rate and range clips
    both engage), as one replica's numpy dict."""
    out = {}
    if spec.sep_ids:
        out["sep"] = rng.uniform(0, scale * spec.sep_total_width).astype(np.float32)
    for i, a in enumerate(spec.gate_ids):
        out[a] = rng.uniform(0, scale * spec.gate_link_widths[i]).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def trajectories():
    """Deterministic JAX env-core trajectories (option1, action_gap 1)
    under random actions: ``{dataset: (js, ts, [states])}``, one state
    kept every 8 RL steps up to step 48."""
    out = {}
    for name in ("butterfly_scC", "long_corridor"):
        prev = jax.config.jax_enable_x64
        jax.config.update("jax_enable_x64", False)
        js, ts = both_scenarios(name)
        core = JaxEnvCore(js, jax_agent_spec(js), stochastic=False)
        step = jax.jit(lambda st, a, ep, core=core: core._step_impl(st, a, ep)[0])
        rng = np.random.default_rng(1)
        st, _ = core.reset(jax.random.PRNGKey(0))
        kept = []
        for i in range(48):
            st = step(st, random_actions(core.spec, rng), js.engine_params)
            if i % 8 == 7:
                kept.append(st)
        out[name] = (js, ts, kept)
        jax.config.update("jax_enable_x64", prev)
    return out


@pytest.mark.parametrize("mode,normalize,reward_mode,coef", [
    ("option1", False, "all", 0.0),
    ("option1", True, "reference_quirk", 0.0),
    ("option2", True, "all", 0.3),
    ("option3", True, "all", 0.0),
    ("option4", True, "reference_quirk", 0.3),
    ("option5", False, "all", 0.05),
])
def test_obs_and_rewards_match_jax(trajectories, mode, normalize, reward_mode, coef):
    """Each observation mode (normalized or not), both reward modes and
    the global shaping term, on states of the JAX trajectories, rtol 1e-6."""
    kw = dict(obs_mode=mode, normalize_obs=normalize, reward_mode=reward_mode,
              global_reward_coef=coef)
    for name, (js, ts, states) in trajectories.items():
        jcore = JaxEnvCore(js, jax_agent_spec(js), **kw)
        tcore = PedNetEnvCore(ts, build_agent_spec(ts), **kw)
        for st in states:
            tst = network_state_from_jax(numpy_leaves(st))
            want_obs, got_obs = jcore._observations(st), tcore._observations(tst)
            want_r, got_r = jcore._rewards(st), tcore._rewards(tst)
            assert got_obs.keys() == want_obs.keys() and got_r.keys() == want_r.keys()
            assert float(np.abs(np.asarray(st.inflow)).sum()) > 0
            for k, v in want_obs.items():
                np.testing.assert_allclose(got_obs[k][0].numpy(), np.asarray(v), rtol=RTOL,
                                           atol=0, err_msg=f"{name} obs {k}")
            for k, v in want_r.items():
                np.testing.assert_allclose(got_r[k][0].numpy(), np.asarray(v), rtol=RTOL,
                                           atol=0, err_msg=f"{name} reward {k}")


def _assert_step_matches(got, want, name):
    (g_st, g_obs, g_r, g_done), (w_st, w_obs, w_r, w_done) = got, want
    assert g_st.t == int(np.asarray(w_st.t).reshape(-1)[0])
    np.testing.assert_array_equal(g_done.numpy(), np.asarray(w_done).reshape(g_done.shape))
    for k, v in w_obs.items():
        np.testing.assert_allclose(g_obs[k].numpy(), np.asarray(v).reshape(g_obs[k].shape),
                                   rtol=RTOL, atol=0, err_msg=f"{name} obs {k}")
    for k, v in w_r.items():
        np.testing.assert_allclose(g_r[k].numpy(), np.asarray(v).reshape(g_r[k].shape),
                                   rtol=RTOL, atol=0, err_msg=f"{name} reward {k}")
    for k, v in numpy_leaves(w_st, skip=("key", "t")).items():
        np.testing.assert_allclose(getattr(g_st, k).numpy().reshape(v.shape), v, rtol=RTOL,
                                   atol=0, err_msg=f"{name} state {k}")


@pytest.mark.parametrize("name", ["butterfly_scC", "long_corridor"])
def test_rl_step_matches_jax(name):
    """Whole RL steps (action clipping and application, action_gap=2
    engine substeps, obs option5, reward shaping) of the port from the
    JAX core's state, against the JAX core, over 16 steps under random
    out-of-bounds actions, rtol 1e-6."""
    js, ts = both_scenarios(name)
    kw = dict(obs_mode="option5", action_gap=2, stochastic=False, global_reward_coef=0.1)
    jcore = JaxEnvCore(js, jax_agent_spec(js), **kw)
    tcore = PedNetEnvCore(ts, build_agent_spec(ts), **kw)
    step = jax.jit(lambda st, a, ep: jcore._step_impl(st, a, ep)[:4])
    rng = np.random.default_rng(2)
    st, _ = jcore.reset(jax.random.PRNGKey(0))
    for _ in range(16):
        actions = random_actions(jcore.spec, rng)
        want = step(st, actions, js.engine_params)
        got = tcore.step(network_state_from_jax(numpy_leaves(st)), actions)[:4]
        _assert_step_matches(got, want, name)
        st = want[0]
    assert float(np.asarray(st.virt_arr_cum).sum() + np.asarray(st.num_peds).sum()) > 0


def test_rl_step_past_the_horizon_matches_jax():
    """An RL step whose action_gap engine steps run past the horizon (as
    45_intersections' 700 steps under action_gap=15 do): the demand and
    OD-table reads clamp to the last column as the JAX engine's traced
    index does, and the step matches JAX's (rtol 1e-6) with done set."""
    js, ts = both_scenarios("butterfly_scC")
    kw = dict(obs_mode="option2", action_gap=7, stochastic=False)
    jcore = JaxEnvCore(js, jax_agent_spec(js), **kw)
    tcore = PedNetEnvCore(ts, build_agent_spec(ts), **kw)
    step = jax.jit(lambda st, a, ep: jcore._step_impl(st, a, ep)[:4])
    rng = np.random.default_rng(5)
    st, _ = jcore.reset(jax.random.PRNGKey(0))
    for _ in range(6):
        st = step(st, random_actions(jcore.spec, rng), js.engine_params)[0]
    st = st.replace(t=jax.numpy.asarray(js.simulation_steps - 3, st.t.dtype))
    actions = random_actions(jcore.spec, rng)
    want = step(st, actions, js.engine_params)
    got = tcore.step(network_state_from_jax(numpy_leaves(st)), actions)[:4]
    assert got[0].t == js.simulation_steps + 4 and bool(got[3])
    _assert_step_matches(got, want, "past the horizon")


def test_batch_step_randomized_matches_jax():
    """batch_step_randomized with JAX-drawn per-replica EngineParams,
    carried across by interop, against the JAX core's, from the JAX
    batch's state at each of 12 steps, rtol 1e-6."""
    jgen = JaxGenerator()
    js = jgen.build_od_randomizable("butterfly_scC", use_pallas=True, pallas_interpret=True)
    ts = NetworkEnvGenerator().build_od_randomizable("butterfly_scC")
    kw = dict(obs_mode="option2", stochastic=False)
    jcore = JaxEnvCore(js, jax_agent_spec(js), **kw)
    tcore = PedNetEnvCore(ts, build_agent_spec(ts), **kw)
    B = 3
    eps = jax_draws(js, jax.random.PRNGKey(9), B)
    teps = engine_params_from_jax(numpy_leaves(eps))
    states, _ = jcore.batch_reset(jax.random.split(jax.random.PRNGKey(0), B))
    rng = np.random.default_rng(3)
    for _ in range(12):
        one = [random_actions(jcore.spec, rng) for _ in range(B)]
        actions = {k: np.stack([a[k] for a in one]) for k in one[0]}
        want = jcore.batch_step_randomized(states, actions, eps)
        got = tcore.batch_step_randomized(network_state_from_jax(numpy_leaves(states)),
                                          tensors_from_jax(actions), teps)
        _assert_step_matches(got, want, "randomized")
        states = want[0]
    assert float(np.asarray(states.virt_arr_cum).sum()) > 0


def test_profiling_env_path_on_cpu():
    """The profiling module drives the randomized env path end to end; on
    a CPU device it times the steps and finds no device kernels."""
    from pednstream_tpu_torch.profiling import run

    out = run("env", device="cpu", batch=2, warm=1, steps=2)
    assert out["path"] == "env" and out["batch"] == 2 and out["steps"] == 2
    assert out["wall_ms_per_step"] > 0
    assert out["kernels_per_step"] == 0 and out["top_kernels"] == []
