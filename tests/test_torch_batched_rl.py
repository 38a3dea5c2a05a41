"""The port's batched trainers on the CPU (butterfly_scC, 8 replicas).

BatchedPPOTrainer: the update half fed one JAX rollout's trajectory (its
starting carries, an episode boundary inside it and the JAX index sets)
updates the parameters as JAX's ``_agent_update`` does (rtol 1e-4), with
the KL mask off and engaged; a whole port iteration for the mlp and
attention families with randomized worlds, and a rollout that crosses an
episode boundary.  BatchedSACTrainer: ``_rms_update`` and ``_sac_update``
(noises fed in) against JAX's, iterations past warm-up with the replay
ring wrapping, and ``export`` loading through both packages'
``build_agents`` + ``load_all_agents``."""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pednstream_tpu.env import PedNetParallelEnv as JaxEnv
from pednstream_tpu.rl.batched_ppo import BatchedPPOTrainer as JaxPPOTrainer
from pednstream_tpu.rl.batched_sac import BatchedSACTrainer as JaxSACTrainer
from pednstream_tpu_torch import env as port_env
from pednstream_tpu_torch.interop import params_from_flax
from pednstream_tpu_torch.rl.batched_ppo import BatchedPPOTrainer
from pednstream_tpu_torch.rl.batched_sac import BatchedSACTrainer
from pednstream_tpu_torch.rl.optim import adam_init

# the port runs on the card unless asked: every CPU test asks
PedNetParallelEnv = partial(port_env.PedNetParallelEnv, device="cpu")

torch.set_num_threads(1)

FWD = dict(rtol=1e-5, atol=1e-6)
UPD = dict(rtol=1e-4, atol=1e-6)
# normalized observations keep the tanh input layers out of saturation,
# where both packages' gradients are rounding noise that Adam would
# turn into lr-sized steps of either sign
ENV = dict(obs_mode="option2", normalize_obs=True, action_gap=5, history_window=16, seed=0)
B, T = 8, 4
PPO = dict(num_envs=B, rollout_len=T, net_type="attention", hidden_dim=16, gate_anchor="open",
           max_delta=4.0)
AID = "gate_2"


@pytest.fixture(autouse=True)
def float32_jax():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


@pytest.fixture(scope="module")
def env():
    return PedNetParallelEnv("butterfly_scC", **ENV)


@pytest.fixture(scope="module")
def jax_rollout():
    """One JAX rollout and what the JAX iteration feeds ``_agent_update``
    (GAE, normalized advantages, the rollout-start carries, the update
    key), with replicas 0-2 ending an episode after step 1."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    jenv = JaxEnv("butterfly_scC", **ENV)
    jtr = JaxPPOTrainer(jenv.core, **PPO)
    ts = jtr.init(jax.random.PRNGKey(0))
    _, k_roll, k_perm = jax.random.split(ts.key, 3)
    _, obs, _, ccar, _, traj = jax.jit(jtr._rollout)(ts, k_roll)
    done = np.asarray(traj["done"]).copy()
    done[1, :3] = 1.0
    o_last = jtr._shape_obs(AID, jtr._agent_obs(obs, AID))
    last_v, _ = jtr._apply_value(AID, ts.value_params[AID], o_last, ccar[AID])
    adv, ret = jtr._gae(jtr.reward_scale * traj["reward"][AID], traj["value"][AID],
                        jnp.asarray(done), last_v)
    adv = (adv - adv.mean()) / (adv.std() + 1e-8)
    out = dict(jtr=jtr, ts=ts, obs=traj["obs"][AID], done=done, delta=traj["delta"][AID],
               logp=traj["logp"][AID], adv=adv, ret=ret, key=jax.random.fold_in(k_perm, 0),
               carry0=(ts.actor_carry[AID], ts.critic_carry[AID]))
    jax.config.update("jax_enable_x64", prev)
    return jax.device_get(out)


def _idx_sets(jtr, key):
    """The JAX trainer's index sets: one permutation per epoch, sliced."""
    mb = jtr.B // jtr.minibatches
    return np.stack([np.asarray(jax.random.permutation(jax.random.fold_in(key, e), jtr.B))
                     [m * mb:(m + 1) * mb]
                     for e in range(jtr.epochs) for m in range(jtr.minibatches)])


def _count(opt_state) -> int:
    return int([x for x in jax.tree_util.tree_leaves(opt_state)
                if np.asarray(x).dtype == np.int32][0])


@pytest.mark.parametrize("kl_target", [10.0, 1e-5])
def test_ppo_update_matches_jax(env, jax_rollout, kl_target):
    """Parameters, loss, KL and the number of updates applied after the
    epochs x minibatches updates (16 of them with a large kl_target; the
    mask stops them after the first KL above a tiny one)."""
    r = jax_rollout
    jtr, ts = r["jtr"], r["ts"]
    jtr.kl_target = kl_target
    pv0 = {"p": ts.params[AID], "v": ts.value_params[AID]}
    pv, opt, loss, kl = jax.jit(partial(jtr._agent_update, AID))(
        pv0, ts.opt_states[AID], r["obs"], jnp.asarray(r["done"]), r["carry0"], r["delta"],
        r["logp"], r["adv"], r["ret"], r["key"])

    tr = BatchedPPOTrainer(env.core, **PPO, kl_target=kl_target)
    policy, value = tr._nets(AID)
    policy.load_state_dict(params_from_flax(policy, pv0["p"]))
    value.load_state_dict(params_from_flax(value, pv0["v"]))
    topt = adam_init([*policy.parameters(), *value.parameters()])

    def t(x):
        return torch.from_numpy(np.array(x))

    carry0 = tuple(tuple(t(x) for x in c) for c in r["carry0"])
    tloss, tkl = tr._agent_update(
        AID, (policy, value), topt, t(r["obs"]), t(r["done"]), carry0, t(r["delta"]),
        t(r["logp"]), t(r["adv"]), t(r["ret"]), t(_idx_sets(jtr, r["key"])).long())
    n = _count(opt)
    assert int(topt.count) == n
    assert n == 16 if kl_target > 1 else 1 <= n < 16
    np.testing.assert_allclose(float(tloss), float(loss), **UPD)
    np.testing.assert_allclose(float(tkl), float(kl), **UPD)
    for mod, tree in ((policy, pv["p"]), (value, pv["v"])):
        want = params_from_flax(mod, jax.device_get(tree))
        for k, p in mod.state_dict().items():
            if "key.bias" in k:  # zero true gradient: Adam steps on rounding noise
                assert float((p - want[k]).abs().max()) <= 2 * n * tr.lr
                continue
            np.testing.assert_allclose(p.numpy(), want[k].numpy(), **UPD, err_msg=k)


def _flat(modules):
    return torch.cat([p.detach().reshape(-1).clone() for m in modules for p in m.parameters()])


@pytest.mark.parametrize("net_type", ["mlp", "attention"])
def test_ppo_iteration_and_episode_boundary(env, net_type):
    """A whole port iteration with randomized worlds; then a rollout
    started 15 engine steps before the horizon ends the episode at its
    last RL step: fresh states, fresh carries, fresh worlds."""
    tr = BatchedPPOTrainer(env.core, **{**PPO, "net_type": net_type}, randomize=True)
    ts = tr.init(seed=0)
    before = _flat([ts.params[AID], ts.value_params[AID]])
    ts, m = tr.train_iteration(ts)
    assert ts.iteration == 1 and ts.env_states.t == 1 + T * ENV["action_gap"]
    assert set(m) == {f"{AID}/loss", f"{AID}/kl", f"{AID}/reward"}
    assert all(np.isfinite(v) for v in m.values()) and m[f"{AID}/reward"] < 0
    assert not torch.equal(before, _flat([ts.params[AID], ts.value_params[AID]]))
    kc = ts.engine_params.k_critical
    assert kc.shape == (B, env.scn.n_links) and not torch.equal(kc[0], kc[1])

    steps = env.scn.simulation_steps
    ts.env_states = ts.env_states.replace(t=steps - 15)
    worlds = ts.engine_params
    env_states, obs, acar, ccar, eps, traj = tr._rollout(ts)
    np.testing.assert_array_equal(traj["done"].numpy(), np.repeat([[0.], [0.], [0.], [1.]], B, 1))
    assert env_states.t == 1 and float(env_states.cum_in.abs().sum()) == 0.0
    fresh = tr._batched_carry(AID)
    for got, want in zip((*acar[AID], *ccar[AID]), (*fresh, *fresh)):
        assert torch.equal(got, want)
    if net_type == "attention":
        assert float(ts.actor_carry[AID][1].abs().sum()) > 0  # the carry had moved
    assert not torch.equal(eps.k_critical, worlds.k_critical)
    ts, m = tr._learn(ts, (env_states, obs, acar, ccar, eps, traj))
    assert all(bool(torch.isfinite(v)) for v in m.values())


def test_mesh_is_queue_4(env):
    for cls in (BatchedPPOTrainer, BatchedSACTrainer):
        with pytest.raises(NotImplementedError, match="ROADMAP queue 4"):
            cls(env.core, mesh=object())


# -- BatchedSACTrainer -------------------------------------------------------------

def test_rms_update_matches_jax():
    rng = np.random.default_rng(0)
    mean, var = rng.normal(0, 1, 6).astype(np.float32), rng.uniform(0.5, 2, 6).astype(np.float32)
    batch = rng.normal(2, 3, (9, 6)).astype(np.float32)
    count = np.float32(37.0001)
    want = JaxSACTrainer._rms_update(*map(jnp.asarray, (mean, var, count, batch)))
    got = BatchedSACTrainer._rms_update(*map(torch.from_numpy, (mean, var, np.array(count),
                                                                 batch)))
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **FWD)


def test_sac_update_matches_jax(env):
    """One ``_sac_update`` from the same parameters, with the standard
    normals JAX draws from its key fed in: losses, actor, critic, target,
    log_alpha."""
    jenv = JaxEnv("butterfly_scC", **ENV)
    jtr = JaxSACTrainer(jenv.core, num_envs=B, hidden_dim=16)
    tr = BatchedSACTrainer(env.core, num_envs=B, hidden_dim=16)
    meta = tr.agents[AID]
    S, O, A, n = tr.S, meta["obs_dim"], meta["act_dim"], 16
    k1, k2, key = jax.random.split(jax.random.PRNGKey(4), 3)
    ap = jtr.actor[AID].init(k1, jnp.zeros((S, O)))
    cp = jtr.critic.init(k2, jnp.zeros((S, O)), jnp.zeros((A,)))
    p = {"actor": ap, "critic": cp, "target": cp, "log_alpha": jnp.asarray(0.1)}
    opt = {"actor": jtr.actor_tx.init(ap), "critic": jtr.critic_tx.init(cp),
           "alpha": jtr.alpha_tx.init(jnp.zeros(()))}
    rng = np.random.default_rng(5)
    batch = (rng.normal(0, 1, (n, S, O)).astype(np.float32),
             rng.uniform(-1, 1, (n, A)).astype(np.float32),
             rng.normal(0, 1, n).astype(np.float32),
             rng.normal(0, 1, (n, S, O)).astype(np.float32),
             (rng.random(n) < 0.3).astype(np.float32))
    jp, _, a_loss, c_loss = jax.jit(partial(jtr._sac_update, AID))(
        p, opt, tuple(map(jnp.asarray, batch)), key)

    init = tr.init(seed=1).params[AID]
    for name in ("actor", "critic", "target"):
        init[name].load_state_dict(params_from_flax(init[name], jax.device_get(p[name])))
    with torch.no_grad():
        init["log_alpha"].fill_(0.1)
    topt = {"actor": adam_init(list(init["actor"].parameters())),
            "critic": adam_init(list(init["critic"].parameters())),
            "alpha": adam_init([init["log_alpha"]])}
    ka, kb = jax.random.split(key)
    draw = jax.vmap(lambda k: jax.random.normal(k, (A,)))
    noise = tuple(torch.from_numpy(np.array(draw(jax.random.split(k, n)))) for k in (ka, kb))
    got = tr._sac_update(AID, init, topt, tuple(map(torch.from_numpy, batch)), noise)
    np.testing.assert_allclose(float(got[0]), float(a_loss), **UPD)
    np.testing.assert_allclose(float(got[1]), float(c_loss), **UPD)
    np.testing.assert_allclose(float(init["log_alpha"].detach()), float(jp["log_alpha"]), **UPD)
    for name in ("actor", "critic", "target"):
        want = params_from_flax(init[name], jax.device_get(jp[name]))
        for k, v in init[name].state_dict().items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), **UPD, err_msg=f"{name} {k}")


@pytest.fixture(scope="module")
def sac_trained(env):
    tr = BatchedSACTrainer(env.core, num_envs=B, collect_steps=4, updates_per_iter=4,
                           batch_size=32, buffer_capacity=128, warmup_transitions=64,
                           randomize=True, randomize_fraction=0.5, max_delta=4.0)
    ts = tr.init(seed=0)
    actor0 = _flat([ts.params[AID]["actor"]])
    metrics = []
    for _ in range(5):
        ts, m = tr.train_iteration(ts)
        metrics.append(m)
    return tr, ts, metrics, actor0


def test_sac_iterations_past_warmup(sac_trained):
    """No update before the ring holds warmup_transitions, finite metrics
    and moving parameters after; the ring wraps.  Before warm-up the port
    reports NaN losses ("not ready") where the JAX trainer, which runs
    its updates masked, reports the losses of the unchanged parameters."""
    tr, ts, metrics, actor0 = sac_trained
    assert np.isnan(metrics[0][f"{AID}/actor_loss"]) and metrics[0]["buffer_size"] == 32
    for m in metrics[1:]:
        assert all(np.isfinite(v) for v in m.values()), m
    assert not torch.equal(actor0, _flat([ts.params[AID]["actor"]]))
    assert ts.size == 128 and ts.ptr == (B * 4 * 5) % 128 and ts.iteration == 5
    eps = ts.engine_params.k_critical
    assert torch.equal(eps[B - 1], tr.scn.engine_params.k_critical)  # nominal half
    assert float(ts.buffers[AID]["r"].abs().sum()) > 0


def test_sac_export_loads_in_both_packages(env, sac_trained, tmp_path):
    """export -> build_agents + load_all_agents (with the normalization
    stats) in the port and in the JAX package: the same deterministic
    actions on the same normalized observation."""
    from pednstream_tpu.rl.rl_utils import RunningNormalizeWrapper as JaxWrapper
    from pednstream_tpu.rl.rl_utils import load_all_agents as jax_load
    from pednstream_tpu.rl.train import build_agents as jax_build
    from pednstream_tpu_torch.rl.rl_utils import RunningNormalizeWrapper, load_all_agents
    from pednstream_tpu_torch.rl.train import build_agents

    tr, ts, _, _ = sac_trained
    tr.export(ts, str(tmp_path), extra={"val_reward": -1.0})
    wrapped = RunningNormalizeWrapper(env)
    agents = load_all_agents(build_agents(wrapped, algo="sac", device="cpu"), str(tmp_path),
                             env=wrapped)
    jwrapped = JaxWrapper(JaxEnv("butterfly_scC", **ENV))
    jagents = jax_load(jax_build(jwrapped, algo="sac"), str(tmp_path), env=jwrapped)
    assert wrapped._frozen and jwrapped._frozen and set(agents) == set(jagents) == {AID}
    np.testing.assert_array_equal(wrapped.obs_rms[AID].mean, jwrapped.obs_rms[AID].mean)
    obs, _ = wrapped.reset()
    for a in (agents[AID], jagents[AID]):
        assert a.max_delta == 4.0 and a.gate_anchor == "open"
    got = agents[AID].absolute_action(obs[AID], agents[AID].take_action(obs[AID], False))
    want = jagents[AID].absolute_action(obs[AID], jagents[AID].take_action(obs[AID], False))
    np.testing.assert_allclose(got, want, **FWD)


def test_profiling_ppo_path_on_cpu():
    """``python -m pednstream_tpu_torch.profiling ppo`` drives the trainer
    path (45_intersections, attention, randomized worlds) end to end; on a
    CPU device it times both halves and finds no device kernels."""
    from pednstream_tpu_torch.profiling import run

    out = run("ppo", device="cpu", batch=4, warm=1, steps=1, rollout_len=2)
    assert out["path"] == "ppo" and out["engine_steps_per_iteration"] == 2 * 15
    for half in ("rollout", "update"):
        assert out[half]["wall_ms"] > 0
        assert out[half]["kernels"] == 0 and out[half]["top_kernels"] == []
    assert out["rollout"]["kernels_per_rl_step"] == 0
    assert out["wall_ms_per_iteration"] == out["rollout"]["wall_ms"] + out["update"]["wall_ms"]
