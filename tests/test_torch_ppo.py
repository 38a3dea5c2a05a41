"""The port's PPO pieces against the JAX package on the CPU: the Gaussian
log-probability, GAE (the host copy exactly, the batched trainer's at
rtol 1e-5), the functional Adam against ``optax.chain(clip_by_global_norm,
adam)``, ``PPOAgent.update`` on one stored episode (the same epochs run
before the KL break, losses and parameters at rtol 1e-4) and checkpoints
crossing between the packages with the same deterministic actions."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from pednstream_tpu.rl import ppo as jppo
from pednstream_tpu.rl.batched_ppo import BatchedPPOTrainer as JaxPPOTrainer
from pednstream_tpu.rl.rl_utils import compute_gae as jax_gae
from pednstream_tpu_torch.interop import params_from_flax, params_to_flax
from pednstream_tpu_torch.rl import ppo as tppo
from pednstream_tpu_torch.rl.batched_ppo import BatchedPPOTrainer
from pednstream_tpu_torch.rl.optim import adam_init, adam_update
from pednstream_tpu_torch.rl.rl_utils import compute_gae

torch.set_num_threads(1)

FWD = dict(rtol=1e-5, atol=1e-6)
UPD = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(autouse=True)
def float32_jax():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def test_gaussian_logprob():
    rng = np.random.default_rng(0)
    mu, log_std, act = (rng.normal(0, 1, (7, 4)).astype(np.float32) for _ in range(3))
    want = jppo._gaussian_logprob(mu, log_std, act)
    got = tppo._gaussian_logprob(*map(torch.from_numpy, (mu, log_std, act)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)


def test_compute_gae_host_copy_exact():
    rng = np.random.default_rng(1)
    r, v = rng.normal(0, 5, 20), rng.normal(0, 5, 20)
    d = rng.random(20) < 0.2
    for args in ((r, v, 0.3, d), (r, v, -1.0, d, 0.9, 0.8)):
        for a, b in zip(compute_gae(*args), jax_gae(*args)):
            np.testing.assert_array_equal(a, b)


def test_batched_gae_matches_jax():
    """The trainer's [T, B] GAE with episode boundaries."""
    rng = np.random.default_rng(2)
    r, v = (rng.normal(0, 3, (6, 5)).astype(np.float32) for _ in range(2))
    d = (rng.random((6, 5)) < 0.25).astype(np.float32)
    last = rng.normal(0, 3, 5).astype(np.float32)
    hp = SimpleNamespace(gamma=0.99, lmbda=0.95)
    want = JaxPPOTrainer._gae(hp, *map(jnp.asarray, (r, v, d, last)))
    got = BatchedPPOTrainer._gae(hp, *map(torch.from_numpy, (r, v, d, last)))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **FWD)


def test_adam_matches_optax():
    """Three steps of clip_by_global_norm(0.5) + adam(1e-2) on two
    tensors; the second step's gradient norm is above the clip.  A masked
    step changes nothing."""
    rng = np.random.default_rng(3)
    params = {"a": rng.normal(0, 1, (3, 4)).astype(np.float32),
              "b": rng.normal(0, 1, (4,)).astype(np.float32)}
    scales = (0.05, 5.0, 0.1)
    grads = [{k: (s * rng.normal(0, 1, v.shape)).astype(np.float32) for k, v in params.items()}
             for s in scales]
    tx = optax.chain(optax.clip_by_global_norm(0.5), optax.adam(1e-2))
    jp, opt = jax.tree_util.tree_map(jnp.asarray, params), None
    opt = tx.init(jp)
    tp = [torch.from_numpy(params[k].copy()) for k in ("a", "b")]
    state = adam_init(tp)
    norms = []
    for g in grads:
        norms.append(float(np.sqrt(sum((x ** 2).sum() for x in g.values()))))
        upd, opt = tx.update(jax.tree_util.tree_map(jnp.asarray, g), opt)
        jp = optax.apply_updates(jp, upd)
        adam_update(tp, [torch.from_numpy(g[k]) for k in ("a", "b")], state, 1e-2,
                    max_norm=0.5)
        for k, t in zip(("a", "b"), tp):
            np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]), **UPD)
    assert norms[1] > 0.5 > norms[0]
    assert int(state.count) == 3
    before = [t.clone() for t in tp]
    mu = [m.clone() for m in state.mu]
    adam_update(tp, [torch.ones_like(t) for t in tp], state, 1e-2, max_norm=0.5,
                keep=torch.tensor(True))
    assert all(torch.equal(a, b) for a, b in zip(tp, before))
    assert all(torch.equal(a, b) for a, b in zip(state.mu, mu)) and int(state.count) == 3


# -- PPOAgent --------------------------------------------------------------------

AGENT = dict(obs_dim=16, act_dim=4, features_per_link=4, net_type="attention", hidden_dim=16,
             epochs=4, action_low=np.zeros(4, np.float32),
             action_high=np.full(4, 3.0, np.float32))
# the attention key bias shifts every score of a query equally, so its
# true gradient is zero and Adam steps on rounding noise (both packages
# move it by at most lr per epoch, in no agreed direction)
ZERO_GRAD = "MultiHeadDotProductAttention_0.key.bias"


def _adam_count(opt_state) -> int:
    return int([x for x in jax.tree_util.tree_leaves(opt_state)
                if np.asarray(x).dtype == np.int32][0])


def _assert_params_match(module, tree, what, max_step=None):
    want = params_from_flax(module, jax.device_get(tree))
    for k, p in module.state_dict().items():
        if ZERO_GRAD in k:
            assert float((p - want[k]).abs().max()) <= 2 * max_step, (what, k)
            continue
        np.testing.assert_allclose(p.numpy(), want[k].numpy(), **UPD, err_msg=f"{what} {k}")


@pytest.mark.parametrize("kl_target,epochs_run", [(10.0, 4), (1e-4, None)])
def test_ppo_agent_update_matches_jax(kl_target, epochs_run):
    """One update over a fixed 12-step episode from the same parameters:
    the same number of epochs before the KL break (all four with a large
    kl_target, fewer with a tiny one), the same losses and KL and the same
    updated actor and critic."""
    jag = jppo.PPOAgent(**AGENT, kl_target=kl_target, seed=0)
    tag = tppo.PPOAgent(**AGENT, kl_target=kl_target, seed=5)
    tag.actor.load_state_dict(params_from_flax(tag.actor, jax.device_get(jag.actor_params)))
    tag.critic.load_state_dict(params_from_flax(tag.critic, jax.device_get(jag.critic_params)))
    rng = np.random.default_rng(4)
    for t in range(12):
        obs = rng.normal(0, 1, 16).astype(np.float32)
        act = rng.normal(0, 1, 4).astype(np.float32)
        r = float(rng.normal(-5, 3))
        for ag in (jag, tag):
            ag.store_transition(obs, act, r, t == 11)
    want, got = jag.update(), tag.update()
    n_j, n_t = _adam_count(jag.actor_opt), int(tag.actor_opt.count)
    assert n_t == n_j and int(tag.critic_opt.count) == n_j
    if epochs_run is not None:
        assert n_t == epochs_run
    else:
        assert 1 <= n_t < AGENT["epochs"]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **UPD, err_msg=k)
    _assert_params_match(tag.actor, jag.actor_params, "actor", max_step=n_t * 9e-5)
    _assert_params_match(tag.critic, jag.critic_params, "critic", max_step=n_t * 2e-4)
    assert tag._episode == jag._episode == 1


@pytest.mark.parametrize("net_type,fpl,obs_dim", [("attention", 4, 16), ("lstm", None, 4)])
def test_checkpoints_cross_packages(tmp_path, net_type, fpl, obs_dim):
    """Port save -> JAX load and JAX save -> port load: the same
    deterministic absolute actions on three successive observations, with
    the recurrent carries advancing."""
    act_dim = 4 if fpl else 1
    kw = dict(obs_dim=obs_dim, act_dim=act_dim, features_per_link=fpl, net_type=net_type,
              max_delta=2.0, action_low=np.zeros(act_dim, np.float32),
              action_high=np.full(act_dim, 3.0, np.float32))
    rng = np.random.default_rng(6)
    obs = [rng.normal(0, 1, obs_dim).astype(np.float32) for _ in range(3)]

    def acts(agent):
        agent.reset_hidden()
        return [agent.absolute_action(o, agent.take_action(o, explore=False)) for o in obs]

    src = tppo.PPOAgent(**kw, seed=1)
    src.gate_anchor = "open"
    src.save(str(tmp_path / "port.pkl"))
    dst = jppo.PPOAgent(**kw, seed=2)
    dst.load(str(tmp_path / "port.pkl"))
    assert dst.gate_anchor == "open"
    for a, b in zip(acts(src), acts(dst)):
        np.testing.assert_allclose(a, b, **FWD)

    jsrc = jppo.PPOAgent(**kw, seed=3)
    jsrc.save(str(tmp_path / "jax.pkl"))
    tdst = tppo.PPOAgent(**kw, seed=4)
    tdst.load(str(tmp_path / "jax.pkl"))
    got, want = acts(tdst), acts(jsrc)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **FWD)
    assert len({tuple(a) for a in got}) == 3  # the carry advanced
    back = params_to_flax(tdst.actor)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(
        jax.device_get(jsrc.actor_params))


def test_load_rebuilds_architecture(tmp_path):
    """A checkpoint of another family rebuilds the modules (ppo.py:336-373);
    a gat checkpoint needs the adjacency the agent was built with."""
    lstm = tppo.PPOAgent(obs_dim=16, act_dim=4, features_per_link=4, net_type="lstm", seed=0)
    lstm.save(str(tmp_path / "lstm.pkl"))
    att = tppo.PPOAgent(obs_dim=16, act_dim=4, features_per_link=4, seed=1)
    att.load(str(tmp_path / "lstm.pkl"))
    assert att.net_type == "lstm" and type(att.actor).__name__ == "LSTMPolicy"
    o = np.ones(16, np.float32)
    np.testing.assert_array_equal(att.take_action(o, explore=False),
                                  lstm.take_action(o, explore=False))
    gat = tppo.PPOAgent(obs_dim=16, act_dim=4, features_per_link=4, net_type="gat", seed=0)
    gat.save(str(tmp_path / "gat.pkl"))
    with pytest.raises(ValueError, match="adjacency"):
        tppo.PPOAgent(obs_dim=16, act_dim=4, features_per_link=4, seed=1).load(
            str(tmp_path / "gat.pkl"))
