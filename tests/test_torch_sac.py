"""The port's SAC agent against the JAX package on the CPU: the actor's
tanh-Gaussian sample with the same standard normals (rtol 1e-5), two
``_update_step``s (twin-Q critic, actor, temperature, soft target) with
the JAX steps' noises fed in (rtol 1e-4), the frame stack and
``peek_stack`` (exact) and checkpoints crossing between the packages."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pednstream_tpu.rl import sac as jsac
from pednstream_tpu_torch.interop import params_from_flax
from pednstream_tpu_torch.rl import sac as tsac

torch.set_num_threads(1)

FWD = dict(rtol=1e-5, atol=1e-6)
UPD = dict(rtol=1e-4, atol=1e-6)
OBS, ACT, K = 8, 2, 4


@pytest.fixture(autouse=True)
def float32_jax():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def pair(**kw):
    """A JAX agent and a port agent holding the JAX agent's parameters."""
    j = jsac.SACAgent(OBS, ACT, hidden_dim=16, **kw, seed=0)
    t = tsac.SACAgent(OBS, ACT, hidden_dim=16, **kw, seed=1)
    for mod, tree in ((t.actor, j.actor_params), (t.critic, j.critic_params),
                      (t.target_critic, j.target_critic_params)):
        mod.load_state_dict(params_from_flax(mod, jax.device_get(tree)))
    return j, t


def noises(key, n):
    """The standard normals JAX's _update_step draws from ``key``: one
    ``[act_dim]`` draw per sample, next-state samples from k1, actor-loss
    samples from k2."""
    k1, k2 = jax.random.split(key)
    draw = jax.vmap(lambda k: jax.random.normal(k, (ACT,)))
    return tuple(torch.from_numpy(np.array(draw(jax.random.split(k, n)))) for k in (k1, k2))


def test_actor_sample_same_eps():
    j, t = pair()
    rng = np.random.default_rng(0)
    obs = rng.normal(0, 1, (5, K, OBS)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(3), 5)
    want_a, want_logp = jax.vmap(lambda o, k: j.actor.sample(j.actor_params, o, k))(obs, keys)
    eps = torch.from_numpy(np.array(jax.vmap(lambda k: jax.random.normal(k, (ACT,)))(keys)))
    got_a, got_logp = t.actor.sample(torch.from_numpy(obs), eps=eps)
    np.testing.assert_allclose(got_a.detach().numpy(), np.asarray(want_a), **FWD)
    np.testing.assert_allclose(got_logp.detach().numpy(), np.asarray(want_logp), **FWD)


def test_update_step_matches_jax():
    """Two consecutive gradient steps on random batches: losses, actor,
    critic, target and log_alpha after each."""
    j, t = pair()
    step = jax.jit(j._update_step)
    rng = np.random.default_rng(1)
    n = 16
    for i in range(2):
        batch = (rng.normal(0, 1, (n, K, OBS)).astype(np.float32),
                 rng.uniform(-1, 1, (n, ACT)).astype(np.float32),
                 rng.normal(0, 1, n).astype(np.float32),
                 rng.normal(0, 1, (n, K, OBS)).astype(np.float32),
                 (rng.random(n) < 0.2).astype(np.float32))
        key = jax.random.PRNGKey(10 + i)
        (j.actor_params, j.critic_params, j.target_critic_params, j.log_alpha,
         j.actor_opt, j.critic_opt, j.alpha_opt, a_loss, c_loss) = step(
            j.actor_params, j.critic_params, j.target_critic_params, j.log_alpha,
            j.actor_opt, j.critic_opt, j.alpha_opt, tuple(map(jnp.asarray, batch)), key)
        got = t._update_step(tuple(map(torch.from_numpy, batch)), noises(key, n))
        np.testing.assert_allclose(float(got[0]), float(a_loss), **UPD)
        np.testing.assert_allclose(float(got[1]), float(c_loss), **UPD)
        np.testing.assert_allclose(float(t.log_alpha.detach()), float(j.log_alpha), **UPD)
        for mod, tree in ((t.actor, j.actor_params), (t.critic, j.critic_params),
                          (t.target_critic, j.target_critic_params)):
            want = params_from_flax(mod, jax.device_get(tree))
            for k, p in mod.state_dict().items():
                np.testing.assert_allclose(p.numpy(), want[k].numpy(), **UPD,
                                           err_msg=f"step {i} {type(mod).__name__} {k}")
    assert float(t.log_alpha.detach()) != 0.0


def test_frame_stack_and_peek_exact():
    j, t = pair()
    rng = np.random.default_rng(2)
    for episode in range(2):
        j.reset_hidden()
        t.reset_hidden()
        assert t.last_stack is None and j.last_stack is None
        for _ in range(6):
            o = rng.normal(0, 1, OBS).astype(np.float32)
            np.testing.assert_array_equal(t.peek_stack(o), j.peek_stack(o))
            np.testing.assert_array_equal(t._stack(o), j._stack(o))
            np.testing.assert_array_equal(t.last_stack, j.last_stack)


def test_checkpoints_cross_packages(tmp_path):
    """Port save -> JAX load and JAX save -> port load: the same
    deterministic absolute actions on three observations; max_delta,
    gate_anchor and log_alpha travel with the checkpoint."""
    kw = dict(action_low=np.zeros(ACT, np.float32), action_high=np.full(ACT, 3.0, np.float32))
    rng = np.random.default_rng(3)
    obs = [rng.normal(0, 1, OBS).astype(np.float32) for _ in range(3)]

    def acts(agent):
        agent.reset_hidden()
        return [agent.absolute_action(o, agent.take_action(o, explore=False)) for o in obs]

    src = tsac.SACAgent(OBS, ACT, max_delta=1.5, seed=4, **kw)
    src.gate_anchor = "open"
    with torch.no_grad():
        src.log_alpha.fill_(-0.3)
    src.save(str(tmp_path / "port.pkl"))
    dst = jsac.SACAgent(OBS, ACT, seed=5, **kw)
    dst.load(str(tmp_path / "port.pkl"))
    assert (dst.max_delta, dst.gate_anchor) == (1.5, "open")
    np.testing.assert_allclose(float(dst.log_alpha), -0.3, rtol=1e-6)
    for a, b in zip(acts(src), acts(dst)):
        np.testing.assert_allclose(a, b, **FWD)

    jsrc = jsac.SACAgent(OBS, ACT, seed=6, **kw)
    jsrc.save(str(tmp_path / "jax.pkl"))
    tdst = tsac.SACAgent(OBS, ACT, max_delta=9.0, seed=7, **kw)
    tdst.load(str(tmp_path / "jax.pkl"))
    assert tdst.max_delta == jsrc.max_delta
    for a, b in zip(acts(tdst), acts(jsrc)):
        np.testing.assert_allclose(a, b, **FWD)
