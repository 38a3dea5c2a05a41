"""The port's host RL utilities, rule-based baselines and training drivers
on the CPU against the JAX package.

The host NumPy copies (``RunningMeanStd``, ``RunningNormalizeWrapper``
with its stats files, ``ReplayBuffer``, the rule-based and no-control
agents that ``build_agents`` makes) must agree exactly with JAX's on the
same inputs.  The episode loops (``train_on_policy_multi_agent``,
``train_off_policy_multi_agent``) and the CLI (``train.main``) run on
butterfly_scC with 10 RL steps per episode (``action_gap=60``); the
checkpoints they write load in the JAX package and act as the port's
agents do (rtol 1e-5)."""

import json
import random

import numpy as np
import pytest
import torch

import jax

from pednstream_tpu.env import PedNetParallelEnv as JaxEnv
from pednstream_tpu.rl import rl_utils as jax_utils
from pednstream_tpu.rl.train import build_agents as jax_build_agents
from pednstream_tpu_torch.env import PedNetParallelEnv
from pednstream_tpu_torch.rl import rl_utils, train

torch.set_num_threads(1)

FWD = dict(rtol=1e-5, atol=1e-6)
ENV = dict(obs_mode="option2", action_gap=60, history_window=16, seed=0)


@pytest.fixture(autouse=True)
def float32_jax():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


class ScriptedEnv:
    """An env stand-in replaying seeded observations and rewards for a
    gate agent (3 links x 4 features) and a separator agent."""

    obs_mode = "option2"
    agents = ("gate_1", "sep_1_2")

    def __init__(self, seed: int, steps: int = 6):
        self.rng = np.random.default_rng(seed)
        self.steps = steps

    def _obs(self):
        return {"gate_1": self.rng.uniform(0, 5, 12).astype(np.float32),
                "sep_1_2": self.rng.uniform(0, 3, 4).astype(np.float32)}

    def reset(self, seed=None, options=None):
        self.t = 0
        return self._obs(), {}

    def step(self, actions):
        self.t += 1
        rewards = {a: float(self.rng.normal(-50, 20)) for a in self.agents}
        done = self.t >= self.steps
        return (self._obs(), rewards, {a: done for a in self.agents},
                {a: False for a in self.agents}, {})


def _drive(wrapper, episodes: int = 2):
    """Everything ``wrapper`` returns over ``episodes`` scripted episodes."""
    out = []
    for _ in range(episodes):
        obs, _ = wrapper.reset()
        out.append(obs)
        done = False
        while not done:
            obs, rewards, terms, _, infos = wrapper.step({})
            out.extend([obs, rewards, {a: i["true_reward"] for a, i in infos.items()}])
            done = any(terms.values())
    return out


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_normalize_wrapper_matches_jax(tmp_path):
    """Normalized observations (the gate-width feature kept raw), rewards
    and true rewards equal JAX's exactly; the stats files cross both ways
    and freeze both wrappers alike."""
    port = rl_utils.RunningNormalizeWrapper(ScriptedEnv(0))
    ref = jax_utils.RunningNormalizeWrapper(ScriptedEnv(0))
    _assert_same(_drive(port), _drive(ref))
    port.save_stats(str(tmp_path / "port.json"))
    ref.save_stats(str(tmp_path / "jax.json"))
    assert json.loads((tmp_path / "port.json").read_text()) == \
        json.loads((tmp_path / "jax.json").read_text())

    port2 = rl_utils.RunningNormalizeWrapper(ScriptedEnv(1))
    ref2 = jax_utils.RunningNormalizeWrapper(ScriptedEnv(1))
    port2.load_stats(str(tmp_path / "jax.json"))
    ref2.load_stats(str(tmp_path / "port.json"))
    assert port2._frozen and ref2._frozen
    _assert_same(_drive(port2, 1), _drive(ref2, 1))


def test_replay_buffer_and_running_mean_std_exact():
    rng = np.random.default_rng(2)
    port, ref = rl_utils.RunningMeanStd((5,)), jax_utils.RunningMeanStd((5,))
    for x in rng.normal(3, 2, (10, 5)):
        port.update(x)
        ref.update(x)
    np.testing.assert_array_equal(port.mean, ref.mean)
    np.testing.assert_array_equal(port.var, ref.var)
    assert port.count == ref.count

    bufs = rl_utils.ReplayBuffer(16), jax_utils.ReplayBuffer(16)
    for i in range(20):
        tr = (rng.normal(size=(4, 3)), rng.normal(size=2), float(i), rng.normal(size=(4, 3)),
              i % 7 == 0)
        for b in bufs:
            b.add(*tr)
    assert bufs[0].size() == bufs[1].size() == 16
    samples = []
    for b in bufs:
        random.seed(3)
        samples.append(b.sample(6))
    for got, want in zip(*samples):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dataset", ["butterfly_scC", "long_corridor"])
@pytest.mark.parametrize("algo", ["rule_based", "no_control"])
def test_baseline_agents_match_jax(dataset, algo):
    """build_agents' rule-based and no-control agents (a gate on
    butterfly_scC, a separator on long_corridor) act exactly as JAX's on
    the same five observations, the separator's smoothing carried."""
    env, jenv = PedNetParallelEnv(dataset, **ENV), JaxEnv(dataset, **ENV)
    agents = train.build_agents(env, algo=algo)
    jagents = jax_build_agents(jenv, algo=algo)
    assert set(agents) == set(jagents) == set(env.possible_agents)
    rng = np.random.default_rng(4)
    for aid in agents:
        a, ja = agents[aid], jagents[aid]
        a.reset_hidden()
        ja.reset_hidden()
        dim = env.observation_space(aid).shape[0]
        for _ in range(5):
            obs = rng.uniform(0, 6, dim).astype(np.float32)
            got = a.absolute_action(obs, a.take_action(obs))
            want = ja.absolute_action(obs, ja.take_action(obs))
            np.testing.assert_array_equal(got, want, err_msg=aid)


def _acts_like_jax(save_dir, algo, env):
    """The checkpoints in ``save_dir`` through both packages'
    ``build_agents`` + ``load_all_agents``: the same deterministic actions
    on the same normalized observation."""
    wrapped = rl_utils.RunningNormalizeWrapper(env)
    agents = rl_utils.load_all_agents(train.build_agents(wrapped, algo=algo), save_dir,
                                      env=wrapped)
    jwrapped = jax_utils.RunningNormalizeWrapper(JaxEnv("butterfly_scC", **ENV))
    jagents = jax_utils.load_all_agents(jax_build_agents(jwrapped, algo=algo), save_dir,
                                        env=jwrapped)
    obs, _ = wrapped.reset()
    for aid in agents:
        agents[aid].reset_hidden()
        jagents[aid].reset_hidden()
        got = agents[aid].absolute_action(obs[aid], agents[aid].take_action(obs[aid], False))
        want = jagents[aid].absolute_action(obs[aid], jagents[aid].take_action(obs[aid], False))
        np.testing.assert_allclose(got, want, **FWD, err_msg=aid)


def test_on_policy_loop_checkpoints_load_in_jax(tmp_path):
    """Two PPO episodes through the normalizing wrapper, validation-gated
    checkpointing after the second: finite rewards, actor losses, a
    checkpoint with its validation score that JAX loads."""
    env = PedNetParallelEnv("butterfly_scC", **ENV)
    wrapped = rl_utils.RunningNormalizeWrapper(env)
    agents = train.build_agents(env, algo="ppo", hidden_dim=16)
    logged = []
    history = train.train_on_policy_multi_agent(
        wrapped, agents, num_episodes=2, val_freq=1, save_dir=str(tmp_path),
        log_fn=lambda ep, m: logged.append((ep, m)))
    assert [h["episode"] for h in history] == [0, 1] and len(logged) == 2
    for h in history:
        assert np.isfinite(h["reward"]) and h["reward"] < 0
        assert np.isfinite(h["gate_2_loss"])
    extra = json.loads((tmp_path / "config.json").read_text())["extra"]
    assert np.isfinite(extra["val_reward"])
    assert agents["gate_2"]._episode == 2
    _acts_like_jax(str(tmp_path), "ppo", env)


def test_off_policy_loop_updates_past_warmup(tmp_path):
    """Two SAC episodes with a 5-step warm-up: the actor moves once the
    replay buffer holds a batch, the final state is validated and saved,
    and JAX loads the checkpoint."""
    env = PedNetParallelEnv("butterfly_scC", **ENV)
    wrapped = rl_utils.RunningNormalizeWrapper(env)
    agents = train.build_agents(env, algo="sac", batch_size=8)
    actor0 = [p.detach().clone() for p in agents["gate_2"].actor.parameters()]
    np.random.seed(0)
    history = train.train_off_policy_multi_agent(
        wrapped, agents, num_episodes=2, warmup_steps=5, val_freq=10,
        save_dir=str(tmp_path))
    assert len(history) == 2 and all(np.isfinite(h["reward"]) for h in history)
    assert agents["gate_2"].buffer.size() == 20
    assert any(not torch.equal(a, b)
               for a, b in zip(actor0, agents["gate_2"].actor.parameters()))
    _acts_like_jax(str(tmp_path), "sac", env)


def test_cli_trains_logs_and_saves(tmp_path):
    """``python -m pednstream_tpu_torch.rl.train`` for one PPO episode:
    one JSONL log line, a checkpoint and the normalization stats."""
    save, log = tmp_path / "ppo", tmp_path / "log.jsonl"
    train.main(["--dataset", "butterfly_scC", "--episodes", "1", "--action-gap", "60",
                "--save-dir", str(save), "--log-file", str(log)])
    lines = log.read_text().splitlines()
    assert len(lines) == 1 and json.loads(lines[0])["episode"] == 0
    assert {p.name for p in save.iterdir()} == {"gate_2.pkl", "config.json",
                                                "norm_stats.json"}
    cfg = json.loads((save / "config.json").read_text())
    assert cfg["agents"]["gate_2"]["net_type"] == "attention"
