"""RL utilities: GAE, running normalization wrapper, replay buffer,
validation / checkpoint helpers (a host-side NumPy copy of
``pednstream_tpu/rl/rl_utils.py``; importing that package loads JAX).

Functional parity with the reference rl/rl_utils.py: Welford
observation normalization that skips the gate-width feature
(:129-141,181-249), return-based reward normalization (:251-267),
true-reward passthrough in infos (:170-175), stats save/load (:273-300),
compute_gae (:1754-1773), ReplayBuffer (:37-50), validate/save-best
(:306-496).  The checkpoint format is the JAX package's: an
``{agent_id}.pkl`` per agent, ``config.json`` and ``norm_stats.json``.
"""

import collections
import json
import os
import random
from typing import Dict, Optional

import numpy as np

from ..env.agents import FEATURES_PER_LINK


def compute_gae(rewards, values, next_value, dones, gamma=0.99, lam=0.95):
    """Generalized advantage estimation (rl_utils.py:1754-1773)."""
    rewards = np.asarray(rewards, dtype=np.float64)
    values = np.asarray(values, dtype=np.float64)
    dones = np.asarray(dones, dtype=np.float64)
    T = len(rewards)
    adv = np.zeros(T)
    gae = 0.0
    for t in reversed(range(T)):
        v_next = next_value if t == T - 1 else values[t + 1]
        delta = rewards[t] + gamma * v_next * (1 - dones[t]) - values[t]
        gae = delta + gamma * lam * (1 - dones[t]) * gae
        adv[t] = gae
    returns = adv + values
    return adv, returns


class ReplayBuffer:
    """Uniform replay buffer (rl_utils.py:37-50)."""

    def __init__(self, capacity: int):
        self.buffer = collections.deque(maxlen=capacity)

    def add(self, state, action, reward, next_state, done):
        self.buffer.append((state, action, reward, next_state, done))

    def sample(self, batch_size: int):
        transitions = random.sample(self.buffer, batch_size)
        s, a, r, ns, d = zip(*transitions)
        return (np.array(s), np.array(a), np.array(r), np.array(ns), np.array(d))

    def size(self) -> int:
        return len(self.buffer)


class RunningMeanStd:
    """Welford online mean/var (rl_utils.py:57-84)."""

    def __init__(self, shape):
        self.mean = np.zeros(shape, dtype=np.float64)
        self.var = np.ones(shape, dtype=np.float64)
        self.count = 1e-4

    def update(self, x: np.ndarray):
        x = np.asarray(x, dtype=np.float64)
        batch_mean = x
        batch_count = 1
        delta = batch_mean - self.mean
        tot = self.count + batch_count
        self.mean = self.mean + delta * batch_count / tot
        m_a = self.var * self.count
        m_b = 0.0
        M2 = m_a + m_b + delta**2 * self.count * batch_count / tot
        self.var = M2 / tot
        self.count = tot

    def normalize(self, x: np.ndarray) -> np.ndarray:
        return (x - self.mean) / np.sqrt(self.var + 1e-8)


class RunningNormalizeWrapper:
    """Observation/reward-normalizing env wrapper (rl_utils.py:86-300).

    Observation normalization excludes the gate-width feature (the last
    feature of each per-link block) so the physical control state stays
    in meters; rewards normalize by the running std of discounted
    returns.  True rewards pass through in infos.
    """

    def __init__(self, env, normalize_obs: bool = True, normalize_reward: bool = True,
                 gamma: float = 0.99, clip_obs: float = 10.0, clip_reward: float = 10.0):
        self.env = env
        self.normalize_obs_flag = normalize_obs
        self.normalize_reward_flag = normalize_reward
        self.gamma = gamma
        # +- clip on normalized values (reference rl_utils.py:99-100 clip_obs/
        # clip_reward defaults) so extreme transients stay bounded
        self.clip_obs = clip_obs
        self.clip_reward = clip_reward
        self.obs_rms: Dict[str, RunningMeanStd] = {}
        self.ret_rms: Dict[str, RunningMeanStd] = {}
        self.returns: Dict[str, float] = {}
        self._frozen = False
        self._fpl = FEATURES_PER_LINK.get(getattr(env, "obs_mode", "option1"), None)

    def __getattr__(self, name):
        return getattr(self.env, name)

    def _gate_mask(self, agent: str, size: int) -> np.ndarray:
        """True where the feature should be normalized (skip gate width)."""
        mask = np.ones(size, dtype=bool)
        if agent.startswith("gate_") and self._fpl:
            mask.reshape(-1, self._fpl)[:, -1] = False
        return mask

    def _norm_obs(self, obs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        if not self.normalize_obs_flag:
            return obs
        out = {}
        for agent, o in obs.items():
            if agent not in self.obs_rms:
                self.obs_rms[agent] = RunningMeanStd(o.shape)
            if not self._frozen:
                self.obs_rms[agent].update(o)
            normed = self.obs_rms[agent].normalize(o)
            normed = np.clip(normed, -self.clip_obs, self.clip_obs)
            mask = self._gate_mask(agent, o.size)
            out[agent] = np.where(mask.reshape(o.shape), normed, o).astype(np.float32)
        return out

    def reset(self, seed=None, options=None):
        obs, infos = self.env.reset(seed=seed, options=options)
        self.returns = {a: 0.0 for a in obs}
        return self._norm_obs(obs), infos

    def step(self, actions):
        obs, rewards, terms, truncs, infos = self.env.step(actions)
        normed_rewards = {}
        for agent, r in rewards.items():
            infos.setdefault(agent, {})["true_reward"] = r
            if self.normalize_reward_flag:
                self.returns[agent] = self.returns.get(agent, 0.0) * self.gamma + r
                if agent not in self.ret_rms:
                    self.ret_rms[agent] = RunningMeanStd(())
                if not self._frozen:
                    self.ret_rms[agent].update(self.returns[agent])
                normed_rewards[agent] = float(np.clip(
                    r / np.sqrt(self.ret_rms[agent].var + 1e-8),
                    -self.clip_reward, self.clip_reward,
                ))
            else:
                normed_rewards[agent] = r
        return self._norm_obs(obs), normed_rewards, terms, truncs, infos

    def freeze(self):
        """Stop updating statistics (evaluation mode)."""
        self._frozen = True

    @staticmethod
    def _rms_to_dict(rms: "RunningMeanStd") -> dict:
        return {"mean": rms.mean.tolist(), "var": rms.var.tolist(),
                "count": rms.count}

    @staticmethod
    def _rms_from_dict(s: dict) -> "RunningMeanStd":
        rms = RunningMeanStd(np.array(s["mean"]).shape)
        rms.mean = np.array(s["mean"])
        rms.var = np.array(s["var"])
        rms.count = s["count"]
        return rms

    def save_stats(self, path: str):
        """Persist BOTH obs and return statistics (the reference's
        get_normalization_stats saves obs_rms and ret_rms together) so a
        resumed run does not renormalize rewards from scratch."""
        stats = {
            "obs_rms": {a: self._rms_to_dict(r) for a, r in self.obs_rms.items()},
            "ret_rms": {a: self._rms_to_dict(r) for a, r in self.ret_rms.items()},
        }
        with open(path, "w") as f:
            json.dump(stats, f)

    def load_stats(self, path: str):
        with open(path) as f:
            stats = json.load(f)
        if "obs_rms" not in stats:  # round-1 format: flat obs-only dict
            stats = {"obs_rms": stats, "ret_rms": {}}
        self.obs_rms = {a: self._rms_from_dict(s) for a, s in stats["obs_rms"].items()}
        self.ret_rms = {a: self._rms_from_dict(s) for a, s in stats["ret_rms"].items()}
        self._frozen = True


# -- evaluation / checkpoint helpers (rl_utils.py:306-763) ---------------------


def validate_agents(env, agents: Dict, num_episodes: int = 3,
                    randomize: bool = False) -> float:
    """Deterministic rollouts; mean total true reward (rl_utils.py:306-408)."""
    totals = []
    for _ in range(num_episodes):
        obs, _ = env.reset(options={"randomize": randomize})
        for a in agents.values():
            if hasattr(a, "reset_hidden"):
                a.reset_hidden()
        done = False
        total = 0.0
        while not done:
            # delta -> absolute conversion, as the reference's validation
            # does for delta_actions agents (rl_utils.py:332-341)
            actions = {}
            for aid in agents:
                delta = agents[aid].take_action(obs[aid], explore=False)
                actions[aid] = (
                    agents[aid].absolute_action(obs[aid], delta)
                    if hasattr(agents[aid], "absolute_action") else delta
                )
            obs, rewards, terms, truncs, infos = env.step(actions)
            total += sum(
                infos[a].get("true_reward", rewards.get(a, 0.0)) for a in rewards
            )
            done = any(terms.values()) or any(truncs.values())
        totals.append(total)
    return float(np.mean(totals))


def save_all_agents(agents: Dict, save_dir: str, env=None, extra: Optional[dict] = None):
    """Checkpoint all agents (rl_utils.py:499-618): per-agent params +
    config.json, plus normalization stats when the env wrapper has any."""
    os.makedirs(save_dir, exist_ok=True)
    for agent_id, agent in agents.items():
        agent.save(os.path.join(save_dir, f"{agent_id}.pkl"))
    config = {
        "agents": {aid: agents[aid].get_config() for aid in agents},
        "extra": extra or {},
    }
    with open(os.path.join(save_dir, "config.json"), "w") as f:
        json.dump(config, f, indent=2, default=str)
    if env is not None and hasattr(env, "save_stats"):
        env.save_stats(os.path.join(save_dir, "norm_stats.json"))


def load_all_agents(agents: Dict, save_dir: str, env=None):
    for agent_id, agent in agents.items():
        agent.load(os.path.join(save_dir, f"{agent_id}.pkl"))
    stats = os.path.join(save_dir, "norm_stats.json")
    if env is not None and hasattr(env, "load_stats") and os.path.exists(stats):
        env.load_stats(stats)
    return agents


def validate_and_save_best(env, agents, best_reward, save_dir,
                           num_episodes=3) -> float:
    """Validation-gated best checkpointing (rl_utils.py:437-496)."""
    score = validate_agents(env, agents, num_episodes=num_episodes)
    if score > best_reward:
        save_all_agents(agents, save_dir, env=env, extra={"val_reward": score})
        return score
    return best_reward
