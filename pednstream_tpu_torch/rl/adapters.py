"""Third-party RL framework adapters (the counterpart of
``pednstream_tpu/rl/adapters.py``, over the port's env).

The reference integrates RLlib (rl/train_ppo_rllib.py:23-34, Ray rollout
workers as its only parallelism) and Stable-Baselines3 via a concat
wrapper (rl/train_ppo_sb3.py:52-120).  Both frameworks are optional
here — the batched trainers supersede process-level rollout workers —
but the thin adapters are provided for users migrating existing
pipelines.  ``env_kwargs`` go to ``PedNetParallelEnv`` (``device`` among
them); ray and gymnasium are imported where an adapter needs them.
"""

from typing import Dict, Optional

import numpy as np


def make_rllib_env(dataset: str, **env_kwargs):
    """PedNet as an RLlib multi-agent env (train_ppo_rllib.py:23-34).

    Requires ray[rllib]; returns a ParallelPettingZooEnv wrapping the
    PettingZoo env.
    """
    try:
        from ray.rllib.env.wrappers.pettingzoo_env import ParallelPettingZooEnv
    except ImportError as e:
        raise ImportError(
            "ray[rllib] is not installed; use pednstream_tpu_torch.rl.train's "
            "native batched trainer, or install ray to use this adapter"
        ) from e
    from ..env import PedNetParallelEnv

    return ParallelPettingZooEnv(PedNetParallelEnv(dataset, **env_kwargs))


def rllib_ppo_config(dataset: str, num_workers: int = 2, **env_kwargs):
    """PPOConfig for multi-agent training (train_ppo_rllib.py:36-120)."""
    try:
        from ray.rllib.algorithms.ppo import PPOConfig
        from ray import tune
    except ImportError as e:
        raise ImportError("ray[rllib] is not installed") from e
    from ..env import PedNetParallelEnv

    env_name = "pednet_rllib"
    tune.register_env(env_name, lambda cfg: make_rllib_env(dataset, **env_kwargs))
    probe = PedNetParallelEnv(dataset, **env_kwargs)
    policies = {aid: (None, probe.observation_space(aid), probe.action_space(aid), {})
                for aid in probe.possible_agents}
    return (
        PPOConfig()
        .environment(env_name)
        .env_runners(num_env_runners=num_workers)
        .multi_agent(
            policies=policies,
            policy_mapping_fn=lambda agent_id, *a, **k: agent_id,
        )
    )


class PedNetSB3Wrapper:
    """Single-agent gymnasium Env concatenating all agents' obs/actions
    (train_ppo_sb3.py:52-120) for Stable-Baselines3 PPO."""

    def __init__(self, dataset: str, **env_kwargs):
        from gymnasium import spaces

        from ..env import PedNetParallelEnv

        self.env = PedNetParallelEnv(dataset, **env_kwargs)
        self.agent_ids = self.env.possible_agents
        obs_dims = [int(np.prod(self.env.observation_space(a).shape))
                    for a in self.agent_ids]
        self._obs_splits = np.cumsum(obs_dims)[:-1]
        lows, highs = [], []
        self._act_shapes = []
        for a in self.agent_ids:
            sp = self.env.action_space(a)
            lows.append(np.asarray(sp.low).ravel())
            highs.append(np.asarray(sp.high).ravel())
            self._act_shapes.append(sp.shape)
        self.action_space = spaces.Box(
            low=np.concatenate(lows), high=np.concatenate(highs), dtype=np.float32
        )
        self.observation_space = spaces.Box(
            low=-np.inf, high=np.inf, shape=(int(sum(obs_dims)),), dtype=np.float32
        )
        self.metadata = {"render_modes": []}
        self.render_mode = None

    def _concat_obs(self, obs: Dict[str, np.ndarray]) -> np.ndarray:
        return np.concatenate([obs[a].ravel() for a in self.agent_ids]).astype(np.float32)

    def _split_action(self, action: np.ndarray) -> Dict[str, np.ndarray]:
        out = {}
        i = 0
        for a, shape in zip(self.agent_ids, self._act_shapes):
            n = int(np.prod(shape))
            out[a] = action[i : i + n].reshape(shape)
            i += n
        return out

    def reset(self, seed: Optional[int] = None, options=None):
        if seed is not None:
            self.env.seed(seed)
        obs, infos = self.env.reset(options=options)
        return self._concat_obs(obs), {}

    def step(self, action: np.ndarray):
        obs, rewards, terms, truncs, infos = self.env.step(self._split_action(action))
        reward = float(sum(rewards.values()))
        return (self._concat_obs(obs), reward, any(terms.values()),
                any(truncs.values()), {})

    def close(self):
        self.env.close()
