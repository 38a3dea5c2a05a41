"""PettingZoo ParallelEnv wrapper over the env core (the counterpart of
``pednstream_tpu/env/pz_env.py``).

API-compatible with the reference env (rl/pz_pednet_env.py:38-697) and
the JAX wrapper: the same constructor (plus ``device``), agent ids,
spaces, ``seed``/``reset(options={'randomize': bool})``/``step`` semantics,
action rate limits and termination rule.  Seeding drives the
``torch.Generator`` of the stochastic steps.  ``render`` and ``save`` need
the visualizer and the output handler, which come with the port's
host-side consumers slice.
"""

import functools
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..generator import NetworkEnvGenerator
from .agents import build_agent_spec, build_spaces
from .core import PedNetEnvCore

try:
    from pettingzoo import ParallelEnv
except ImportError:  # the wrapper works without pettingzoo, as a plain class
    ParallelEnv = object


class PedNetParallelEnv(ParallelEnv):
    metadata = {"render_modes": ["human", "animate"], "name": "pednet_v0"}

    def __init__(
        self,
        dataset: str,
        normalize_obs: bool = False,
        obs_mode: str = "option1",
        render_mode: Optional[str] = None,
        verbose: bool = False,
        action_gap: int = 1,
        seed: Optional[int] = None,
        reward_mode: str = "all",
        stochastic: bool = True,
        data_dir: Optional[str] = None,
        record_history: bool = False,
        history_window: Optional[int] = None,
        od_randomize: bool = False,
        global_reward_coef: float = 0.0,
        device="cpu",
    ):
        super().__init__()
        self.render_mode = render_mode
        self.verbose = verbose
        self.dataset = dataset
        self._seed = seed if seed is not None else 0
        if seed is not None:
            np.random.seed(seed)

        self.env_generator = NetworkEnvGenerator(
            data_dir=data_dir, history_window=history_window, device=device)
        if od_randomize:
            # superset topology whose candidate OD nodes open/close per
            # replica (randomize.py); replaces the reference's host-side
            # OD rebuild (env_loader.py:261-359)
            self.scn = self.env_generator.build_od_randomizable(dataset)
        else:
            self.scn = self.env_generator.create_network(dataset, verbose=verbose)
        self.simulation_steps = self.scn.simulation_steps

        self.normalize_obs = normalize_obs
        self.obs_mode = obs_mode
        self._action_gap = action_gap
        self._reward_mode = reward_mode
        self._stochastic = stochastic
        self._record_history = record_history
        self._global_reward_coef = global_reward_coef
        self._history = []

        self.spec_agents = build_agent_spec(self.scn)
        self.possible_agents = list(self.spec_agents.agent_ids)
        self._action_spaces, self._observation_spaces = build_spaces(
            self.spec_agents, obs_mode)
        self._rebuild_core()
        self._gen = torch.Generator(device=self.scn.device).manual_seed(self._seed)
        self._state = None
        self._cumulative_rewards = {a: 0.0 for a in self.possible_agents}
        self.visualizer = None

    # -- PettingZoo API ------------------------------------------------------

    @property
    def agents(self) -> List[str]:
        return self.possible_agents.copy()

    @property
    def sim_step(self) -> int:
        return self._state.t if self._state is not None else 1

    @functools.lru_cache(maxsize=None)
    def observation_space(self, agent: str):
        if agent not in self._observation_spaces:
            raise ValueError(f"Agent {agent} not found in observation spaces")
        return self._observation_spaces[agent]

    @functools.lru_cache(maxsize=None)
    def action_space(self, agent: str):
        if agent not in self._action_spaces:
            raise ValueError(f"Agent {agent} not found in action spaces")
        return self._action_spaces[agent]

    def seed(self, seed: int) -> None:
        self._seed = seed
        self._gen.manual_seed(seed)
        np.random.seed(seed)

    def _rebuild_core(self):
        self.spec_agents = build_agent_spec(self.scn)
        self.core = PedNetEnvCore(
            self.scn, self.spec_agents, obs_mode=self.obs_mode,
            normalize_obs=self.normalize_obs, action_gap=self._action_gap,
            reward_mode=self._reward_mode, stochastic=self._stochastic,
            record=self._record_history,
            global_reward_coef=self._global_reward_coef,
        )

    def reset(self, seed: Optional[int] = None, options: Optional[dict] = None):
        randomize = options.get("randomize", False) if options else False
        if randomize:
            self.scn = self.env_generator.randomize_network(
                self.dataset, seed=None, verbose=self.verbose)
            self._rebuild_core()
        self._state, obs = self.core.reset()
        self._cumulative_rewards = {a: 0.0 for a in self.possible_agents}
        self._history = []
        return self._obs_to_numpy(obs), self._get_infos()

    def step(self, actions: Dict[str, Any]):
        for agent_id in actions:
            if agent_id not in self.possible_agents:
                raise ValueError(f"Unknown agent: {agent_id}")
        packed = self._pack_actions(actions)
        self._state, obs, rewards, done, outs = self.core.step(self._state, packed,
                                                               gen=self._gen)
        if self._record_history:
            self._history.append(outs)  # StepOutputs [action_gap, 1, ...]
        rewards_np = {a: float(rewards[a]) if a in rewards else 0.0
                      for a in self.possible_agents}
        for a, r in rewards_np.items():
            self._cumulative_rewards[a] += r
        done = bool(done)
        terminations = {a: done for a in self.possible_agents}
        truncations = {a: False for a in self.possible_agents}
        return (self._obs_to_numpy(obs), rewards_np, terminations, truncations,
                self._get_infos())

    # -- helpers ---------------------------------------------------------------

    def _pack_actions(self, actions: Dict[str, Any]) -> Dict[str, np.ndarray]:
        packed: Dict[str, np.ndarray] = {}
        if self.spec_agents.sep_ids:
            sep = np.zeros(len(self.spec_agents.sep_ids), dtype=np.float32)
            for i, a in enumerate(self.spec_agents.sep_ids):
                if a in actions:
                    sep[i] = np.asarray(actions[a]).reshape(-1)[0]
                else:
                    sep[i] = float(self.core.spec.sep_total_width[i]) / 2
            packed["sep"] = sep
        for i, a in enumerate(self.spec_agents.gate_ids):
            if a in actions:
                packed[a] = np.asarray(actions[a], dtype=np.float32).reshape(-1)
            else:
                packed[a] = self.spec_agents.gate_link_widths[i].astype(np.float32)
        return packed

    def _obs_to_numpy(self, obs) -> Dict[str, np.ndarray]:
        out = {}
        if "sep" in obs:
            sep = obs["sep"].cpu().numpy().astype(np.float32)
            for i, a in enumerate(self.spec_agents.sep_ids):
                out[a] = sep[i]
        for a in self.spec_agents.gate_ids:
            out[a] = obs[a].cpu().numpy().astype(np.float32)
        return out

    def _get_infos(self) -> Dict[str, Dict]:
        return {
            a: {"step": self.sim_step,
                "cumulative_reward": self._cumulative_rewards.get(a, 0.0)}
            for a in self.possible_agents
        }

    def render(self, simulation_dir: str = None, variable: str = "density",
               vis_actions: bool = False, save_dir: str = None):
        if self.render_mode is None:
            return
        raise NotImplementedError(
            "render needs the visualizer, which is not ported yet (ROADMAP queue 1, "
            "host-side consumers)")

    def save(self, simulation_dir: str, base_dir: str = "outputs"):
        raise NotImplementedError(
            "save needs the output handler, which is not ported yet (ROADMAP queue 1, "
            "host-side consumers)")

    def close(self):
        pass
