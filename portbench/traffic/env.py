"""Domain-randomized batched RL env steps:
``PedNetEnvCore.batch_step_randomized`` over ``batch`` randomized worlds
(``randomize_engine_params_batched`` anew each episode), uniform random
actions over each agent's action space, ``episode_steps`` RL steps an
episode."""

from typing import Dict

import numpy as np
import torch

from portbench.check import StepReference
from portbench.drivers import capture, derived_seeds, seed_demand


class Driver:
    def __init__(self, config: dict, traffic: dict, device):
        from pednstream_tpu_torch.env.agents import build_agent_spec, build_spaces
        from pednstream_tpu_torch.env.core import PedNetEnvCore
        from pednstream_tpu_torch.generator import NetworkEnvGenerator

        self.device = torch.device(device)
        seed_demand(config)
        gen = NetworkEnvGenerator(history_window=config["history_window"], device=self.device)
        self.scn = gen.build_od_randomizable(config["dataset"],
                                             binomial_mode=config["binomial_mode"])
        spec = build_agent_spec(self.scn)
        env = config["env"]
        self.core = PedNetEnvCore(self.scn, spec, obs_mode=env["obs_mode"],
                                  normalize_obs=env["normalize_obs"],
                                  action_gap=env["action_gap"], reward_mode=env["reward_mode"],
                                  stochastic=True)
        spaces, _ = build_spaces(spec, self.core.obs_mode)
        self.bounds = {a: [torch.as_tensor(np.asarray(x), device=self.device)
                           for x in (sp.low, sp.high)] for a, sp in spaces.items()}
        self.batch = int(traffic["batch"])
        self.horizon = int(traffic["episode_steps"])
        self.states = self.eps = None

    def begin(self, seed: int) -> None:
        s_engine, s_world, s_act = derived_seeds(seed, 3)
        self.gen = torch.Generator(device=self.device).manual_seed(s_engine)
        self.gen_world = torch.Generator(device=self.device).manual_seed(s_world)
        self.gen_act = torch.Generator(device=self.device).manual_seed(s_act)

    def reset(self) -> None:
        from pednstream_tpu_torch.randomize import randomize_engine_params_batched

        self.states = self.eps = None
        self.world_gen_state = self.gen_world.get_state()
        self.eps = randomize_engine_params_batched(self.scn, self.gen_world, self.batch)
        self.states = self.core.batch_reset(self.batch)[0]

    def _actions(self) -> dict:
        return {a: lo + (hi - lo) * torch.rand((self.batch,) + lo.shape, generator=self.gen_act,
                                               device=self.device, dtype=lo.dtype)
                for a, (lo, hi) in self.bounds.items()}

    def _step(self, actions) -> tuple:
        self.states, obs, rewards, _ = self.core.batch_step_randomized(
            self.states, actions, self.eps, self.gen, lockstep=True)
        return obs, rewards

    def step(self) -> None:
        self._step(self._actions())

    def start_record(self, rows) -> dict:
        return {"state": self.states.take(rows), "eps": self.eps.take(rows),
                "world_gen": self.world_gen_state}

    def snapshot(self, rows) -> dict:
        self._pending = self._actions()
        return {"state": self.states.take(rows), "gen": self.gen.get_state(),
                "actions": {a: x[rows].clone() for a, x in self._pending.items()}}

    def captured_step(self, rows) -> dict:
        from pednstream_tpu_torch import engine

        got: Dict[str, list] = {}
        with capture(engine, rows, got):
            obs, rewards = self._step(self._pending)
        self._pending = None
        return {"state": self.states.take(rows), **got,
                "obs": {a: x[rows].clone() for a, x in obs.items()},
                "rewards": {a: x[rows].clone() for a, x in rewards.items()}}

    def release(self) -> None:
        self.states = self.eps = None


class Reference(StepReference):
    faults = ("unchanged", "half_batch", "altered", "speed", "reward", "obs")

    def build(self, ref, config: dict) -> None:
        gen = ref.generator.NetworkEnvGenerator(history_window=config["history_window"],
                                                device=self.device)
        self.scn = gen.build_od_randomizable(config["dataset"],
                                             binomial_mode=config["binomial_mode"])
        env = config["env"]
        self.core = ref.envcore.PedNetEnvCore(
            self.scn, ref.agents.build_agent_spec(self.scn), obs_mode=env["obs_mode"],
            normalize_obs=env["normalize_obs"], action_gap=env["action_gap"],
            reward_mode=env["reward_mode"], stochastic=True)

    def engine_params(self, world_gen_state, rows):
        """The randomized parameters of the replicas ``rows``: drawn at the
        whole batch from the world generator's state, then taken."""
        g = torch.Generator(device=self.device)
        g.set_state(world_gen_state)
        eps = self.ref.randomize.randomize_engine_params_batched(self.scn, g, self.batch)
        return eps.take(rows)

    def step_once(self, st, pre: dict, eps, draws) -> dict:
        st, obs, rewards, _, _ = self.core._step_impl(st, pre["actions"], eps, draws)
        return {"state": st, "obs": obs, "rewards": rewards}
