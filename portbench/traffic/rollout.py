"""Lockstep batched stochastic rollouts: ``engine.simulate_batched`` over
``batch`` replicas, one step per call, ``episode_steps`` steps an episode,
each episode from ``init_state``; the draws come from a generator seeded
from the run's seed."""

from typing import Dict

import torch

from portbench.check import StepReference
from portbench.drivers import capture, derived_seeds, seed_demand


class Driver:
    def __init__(self, config: dict, traffic: dict, device):
        from pednstream_tpu_torch.generator import NetworkEnvGenerator
        from pednstream_tpu_torch.scenario import build_scenario

        self.device = torch.device(device)
        seed_demand(config)
        args = NetworkEnvGenerator(device=self.device).scenario_args(config["dataset"])
        self.scn = build_scenario(**args, history_window=config["history_window"],
                                  binomial_mode=config["binomial_mode"], device=self.device)
        self.batch = int(traffic["batch"])
        self.horizon = int(traffic["episode_steps"])
        self.states = None

    def begin(self, seed: int) -> None:
        (s,) = derived_seeds(seed, 1)
        self.gen = torch.Generator(device=self.device).manual_seed(s)

    def reset(self) -> None:
        self.states = None  # the old rings go back to the allocator first
        self.states = self.scn.init_state(self.batch)

    def step(self) -> None:
        from pednstream_tpu_torch.engine import simulate_batched

        self.states = simulate_batched(self.scn, self.scn.engine_params, self.states, 1,
                                       gen=self.gen, stochastic=True)

    def start_record(self, rows) -> dict:
        """What the check needs of an episode's start."""
        return {"state": self.states.take(rows)}

    def snapshot(self, rows) -> dict:
        """The compared rows of the state and the engine's generator state,
        before a step."""
        return {"state": self.states.take(rows), "gen": self.gen.get_state()}

    def captured_step(self, rows) -> dict:
        """One step with its intermediates recorded; the compared rows after it."""
        from pednstream_tpu_torch import engine

        got: Dict[str, list] = {}
        with capture(engine, rows, got):
            self.step()
        return {"state": self.states.take(rows), **got}

    def release(self) -> None:
        self.states = None


class Reference(StepReference):
    faults = ("unchanged", "half_batch", "altered", "speed")

    def build(self, ref, config: dict) -> None:
        from portbench.reference.scenario import build_scenario

        gen = ref.generator.NetworkEnvGenerator(history_window=config["history_window"],
                                                device=self.device)
        args = gen.scenario_args(config["dataset"])
        self.scn = build_scenario(**args, history_window=config["history_window"],
                                  binomial_mode=config["binomial_mode"], device=self.device)

    def step_once(self, st, pre: dict, eps, draws) -> dict:
        st, _ = self.ref.engine.step_fn(self.scn, self.scn.engine_params, st, draws,
                                        stochastic=True, record=False)
        return {"state": st}
