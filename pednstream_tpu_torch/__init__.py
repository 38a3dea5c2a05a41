"""pednstream_tpu_torch — the pedestrian Link Transmission Model on PyTorch
and CUDA.

The port of ``pednstream_tpu`` to an NVIDIA H100, module by module under
the same names.  It imports ``torch``, numpy, networkx, PyYAML and (for
the ``'optimal'`` solve) scipy, and never JAX.  It holds the host-side
scenario compiler (config, topology, demand, routing tables, scenario,
generator, lp_solver), the engine's float32 fast path and float64
exact-parity path (engine, fd, routing), per-replica domain randomization
(randomize), the RL env core and its PettingZoo wrapper (env), the
policy networks, PPO/SAC agents, batched PPO and SAC trainers and training
drivers (rl) and the fused N-curve history-read kernel (ops,
csrc/ncurve.cu).
"""

from .config import load_config
from .engine import simulate, simulate_batched, step_fn
from .generator import NetworkEnvGenerator
from .scenario import Scenario, build_scenario
from .state import EngineParams, NetworkState, StepOutputs

__all__ = [
    "load_config",
    "simulate",
    "simulate_batched",
    "step_fn",
    "NetworkEnvGenerator",
    "Scenario",
    "build_scenario",
    "EngineParams",
    "NetworkState",
    "StepOutputs",
]
