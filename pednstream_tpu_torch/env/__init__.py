"""The multi-agent RL environment on the port's engine: agent discovery
(host), the batched env core and the PettingZoo wrapper."""

from .agents import AgentSpec, build_agent_spec
from .core import PedNetEnvCore
from .pz_env import PedNetParallelEnv

__all__ = ["AgentSpec", "build_agent_spec", "PedNetEnvCore", "PedNetParallelEnv"]
