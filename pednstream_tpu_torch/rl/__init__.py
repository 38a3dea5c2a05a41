"""Policies, agents and trainers on the port (the counterpart of
``pednstream_tpu/rl``): the network families (networks), the host PPO and
SAC agents (ppo, sac), rule-based baselines, the batched PPO and SAC
trainers that step the env core on the card, the training drivers
(train) and the host utilities (rl_utils).  The host consumers
(evaluate, metrics, optimization_based, adapters) come with a later
slice."""

from .ppo import PPOAgent
from .sac import SACAgent
from .rule_based import RuleBasedGaterAgent, RuleBasedSeparatorAgent
from .batched_ppo import BatchedPPOTrainer
from .batched_sac import BatchedSACTrainer

__all__ = ["PPOAgent", "SACAgent", "RuleBasedGaterAgent", "RuleBasedSeparatorAgent",
           "BatchedPPOTrainer", "BatchedSACTrainer"]
