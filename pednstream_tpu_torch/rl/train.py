"""Training drivers (the counterpart of ``pednstream_tpu/rl/train.py``).

``train_on_policy_multi_agent`` mirrors the reference's independent-
learner episode loop (rl/agents/PPO_backup.py:762-956, rl/train_rl.py:
35-106): per-episode rollouts over a dict of agents with delta->absolute
action conversion, per-episode PPO updates, and validation-gated best
checkpointing.  ``train_off_policy_multi_agent`` is the SAC loop
(rl/agents/SAC_copy.py:157-310).  ``init_train_state`` is the policy and
optimizer state of the JAX package's multi-device demo step; the step
itself (``make_dp_train_step``) comes with the multi-device slice.

    python -m pednstream_tpu_torch.rl.train --dataset butterfly_scC --algo ppo \\
        --episodes 100 --device cuda
"""

import json
import os
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..device import DEFAULT, resolve
from ..env.agents import FEATURES_PER_LINK, controlled_links_adjacency
from .networks import MLPPolicy, init_flax_
from .optim import adam_init
from .ppo import PPOAgent
from .rl_utils import validate_and_save_best
from .rule_based import NoControlAgent, RuleBasedGaterAgent, RuleBasedSeparatorAgent
from .sac import SACAgent


# -- agent construction (train_rl.py:70-95) -----------------------------------

def build_agents(env, algo: str = "ppo", net_type: str = "attention",
                 seed: int = 0, **kwargs) -> Dict[str, object]:
    """One agent per env agent id; ``kwargs`` (``device`` among them) go
    to every PPO or SAC agent."""
    fpl = FEATURES_PER_LINK[env.obs_mode]
    agents: Dict[str, object] = {}
    spec = env.spec_agents
    for i, agent_id in enumerate(spec.agent_ids):
        space = env.action_space(agent_id)
        obs_space = env.observation_space(agent_id)
        act_dim = int(np.prod(space.shape))
        obs_dim = int(np.prod(obs_space.shape))
        if algo == "ppo":
            extra = dict(kwargs)
            if net_type == "gat" and agent_id.startswith("gate"):
                gi = spec.gate_ids.index(agent_id)
                extra["adj"] = controlled_links_adjacency(env.scn, spec.gate_links[gi])
            agents[agent_id] = PPOAgent(
                obs_dim=obs_dim, act_dim=act_dim,
                features_per_link=fpl if agent_id.startswith("gate") else None,
                net_type=net_type if agent_id.startswith("gate") else "lstm",
                action_low=space.low, action_high=space.high,
                seed=seed + i, **extra,
            )
        elif algo == "sac":
            agents[agent_id] = SACAgent(
                obs_dim=obs_dim, act_dim=act_dim,
                action_low=space.low, action_high=space.high,
                seed=seed + i, is_separator=agent_id.startswith("sep"),
                **kwargs,
            )
        elif algo == "rule_based":
            if agent_id.startswith("gate"):
                agents[agent_id] = RuleBasedGaterAgent(
                    act_dim=act_dim, max_widths=space.high, features_per_link=fpl
                )
            else:
                total = float(spec.sep_total_width[spec.sep_ids.index(agent_id)])
                agents[agent_id] = RuleBasedSeparatorAgent(total_width=total)
        elif algo == "no_control":
            agents[agent_id] = NoControlAgent(space.high if agent_id.startswith("gate")
                                              else (space.low + space.high) / 2)
        else:
            raise ValueError(f"unknown algo {algo}")
    return agents


# -- on-policy loop (PPO_backup.py:762-956) ------------------------------------

def train_on_policy_multi_agent(
    env,
    agents: Dict[str, PPOAgent],
    num_episodes: int = 100,
    randomize: bool = False,
    val_freq: int = 10,
    save_dir: Optional[str] = None,
    log_fn: Optional[Callable[[int, dict], None]] = None,
):
    history = []
    best_reward = -np.inf
    for episode in range(num_episodes):
        obs, _ = env.reset(options={"randomize": randomize})
        for a in agents.values():
            if hasattr(a, "reset_hidden"):
                a.reset_hidden()
        done = False
        ep_reward = 0.0
        while not done:
            deltas = {aid: agents[aid].take_action(obs[aid]) for aid in agents}
            actions = {
                aid: agents[aid].absolute_action(obs[aid], deltas[aid])
                for aid in agents
            }  # delta -> absolute (PPO_backup.py:848-851)
            next_obs, rewards, terms, truncs, infos = env.step(actions)
            done = any(terms.values()) or any(truncs.values())
            for aid in agents:
                if hasattr(agents[aid], "store_transition"):
                    agents[aid].store_transition(
                        obs[aid], deltas[aid], rewards.get(aid, 0.0), done
                    )
                ep_reward += infos.get(aid, {}).get(
                    "true_reward", rewards.get(aid, 0.0)
                )
            obs = next_obs
        metrics = {}
        for aid in agents:
            if hasattr(agents[aid], "update"):
                metrics[aid] = agents[aid].update()
        history.append({"episode": episode, "reward": ep_reward, **{
            f"{aid}_loss": m.get("actor_loss") for aid, m in metrics.items() if m
        }})
        if log_fn:
            log_fn(episode, history[-1])
        # validation-gated checkpointing after half of training
        # (PPO_backup.py:928-939)
        if save_dir and episode >= num_episodes // 2 and (episode + 1) % val_freq == 0:
            best_reward = validate_and_save_best(env, agents, best_reward, save_dir)
    return history


# -- off-policy loop (SAC_copy.py:157-310) --------------------------------------

def train_off_policy_multi_agent(
    env,
    agents: Dict[str, SACAgent],
    num_episodes: int = 100,
    randomize: bool = False,
    updates_per_step: int = 1,
    warmup_steps: int = 200,
    val_freq: int = 10,
    save_dir: Optional[str] = None,
    log_fn: Optional[Callable[[int, dict], None]] = None,
):
    history = []
    best_reward = -np.inf
    if save_dir:
        # never regress an existing checkpoint: a fresh training run must
        # beat the previously shipped validation score before it may
        # overwrite save_dir
        cfg_path = os.path.join(save_dir, "config.json")
        if os.path.exists(cfg_path):
            try:
                with open(cfg_path) as f:
                    prev = json.load(f).get("extra", {}).get("val_reward")
                if prev is not None:
                    best_reward = float(prev)
            except (json.JSONDecodeError, OSError):
                pass
    total_steps = 0
    for episode in range(num_episodes):
        # off-policy replay tolerates mixed worlds, so keep 1-in-4
        # episodes on the nominal scenario
        ep_randomize = randomize and (episode % 4 != 3)
        obs, _ = env.reset(options={"randomize": ep_randomize})
        for a in agents.values():
            a.reset_hidden()  # first push below tiles the reset obs
        done = False
        ep_reward = 0.0
        while not done:
            deltas, cur_stacks = {}, {}
            for aid in agents:
                if total_steps < warmup_steps:
                    act_dim = agents[aid].act_dim
                    deltas[aid] = np.random.uniform(
                        -agents[aid].max_delta, agents[aid].max_delta, act_dim
                    ).astype(np.float32)
                    agents[aid]._stack(obs[aid])  # keep the window rolling
                else:
                    deltas[aid] = agents[aid].take_action(obs[aid])
                cur_stacks[aid] = agents[aid].last_stack
            actions = {
                aid: agents[aid].absolute_action(obs[aid], deltas[aid])
                for aid in agents
            }
            next_obs, rewards, terms, truncs, infos = env.step(actions)
            done = any(terms.values()) or any(truncs.values())
            for aid in agents:
                # the stored next state includes next_obs (peek, don't
                # push: take_action pushes next iteration); deltas are
                # stored raw, SACAgent.update normalizes by max_delta
                next_stack = agents[aid].peek_stack(next_obs[aid])
                agents[aid].store_transition(
                    cur_stacks[aid], deltas[aid],
                    rewards.get(aid, 0.0), next_stack, done,
                )
                ep_reward += infos.get(aid, {}).get(
                    "true_reward", rewards.get(aid, 0.0)
                )
            obs = next_obs
            total_steps += 1
            if total_steps >= warmup_steps:
                for aid in agents:
                    for _ in range(updates_per_step):
                        agents[aid].update()
        history.append({"episode": episode, "reward": ep_reward})
        if log_fn:
            log_fn(episode, history[-1])
        if save_dir and episode >= num_episodes // 2 and (episode + 1) % val_freq == 0:
            best_reward = validate_and_save_best(env, agents, best_reward, save_dir)
    if save_dir:
        # the final state competes too: off-policy training is not monotone
        validate_and_save_best(env, agents, best_reward, save_dir)
    return history


# -- state of the data-parallel demo trainer -----------------------------------

def init_train_state(core, seed: int = 0, device=DEFAULT) -> dict:
    """Policy + optimizer state for the batched data-parallel trainer: an
    ``MLPPolicy`` for the first gater (or the separators) with flax's
    initializers drawn on the host from ``seed``, moved to ``device``, and
    an Adam state at ``tx["lr"] = 3e-4`` for ``rl.optim.adam_update``."""
    device = resolve(device)
    spec = core.spec
    agent_id = spec.gate_ids[0] if spec.gate_ids else "sep"
    if spec.gate_ids:
        obs_dim = len(spec.gate_links[0]) * FEATURES_PER_LINK[core.obs_mode]
        act_dim = len(spec.gate_links[0])
    else:
        obs_dim, act_dim = 4, 1
    gen = torch.Generator().manual_seed(seed)
    policy = init_flax_(MLPPolicy(obs_dim, act_dim), gen).to(device)
    return {
        "agent_id": agent_id,
        "policy": policy,
        "params": list(policy.parameters()),
        "tx": {"lr": 3e-4},
        "opt_state": adam_init(policy.parameters()),
        "act_dim": act_dim,
    }


# -- CLI (reference rl/train_rl.py:35-247) ---------------------------------------

def make_logger(log_path: Optional[str] = None, use_wandb: bool = False,
                project: str = "crowd-control-rl"):
    """Episode metric logger: JSONL file, console, optional wandb
    (PPO_backup.py:783-786,913-926)."""
    run = None
    if use_wandb:
        try:
            import wandb

            run = wandb.init(project=project)
        except ImportError:
            print("wandb not installed; falling back to JSONL logging")
    fh = open(log_path, "a") if log_path else None

    def log_fn(episode: int, metrics: dict):
        print(f"episode {episode}: " + ", ".join(
            f"{k}={v:.3f}" for k, v in metrics.items()
            if isinstance(v, (int, float)) and v is not None
        ))
        if fh:
            fh.write(json.dumps(metrics, default=float) + "\n")
            fh.flush()
        if run:
            run.log(metrics, step=episode)

    return log_fn


def main(argv=None):
    import argparse

    from ..env import PedNetParallelEnv
    from .rl_utils import RunningNormalizeWrapper, save_all_agents

    parser = argparse.ArgumentParser(
        description="Train multi-agent crowd-control policies"
    )
    parser.add_argument("--dataset", default="butterfly_scC")
    parser.add_argument("--algo", default="ppo", choices=["ppo", "sac"])
    parser.add_argument("--net", default="attention",
                        choices=["attention", "lstm", "stacked", "mlp",
                                 "gat", "udlstm"])
    parser.add_argument("--episodes", type=int, default=100)
    parser.add_argument("--obs-mode", default="option2")
    parser.add_argument("--action-gap", type=int, default=15)
    parser.add_argument("--randomize", action="store_true")
    parser.add_argument("--normalize", action="store_true", default=True)
    parser.add_argument("--save-dir", default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--wandb", action="store_true")
    parser.add_argument("--log-file", default=None)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    env = PedNetParallelEnv(args.dataset, obs_mode=args.obs_mode,
                            seed=args.seed, action_gap=args.action_gap,
                            device=args.device)
    wrapped = RunningNormalizeWrapper(env) if args.normalize else env
    save_dir = args.save_dir or f"outputs/{args.algo}_agents_{args.dataset}"
    log_fn = make_logger(args.log_file, use_wandb=args.wandb)

    if args.algo == "ppo":
        agents = build_agents(env, algo="ppo", net_type=args.net, seed=args.seed,
                              device=args.device)
        train_on_policy_multi_agent(wrapped, agents, num_episodes=args.episodes,
                                    randomize=args.randomize,
                                    save_dir=save_dir, log_fn=log_fn)
    else:
        agents = build_agents(env, algo="sac", seed=args.seed, device=args.device)
        train_off_policy_multi_agent(wrapped, agents, num_episodes=args.episodes,
                                     randomize=args.randomize,
                                     save_dir=save_dir, log_fn=log_fn)
    save_all_agents(agents, save_dir, env=wrapped)
    print(f"saved agents to {save_dir}")


if __name__ == "__main__":
    main()
