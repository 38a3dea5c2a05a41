"""Batched SAC on the card: vectorized collection and update steps (the
counterpart of ``pednstream_tpu/rl/batched_sac.py``).

B lockstep env replicas collect transitions into a device-resident replay
ring, then every agent takes ``updates_per_iter`` SAC steps on uniform
minibatches from it.  The math is the host SACAgent's (``sac.sac_update``:
twin Q, tanh-squashed Gaussian over a frame-stacked window, auto-entropy
via log_alpha, soft target updates — SAC_copy.py:313-482) and the
RunningNormalizeWrapper pipeline (rl_utils.py:86-300): per-agent running
obs normalization that skips the gate-width feature, and reward
normalization by the running std of discounted returns, both updated with
the whole replica batch (Chan's parallel update).  Checkpoints export in
the host format ({agent_id}.pkl + config.json + norm_stats.json), which
both packages' ``build_agents`` + ``load_all_agents`` load.

Independent learners: every gate agent and every separator agent owns its
actor/critic/alpha.  The ring pointer and fill are host integers (the
batch writes B rows per step in lockstep), so warm-up is a host branch:
before the ring holds ``warmup_transitions`` the iteration's updates run on
copies that are dropped, so the parameters and optimizer state stay as
they were and the logged losses are those of the unchanged parameters, as
the JAX trainer's masked updates log them.  Random draws come from the state's
``torch.Generator`` (the initial weights from a host generator of the
same seed), so the JAX trainer's streams are matched in distribution
only.

``mesh=`` (a ``parallel.Mesh`` with an ``env`` axis) shards the collection:
``num_envs`` stays the size of the WHOLE batch, each rank steps its block
of the replicas with the unsharded trainer's draws
(``parallel.BlockDraws``), and one all-gather per RL step brings every
rank the whole batch's actions, observations, rewards and done flags.  The
replay ring, the frame stacks, the return accumulators and the running
moments are then the unsharded trainer's on every rank (the moments are
taken over the gathered batch, so they are equal bit for bit), and so are
the updates: minibatches come from the replicated ring with the same
draws, so parameters and optimizer state stay replicated without a
gradient exchange.

Usage:
    trainer = BatchedSACTrainer(env.core, num_envs=64, randomize=True)
    state = trainer.init(seed=0)
    for it in range(200):
        state, metrics = trainer.train_iteration(state)
    trainer.export(state, "outputs/sac_agents_x", extra={...})
"""

import copy
import json
import os
import pickle
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from ..env.agents import FEATURES_PER_LINK
from ..env.core import PedNetEnvCore
from ..state import EngineParams, NetworkState
from ..engine import draw
from .batched_ppo import ReplicaSharding, _draw_worlds
from .networks import SACActor, SACCritic, init_flax_
from .optim import adam_init
from .sac import checkpoint, sac_update


@dataclass
class SACTrainerState:
    env_states: NetworkState
    obs: Dict[str, torch.Tensor]  # raw per-agent obs [B, obs_dim]
    stacks: Dict[str, torch.Tensor]  # normalized frame stacks [B, S, obs_dim]
    params: Dict[str, dict]  # per agent: actor/critic/target modules, log_alpha
    opt_states: Dict[str, dict]
    rms: Dict[str, Dict[str, torch.Tensor]]  # obs mean/var/count + ret mean/var/count
    returns: Dict[str, torch.Tensor]  # discounted return accumulators [B]
    buffers: Dict[str, Dict[str, torch.Tensor]]
    ptr: int  # shared ring pointer (lockstep writes)
    size: int
    engine_params: Optional[EngineParams]  # per-replica when randomize
    gen: torch.Generator
    iteration: int


class BatchedSACTrainer:
    def __init__(
        self,
        core: PedNetEnvCore,
        num_envs: int = 64,
        collect_steps: int = 8,
        updates_per_iter: int = 32,
        batch_size: int = 256,
        buffer_capacity: int = 65536,
        stack_size: int = 4,
        hidden_dim: int = 64,
        actor_lr: float = 3e-4,
        critic_lr: float = 3e-4,
        alpha_lr: float = 3e-4,
        gamma: float = 0.99,
        tau: float = 0.005,
        max_delta: float = 2.5,
        warmup_transitions: int = 1024,
        clip_obs: float = 10.0,
        clip_reward: float = 10.0,
        randomize: bool = False,
        randomize_fraction: float = 1.0,
        gate_anchor: str = "open",
        mesh=None,
    ):
        if gate_anchor not in ("current", "open"):
            raise ValueError("gate_anchor must be 'current' or 'open'")
        self.mesh = mesh
        self.sharding = ReplicaSharding(mesh, num_envs)
        self.Bl = self.sharding.local  # this rank's replicas (all of them without a mesh)
        self.core = core
        self.scn = core.scn
        self.spec = core.spec
        self.device = core.scn.device
        self.B = num_envs
        self.C = collect_steps
        self.U = updates_per_iter
        self.batch_size = batch_size
        self.cap = buffer_capacity
        self.S = stack_size
        self.hidden_dim = hidden_dim
        self.lrs = {"actor": actor_lr, "critic": critic_lr, "alpha": alpha_lr}
        self.gamma = gamma
        self.tau = tau
        self.max_delta = max_delta
        self.warmup = warmup_transitions
        self.clip_obs = clip_obs
        self.clip_reward = clip_reward
        self.randomize = randomize
        self.randomize_fraction = randomize_fraction
        self.gate_anchor = gate_anchor

        fpl = FEATURES_PER_LINK[core.obs_mode]

        def dev(a, dtype=torch.float32):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

        # independent learners keyed by env agent id, 1:1 with the host
        # checkpoint format
        self.agents: Dict[str, dict] = {}
        for i, gid in enumerate(self.spec.gate_ids):
            L = len(self.spec.gate_links[i])
            mask = np.ones(L * fpl, bool)
            mask.reshape(L, fpl)[:, -1] = False  # the gate width stays raw
            self.agents[gid] = {
                "obs_dim": L * fpl, "act_dim": L, "kind": "gate", "index": i,
                "norm_mask": dev(mask, torch.bool),
                "low": dev(np.zeros(L)), "high": dev(self.spec.gate_link_widths[i]),
            }
        for i, sid in enumerate(self.spec.sep_ids):
            lo = float(self.spec.min_sep_width)
            hi = float(self.spec.sep_total_width[i]) - lo
            self.agents[sid] = {
                "obs_dim": 4, "act_dim": 1, "kind": "sep", "index": i,
                "norm_mask": dev(np.ones(4, bool), torch.bool),
                "low": dev([lo]), "high": dev([hi]),
            }

    # -- setup -------------------------------------------------------------------

    def init(self, seed: int = 0) -> SACTrainerState:
        dev = self.device
        self.sharding.check_scenario(self.scn)
        gen = torch.Generator(device=dev).manual_seed(seed)
        env_states, obs_env = self.core.batch_reset(self.Bl)
        eps = self._worlds(gen) if self.randomize else None
        init_gen = torch.Generator().manual_seed(seed)  # weights: drawn on the host
        params, opts, rms, rets, stacks, bufs = {}, {}, {}, {}, {}, {}
        obs_raw = self._whole_obs(obs_env)
        for aid, meta in self.agents.items():
            dims = (meta["obs_dim"], meta["act_dim"], self.S, self.hidden_dim)
            actor = init_flax_(SACActor(*dims), init_gen).to(dev)
            critic = init_flax_(SACCritic(*dims), init_gen).to(dev)
            log_alpha = torch.zeros((), device=dev, requires_grad=True)
            params[aid] = {"actor": actor, "critic": critic,
                           "target": copy.deepcopy(critic), "log_alpha": log_alpha}
            opts[aid] = {"actor": adam_init(list(actor.parameters())),
                         "critic": adam_init(list(critic.parameters())),
                         "alpha": adam_init([log_alpha])}
            rms[aid] = {
                "obs_mean": torch.zeros(meta["obs_dim"], device=dev),
                "obs_var": torch.ones(meta["obs_dim"], device=dev),
                "obs_count": torch.tensor(1e-4, device=dev),
                "ret_mean": torch.zeros((), device=dev),
                "ret_var": torch.ones((), device=dev),
                "ret_count": torch.tensor(1e-4, device=dev),
            }
            rets[aid] = torch.zeros(self.B, device=dev)
            o0 = self._normalize(aid, rms[aid], obs_raw[aid])
            stacks[aid] = o0[:, None, :].repeat(1, self.S, 1)
            bufs[aid] = {
                "s": torch.zeros((self.cap, self.S, meta["obs_dim"]), device=dev),
                "a": torch.zeros((self.cap, meta["act_dim"]), device=dev),
                "r": torch.zeros((self.cap,), device=dev),
                "ns": torch.zeros((self.cap, self.S, meta["obs_dim"]), device=dev),
                "d": torch.zeros((self.cap,), device=dev),
            }
        return SACTrainerState(
            env_states=env_states, obs=obs_raw, stacks=stacks, params=params,
            opt_states=opts, rms=rms, returns=rets, buffers=bufs, ptr=0, size=0,
            engine_params=eps, gen=gen, iteration=0)

    # -- helpers -----------------------------------------------------------------

    def _worlds(self, gen: torch.Generator) -> EngineParams:
        """The whole batch's world draws, cut to this rank's replicas."""
        return self.sharding.take(
            _draw_worlds(self.scn, gen, self.B, self.randomize_fraction))

    def _whole_obs(self, obs_env) -> Dict[str, torch.Tensor]:
        """Every agent's raw observation of the whole batch from this
        rank's env observations."""
        return dict(zip(self.agents, self.sharding.whole(
            [self._agent_obs(obs_env, aid) for aid in self.agents])))

    def _agent_obs(self, obs_env, aid):
        meta = self.agents[aid]
        if meta["kind"] == "sep":
            return obs_env["sep"][:, meta["index"], :]
        return obs_env[aid]

    def _normalize(self, aid, rms_a, o_raw):
        """Running-normalize ``[B, obs_dim]`` obs, skipping the gate-width
        feature (rl_utils.py:113-132 semantics)."""
        normed = (o_raw - rms_a["obs_mean"]) / torch.sqrt(rms_a["obs_var"] + 1e-8)
        normed = torch.clamp(normed, -self.clip_obs, self.clip_obs)
        return torch.where(self.agents[aid]["norm_mask"], normed, o_raw).to(torch.float32)

    @staticmethod
    def _rms_update(mean, var, count, batch):
        """Chan's parallel update with a ``[B, ...]`` batch (population
        variance of the batch, as NumPy's)."""
        b_mean = batch.mean(dim=0)
        b_var = batch.var(dim=0, correction=0)
        b_count = batch.shape[0]
        delta = b_mean - mean
        tot = count + b_count
        new_mean = mean + delta * b_count / tot
        m_a = var * count
        m_b = b_var * b_count
        m2 = m_a + m_b + delta ** 2 * count * b_count / tot
        return new_mean, m2 / tot, tot

    def _absolute(self, aid, o_raw, delta):
        meta = self.agents[aid]
        if meta["kind"] == "sep":
            cur = ((meta["low"] + meta["high"]) / 2.0).expand_as(delta)
        elif self.gate_anchor == "open":
            cur = meta["high"].expand_as(delta)
        else:  # reference integrator semantics: anchor at the current width
            cur = o_raw.reshape(o_raw.shape[0], meta["act_dim"], -1)[:, :, -1]
        return torch.minimum(torch.maximum(cur + delta, meta["low"]), meta["high"])

    # -- collection --------------------------------------------------------------

    @torch.no_grad()
    def _collect(self, ts: SACTrainerState) -> torch.Tensor:
        """``collect_steps`` lockstep RL steps into the replay ring; moves
        ``ts`` past them and returns the mean reward per agent and step
        (a device scalar)."""
        B, dev = self.B, self.device
        env_states, obs, eps = ts.env_states, dict(ts.obs), ts.engine_params
        rewards_sum = torch.zeros((), device=dev)
        mine = self.sharding.block  # this rank's replicas of the whole-batch leaves
        draws = self.sharding.draws(ts.gen)
        for _ in range(self.C):
            deltas, abs_acts = {}, {}
            for aid, meta in self.agents.items():
                noise = draw(draws, True, (self.Bl, meta["act_dim"]), torch.float32, dev)
                a, _ = ts.params[aid]["actor"].sample(ts.stacks[aid][mine], eps=noise)
                deltas[aid] = a  # the ring stores the [-1, 1] pre-scale action
                abs_acts[aid] = self._absolute(aid, obs[aid][mine], a * self.max_delta)
            env_actions = {aid: abs_acts[aid] for aid in self.agents
                           if self.agents[aid]["kind"] == "gate"}
            if self.spec.sep_ids:
                env_actions["sep"] = torch.cat([abs_acts[sid] for sid in self.spec.sep_ids],
                                               dim=-1)
            env_states, obs_env, rewards, done, _ = self.core._step_impl(
                env_states, env_actions, eps, draws)
            # the whole batch's transition on every rank (one collective)
            zeros = torch.zeros(self.Bl, device=dev)
            n = len(self.agents)
            whole = self.sharding.whole(
                [deltas[aid] for aid in self.agents]
                + [self._agent_obs(obs_env, aid) for aid in self.agents]
                + [rewards.get(aid, zeros) for aid in self.agents] + [done.to(torch.float32)])
            deltas = dict(zip(self.agents, whole[:n]))
            obs = dict(zip(self.agents, whole[n:2 * n]))
            rewards = dict(zip(self.agents, whole[2 * n:3 * n]))
            done_f = whole[-1]
            idx = (ts.ptr + torch.arange(B, device=dev)) % self.cap
            zeros = torch.zeros(B, device=dev)
            for aid in self.agents:
                o = obs[aid]
                r_a = ts.rms[aid]
                r_a["obs_mean"], r_a["obs_var"], r_a["obs_count"] = self._rms_update(
                    r_a["obs_mean"], r_a["obs_var"], r_a["obs_count"], o)
                next_stack = torch.cat(
                    [ts.stacks[aid][:, 1:], self._normalize(aid, r_a, o)[:, None, :]], dim=1)
                r_true = rewards.get(aid, zeros)
                ret = ts.returns[aid] * self.gamma + r_true
                rm, rv, r_a["ret_count"] = self._rms_update(
                    r_a["ret_mean"], r_a["ret_var"], r_a["ret_count"], ret[:, None])
                r_a["ret_mean"], r_a["ret_var"] = rm[0], rv[0]
                r_n = torch.clamp(r_true / torch.sqrt(r_a["ret_var"] + 1e-8),
                                  -self.clip_reward, self.clip_reward)
                b = ts.buffers[aid]
                for k, x in (("s", ts.stacks[aid]), ("a", deltas[aid]), ("r", r_n),
                             ("ns", next_stack), ("d", done_f)):
                    b[k][idx] = x
                ts.returns[aid] = ret * (1.0 - done_f)
                ts.stacks[aid] = next_stack
            rewards_sum = rewards_sum + sum(
                rewards.get(a, zeros).mean() for a in self.agents) / len(self.agents)
            ts.ptr = (ts.ptr + B) % self.cap
            ts.size = min(ts.size + B, self.cap)

            if env_states.t > self.scn.simulation_steps:
                # the lockstep batch finished: fresh engine states, stacks
                # anchored at the fresh obs, fresh world draws
                env_states = self.scn.init_state(self.Bl)
                if self.randomize:
                    eps = self._worlds(ts.gen)
                obs = self._whole_obs(self.core._observations(env_states))
                for aid in self.agents:
                    fo_n = self._normalize(aid, ts.rms[aid], obs[aid])
                    ts.stacks[aid] = fo_n[:, None, :].repeat(1, self.S, 1)
        ts.env_states, ts.obs, ts.engine_params = env_states, obs, eps
        return rewards_sum / self.C

    # -- update ------------------------------------------------------------------

    def _sac_update(self, aid, p, opt, batch, noise):
        """One SAC gradient step of agent ``aid`` (the math of
        ``SACAgent._update_step``) with ``noise = (eps_next, eps_pi)``."""
        return sac_update(p["actor"], p["critic"], p["target"], p["log_alpha"], opt,
                          self.lrs, batch, noise, self.gamma, self.tau,
                          -float(self.agents[aid]["act_dim"]))

    def _learn(self, ts: SACTrainerState, mean_r):
        """The update half of an iteration; returns ``ts`` and device-scalar
        metrics: ``reward``, ``buffer_size`` and, per agent, ``actor_loss``
        and ``critic_loss`` (the means over the iteration's updates) and
        ``alpha``.  Every iteration evaluates its ``U`` updates on batches
        drawn from the filled part of the ring, as the JAX trainer's scan
        does; before the ring holds ``warmup_transitions`` each update runs
        on a copy of the parameters and optimizer state, which is dropped
        (JAX masks the update), so the losses are those of the unchanged
        parameters."""
        ready = ts.size >= min(self.warmup, self.cap)
        metrics = {"reward": mean_r, "buffer_size": float(ts.size)}
        for aid in self.agents:
            p, opt, b = ts.params[aid], ts.opt_states[aid], ts.buffers[aid]
            a_losses, c_losses = [], []
            for _ in range(self.U):
                idx = torch.randint(0, max(ts.size, 1), (self.batch_size,), generator=ts.gen,
                                    device=self.device)
                shape = (self.batch_size, self.agents[aid]["act_dim"])
                noise = tuple(torch.randn(shape, generator=ts.gen, device=self.device)
                              for _ in range(2))
                batch = tuple(b[k][idx] for k in ("s", "a", "r", "ns", "d"))
                p_u, opt_u = (p, opt) if ready else copy.deepcopy((p, opt))
                a_loss, c_loss = self._sac_update(aid, p_u, opt_u, batch, noise)
                a_losses.append(a_loss)
                c_losses.append(c_loss)
            metrics[f"{aid}/actor_loss"] = torch.stack(a_losses).mean()
            metrics[f"{aid}/critic_loss"] = torch.stack(c_losses).mean()
            metrics[f"{aid}/alpha"] = torch.exp(p["log_alpha"].detach())
        ts.iteration += 1
        return ts, metrics

    def train_iteration(self, ts: SACTrainerState):
        ts, metrics = self._learn(ts, self._collect(ts))
        return ts, {k: float(v) for k, v in metrics.items()}

    # -- persistence --------------------------------------------------------------

    def agent_config(self, aid: str) -> dict:
        meta = self.agents[aid]
        return {"obs_dim": meta["obs_dim"], "act_dim": meta["act_dim"],
                "stack_size": self.S, "gamma": self.gamma, "tau": self.tau,
                "max_delta": self.max_delta, "gate_anchor": self.gate_anchor,
                "algo": "sac"}

    def export(self, ts: SACTrainerState, save_dir: str, extra: Optional[dict] = None):
        """Write host-format checkpoints: {agent_id}.pkl (SACAgent.save
        layout), config.json (save_all_agents layout), norm_stats.json
        (RunningNormalizeWrapper.save_stats layout)."""
        os.makedirs(save_dir, exist_ok=True)
        for aid in self.agents:
            p = ts.params[aid]
            with open(os.path.join(save_dir, f"{aid}.pkl"), "wb") as f:
                pickle.dump(checkpoint(self.agent_config(aid), p["actor"], p["critic"],
                                       p["target"], p["log_alpha"]), f)
        with open(os.path.join(save_dir, "config.json"), "w") as f:
            json.dump({"agents": {aid: self.agent_config(aid) for aid in self.agents},
                       "extra": extra or {}}, f, indent=2, default=str)
        stats = {"obs_rms": {}, "ret_rms": {}}
        for aid in self.agents:
            r = {k: v.cpu().numpy() for k, v in ts.rms[aid].items()}
            stats["obs_rms"][aid] = {"mean": r["obs_mean"].tolist(),
                                     "var": r["obs_var"].tolist(),
                                     "count": float(r["obs_count"])}
            stats["ret_rms"][aid] = {"mean": float(r["ret_mean"]),
                                     "var": float(r["ret_var"]),
                                     "count": float(r["ret_count"])}
        with open(os.path.join(save_dir, "norm_stats.json"), "w") as f:
            json.dump(stats, f)
