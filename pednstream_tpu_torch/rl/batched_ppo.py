"""Batched PPO on the card: vectorized rollouts and updates (the
counterpart of ``pednstream_tpu/rl/batched_ppo.py``).

B env replicas roll T steps in lockstep through the env core — engine
steps (each through the fused history-read kernel), recurrent policy
torsos and value nets on the same device — GAE is computed over the
[T, B] batch, and every agent's PPO update re-forwards whole sequences
through the recurrent torso, minibatched over the replica axis, with the
clipped surrogate, an entropy bonus, the value loss and the
approximate-KL early stop (PPO_backup.py:1247-1389 semantics) as masked
updates.  Independent learners: each agent owns its policy and value
nets and one Adam state over both (``clip_by_global_norm(0.5)`` over the
joint tree, as the JAX trainer's ``{"p", "v"}``).

Policy families (``net_type``): ``mlp``; ``attention`` (per-link LSTM +
link attention for gate agents, a flat LSTM for the separator
pseudo-agent); ``lstm``; ``udlstm``.  Recurrent carries persist across
iterations and reset with the env state at an episode boundary; with
``randomize=True`` every replica simulates its own randomized world,
redrawn at each boundary.  Replicas run in lockstep, so the boundary is
known on the host from the state's ``t``: the reset is a host branch and
a training iteration needs no host sync until its metrics are read.

Random draws (the world draws, the action noise in a fixed agent order,
the minibatch permutations) all come from the state's ``torch.Generator``
on the trainer's device; the initial weights come from a host generator
of the same seed, so they are the same on every device.  The JAX
trainer's PRNG streams are not reproduced, so the two agree in
distribution.

Usage:
    env = PedNetParallelEnv("45_intersections", obs_mode="option2",
                            action_gap=15, history_window=64, device="cuda")
    trainer = BatchedPPOTrainer(env.core, num_envs=256, rollout_len=16,
                                net_type="attention", randomize=True)
    state = trainer.init(seed=0)
    for it in range(100):
        state, metrics = trainer.train_iteration(state)

``train_iteration`` updates ``state`` in place and returns it.
"""

import math
import pickle
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from ..env.agents import FEATURES_PER_LINK
from ..env.core import PedNetEnvCore
from ..interop import params_to_flax
from ..randomize import randomize_engine_params_batched
from ..state import EngineParams, NetworkState
from .networks import build_family, family_carry, init_flax_
from .optim import AdamState, adam_init, adam_update
from .ppo import _gaussian_logprob

MESH_NOT_PORTED = ("mesh= (a sharded trainer) is not ported yet: ROADMAP queue 4, "
                   "multi-device")


@dataclass
class TrainerState:
    env_states: NetworkState
    obs: Dict[str, torch.Tensor]
    params: Dict[str, torch.nn.Module]  # policy per agent
    value_params: Dict[str, torch.nn.Module]
    opt_states: Dict[str, AdamState]  # over the policy and value parameters together
    actor_carry: Dict[str, tuple]  # [B, ...] recurrent state per agent
    critic_carry: Dict[str, tuple]
    engine_params: Optional[EngineParams]  # per-replica when randomize=True, else None
    gen: torch.Generator
    iteration: int


def _where_done(done, fresh, cur):
    """``fresh`` where ``done [B]`` is true, else ``cur``, leaf for leaf
    over a tensor, a tuple of them or a dataclass of them (``fresh`` may
    lack the batch axis)."""
    if isinstance(cur, torch.Tensor):
        return torch.where(done.reshape((-1,) + (1,) * (cur.ndim - 1)), fresh, cur)
    if isinstance(cur, tuple):
        return tuple(_where_done(done, f, c) for f, c in zip(fresh, cur))
    return type(cur)(**{k: _where_done(done, getattr(fresh, k), v)
                        for k, v in vars(cur).items()})


def _draw_worlds(scn, gen: torch.Generator, batch: int, fraction: float) -> EngineParams:
    """One randomized EngineParams per replica; replicas
    ``[fraction * batch:]`` keep the scenario's nominal world."""
    eps = randomize_engine_params_batched(scn, gen, batch)
    if fraction >= 1.0:
        return eps
    n_rand = int(round(fraction * batch))
    nominal = torch.arange(batch, device=scn.device) >= n_rand
    return _where_done(nominal, scn.engine_params, eps)


def _take(carry, idx):
    return tuple(c[idx] for c in carry)


class BatchedPPOTrainer:
    def __init__(
        self,
        core: PedNetEnvCore,
        num_envs: int = 256,
        rollout_len: int = 32,
        lr: float = 3e-4,
        gamma: float = 0.99,
        lmbda: float = 0.95,
        eps_clip: float = 0.2,
        epochs: int = 4,
        minibatches: int = 4,
        max_delta: float = 2.5,
        entropy_coef: float = 1e-3,
        value_coef: float = 0.5,
        kl_target: float = 0.02,
        reward_scale: float = 1e-2,
        net_type: str = "mlp",
        hidden_dim: int = 64,
        randomize: bool = False,
        randomize_fraction: float = 1.0,
        mesh=None,
        gate_anchor: str = "current",
    ):
        if mesh is not None:
            raise NotImplementedError(MESH_NOT_PORTED)
        if gate_anchor not in ("current", "open"):
            raise ValueError("gate_anchor must be 'current' or 'open'")
        if num_envs % minibatches:
            raise ValueError("num_envs must divide evenly into minibatches")
        self.gate_anchor = gate_anchor
        self.core = core
        self.scn = core.scn
        self.spec = core.spec
        self.device = core.scn.device
        self.B = num_envs
        self.T = rollout_len
        self.lr = lr
        self.gamma = gamma
        self.lmbda = lmbda
        self.eps_clip = eps_clip
        self.epochs = epochs
        self.minibatches = minibatches
        self.max_delta = max_delta
        self.entropy_coef = entropy_coef
        self.value_coef = value_coef
        self.kl_target = kl_target
        self.reward_scale = reward_scale  # rewards are large negative travel-time sums
        self.net_type = net_type
        self.hidden_dim = hidden_dim
        self.randomize = randomize
        # fraction of replicas simulating randomized worlds; the rest keep
        # the scenario's nominal world
        self.randomize_fraction = randomize_fraction

        fpl = FEATURES_PER_LINK[core.obs_mode]

        def dev(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

        self.agents = {}
        for i, gid in enumerate(self.spec.gate_ids):
            L = len(self.spec.gate_links[i])
            self.agents[gid] = {
                "obs_dim": L * fpl, "act_dim": L, "fpl": fpl,
                "low": dev(np.zeros(L)), "high": dev(self.spec.gate_link_widths[i]),
            }
        if self.spec.sep_ids:
            S = len(self.spec.sep_ids)
            self.agents["sep"] = {
                "obs_dim": 4 * S, "act_dim": S, "fpl": None,
                "low": dev(np.full(S, self.spec.min_sep_width)),
                "high": dev(np.asarray(self.spec.sep_total_width) - self.spec.min_sep_width),
            }

    # -- network families --------------------------------------------------------

    def _family(self, aid: str) -> str:
        """Gate agents get the selected family; the separator pseudo-agent
        gets a flat LSTM under per-link families (mirrors
        rl.train.build_agents, reference train_rl.py:70-95)."""
        if self.net_type in ("attention", "udlstm"):
            return self.net_type if self.agents[aid]["fpl"] else "lstm"
        return self.net_type

    def _nets(self, aid: str):
        meta = self.agents[aid]
        return build_family(self._family(aid), meta["obs_dim"], meta["act_dim"],
                            meta["fpl"], self.hidden_dim)

    def _batched_carry(self, aid: str, B: Optional[int] = None):
        return family_carry(self._family(aid), B or self.B, self.agents[aid]["act_dim"],
                            self.hidden_dim, self.device)

    def _shape_obs(self, aid: str, o: torch.Tensor) -> torch.Tensor:
        """[B, obs_dim] -> [B, L, fpl] for per-link torsos."""
        if self._family(aid) in ("attention", "udlstm"):
            meta = self.agents[aid]
            return o.reshape(o.shape[0], meta["act_dim"], meta["fpl"])
        return o

    # -- setup -----------------------------------------------------------------

    def init(self, seed: int = 0) -> TrainerState:
        gen = torch.Generator(device=self.device).manual_seed(seed)
        env_states, obs = self.core.batch_reset(self.B)
        eps = _draw_worlds(self.scn, gen, self.B, self.randomize_fraction) if self.randomize else None
        init_gen = torch.Generator().manual_seed(seed)  # weights: drawn on the host
        params, vparams, opts, acar, ccar = {}, {}, {}, {}, {}
        for aid in self.agents:
            policy, value = (init_flax_(m, init_gen).to(self.device) for m in self._nets(aid))
            params[aid], vparams[aid] = policy, value
            opts[aid] = adam_init([*policy.parameters(), *value.parameters()])
            acar[aid] = self._batched_carry(aid)
            ccar[aid] = self._batched_carry(aid)
        return TrainerState(env_states=env_states, obs=obs, params=params,
                            value_params=vparams, opt_states=opts,
                            actor_carry=acar, critic_carry=ccar,
                            engine_params=eps, gen=gen, iteration=0)

    # -- helpers -----------------------------------------------------------------

    def _agent_obs(self, obs, aid):
        if aid == "sep":
            return obs["sep"].reshape(obs["sep"].shape[0], -1)
        return obs[aid]

    def _absolute(self, aid, obs_a, delta):
        meta = self.agents[aid]
        if meta["fpl"] and self.gate_anchor == "current":
            # reference semantics: delta from the current width (the last
            # feature per link), an integrator (PPO_backup.py:848-851)
            cur = obs_a.reshape(obs_a.shape[0], meta["act_dim"], -1)[:, :, -1]
        elif meta["fpl"]:
            # 'open' anchor: absolute target = full-open + learned offset
            cur = meta["high"].expand_as(delta)
        else:  # separator: target is absolute width around the midpoint
            cur = ((meta["low"] + meta["high"]) / 2).expand_as(delta)
        return torch.minimum(torch.maximum(cur + delta, meta["low"]), meta["high"])

    # -- rollout ------------------------------------------------------------------

    @torch.no_grad()
    def _rollout(self, ts: TrainerState):
        """T lockstep RL steps from ``ts``; returns ``(env_states, obs,
        actor_carry, critic_carry, engine_params, traj)`` with ``traj``
        holding ``[T, B, ...]`` tensors per agent ("obs" shaped for the
        torso, "delta", "logp", "value", "reward") and "done" ``[T, B]``."""
        env_states, obs, eps = ts.env_states, ts.obs, ts.engine_params
        acar, ccar = dict(ts.actor_carry), dict(ts.critic_carry)
        steps = {k: {aid: [] for aid in self.agents}
                 for k in ("obs", "delta", "logp", "value", "reward")}
        dones = []
        for _ in range(self.T):
            acts = {}
            for aid in self.agents:
                o = self._shape_obs(aid, self._agent_obs(obs, aid))
                mu, log_std, acar[aid] = ts.params[aid](o, acar[aid])
                v, ccar[aid] = ts.value_params[aid](o, ccar[aid])
                noise = torch.randn(mu.shape, generator=ts.gen, device=self.device)
                delta = torch.clamp(mu + torch.exp(log_std) * noise,
                                    -self.max_delta, self.max_delta)
                for k, x in (("obs", o), ("delta", delta), ("value", v),
                             ("logp", _gaussian_logprob(mu, log_std, delta))):
                    steps[k][aid].append(x)
                acts[aid] = self._absolute(aid, self._agent_obs(obs, aid), delta)
            env_states, obs, rewards, done, _ = self.core._step_impl(
                env_states, acts, eps, ts.gen)
            if env_states.t > self.scn.simulation_steps:
                # the lockstep batch finished its episode: fresh engine
                # states (the stepped rings are updated in place and not
                # reused), fresh carries and, randomized, fresh worlds
                env_states = self.scn.init_state(self.B)
                for aid in self.agents:
                    acar[aid] = self._batched_carry(aid)
                    ccar[aid] = self._batched_carry(aid)
                if self.randomize:
                    eps = _draw_worlds(self.scn, ts.gen, self.B, self.randomize_fraction)
                obs = self.core._observations(env_states)
            sep_key = self.spec.sep_ids[0] if self.spec.sep_ids else "sep"
            for aid in self.agents:
                r = rewards.get(sep_key if aid == "sep" else aid)
                steps["reward"][aid].append(
                    r if r is not None else torch.zeros(self.B, device=self.device))
            dones.append(done.to(torch.float32))
        traj = {k: {aid: torch.stack(xs) for aid, xs in per.items()}
                for k, per in steps.items()}
        traj["done"] = torch.stack(dones)
        return env_states, obs, acar, ccar, eps, traj

    # -- GAE ------------------------------------------------------------------

    def _gae(self, rewards, values, dones, last_value):
        v_next = torch.cat([values[1:], last_value[None]], dim=0)
        gae = torch.zeros_like(last_value)
        adv = []
        for t in reversed(range(rewards.shape[0])):
            delta = rewards[t] + self.gamma * v_next[t] * (1 - dones[t]) - values[t]
            gae = delta + self.gamma * self.lmbda * (1 - dones[t]) * gae
            adv.append(gae)
        adv = torch.stack(adv[::-1])
        return adv, adv + values

    # -- update ------------------------------------------------------------------

    def _sequence_forward(self, aid, nets, obs_seq, dones, carry0):
        """Re-forward ``[T, mb, ...]`` sequences through the recurrent
        torso, resetting hidden state at episode boundaries exactly as the
        rollout did."""
        policy, value = nets
        fresh = self._batched_carry(aid, obs_seq.shape[1])
        ac, cc = carry0
        mus, log_stds, vs = [], [], []
        for o_t, d_t in zip(obs_seq, dones):
            mu, log_std, ac = policy(o_t, ac)
            v, cc = value(o_t, cc)
            ac = _where_done(d_t > 0, fresh, ac)
            cc = _where_done(d_t > 0, fresh, cc)
            mus.append(mu)
            log_stds.append(log_std)
            vs.append(v)
        return torch.stack(mus), torch.stack(log_stds), torch.stack(vs)

    def _index_sets(self, gen: torch.Generator) -> torch.Tensor:
        """``[epochs * minibatches, B / minibatches]`` replica indices: one
        permutation of B per epoch, cut into minibatch slices."""
        mb = self.B // self.minibatches
        return torch.cat([
            torch.randperm(self.B, generator=gen, device=self.device).reshape(-1, mb)
            for _ in range(self.epochs)])

    def _agent_update(self, aid, nets, opt, obs_seq, dones, carry0,
                      act_seq, old_logp, adv, ret, idx_sets):
        """PPO epochs minibatched over the replica axis (sequences stay
        whole for the recurrent torsos), one update per row of
        ``idx_sets``, with the approximate-KL early stop: the update that
        trips ``|kl| > kl_target`` is applied and every later one is a
        masked no-op (PPO_backup.py:1345-1350).  Updates ``nets`` and
        ``opt`` in place; returns the mean loss over the updates applied
        and the last applied update's KL, as device scalars."""
        params = [p for m in nets for p in m.parameters()]
        zero = torch.zeros((), device=self.device)
        stopped = torch.zeros((), dtype=torch.bool, device=self.device)
        total_loss, n_applied, last_kl = zero, zero, zero
        for idx in idx_sets:
            c0 = (_take(carry0[0], idx), _take(carry0[1], idx))
            mu, log_std, v = self._sequence_forward(aid, nets, obs_seq[:, idx],
                                                    dones[:, idx], c0)
            logp = _gaussian_logprob(mu, log_std, act_seq[:, idx])
            ratio = torch.exp(logp - old_logp[:, idx])
            a = adv[:, idx]
            s1 = ratio * a
            s2 = torch.clamp(ratio, 1 - self.eps_clip, 1 + self.eps_clip) * a
            entropy = (log_std + 0.5 * math.log(2 * math.pi * math.e)).sum(-1).mean()
            v_loss = ((v - ret[:, idx]) ** 2).mean()
            kl = torch.mean(old_logp[:, idx] - logp).detach()
            loss = (-torch.minimum(s1, s2).mean() - self.entropy_coef * entropy
                    + self.value_coef * v_loss)
            grads = torch.autograd.grad(loss, params)
            adam_update(params, grads, opt, self.lr, max_norm=0.5, keep=stopped)
            total_loss = total_loss + torch.where(stopped, zero, loss.detach())
            n_applied = n_applied + torch.where(stopped, zero, zero + 1)
            last_kl = torch.where(stopped, last_kl, kl)
            stopped = stopped | (torch.abs(kl) > self.kl_target)
        # mean over the updates actually applied
        return total_loss / torch.clamp(n_applied, min=1.0), last_kl

    def _learn(self, ts: TrainerState, rolled):
        """The update half of an iteration: GAE and every agent's PPO
        epochs on the rollout ``rolled`` (from ``_rollout(ts)``); moves
        ``ts`` past the rollout and returns it with device-scalar
        metrics."""
        env_states, obs, acar, ccar, eps, traj = rolled
        metrics = {}
        for aid in self.agents:
            nets = (ts.params[aid], ts.value_params[aid])
            with torch.no_grad():
                # bootstrap value of the post-rollout observation
                o_last = self._shape_obs(aid, self._agent_obs(obs, aid))
                last_v, _ = nets[1](o_last, ccar[aid])
                adv, ret = self._gae(self.reward_scale * traj["reward"][aid],
                                     traj["value"][aid], traj["done"], last_v)
                adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
            carry0 = (ts.actor_carry[aid], ts.critic_carry[aid])  # rollout start
            loss, kl = self._agent_update(
                aid, nets, ts.opt_states[aid], traj["obs"][aid], traj["done"], carry0,
                traj["delta"][aid], traj["logp"][aid], adv, ret, self._index_sets(ts.gen))
            metrics[f"{aid}/loss"] = loss
            metrics[f"{aid}/kl"] = kl
            metrics[f"{aid}/reward"] = traj["reward"][aid].sum(0).mean()
        ts.env_states, ts.obs, ts.engine_params = env_states, obs, eps
        ts.actor_carry, ts.critic_carry = acar, ccar
        ts.iteration += 1
        return ts, metrics

    def train_iteration(self, ts: TrainerState):
        ts, metrics = self._learn(ts, self._rollout(ts))
        return ts, {k: float(v) for k, v in metrics.items()}

    # -- persistence ---------------------------------------------------------------

    def save(self, ts: TrainerState, path: str, extra: Optional[dict] = None):
        with open(path, "wb") as f:
            pickle.dump({
                "params": {aid: params_to_flax(m) for aid, m in ts.params.items()},
                "value_params": {aid: params_to_flax(m) for aid, m in ts.value_params.items()},
                "config": {
                    "net_type": self.net_type, "hidden_dim": self.hidden_dim,
                    "num_envs": self.B, "rollout_len": self.T,
                    "obs_mode": self.core.obs_mode,
                    "randomize": self.randomize,
                    **(extra or {}),
                },
            }, f)
