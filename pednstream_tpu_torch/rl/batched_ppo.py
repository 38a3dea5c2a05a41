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

``mesh=`` (a ``parallel.Mesh`` with an ``env`` axis) makes the trainer
data-parallel, and the trainer owns the layout: ``num_envs`` stays the
size of the WHOLE batch, ``init`` keeps this rank's block of the replicas
(env state, observations, carries, per-replica worlds), and parameters and
optimizer state are replicated.  Every draw is the unsharded trainer's
(``parallel.BlockDraws``; the generator is in the same state on every
rank).  A minibatch is a set of replica indices of the whole batch: each
rank takes its members, the losses and the advantage normalisation divide
sums by the whole batch's counts, and gradients are all-reduced before
the optimizer step, so a sharded iteration equals the unsharded one up to
the order of the sums.  Reading the minibatch members costs one host read
per agent and iteration.
"""

import math
import pickle
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from ..engine import draw
from ..env.agents import FEATURES_PER_LINK
from ..env.core import PedNetEnvCore
from ..interop import params_to_flax
from ..parallel.mesh import (BlockDraws, Mesh, all_gather, all_reduce_sum,
                             assert_same_on_all_ranks, shard_batch)
from ..randomize import randomize_engine_params_batched
from ..state import EngineParams, NetworkState
from .networks import build_family, family_carry, init_flax_
from .optim import AdamState, adam_init, adam_update
from .ppo import _gaussian_logprob

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


class ReplicaSharding:
    """A batched trainer's layout over the ``env`` axis of a mesh: which
    replicas of the whole batch this rank holds, and the few reductions
    the trainers need.  With ``mesh=None`` the block is the whole batch and
    every method is the plain single-process operation."""

    AXIS = "env"

    def __init__(self, mesh: Optional[Mesh], num_envs: int):
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a parallel.Mesh (parallel.make_mesh), got "
                            f"{type(mesh).__name__}")
        self.mesh = mesh
        self.block = slice(0, num_envs) if mesh is None else mesh.block(self.AXIS, num_envs)
        self.local = self.block.stop - self.block.start
        self.ranks = 1 if mesh is None else mesh.size(self.AXIS)

    def check_scenario(self, scn) -> None:
        """Every rank must train on the same scenario."""
        if self.mesh is not None:
            assert_same_on_all_ranks(scn.engine_params.demand, self.mesh, self.AXIS,
                                     "the demand table")

    def take(self, tree):
        """This rank's replicas of a whole-batch tree."""
        return tree if self.mesh is None or tree is None else shard_batch(
            tree, self.mesh, self.AXIS)

    def draws(self, gen: torch.Generator):
        """What the env and the action noise draw from."""
        return gen if self.mesh is None else BlockDraws(gen, self.mesh, env_axis=self.AXIS)

    def sum(self, x: torch.Tensor, name: str = "all_reduce") -> torch.Tensor:
        """``x`` summed over the ranks."""
        return x if self.mesh is None else all_reduce_sum(x, self.mesh, self.AXIS, name)

    def whole(self, xs):
        """The whole-batch tensors of this rank's blocks ``xs`` (float32,
        each ``[B_local, ...]``), gathered together in one collective."""
        if self.mesh is None:
            return xs
        flat = all_gather(torch.cat([x.reshape(x.shape[0], -1) for x in xs], dim=1),
                          self.mesh, self.AXIS, dim=0, name="replicas")
        parts = flat.split([x[0].numel() for x in xs], dim=1)
        return [p.reshape(flat.shape[:1] + x.shape[1:]) for p, x in zip(parts, xs)]

    def members(self, idx_sets: torch.Tensor):
        """Each row of global replica indices cut to this rank's members,
        as local indices (one host read of the rows)."""
        if self.mesh is None:
            return idx_sets
        lo, hi = self.block.start, self.block.stop
        with self.mesh.host_trip():
            rows = idx_sets.cpu()
            return [(row[(row >= lo) & (row < hi)] - lo).to(idx_sets.device) for row in rows]


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
        if gate_anchor not in ("current", "open"):
            raise ValueError("gate_anchor must be 'current' or 'open'")
        if num_envs % minibatches:
            raise ValueError("num_envs must divide evenly into minibatches")
        self.mesh = mesh
        self.sharding = ReplicaSharding(mesh, num_envs)
        self.Bl = self.sharding.local  # this rank's replicas (all of them without a mesh)
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
        return family_carry(self._family(aid), self.Bl if B is None else B,
                            self.agents[aid]["act_dim"],
                            self.hidden_dim, self.device)

    def _shape_obs(self, aid: str, o: torch.Tensor) -> torch.Tensor:
        """[B, obs_dim] -> [B, L, fpl] for per-link torsos."""
        if self._family(aid) in ("attention", "udlstm"):
            meta = self.agents[aid]
            return o.reshape(o.shape[0], meta["act_dim"], meta["fpl"])
        return o

    # -- setup -----------------------------------------------------------------

    def init(self, seed: int = 0) -> TrainerState:
        self.sharding.check_scenario(self.scn)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        env_states, obs = self.core.batch_reset(self.Bl)
        eps = self._worlds(gen) if self.randomize else None
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

    def _worlds(self, gen: torch.Generator) -> EngineParams:
        """The whole batch's world draws, cut to this rank's replicas."""
        return self.sharding.take(
            _draw_worlds(self.scn, gen, self.B, self.randomize_fraction))

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
        draws = self.sharding.draws(ts.gen)
        for _ in range(self.T):
            acts = {}
            for aid in self.agents:
                o = self._shape_obs(aid, self._agent_obs(obs, aid))
                mu, log_std, acar[aid] = ts.params[aid](o, acar[aid])
                v, ccar[aid] = ts.value_params[aid](o, ccar[aid])
                noise = draw(draws, True, mu.shape, torch.float32, self.device)
                delta = torch.clamp(mu + torch.exp(log_std) * noise,
                                    -self.max_delta, self.max_delta)
                for k, x in (("obs", o), ("delta", delta), ("value", v),
                             ("logp", _gaussian_logprob(mu, log_std, delta))):
                    steps[k][aid].append(x)
                acts[aid] = self._absolute(aid, self._agent_obs(obs, aid), delta)
            env_states, obs, rewards, done, _ = self.core._step_impl(
                env_states, acts, eps, draws)
            if env_states.t > self.scn.simulation_steps:
                # the lockstep batch finished its episode: fresh engine
                # states (the stepped rings are updated in place and not
                # reused), fresh carries and, randomized, fresh worlds
                env_states = self.scn.init_state(self.Bl)
                for aid in self.agents:
                    acar[aid] = self._batched_carry(aid)
                    ccar[aid] = self._batched_carry(aid)
                if self.randomize:
                    eps = self._worlds(ts.gen)
                obs = self.core._observations(env_states)
            sep_key = self.spec.sep_ids[0] if self.spec.sep_ids else "sep"
            for aid in self.agents:
                r = rewards.get(sep_key if aid == "sep" else aid)
                steps["reward"][aid].append(
                    r if r is not None else torch.zeros(self.Bl, device=self.device))
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

    def _index_sets(self, gen: torch.Generator):
        """``[epochs * minibatches, B / minibatches]`` replica indices: one
        permutation of B per epoch, cut into minibatch slices.  On a mesh,
        each row's members among this rank's replicas (rows of unequal
        length, some perhaps empty)."""
        mb = self.B // self.minibatches
        return self.sharding.members(torch.cat([
            torch.randperm(self.B, generator=gen, device=self.device).reshape(-1, mb)
            for _ in range(self.epochs)]))

    def _mean(self, x: torch.Tensor, n_replicas: int) -> torch.Tensor:
        """Mean of ``x [T, mb, ...]`` over a minibatch of ``n_replicas``
        replicas of the whole batch: this rank's share of it, which sums to
        the mean over the ranks."""
        return x.sum() / (x.shape[0] * math.prod(x.shape[2:]) * n_replicas)

    def _moments(self, x: torch.Tensor):
        """Mean and population standard deviation of ``x`` over the whole
        batch."""
        n = x.numel() * self.sharding.ranks
        mean = self.sharding.sum(x.sum(), "advantage_moments") / n
        var = self.sharding.sum(((x - mean) ** 2).sum(), "advantage_moments") / n
        return mean, torch.sqrt(var)

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
        mb = self.B // self.minibatches
        for idx in idx_sets:
            c0 = (_take(carry0[0], idx), _take(carry0[1], idx))
            mu, log_std, v = self._sequence_forward(aid, nets, obs_seq[:, idx],
                                                    dones[:, idx], c0)
            logp = _gaussian_logprob(mu, log_std, act_seq[:, idx])
            ratio = torch.exp(logp - old_logp[:, idx])
            a = adv[:, idx]
            s1 = ratio * a
            s2 = torch.clamp(ratio, 1 - self.eps_clip, 1 + self.eps_clip) * a
            entropy = self._mean((log_std + 0.5 * math.log(2 * math.pi * math.e)).sum(-1), mb)
            v_loss = self._mean((v - ret[:, idx]) ** 2, mb)
            kl = self._mean(old_logp[:, idx] - logp, mb).detach()
            loss = (-self._mean(torch.minimum(s1, s2), mb) - self.entropy_coef * entropy
                    + self.value_coef * v_loss)
            grads = torch.autograd.grad(loss, params)
            if self.mesh is not None:
                # this rank's shares of the gradient, the loss and the KL
                # summed over the ranks in one collective
                flat = self.sharding.sum(torch.cat(
                    [g.reshape(-1) for g in grads] + [loss.detach()[None], kl[None]]),
                    "gradients")
                sizes = [g.numel() for g in grads]
                grads = [f.view_as(g) for f, g in zip(flat[:-2].split(sizes), grads)]
                loss, kl = flat[-2], flat[-1]
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
                mean, std = self._moments(adv)
                adv = (adv - mean) / (std + 1e-8)
            carry0 = (ts.actor_carry[aid], ts.critic_carry[aid])  # rollout start
            loss, kl = self._agent_update(
                aid, nets, ts.opt_states[aid], traj["obs"][aid], traj["done"], carry0,
                traj["delta"][aid], traj["logp"][aid], adv, ret, self._index_sets(ts.gen))
            metrics[f"{aid}/loss"] = loss
            metrics[f"{aid}/kl"] = kl
            metrics[f"{aid}/reward"] = self.sharding.sum(
                traj["reward"][aid].sum(), "metrics") / self.B
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
