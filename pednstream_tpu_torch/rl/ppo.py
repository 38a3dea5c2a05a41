"""Independent-learner PPO on PyTorch (the counterpart of
``pednstream_tpu/rl/ppo.py``).

Algorithmic parity with the reference PPOAgent (rl/agents/PPO_backup.py):
delta-action Gaussian policies clamped to ±max_delta (:1238-1245),
GAE + advantage normalization + clipped surrogate + approximate-KL early
stop + gradient clipping (:1247-1389), exploration-noise linear decay
(:1106-1181), selectable network families (attention default, LSTM,
stacked-conv, GAT, UD-LSTM, MLP; :25-760), checkpoint save/load
(:1399-1483) in the JAX package's pickle format (flax parameter trees of
numpy arrays), so either package loads the other's checkpoints.

The agent acts on one observation at a time (a batch of one) on its
``device``; noise comes from its own ``torch.Generator``.
"""

import math
import pickle
from typing import Dict, Optional

import numpy as np
import torch

from ..device import DEFAULT, resolve
from ..interop import params_from_flax, params_to_flax
from .networks import PER_LINK, build_family, family_carry, init_flax_
from .optim import adam_init, adam_update
from .rl_utils import compute_gae


def _gaussian_logprob(mu, log_std, action):
    std = torch.exp(log_std)
    return (-0.5 * ((action - mu) / std) ** 2 - log_std
            - 0.5 * math.log(2 * math.pi)).sum(-1)


class PPOAgent:
    def __init__(
        self,
        obs_dim: int,
        act_dim: int,
        features_per_link: Optional[int] = None,
        net_type: str = "attention",
        hidden_dim: int = 64,
        actor_lr: float = 9e-5,
        critic_lr: float = 2e-4,
        gamma: float = 0.99,
        lmbda: float = 0.96,
        eps_clip: float = 0.2,
        epochs: int = 10,
        kl_target: float = 0.02,
        max_grad_norm: float = 0.5,
        max_delta: float = 2.5,
        action_low: Optional[np.ndarray] = None,
        action_high: Optional[np.ndarray] = None,
        noise_scale: float = 0.3,
        noise_decay_steps: int = 200,
        stack_size: int = 1,
        adj: Optional[np.ndarray] = None,
        seed: int = 0,
        device=DEFAULT,
    ):
        self.obs_dim = obs_dim
        self.act_dim = act_dim
        self.features_per_link = features_per_link
        self.net_type = net_type
        self.hidden_dim = hidden_dim
        self.actor_lr = actor_lr
        self.critic_lr = critic_lr
        self.gamma = gamma
        self.lmbda = lmbda
        self.eps_clip = eps_clip
        self.epochs = epochs
        self.kl_target = kl_target
        self.max_grad_norm = max_grad_norm
        self.max_delta = max_delta
        self.action_low = None if action_low is None else np.asarray(action_low)
        self.action_high = None if action_high is None else np.asarray(action_high)
        self.noise_scale = noise_scale
        self.noise_decay_steps = noise_decay_steps
        self.stack_size = stack_size
        # gate delta anchoring: 'current' = reference semantics (delta
        # from the current width, an integrator); 'open' = absolute target
        # full-open + offset (what BatchedPPOTrainer(gate_anchor='open')
        # trains).  Restored from the checkpoint on load.
        self.gate_anchor = "current"
        self._episode = 0
        self.device = resolve(device)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)

        # initial weights are drawn on the host, so a seed gives the same
        # networks on every device
        self._build_networks(adj, init_gen=torch.Generator().manual_seed(seed))
        self._init_optimizers()
        self.reset_hidden()
        self._buffer = []

    def _build_networks(self, adj=None, init_gen: Optional[torch.Generator] = None):
        """Instantiate the actor/critic modules for self.net_type, with
        flax's initial weights drawn from the host generator ``init_gen``
        where given (load() rebuilds them when a checkpoint's architecture
        differs)."""
        nets = build_family(self.net_type, self.obs_dim, self.act_dim,
                            self.features_per_link, self.hidden_dim, self.stack_size)
        if init_gen is not None:
            nets = [init_flax_(m, init_gen) for m in nets]
        self.actor, self.critic = (m.to(self.device) for m in nets)
        self.num_links = (self.obs_dim // self.features_per_link
                          if self.net_type in PER_LINK else None)
        # controlled-links adjacency for the GAT family: fully connected
        # unless the caller passes a sparser mask
        self.adj = None
        if self.net_type == "gat":
            self.adj = (torch.as_tensor(np.asarray(adj), dtype=torch.float32, device=self.device)
                        if adj is not None
                        else torch.ones((self.num_links, self.num_links), device=self.device))

    def _init_optimizers(self):
        self.actor_opt = adam_init(list(self.actor.parameters()))
        self.critic_opt = adam_init(list(self.critic.parameters()))

    # -- shapes ----------------------------------------------------------------

    def _shape_obs(self, obs) -> torch.Tensor:
        """One observation (or a ``[T, ...]`` sequence of them) as a float32
        tensor whose last axes are the family's: ``[L, features]`` per link,
        the flat obs, or the ``[stack, obs_dim]`` window."""
        obs = torch.as_tensor(np.asarray(obs, np.float32), device=self.device)
        if self.net_type in PER_LINK:
            return obs.reshape(obs.shape[:-1] + (self.num_links, self.features_per_link))
        return obs

    def _initial_carry(self):
        return family_carry(self.net_type, 1, self.num_links, self.hidden_dim, self.device)

    def reset_hidden(self):
        self._actor_carry = self._initial_carry()
        self._critic_carry = self._initial_carry()

    # -- acting ------------------------------------------------------------------

    def _apply(self, module, obs, carry):
        if self.net_type == "gat":
            return module(obs, carry, self.adj)
        return module(obs, carry)

    @torch.no_grad()
    def take_action(self, obs, explore: bool = True):
        """Sample a delta action clamped to ±max_delta
        (PPO_backup.py:1238-1245); exploration noise decays linearly over
        episodes (:1106-1181)."""
        o = self._shape_obs(obs)[None]
        mu, log_std, self._actor_carry = self._apply(self.actor, o, self._actor_carry)
        if explore:
            decay = max(0.0, 1.0 - self._episode / self.noise_decay_steps)
            std = torch.exp(log_std) + self.noise_scale * decay
            delta = mu + std * torch.randn(mu.shape, generator=self._gen, device=self.device)
        else:
            delta = mu
        delta = torch.clamp(delta, -self.max_delta, self.max_delta)
        return delta[0].cpu().numpy().astype(np.float32)

    def absolute_action(self, obs, delta):
        """delta -> absolute width using the gate-width feature (the last
        feature per link block; PPO_backup.py:848-851).  Separator agents
        (no per-link features) anchor deltas at the width midpoint, as the
        JAX agent and the batched trainer do."""
        obs = np.asarray(obs, np.float32)
        if self.features_per_link and self.gate_anchor == "open":
            current = np.asarray(self.action_high)
        elif self.features_per_link:
            current = obs.reshape(self.act_dim, -1)[:, -1]
        elif self.action_low is not None:
            current = (np.asarray(self.action_low)
                       + np.asarray(self.action_high)) / 2
        else:
            current = obs[-self.act_dim:]
        absolute = current + np.asarray(delta)
        if self.action_low is not None:
            absolute = np.clip(absolute, self.action_low, self.action_high)
        return absolute.astype(np.float32)

    # -- experience ----------------------------------------------------------------

    def store_transition(self, obs, action, reward, done):
        self._buffer.append((np.asarray(obs, np.float32),
                             np.asarray(action, np.float32), float(reward), bool(done)))

    # -- update ---------------------------------------------------------------------

    def _sequence_forward(self, obs_seq, actor: bool = True, critic: bool = True):
        """Re-forward the episode ``obs_seq [T, ...]`` through the
        recurrent torsos from fresh carries: ``(mu [T, A], log_std
        [T, A], v [T])``, each None where not asked for."""
        ac = cc = self._initial_carry()
        mus, log_stds, vs = [], [], []
        for o in obs_seq:
            o = o[None]
            if actor:
                mu, log_std, ac = self._apply(self.actor, o, ac)
                mus.append(mu[0])
                log_stds.append(log_std[0])
            if critic:
                v, cc = self._apply(self.critic, o, cc)
                vs.append(v[0])
        return (torch.stack(mus) if actor else None,
                torch.stack(log_stds) if actor else None,
                torch.stack(vs) if critic else None)

    def _epoch_update(self, obs_seq, act_seq, adv, returns, old_logp):
        """One PPO epoch: the clipped-surrogate actor step and the value
        step, each through ``clip_by_global_norm`` + Adam, from the same
        pre-update parameters; returns ``(actor_loss, critic_loss, kl)``."""
        mu, log_std, _ = self._sequence_forward(obs_seq, critic=False)
        logp = _gaussian_logprob(mu, log_std, act_seq)
        ratio = torch.exp(logp - old_logp)
        s1 = ratio * adv
        s2 = torch.clamp(ratio, 1 - self.eps_clip, 1 + self.eps_clip) * adv
        a_loss = -torch.mean(torch.minimum(s1, s2))
        kl = torch.mean(old_logp - logp)
        a_params = list(self.actor.parameters())
        a_grads = torch.autograd.grad(a_loss, a_params)

        _, _, v = self._sequence_forward(obs_seq, actor=False)
        c_loss = torch.mean((v - returns) ** 2)
        c_params = list(self.critic.parameters())
        c_grads = torch.autograd.grad(c_loss, c_params)

        adam_update(a_params, a_grads, self.actor_opt, self.actor_lr, self.max_grad_norm)
        adam_update(c_params, c_grads, self.critic_opt, self.critic_lr, self.max_grad_norm)
        return a_loss.detach(), c_loss.detach(), kl.detach()

    def update(self) -> Dict[str, float]:
        """One PPO update over the stored episode
        (PPO_backup.py:1247-1389)."""
        if not self._buffer:
            return {}
        obs = np.stack([b[0] for b in self._buffer])
        acts = np.stack([b[1] for b in self._buffer])
        rews = np.array([b[2] for b in self._buffer])
        dones = np.array([b[3] for b in self._buffer])
        self._buffer = []

        obs_seq = self._shape_obs(obs)
        act_seq = torch.as_tensor(acts, device=self.device)
        with torch.no_grad():
            mu, log_std, values = self._sequence_forward(obs_seq)
            old_logp = _gaussian_logprob(mu, log_std, act_seq)
        values = values.cpu().numpy()
        adv, returns = compute_gae(rews, values, 0.0, dones, self.gamma, self.lmbda)
        adv = (adv - adv.mean()) / (adv.std() + 1e-8)
        adv = torch.as_tensor(adv, dtype=torch.float32, device=self.device)
        returns = torch.as_tensor(returns, dtype=torch.float32, device=self.device)

        a_loss = c_loss = kl = 0.0
        for _ in range(self.epochs):
            a_loss, c_loss, kl = self._epoch_update(obs_seq, act_seq, adv, returns, old_logp)
            if abs(float(kl)) > self.kl_target:  # KL early stop (:1345-1350)
                break
        self._episode += 1
        return {"actor_loss": float(a_loss), "critic_loss": float(c_loss),
                "kl": float(kl)}

    # -- persistence -------------------------------------------------------------------

    def get_config(self) -> dict:
        return {
            "obs_dim": self.obs_dim, "act_dim": self.act_dim,
            "features_per_link": self.features_per_link,
            "net_type": self.net_type, "hidden_dim": self.hidden_dim,
            "gamma": self.gamma, "lmbda": self.lmbda,
            "eps_clip": self.eps_clip, "epochs": self.epochs,
            "kl_target": self.kl_target, "max_delta": self.max_delta,
            "gate_anchor": self.gate_anchor,
        }

    def save(self, path: str):
        with open(path, "wb") as f:
            pickle.dump(
                {
                    "config": self.get_config(),
                    "actor": params_to_flax(self.actor),
                    "critic": params_to_flax(self.critic),
                    "episode": self._episode,
                },
                f,
            )

    def load(self, path: str):
        with open(path, "rb") as f:
            data = pickle.load(f)
        cfg = data.get("config", {})
        # rebuild the modules when the checkpoint's architecture differs
        # from this agent's (e.g. build_agents defaulted to attention but
        # the zoo dir holds an lstm_ppo family variant)
        arch = {k: cfg[k] for k in ("net_type", "hidden_dim",
                                    "features_per_link") if k in cfg}
        if any(getattr(self, k) != v for k, v in arch.items()):
            # keep a real adjacency if the caller supplied one: rebuilding
            # with adj=None would swap a gat policy's graph for all-ones
            if arch.get("net_type") == "gat" and self.adj is None:
                raise ValueError(
                    "loading a 'gat' checkpoint into an agent built "
                    "without an adjacency: construct the agent with "
                    "net_type='gat' and the controlled-links adjacency")
            for k, v in arch.items():
                setattr(self, k, v)
            self._build_networks(adj=None if self.adj is None else self.adj.cpu().numpy())
            self.reset_hidden()
        self.actor.load_state_dict(params_from_flax(self.actor, data["actor"]))
        self.critic.load_state_dict(params_from_flax(self.critic, data["critic"]))
        # the action parameterization travels with the params
        self.gate_anchor = cfg.get("gate_anchor", self.gate_anchor)
        md = cfg.get("max_delta")
        if md is not None:
            self.max_delta = md
        self._episode = data.get("episode", 0)
        self._init_optimizers()
