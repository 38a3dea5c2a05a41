"""Soft Actor-Critic on PyTorch (the counterpart of
``pednstream_tpu/rl/sac.py``).

Parity with the reference SACAgent (rl/agents/SAC_copy.py:313-482):
twin Q critics, tanh-squashed Gaussian actor over a frame-stacked
observation window (StackedEncoder, :62-76), automatic entropy tuning
via log_alpha (:399-420), soft target updates (:399-403), delta actions
scaled by max_delta (:362-378).  ``sac_update`` is the one gradient step,
shared with the batched trainer; checkpoints are the JAX package's
pickles.
"""

import copy
import pickle
from typing import Dict, Optional

import numpy as np
import torch

from ..device import DEFAULT, resolve
from ..interop import params_from_flax, params_to_flax
from .networks import SACActor, SACCritic, init_flax_
from .optim import adam_init, adam_update
from .rl_utils import ReplayBuffer


def sac_update(actor: SACActor, critic: SACCritic, target: SACCritic,
               log_alpha: torch.Tensor, opts: dict, lrs: dict, batch, noise,
               gamma: float, tau: float, target_entropy: float):
    """One SAC gradient step (SAC_copy.py:382-420) on ``batch = (s, a, r,
    ns, d)``, updating the actor, critic, target and ``log_alpha`` in
    place.  ``noise = (eps_next, eps_pi)``, each ``[n, act_dim]``, are the
    standard normals of the next-state and the actor-loss samples.
    ``opts``/``lrs`` hold the Adam states and rates under "actor",
    "critic" and "alpha".  Returns ``(actor_loss, critic_loss)``."""
    s, a, r, ns, d = batch
    eps_next, eps_pi = noise
    alpha = torch.exp(log_alpha.detach())

    # critic target (SAC_copy.py:382-398)
    with torch.no_grad():
        na, nlogp = actor.sample(ns, eps=eps_next)
        q1t, q2t = target(ns, na)
        target_q = r + gamma * (1 - d) * (torch.minimum(q1t, q2t) - alpha * nlogp)

    c_params = list(critic.parameters())
    q1, q2 = critic(s, a)
    c_loss = ((q1 - target_q) ** 2 + (q2 - target_q) ** 2).mean()
    adam_update(c_params, torch.autograd.grad(c_loss, c_params), opts["critic"], lrs["critic"])

    # the actor step sees the updated critic
    a_params = list(actor.parameters())
    aa, logp = actor.sample(s, eps=eps_pi)
    q1, q2 = critic(s, aa)
    a_loss = (alpha * logp - torch.minimum(q1, q2)).mean()
    adam_update(a_params, torch.autograd.grad(a_loss, a_params), opts["actor"], lrs["actor"])

    al_loss = (-torch.exp(log_alpha) * (logp.detach() + target_entropy)).mean()
    adam_update([log_alpha], torch.autograd.grad(al_loss, [log_alpha]), opts["alpha"],
                lrs["alpha"])

    # soft target update (SAC_copy.py:399-403)
    with torch.no_grad():
        for t, c in zip(target.parameters(), c_params):
            t.copy_((1 - tau) * t + tau * c)
    return a_loss.detach(), c_loss.detach()


def checkpoint(config: dict, actor: SACActor, critic: SACCritic, target: SACCritic,
               log_alpha: torch.Tensor) -> dict:
    """A SAC agent's checkpoint in the JAX package's pickle layout (flax
    parameter trees of numpy arrays), as ``SACAgent.save`` and the batched
    trainer's ``export`` write it."""
    return {"config": config, "actor": params_to_flax(actor), "critic": params_to_flax(critic),
            "target_critic": params_to_flax(target), "log_alpha": float(log_alpha.detach())}


class SACAgent:
    def __init__(
        self,
        obs_dim: int,
        act_dim: int,
        stack_size: int = 4,
        hidden_dim: int = 64,
        actor_lr: float = 3e-4,
        critic_lr: float = 3e-4,
        alpha_lr: float = 3e-4,
        gamma: float = 0.99,
        tau: float = 0.005,
        max_delta: float = 2.5,
        buffer_capacity: int = 100_000,
        batch_size: int = 64,
        action_low: Optional[np.ndarray] = None,
        action_high: Optional[np.ndarray] = None,
        seed: int = 0,
        is_separator: bool = False,
        device=DEFAULT,
    ):
        self.is_separator = is_separator
        # gate delta anchoring, mirroring PPOAgent; travels with the
        # checkpoint so eval matches training
        self.gate_anchor = "current"
        self.obs_dim = obs_dim
        self.act_dim = act_dim
        self.stack_size = stack_size
        self.hidden_dim = hidden_dim
        self.gamma = gamma
        self.tau = tau
        self.max_delta = max_delta
        self.batch_size = batch_size
        self.lrs = {"actor": actor_lr, "critic": critic_lr, "alpha": alpha_lr}
        self.action_low = None if action_low is None else np.asarray(action_low)
        self.action_high = None if action_high is None else np.asarray(action_high)
        self.target_entropy = -float(act_dim)
        self.device = resolve(device)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._episode = 0

        # initial weights are drawn on the host, so a seed gives the same
        # networks on every device
        init_gen = torch.Generator().manual_seed(seed)
        self.actor = init_flax_(SACActor(obs_dim, act_dim, stack_size, hidden_dim),
                                init_gen).to(self.device)
        self.critic = init_flax_(SACCritic(obs_dim, act_dim, stack_size, hidden_dim),
                                 init_gen).to(self.device)
        self.target_critic = copy.deepcopy(self.critic)
        self.log_alpha = torch.zeros((), device=self.device, requires_grad=True)
        self._init_optimizers()

        self.buffer = ReplayBuffer(buffer_capacity)
        self._obs_stack = None

    def _init_optimizers(self):
        self.opts = {"actor": adam_init(list(self.actor.parameters())),
                     "critic": adam_init(list(self.critic.parameters())),
                     "alpha": adam_init([self.log_alpha])}

    # -- frame stacking ------------------------------------------------------

    def reset_hidden(self):
        self._obs_stack = None

    def _stack(self, obs: np.ndarray) -> np.ndarray:
        obs = np.asarray(obs, np.float32)
        if self._obs_stack is None:
            self._obs_stack = np.tile(obs[None], (self.stack_size, 1))
        else:
            self._obs_stack = np.roll(self._obs_stack, -1, axis=0)
            self._obs_stack[-1] = obs
        return self._obs_stack.copy()

    # -- acting ------------------------------------------------------------------

    def peek_stack(self, obs: np.ndarray) -> np.ndarray:
        """The stack as it WILL look once ``obs`` is pushed, without
        mutating state — used to store the true next-state stack for a
        transition while the actual push happens at the next
        ``take_action``."""
        obs = np.asarray(obs, np.float32)
        if self._obs_stack is None:
            return np.tile(obs[None], (self.stack_size, 1))
        s = np.roll(self._obs_stack, -1, axis=0)
        s[-1] = obs
        return s

    @torch.no_grad()
    def take_action(self, obs, explore: bool = True):
        stacked = torch.as_tensor(self._stack(obs), device=self.device)[None]
        if explore:
            a, _ = self.actor.sample(stacked, self._gen)
        else:
            mu, _ = self.actor(stacked)
            a = torch.tanh(mu)
        return (a[0] * self.max_delta).cpu().numpy().astype(np.float32)

    def absolute_action(self, obs, delta):
        obs = np.asarray(obs, np.float32)
        # separator obs is 4 flows per separator: anchor at the width
        # midpoint instead (see PPOAgent.absolute_action)
        if self.is_separator and self.action_low is not None:
            current = (np.asarray(self.action_low)
                       + np.asarray(self.action_high)) / 2
        elif self.gate_anchor == "open" and self.action_high is not None:
            current = np.asarray(self.action_high, np.float32)
        else:
            current = obs.reshape(self.act_dim, -1)[:, -1] \
                if obs.size % self.act_dim == 0 else obs[-self.act_dim:]
        absolute = current + np.asarray(delta)
        if self.action_low is not None:
            absolute = np.clip(absolute, self.action_low, self.action_high)
        return absolute.astype(np.float32)

    def store_transition(self, stacked_obs, action, reward, next_stacked_obs, done):
        self.buffer.add(stacked_obs, action, reward, next_stacked_obs, done)

    @property
    def last_stack(self):
        return None if self._obs_stack is None else self._obs_stack.copy()

    # -- update -----------------------------------------------------------------

    def _update_step(self, batch, noise=None):
        """One gradient step on ``batch = (s, a, r, ns, d)`` tensors;
        ``noise = (eps_next, eps_pi)`` is drawn from the agent's generator
        unless given."""
        if noise is None:
            shape = (batch[0].shape[0], self.act_dim)
            noise = tuple(torch.randn(shape, generator=self._gen, device=self.device)
                          for _ in range(2))
        return sac_update(self.actor, self.critic, self.target_critic, self.log_alpha,
                          self.opts, self.lrs, batch, noise, self.gamma, self.tau,
                          self.target_entropy)

    def update(self) -> Dict[str, float]:
        if self.buffer.size() < self.batch_size:
            return {}
        s, a, r, ns, d = self.buffer.sample(self.batch_size)

        def t(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

        batch = (t(s), t(a / max(self.max_delta, 1e-6)), t(r), t(ns), t(d))
        a_loss, c_loss = self._update_step(batch)
        return {"actor_loss": float(a_loss), "critic_loss": float(c_loss),
                "alpha": float(torch.exp(self.log_alpha.detach()))}

    # -- persistence ---------------------------------------------------------------

    def get_config(self) -> dict:
        return {"obs_dim": self.obs_dim, "act_dim": self.act_dim,
                "stack_size": self.stack_size, "gamma": self.gamma,
                "tau": self.tau, "max_delta": self.max_delta,
                "gate_anchor": self.gate_anchor, "algo": "sac"}

    def save(self, path: str):
        with open(path, "wb") as f:
            pickle.dump(checkpoint(self.get_config(), self.actor, self.critic,
                                   self.target_critic, self.log_alpha), f)

    def load(self, path: str):
        with open(path, "rb") as f:
            data = pickle.load(f)
        self.actor.load_state_dict(params_from_flax(self.actor, data["actor"]))
        self.critic.load_state_dict(params_from_flax(self.critic, data["critic"]))
        self.target_critic.load_state_dict(
            params_from_flax(self.target_critic, data["target_critic"]))
        with torch.no_grad():
            self.log_alpha.fill_(float(data["log_alpha"]))
        cfg = data.get("config", {})
        self.gate_anchor = cfg.get("gate_anchor", self.gate_anchor)
        # action scaling and frame-stacking are part of the policy's
        # semantics: a checkpoint trained with max_delta=4.0 acts with 4.0
        self.max_delta = cfg.get("max_delta", self.max_delta)
        self.stack_size = cfg.get("stack_size", self.stack_size)
