"""The multi-agent environment core on tensors (the counterpart of
``pednstream_tpu/env/core.py``).

One RL step is action clipping and application, ``action_gap`` engine
steps, observation building, rewards and termination, over a batch of
replicas: every state leaf carries a leading ``B``.  A batch that shares
one Python-int ``t`` is in lockstep by construction; one whose ``t`` is an
int32 ``[B]`` tensor (``state.concat_states``) may hold replicas at
different times and is stepped with ``lockstep=False``, as in the JAX
core.  Stepped with ``lockstep=True`` while its times differ, it comes
back poisoned as from the JAX core's ``_poison_if_not_lockstep``.

Action semantics (rl/builders.py:241-353):
  separators: target width for the forward direction, rate-clipped to
  0.25*unit_time m/step and bounded to [min_sep, total-min_sep]; writing
  also reallocates the reverse direction (link.py:462-478).
  gaters: per-out-link back-gate width, rate-clipped and bounded [0, width].

Observation modes option1..option5 (rl/builders.py:119-177), their static
normalization, the gate reward (pz_pednet_env.py:548-581, with the
travel-time clamp of the JAX core), ``reward_mode='reference_quirk'`` and
the ``global_reward_coef`` shaping are those of the JAX core, feature for
feature.  As there, observations read the scenario's nominal
``EngineParams`` and rewards the per-replica ones.

Stochastic steps draw from the ``torch.Generator`` (on the scenario's
device) that each step is given, where the JAX state carries a PRNG key.
The engine updates the state's rings in place (``engine.step_fn``): a
state that was stepped must not be stepped again.
"""

from typing import Dict, Optional

import numpy as np
import torch

from ..engine import step_fn
from ..state import NetworkState, StepOutputs
from .agents import FEATURES_PER_LINK, AgentSpec

_f32 = torch.float32


def _poison_if_not_lockstep(t_in: torch.Tensor, st: NetworkState, obs: Dict, rewards: Dict):
    """The lockstep contract's guard on a tensor-``t`` batch, on the device
    (``pednstream_tpu.env.core._poison_if_not_lockstep``): where the
    incoming times differ, every observation and reward becomes NaN and
    the new clock ``-2**30``."""
    ok = (t_in == t_in[0]).all()
    obs = {k: torch.where(ok, v, float("nan")) for k, v in obs.items()}
    rewards = {k: torch.where(ok, v, float("nan")) for k, v in rewards.items()}
    return st.replace(t=torch.where(ok, st.t, -(2 ** 30))), obs, rewards


class PedNetEnvCore:
    def __init__(
        self,
        scn,
        spec: AgentSpec,
        obs_mode: str = "option1",
        normalize_obs: bool = False,
        action_gap: int = 1,
        reward_mode: str = "all",
        stochastic: bool = True,
        record: bool = False,
        global_reward_coef: float = 0.0,
    ):
        if obs_mode not in FEATURES_PER_LINK:
            raise ValueError(
                f"obs_mode must be one of {list(FEATURES_PER_LINK)}, got: {obs_mode}")
        if global_reward_coef < 0.0:
            # the shaping term is subtracted (-coef * total in-network
            # count); a mis-signed coef would silently train unshaped
            raise ValueError(f"global_reward_coef must be >= 0, got {global_reward_coef}")
        self.scn = scn
        self.spec = spec
        self.obs_mode = obs_mode
        self.normalize_obs = normalize_obs
        self.action_gap = action_gap
        self.reward_mode = reward_mode
        self.stochastic = stochastic
        self.record = record
        self.global_reward_coef = float(global_reward_coef)
        # static normalization constants (rl/builders.py:63-66)
        self.density_norm = 6.0
        self.speed_norm = 1.5
        self.flow_norm = 20.0

        # static agent index tensors, staged on the device once so a step
        # copies nothing from the host
        dev, f = scn.device, scn.ftype

        def idx(a):
            return torch.as_tensor(np.asarray(a, dtype=np.int64), device=dev)

        rev = scn.reverse_idx
        self._sep_fwd = idx(spec.sep_fwd_link)
        self._sep_rev = rev[self._sep_fwd]
        self._sep_total = torch.as_tensor(np.asarray(spec.sep_total_width), device=dev).to(f)
        self._gate_links = [idx(g) for g in spec.gate_links]
        self._gate_rev = [rev[g] for g in self._gate_links]
        self._gate_widths = [torch.as_tensor(w, device=dev).to(f)
                             for w in spec.gate_link_widths]

    # -- actions -------------------------------------------------------------

    def _target(self, action, B: int) -> torch.Tensor:
        return torch.as_tensor(action, device=self.scn.device).to(self.scn.ftype).reshape(B, -1)

    def _apply_actions(self, st: NetworkState, actions: Dict) -> NetworkState:
        B = st.batch
        back_gate = st.back_gate.clone()
        sep_width = st.sep_width.clone()

        if len(self.spec.sep_ids):
            fwd, rev, mds = self._sep_fwd, self._sep_rev, self.spec.max_delta_sep
            target = self._target(actions["sep"], B)
            cur = sep_width[:, fwd]
            delta = torch.clamp(target - cur, -mds, mds)
            val = torch.where(torch.abs(target - cur) > mds, cur + delta, target)
            lo = self.spec.min_sep_width
            val = torch.minimum(torch.clamp(val, min=lo), self._sep_total - lo)
            rv = self._sep_total - val
            sep_width[:, fwd] = val
            sep_width[:, rev] = rv
            back_gate[:, fwd] = val
            back_gate[:, rev] = rv

        mdg = self.spec.max_delta_gate
        for i, agent_id in enumerate(self.spec.gate_ids):
            links = self._gate_links[i]
            target = self._target(actions[agent_id], B)
            cur = back_gate[:, links]
            delta = torch.clamp(target - cur, -mdg, mdg)
            val = torch.where(torch.abs(target - cur) > mdg, cur + delta, target)
            back_gate[:, links] = torch.minimum(torch.clamp(val, min=0.0), self._gate_widths[i])

        return st.replace(back_gate=back_gate, sep_width=sep_width)

    # -- observations ----------------------------------------------------------

    def _shared_density(self, st: NetworkState) -> torch.Tensor:
        scn, ep = self.scn, self.scn.engine_params
        area32 = torch.where(scn.is_separator, ep.length * st.sep_width,
                             ep.length * ep.width).to(_f32)
        return torch.where(scn.is_separator, st.num_peds / area32,
                           (st.num_peds + st.num_peds[:, scn.reverse_idx]) / area32)

    def _observations(self, st: NetworkState) -> Dict[str, torch.Tensor]:
        """Per-agent observations, each with a leading ``B``: ``sep``
        ``[B, S, 4]``, each gater ``[B, L * features]`` (link-major)."""
        B = st.batch
        inflow, outflow = st.inflow, st.outflow
        obs: Dict[str, torch.Tensor] = {}

        if len(self.spec.sep_ids):
            fwd, rev = self._sep_fwd, self._sep_rev
            o = torch.stack([inflow[:, fwd], outflow[:, fwd], inflow[:, rev], outflow[:, rev]],
                            dim=-1).to(_f32)
            if self.normalize_obs:
                o = o / self.flow_norm  # option1 separator normalization
            obs["sep"] = o

        dens = self._shared_density(st)
        kj = self.scn.engine_params.k_jam
        for i, agent_id in enumerate(self.spec.gate_ids):
            links, rl = self._gate_links[i], self._gate_rev[i]
            bg = st.back_gate[:, links]
            mode = self.obs_mode
            if mode == "option1":
                feats = [inflow[:, links], outflow[:, rl], bg]
            elif mode == "option2":
                feats = [inflow[:, links], outflow[:, rl], dens[:, links], bg]
            elif mode == "option3":
                feats = [inflow[:, links], outflow[:, links], inflow[:, rl], outflow[:, rl], bg]
            elif mode == "option4":
                feats = [dens[:, links] / kj[links].to(_f32), bg]
            else:  # option5
                feats = [inflow[:, links], outflow[:, links], inflow[:, rl], outflow[:, rl],
                         st.speed[:, links], dens[:, links], bg]
            o = torch.stack([x.to(_f32) for x in feats], dim=-1)
            if self.normalize_obs:
                o = self._normalize_gater(o)
            obs[agent_id] = o.reshape(B, -1)
        return obs

    def _normalize_gater(self, o: torch.Tensor) -> torch.Tensor:
        """Static per-mode normalization (rl/builders.py:203-238) of
        ``o [B, L, features]``."""
        fpl = FEATURES_PER_LINK[self.obs_mode]
        o = o.clone()
        if self.obs_mode in ("option1", "option2"):
            o[..., 0] = o[..., 0] / self.flow_norm
            o[..., 1] = o[..., 1] / self.flow_norm
        elif self.obs_mode in ("option3", "option4"):
            o[..., 0] = o[..., 0] / self.density_norm
            if fpl > 2:
                o[..., 1] = o[..., 1] / self.flow_norm
                o[..., 2] = o[..., 2] / self.flow_norm
        return o

    # -- rewards ---------------------------------------------------------------

    def _rewards(self, st: NetworkState, ep=None) -> Dict[str, torch.Tensor]:
        """Gate reward (pz_pednet_env.py:548-581), ``[B]`` per agent:
        -(T_fwd + T_rev) per out link, -10*(k - k_critical) where shared
        density > 4, minus 10 * mean|k - mean k|.  Travel time is clamped
        to the jam clamp ``max_travel_time`` first (the JAX core's
        deliberate divergence from the reference)."""
        ep = self.scn.engine_params if ep is None else ep
        dens = self._shared_density(st)
        tt = torch.minimum(st.travel_time, ep.max_travel_time)
        kc = ep.k_critical
        rewards: Dict[str, torch.Tensor] = {}

        for i, agent_id in enumerate(self.spec.gate_ids):
            links = self._gate_links[i]
            d = dens[:, links]
            r = -(tt[:, links] + tt[:, self._gate_rev[i]]).sum(dim=-1)
            r = r - torch.where(d > 4.0, 10.0 * (d - kc[..., links].to(_f32)), 0.0).sum(dim=-1)
            if len(self.spec.gate_links[i]) > 1:
                avg = d.mean(dim=-1, keepdim=True)
                r = r - 10.0 * torch.abs(d - avg).mean(dim=-1)
            rewards[agent_id] = r.to(_f32)

        if self.reward_mode != "reference_quirk":
            for i, agent_id in enumerate(self.spec.sep_ids):
                fwd, rev = self._sep_fwd[i], self._sep_rev[i]
                rewards[agent_id] = (-(tt[:, fwd] + tt[:, rev])).to(_f32)

        if self.reward_mode == "reference_quirk" and self.spec.agent_ids:
            # only the first agent's reward survives (pz_pednet_env.py:581)
            first = self.spec.agent_ids[0]
            rewards = {first: rewards[first]} if first in rewards else {}

        if self.global_reward_coef > 0.0 and rewards:
            # delay-aligned shaping: a shared multiple of the total
            # in-network count (see the JAX core)
            g = -self.global_reward_coef * st.num_peds.sum(dim=-1).to(_f32)
            rewards = {k: v + g for k, v in rewards.items()}
        return rewards

    # -- step/reset ------------------------------------------------------------

    def _step_impl(self, st: NetworkState, actions: Dict, ep=None, gen=None):
        ep = self.scn.engine_params if ep is None else ep
        st = self._apply_actions(st, actions)
        rewards = None
        outs = []
        # action_gap engine steps per RL step (pz_pednet_env.py:225-247)
        for _ in range(self.action_gap):
            st, o = step_fn(self.scn, ep, st, gen, stochastic=self.stochastic,
                            record=self.record)
            r = self._rewards(st, ep)
            rewards = r if rewards is None else {k: rewards[k] + r[k] for k in r}
            outs.append(o)
        obs = self._observations(st)
        # sim_step >= simulation_steps, per replica or for the whole batch
        if isinstance(st.t, torch.Tensor):
            done = st.t > self.scn.simulation_steps
        else:
            done = torch.full((st.batch,), st.t > self.scn.simulation_steps,
                              dtype=torch.bool, device=st.cum_in.device)
        info = ()
        if self.record:
            info = StepOutputs(**{name: torch.stack([getattr(o, name) for o in outs])
                                  for name in StepOutputs.__dataclass_fields__})
        return st, obs, rewards, done, info

    def reset(self):
        """One replica's initial state (``B = 1``) and its observations
        without the batch axis."""
        st = self.scn.init_state(1)
        return st, {k: v[0] for k, v in self._observations(st).items()}

    def step(self, st: NetworkState, actions: Dict, gen: Optional[torch.Generator] = None):
        """One RL step of a single replica (``B = 1``): actions, and the
        returned observations, rewards and done, carry no batch axis.
        ``gen`` is required when the core is stochastic.  Returns ``(state, obs, rewards, done, outputs)``; outputs are the
        stacked StepOutputs ``[action_gap, 1, ...]`` when ``record``, else
        ``()``."""
        batched = {k: torch.as_tensor(v, device=self.scn.device)[None]
                   for k, v in actions.items()}
        st, obs, rewards, done, info = self._step_impl(st, batched, gen=gen)
        return (st, {k: v[0] for k, v in obs.items()},
                {k: v[0] for k, v in rewards.items()}, done[0], info)

    # -- batched API -------------------------------------------------------------

    def batch_reset(self, batch: int):
        """``batch`` identical initial replicas and their observations."""
        st = self.scn.init_state(batch)
        return st, self._observations(st)

    def batch_step(self, states: NetworkState, actions: Dict,
                   gen: Optional[torch.Generator] = None, lockstep: bool = True):
        """Step a batch: every action leaf carries a leading ``B``.
        Returns ``(states, obs, rewards, done)``, ``done`` per replica.

        ``lockstep=True`` (the default) requires every replica to be at the
        same time: an int ``states.t`` is, and a ``[B]`` tensor must hold
        equal entries, or the step comes back poisoned (NaN observations
        and rewards, a negative clock; decided on the device, with no host
        read).  Pass ``lockstep=False`` for a tensor-``t`` batch whose
        replicas sit at different times."""
        return self.batch_step_randomized(states, actions, None, gen, lockstep)

    def batch_step_randomized(self, states: NetworkState, actions: Dict, engine_params,
                              gen: Optional[torch.Generator] = None, lockstep: bool = True):
        """Batched step with per-replica EngineParams (every leaf with a
        leading ``B``, see ``randomize``).  For ``lockstep`` see
        :meth:`batch_step`."""
        st, obs, rewards, done, _ = self._step_impl(states, actions, engine_params, gen)
        if lockstep and isinstance(states.t, torch.Tensor):
            st, obs, rewards = _poison_if_not_lockstep(states.t, st, obs, rewards)
        return st, obs, rewards, done
