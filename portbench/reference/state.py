"""Engine parameters, simulation state and per-step outputs as dataclasses
of tensors (the counterparts of ``pednstream_tpu/state.py``).

Layouts follow the JAX package so the two can be compared leaf for leaf,
with one addition: every :class:`NetworkState` and :class:`StepOutputs`
leaf carries a leading replica axis ``B`` (JAX adds it with ``vmap``).
:class:`EngineParams` broadcasts over ``B`` (or carries it, see below).

- rings are time-major ``[B, H, E]`` (time index i lives at row ``i % H``);
  the travel-time ring is ``[B, W, E]``;
- per-link values are ``[B, E]``, per-node values ``[B, N]``;
- ``t`` is a Python int shared by the whole lockstep batch, so ring-row
  writes and demand-column reads index with a host integer and never read
  a device value back; or an int32 tensor ``[B]`` on the state's device
  when the replicas sit at different times (:func:`concat_states` makes
  such a batch), and then the engine scatters and gathers per replica,
  still without reading ``t`` back.

Flow quantities (flows, cumulative curves, rings, previous sending and
receiving flows, gates, virtual counters) are in the scenario's
``ftype``: float32 on the fast path, float64 on the exact-parity path.
Travel times, densities, speeds and pedestrian counts are float32 as in
the reference's arrays (link.py:82-97), the split of
``pednstream_tpu/scenario.py:174-214``.  :class:`EngineParams` leaves are
unbatched for the scenario's own parameters and carry a leading ``B``
when drawn per replica (``randomize``).  There is no PRNG key leaf:
stochastic steps take an explicit ``torch.Generator``.
"""

import dataclasses
from dataclasses import dataclass
from typing import Sequence, Union

import torch


class _Tensors:
    """``replace`` and ``to`` for a dataclass whose leaves are tensors
    (non-tensor leaves, such as ``NetworkState.t``, pass through)."""

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)

    def to(self, device):
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        })

    def take(self, index):
        """The replicas ``index`` (a slice or an index tensor) of every
        tensor leaf's leading axis, copied: the result shares no ring with
        ``self``.  Every tensor leaf must carry the replica axis."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name)[index].clone()
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        })


@dataclass
class EngineParams(_Tensors):
    """Per-link / per-node parameters (see ``pednstream_tpu.state``)."""

    length: torch.Tensor  # [E]
    width: torch.Tensor  # [E]
    free_flow_speed: torch.Tensor  # [E]
    k_critical: torch.Tensor  # [E]
    k_jam: torch.Tensor  # [E]
    gamma: torch.Tensor  # [E]
    bi_factor: torch.Tensor  # [E]
    activity_probability: torch.Tensor  # [E]
    speed_noise_std: torch.Tensor  # [E]
    demand: torch.Tensor  # [N, T+1]
    od_table: torch.Tensor  # [P, T+1]
    phi_base: torch.Tensor  # [N, M, M] static equal turning fractions
    virt_recv: torch.Tensor  # [N] virtual-slot receiving capacity (big-M or 0)
    max_travel_time: torch.Tensor  # [E] f32, jam clamp length/0.05 (link.py:63)
    travel_time0: torch.Tensor  # [E] f32, initial travel time (link.py:83)
    tt_freeflow32: torch.Tensor  # [E] f32, length/v_f in f64 then cast
    free_flow_tau: torch.Tensor  # [E] i32, round(tt0/dt) (link.py:86)
    tau_shockwave: torch.Tensor  # [E] i32, round(L/(w*dt)) (link.py:380)


@dataclass
class NetworkState(_Tensors):
    """State carried from step to step; see the module note for layouts."""

    # next time step to execute (starts at 1): an int shared by the batch,
    # or int32 [B], one per replica
    t: Union[int, torch.Tensor]

    cum_in_ring: torch.Tensor  # [B, H, E]
    cum_out_ring: torch.Tensor  # [B, H, E]
    inflow_ring: torch.Tensor  # [B, H, E]
    tt_ring: torch.Tensor  # [B, W, E]

    cum_in: torch.Tensor  # [B, E]
    cum_out: torch.Tensor
    inflow: torch.Tensor
    outflow: torch.Tensor
    num_peds: torch.Tensor
    density: torch.Tensor
    speed: torch.Tensor
    travel_time: torch.Tensor
    link_flow: torch.Tensor
    avg_tt: torch.Tensor
    tt_run_sum: torch.Tensor
    sending_prev: torch.Tensor  # init -1 sentinel (link.py:16)
    recv_prev: torch.Tensor  # init -1 sentinel (link.py:17)

    back_gate: torch.Tensor  # [B, E] control surface
    sep_width: torch.Tensor  # [B, E]

    virt_dep: torch.Tensor  # [B, N]
    virt_arr: torch.Tensor
    virt_dep_cum: torch.Tensor
    virt_arr_cum: torch.Tensor

    @property
    def batch(self) -> int:
        return self.cum_in.shape[0]


@dataclass
class StepOutputs(_Tensors):
    """One step's recorded values; ``simulate`` stacks them over time
    into ``[T, B, ...]``."""

    inflow: torch.Tensor
    outflow: torch.Tensor
    cum_in: torch.Tensor
    cum_out: torch.Tensor
    num_peds: torch.Tensor
    density: torch.Tensor
    speed: torch.Tensor
    travel_time: torch.Tensor
    link_flow: torch.Tensor
    sending: torch.Tensor
    receiving: torch.Tensor
    back_gate: torch.Tensor
    sep_width: torch.Tensor
    virt_dep: torch.Tensor
    virt_arr: torch.Tensor
