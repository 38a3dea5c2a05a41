"""Link-axis (simulation-state) sharding (the counterpart of
``pednstream_tpu/parallel/link_shard.py``).

The data-parallel path (``parallel/mesh.py``) shards the REPLICA axis:
every rank holds whole networks.  A network whose state outgrows one
device — the state is O(E*H) ring buffers — needs the other
decomposition: the LINK axis blocked over the mesh, so that each rank
holds a block of directed links (N-curve rings, FD state, control
surface) and only small per-step vectors cross ranks.

Layout (that of the JAX package):

  * rings ``[B, H, E]`` and ``[B, W, E]`` are blocked on the link axis; the
    window axis stays local, so the fused history read runs on the block
    as it is, one launch per step per rank at ``(B, H, E/P)``;
  * ``[B, E]`` state leaves and ``[E]`` ``EngineParams`` leaves are blocked;
  * node-axis leaves (``virt_* [B, N]``, ``demand [N, T+1]``, ``od_table``,
    ``phi_base [N, M, M]``, ``virt_recv [N]``) are REPLICATED: they are
    O(N) / O(N*M^2) beside the O(E*H) rings, and N rarely divides.

The sharded step is ``engine.step_fn`` on a *view* of the scenario whose
per-link tables are cut to the block, with a :class:`LinkExchange` as its
``links``.  ``step_fn`` names the places where a step crosses links: the
reverse-link reads, the routed turning fractions and the node solve take
``[B, E]`` vectors from ``links.gather``, which here all-gathers them over
the link axis (4 collectives per step on the float32 path: pedestrian
counts and gates; the sending flows, with the routing operands where the
scenario routes; the receiving flows; the updated density).  Routing and
the node solve are then computed whole on every rank — replicated,
deterministic, identical — and ``links.own`` keeps this rank's slice of
the link flows.  Per step that moves O(E) per replica, never a ring.
:func:`assert_no_full_ring_collectives` holds the run to that from the
mesh's record of its collectives.

``E`` must divide evenly over the link axis (E is always even — links
come in corridor pairs; pad the corridor list if yours does not divide).
One link per rank works: every reverse pair then straddles two ranks.

Bit-exactness: no floating-point reduction runs over a sharded axis, the
gathered vectors are the unsharded run's, and the random draws are made at
the unsharded shape (``mesh.BlockDraws``; the exact binomial's operands
are gathered first), so a sharded run equals the unsharded one BITWISE,
deterministic or stochastic, in both sampler modes.
"""

import copy
import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..engine import simulate_batched
from ..state import EngineParams, NetworkState
from .mesh import (SCENARIO_CHECK, UNSHARD, BlockDraws, Mesh, all_gather,
                   assert_same_on_all_ranks)

# placements of NetworkState / EngineParams fields, by the mesh axes that
# block each of a leaf's axes (None: that axis is whole)
_RINGS = ("cum_in_ring", "cum_out_ring", "inflow_ring", "tt_ring")
_NODE_STATE = ("virt_dep", "virt_arr", "virt_dep_cum", "virt_arr_cum")
_NODE_PARAMS = ("demand", "od_table", "phi_base", "virt_recv")


def _state_placements(env: Optional[str], link: str) -> NetworkState:
    """``NetworkState`` with, per field, the mesh axis that blocks each
    tensor axis: rings ``(env, None, link)``, per-link leaves ``(env,
    link)``, node leaves ``(env, None)``, ``t`` ``(env,)`` (a shared int
    ``t`` is whole on every rank)."""
    out = {"t": (env,)}
    for f in dataclasses.fields(NetworkState):
        if f.name == "t":
            continue
        if f.name in _RINGS:
            out[f.name] = (env, None, link)
        elif f.name in _NODE_STATE:
            out[f.name] = (env, None)
        else:
            out[f.name] = (env, link)
    return NetworkState(**out)


def link_state_shardings(mesh: Mesh, axis: str = "link") -> NetworkState:
    """A ``NetworkState`` of placements: a tuple per field naming, for each
    tensor axis, the mesh axis that blocks it (``None``: whole).  Rings
    ``[B, H, E]`` are ``(None, None, axis)`` (window local), ``[B, E]``
    leaves ``(None, axis)``, node-axis leaves and ``t`` replicated."""
    mesh.size(axis)  # the axis must exist
    return _state_placements(None, axis)


def link_params_shardings(mesh: Mesh, axis: str = "link") -> EngineParams:
    """``EngineParams`` placements: per-link ``[E]`` leaves ``(axis,)`` (on
    their last axis, so a per-replica ``[B, E]`` leaf blocks the same way);
    node-axis leaves (``demand``, ``od_table``, ``phi_base``, ``virt_recv``)
    ``None``, replicated."""
    mesh.size(axis)
    return EngineParams(**{
        f.name: None if f.name in _NODE_PARAMS else (axis,)
        for f in dataclasses.fields(EngineParams)})


def hybrid_state_shardings(mesh: Mesh, env_axis: str = "env",
                           link_axis: str = "link") -> NetworkState:
    """Placements of a batched ``NetworkState`` on a 2-D mesh
    (``make_mesh_2d``): replicas block over ``env_axis`` (rollouts never
    communicate across it), each replica's links over ``link_axis``: rings
    ``(env, None, link)``, ``[B, E]`` leaves ``(env, link)``, ``[B, N]``
    leaves and a per-replica ``t`` ``(env,)`` on their leading axis."""
    mesh.size(env_axis), mesh.size(link_axis)
    return _state_placements(env_axis, link_axis)


def _place(x, placement, mesh: Mesh, last: bool = False):
    """This rank's block of the whole leaf ``x`` under ``placement`` (over
    its leading axes, or over its last ones)."""
    if not isinstance(x, torch.Tensor) or placement is None:
        return x
    dims = range(x.ndim - len(placement), x.ndim) if last else range(len(placement))
    cut = False
    for dim, axis in zip(dims, placement):
        if axis is not None and mesh.size(axis) > 1:
            x = x[(slice(None),) * dim + (mesh.block(axis, x.shape[dim]),)]
            cut = True
    # a block is kept as its own contiguous tensor: the kernel takes raw
    # pointers, and the whole leaf can then be freed
    return x.clone(memory_format=torch.contiguous_format) if cut else x


def _place_fields(tree, placements, mesh: Mesh, last: bool = False):
    return dataclasses.replace(tree, **{
        f.name: _place(getattr(tree, f.name), getattr(placements, f.name), mesh, last)
        for f in dataclasses.fields(tree)})


def shard_link_state(state: NetworkState, mesh: Mesh, axis: str = "link") -> NetworkState:
    """This rank's block of a whole state whose link axis is sharded over
    ``mesh``: each leaf cut to its block and copied once (contiguous for
    the kernel)."""
    return _place_fields(state, link_state_shardings(mesh, axis), mesh)


def shard_link_params(ep: EngineParams, mesh: Mesh, axis: str = "link") -> EngineParams:
    """This rank's block of the per-link leaves of a whole ``EngineParams``
    (copied once); the node-axis leaves stay whole."""
    return _place_fields(ep, link_params_shardings(mesh, axis), mesh, last=True)


def shard_hybrid_state(states: NetworkState, mesh: Mesh, env_axis: str = "env",
                       link_axis: str = "link") -> NetworkState:
    """This rank's block of a whole batched state on a 2-D mesh: its
    replicas of the batch and its links of each."""
    return _place_fields(states, hybrid_state_shardings(mesh, env_axis, link_axis), mesh)


def unshard_state(state: NetworkState, mesh: Mesh, link_axis: Optional[str] = "link",
                  env_axis: Optional[str] = None) -> NetworkState:
    """The whole state on every rank, gathered from the blocks (for reading
    results and for tests: it moves the rings, which a sharded step never
    does, and is recorded under ``mesh.UNSHARD``)."""
    sh = _state_placements(env_axis, link_axis)

    def whole(x, placement):
        if not isinstance(x, torch.Tensor):
            return x
        for dim, axis in enumerate(placement):
            if axis is not None:
                x = all_gather(x, mesh, axis, dim=dim, name=UNSHARD)
        return x

    return dataclasses.replace(state, **{
        f.name: whole(getattr(state, f.name), getattr(sh, f.name))
        for f in dataclasses.fields(NetworkState)})


class LinkExchange:
    """The ``links`` of ``engine.step_fn`` for a step on this rank's block of
    the link axis: whole ``[B, E]`` vectors gathered from the blocks, and
    this rank's slice of a whole vector.

    Every collective of the sharded step is made by :meth:`gather`, through
    ``mesh.all_gather``, which records it under ``"link_exchange"``."""

    def __init__(self, mesh: Mesh, axis: str, n_links: int):
        self.mesh = mesh
        self.axis = axis
        self.slice = mesh.block(axis, n_links)

    def gather(self, *xs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """The whole ``[B, E]`` vector of each block ``[B, E/P]`` in ``xs``;
        those of one dtype travel stacked in one collective."""
        whole: Dict[int, torch.Tensor] = {}
        for dtype in dict.fromkeys(x.dtype for x in xs):
            at = [i for i, x in enumerate(xs) if x.dtype == dtype]
            stacked = all_gather(torch.stack([xs[i] for i in at]), self.mesh, self.axis,
                                 dim=-1, name="link_exchange")
            whole.update(zip(at, stacked.unbind(0)))
        return tuple(whole[i] for i in range(len(xs)))

    def own(self, x_all: torch.Tensor) -> torch.Tensor:
        return x_all[..., self.slice]


def _block_view(scn, links: LinkExchange):
    """A shallow copy of ``scn`` whose per-link tables are this rank's
    block (``reverse_idx`` then holds, for the block's links, the positions
    of their reverse links on the WHOLE axis); its node and routing tables
    stay whole."""
    view = copy.copy(scn)
    view.is_separator = scn.is_separator[links.slice]
    view.fd_type = scn.fd_type[links.slice]
    view.reverse_idx = scn.reverse_idx[links.slice]
    return view


def _sharded_run(scn, mesh: Mesh, num_steps: int, stochastic: bool,
                 env_axis: Optional[str], link_axis: str):
    assert_same_on_all_ranks(scn.engine_params.demand, mesh, link_axis, "the demand table")
    links = LinkExchange(mesh, link_axis, scn.n_links)
    view = _block_view(scn, links)
    width = links.slice.stop - links.slice.start

    def run(ep: EngineParams, state: NetworkState,
            gen: Optional[torch.Generator] = None) -> NetworkState:
        if ep.length.shape[-1] != width or state.cum_in.shape[-1] != width:
            raise ValueError(
                f"this rank steps {width} of the {scn.n_links} links: pass shard_link_params("
                f"ep, mesh) and a sharded state, each placed once (got {ep.length.shape[-1]} "
                f"and {state.cum_in.shape[-1]} links)")
        draws = None
        if stochastic:
            if gen is None:
                raise ValueError("a stochastic step needs a torch.Generator")
            draws = BlockDraws(gen, mesh, env_axis=env_axis, link_axis=link_axis)
        return simulate_batched(view, ep, state, num_steps, draws, stochastic, links)

    return run


def make_link_sharded_simulate(scn, mesh: Mesh, num_steps: int, stochastic: bool = False,
                               axis: str = "link"):
    """``run(ep, state, gen=None) -> final_state`` over ``num_steps`` engine
    steps on this rank's block of a link-sharded state
    (``shard_link_state``) with this rank's block of the parameters
    (``shard_link_params``); both are placed once by the caller, and whole
    ones are refused.

    Semantics are those of ``engine.simulate(..., record=False)``: the same
    step function on a different layout.  ``gen`` (required when
    ``stochastic``) must be in the same state on every rank.  The block's
    rings are advanced in place."""
    return _sharded_run(scn, mesh, num_steps, stochastic, None, axis)


def make_link_sharded_step(scn, mesh: Mesh, stochastic: bool = False, axis: str = "link"):
    """A single sharded step ``step(ep, state, gen=None) -> state``
    (interactive or RL-control stepping on a link-sharded network)."""
    return _sharded_run(scn, mesh, 1, stochastic, None, axis)


def make_hybrid_sharded_simulate(scn, mesh: Mesh, num_steps: int, stochastic: bool = False,
                                 env_axis: str = "env", link_axis: str = "link"):
    """``run(ep, states, gen=None) -> final_states`` with the replica axis
    blocked over ``env_axis`` and the link axis over ``link_axis``
    (semantics of ``engine.simulate_batched``; shared unbatched
    ``EngineParams``, placed with ``shard_link_params`` as in the 1-D path).
    Only the link axis communicates."""
    return _sharded_run(scn, mesh, num_steps, stochastic, env_axis, link_axis)


def assert_no_full_ring_collectives(record, ring_bytes: int) -> Tuple[int, int]:
    """Hold a sharded run to its memory claim: no collective moved a ring.

    ``record`` is the mesh's record of its collectives (``mesh.collectives``:
    ``{name: [calls, largest result in bytes, total bytes]}``), or the mesh
    itself; ``ring_bytes`` = B * H * E * itemsize of one whole ring.  Returns
    ``(n_collectives, n_violations)`` and raises ``AssertionError`` when a
    collective's result reached a ring's size — link sharding would then
    have degenerated to replication.  Reading a state back
    (``unshard_state``) and the once-only check that the ranks built one
    scenario are not part of a run and are not counted."""
    record = getattr(record, "collectives", record)
    n_coll = 0
    bad = []
    for name, (calls, largest, _total) in record.items():
        if name in (UNSHARD, SCENARIO_CHECK):
            continue
        n_coll += calls
        if largest >= ring_bytes:
            bad.append(f"{name}: {calls} calls, largest {largest} bytes >= ring {ring_bytes}")
    if bad:
        raise AssertionError("collective(s) materialize a full ring — link sharding "
                             "degenerated to replication:\n" + "\n".join(bad))
    return n_coll, len(bad)
