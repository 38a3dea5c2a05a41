"""Multi-device scaling: meshes of ranks and sharded batched environments
(the counterpart of ``pednstream_tpu/parallel/mesh.py``).

The JAX package runs one program over a ``jax.sharding.Mesh`` and lets
XLA's partitioner insert the collectives.  Here the same layouts are
explicit SPMD over ``torch.distributed``: every rank runs the same Python
program on its own block of the state, and the few values that cross
ranks go through :func:`all_gather` and :func:`all_reduce_sum` below.

Axes:
  ``env``  — environment replicas (data parallelism for rollouts and
             per-agent updates);
  ``link`` — the directed-link axis of the simulation state
             (``parallel/link_shard.py``), for networks whose O(E*H) ring
             state outgrows one device.

A :class:`Mesh` names the axes, this rank's coordinates and one process
group per axis.  The process group must be up before a mesh is made:
:func:`spawn_ranks` starts ``world`` processes through a ``file://`` store
and runs a function in each; a launcher of the caller's own
(``torchrun``, a scheduler) works as well.

Backend and transport.  CPU ranks use ``gloo``.  On the card, ranks that
each own a card use ``nccl``; ranks that share one card use ``gloo``
(NCCL refuses two ranks on one device).  ``gloo`` takes the CUDA tensors
of :func:`all_gather` and :func:`all_reduce_sum` as they are, moves them
through host memory itself and waits for the card while it does: those
round trips are counted in ``Mesh.host_trips``.  State, kernels and every
per-link op stay on the card either way, and a rank that is asked for a
card and sees none raises (``device.resolve``).

Every rank builds the same scenario itself (a dataset that ships unseeded
draws fresh demand per build: seed it); the sharded paths check the demand
table once (:func:`assert_same_on_all_ranks`).

Random numbers.  A sharded run sees the unsharded run's draws: every rank
holds a generator in the same state, :class:`BlockDraws` makes each draw
at the UNSHARDED shape and keeps this rank's block.  The exact binomial
(``torch.binomial``) draws by value, so its trial counts and
probabilities are gathered to the unsharded shape first.  Sharded and
unsharded runs are then bitwise equal in both sampler modes; the price is
that the draw itself is not divided among the ranks.
"""

import contextlib
import dataclasses
import os
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..device import DEFAULT, resolve


# names under which Mesh.collectives records what is no part of a sharded
# step: reading a state back whole, and the once-only check of the scenario
UNSHARD = "unshard"
SCENARIO_CHECK = "scenario_check"


class Mesh:
    """Named axes over the ranks of the default process group.

    ``ranks`` is the array of global ranks in mesh layout (the last-named
    axis varies fastest), ``coords`` this rank's index on each axis,
    ``device`` where this rank keeps its blocks.  ``collectives`` records
    what :func:`all_gather` and :func:`all_reduce_sum` moved, as
    ``{name: [calls, largest result in bytes, total bytes]}``;
    ``host_trips`` counts the host round trips (the collectives that
    ``gloo`` moved through host memory among them).
    """

    def __init__(self, axis_names: Tuple[str, ...], ranks: np.ndarray, device: torch.device):
        self.axis_names = tuple(axis_names)
        self.ranks = ranks
        self.shape = tuple(ranks.shape)
        self.device = device
        self.rank = dist.get_rank()
        where = np.argwhere(ranks == self.rank)
        if len(where) != 1:
            raise ValueError(f"rank {self.rank} is not in the mesh {ranks.tolist()}")
        self.coords = dict(zip(self.axis_names, (int(i) for i in where[0])))
        # one group per line of ranks along each axis; every rank of the
        # default group creates every group, in the same order
        self._groups: Dict[str, object] = {}
        for k, name in enumerate(self.axis_names):
            lines = np.moveaxis(ranks, k, -1).reshape(-1, ranks.shape[k])
            for line in lines:
                group = dist.new_group([int(r) for r in line]) if len(line) > 1 else None
                if self.rank in line:
                    self._groups[name] = group
        # gloo moves a CUDA tensor through host memory and waits for the card
        self.via_host = dist.get_backend() == "gloo" and device.type == "cuda"
        self.collectives: Dict[str, List[int]] = {}
        self.host_trips = 0

    def size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)]

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axis: str):
        return self._groups[axis]

    def block(self, axis: str, n: int) -> slice:
        """This rank's block of an axis of length ``n`` (``n`` must divide
        evenly over the mesh axis)."""
        p = self.size(axis)
        if n % p:
            raise ValueError(f"an axis of length {n} does not divide over the {p} ranks of "
                             f"mesh axis {axis!r}")
        w = n // p
        return slice(self.index(axis) * w, (self.index(axis) + 1) * w)

    def _record(self, name: str, nbytes: int) -> None:
        rec = self.collectives.setdefault(name, [0, 0, 0])
        rec[0] += 1
        rec[1] = max(rec[1], nbytes)
        rec[2] += nbytes

    @contextlib.contextmanager
    def host_trip(self):
        """Around a host round trip of a sharded run (a collective over
        ``gloo``, a trainer reading its minibatch members): counted in
        ``host_trips``,
        and allowed under ``torch.cuda.set_sync_debug_mode("error")``, which
        holds everything else in the run to no host sync."""
        self.host_trips += 1
        if self.device.type != "cuda":
            yield
            return
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("default")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(mode)

    def _transport(self):
        """Around one collective: a host trip where it goes through the host."""
        return self.host_trip() if self.via_host else contextlib.nullcontext()


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str, dim: int = -1,
               name: str = "all_gather") -> torch.Tensor:
    """The blocks ``x`` of every rank along mesh ``axis``, concatenated
    along ``dim`` in rank order; every rank passes the same shape.  Recorded
    in ``mesh.collectives`` under ``name`` with the result's bytes."""
    n = mesh.size(axis)
    if n == 1:
        return x
    with mesh._transport():
        src = x.contiguous()
        outs = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(outs, src, group=mesh.group(axis))
        full = torch.cat(outs, dim=dim)
    mesh._record(name, full.numel() * full.element_size())
    return full


def all_reduce_sum(x: torch.Tensor, mesh: Mesh, axis: str,
                   name: str = "all_reduce") -> torch.Tensor:
    """The sum of ``x`` over the ranks along mesh ``axis`` (a new tensor)."""
    if mesh.size(axis) == 1:
        return x
    with mesh._transport():
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.group(axis))
    mesh._record(name, out.numel() * out.element_size())
    return out


def assert_same_on_all_ranks(x: torch.Tensor, mesh: Mesh, axis: str, what: str) -> None:
    """Raise unless ``x`` holds the same values on every rank along
    ``axis``.  The sharded paths call it once on the demand table: ranks
    that built different scenarios (an unseeded dataset draws fresh demand
    in every process) would otherwise run on and disagree silently."""
    if mesh.size(axis) == 1:
        return
    mine = torch.stack([x.double().sum(), x.double().abs().max()]).float().to(mesh.device)
    every = all_gather(mine.unsqueeze(0), mesh, axis, dim=0, name=SCENARIO_CHECK)
    if not torch.equal(every, every[:1].expand_as(every)):
        raise RuntimeError(f"{what} differs between the ranks of mesh axis {axis!r}: every "
                           f"rank must build the same scenario (seed an unseeded dataset)")


def _make(axis_names, ranks: np.ndarray, device) -> Optional[Mesh]:
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialised: start the ranks with "
                           "parallel.spawn_ranks or a launcher of your own")
    device = resolve(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if ranks.size > dist.get_world_size():
        raise ValueError(f"need {ranks.size} ranks, have {dist.get_world_size()}")
    if dist.get_rank() not in ranks:
        # groups are created by every rank of the default group, members or not
        for k in range(ranks.ndim):
            for line in np.moveaxis(ranks, k, -1).reshape(-1, ranks.shape[k]):
                if len(line) > 1:
                    dist.new_group([int(r) for r in line])
        return None
    return Mesh(axis_names, ranks, device)


def make_mesh(n_devices: Optional[int] = None, axis: str = "env",
              device=DEFAULT) -> Optional[Mesh]:
    """1-D mesh over ``axis`` (``'env'`` for replica data parallelism,
    ``'link'`` for ``parallel/link_shard.py``) of the first ``n_devices``
    ranks of the process group (all of them by default).  Every rank of
    the group must call it; a rank beyond ``n_devices`` gets ``None``."""
    if n_devices is None and dist.is_initialized():
        n_devices = dist.get_world_size()
    return _make((axis,), np.arange(n_devices or 1), device)


def make_mesh_2d(n_env: int, n_link: int, axes: tuple = ("env", "link"),
                 device=DEFAULT) -> Optional[Mesh]:
    """2-D mesh for the hybrid decomposition: replica data parallelism on
    the first axis, link-state sharding on the second.  The LAST-NAMED axis
    varies fastest over the ranks, so the link axis (which carries the
    per-step exchange) joins neighbouring ranks and the env axis (no
    rollout communication) the distant ones."""
    return _make(tuple(axes), np.arange(n_env * n_link).reshape(n_env, n_link), device)


def _map_tensors(fn: Callable, tree):
    """``fn`` over the tensor leaves of a tensor, a dict, a tuple or list,
    or a dataclass of them; other leaves pass through."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_tensors(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _map_tensors(fn, getattr(tree, f.name)) for f in dataclasses.fields(tree)})
    return tree


def shard_batch(tree, mesh: Mesh, axis: str = "env"):
    """This rank's block of the leading (replica) axis of every tensor leaf
    with ``ndim >= 1`` of ``tree`` (a ``NetworkState``, ``EngineParams``,
    dict, tuple or tensor), copied; scalars (a shared int ``t`` among them)
    stay whole."""
    def put(x):
        if x.ndim < 1:
            return x
        return x[mesh.block(axis, x.shape[0])].clone()

    return _map_tensors(put, tree)


def unshard_batch(tree, mesh: Mesh, axis: str = "env"):
    """The inverse of :func:`shard_batch` on every rank: the blocks of the
    leading axis gathered in rank order (for reading results; a sharded
    step never calls it)."""
    return _map_tensors(
        lambda x: x if x.ndim < 1 else all_gather(x, mesh, axis, dim=0, name=UNSHARD), tree)


class BlockDraws:
    """Random draws of a sharded run: made at the unsharded shape from
    ``gen`` (in the same state on every rank) and cut to this rank's block.

    A requested shape is this rank's: its leading axis is the block of the
    replicas when ``env_axis`` is given, its last axis the block of the
    links when ``link_axis`` is.  The engine and the trainers take an
    instance wherever they take a ``torch.Generator`` (``engine.draw``)."""

    def __init__(self, gen: torch.Generator, mesh: Mesh, env_axis: Optional[str] = None,
                 link_axis: Optional[str] = None):
        self.gen = gen
        self.mesh = mesh
        self.cuts = [(dim, axis) for dim, axis in ((0, env_axis), (-1, link_axis))
                     if axis is not None and mesh.size(axis) > 1]

    def _keep(self, full: torch.Tensor, shape) -> torch.Tensor:
        for dim, axis in self.cuts:
            w = shape[dim]
            full = full.narrow(dim, self.mesh.index(axis) * w, w)
        return full

    def draw(self, normal: bool, shape, dtype, device) -> torch.Tensor:
        full = list(shape)
        for dim, axis in self.cuts:
            full[dim] = shape[dim] * self.mesh.size(axis)
        fn = torch.randn if normal else torch.rand
        return self._keep(fn(full, generator=self.gen, dtype=dtype, device=device), shape)

    def binomial(self, n: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        """``torch.binomial(n, p)`` as the unsharded run draws it: counts
        and probabilities gathered to the unsharded shape first."""
        shape = n.shape
        for dim, axis in self.cuts:
            n = all_gather(n, self.mesh, axis, dim=dim, name="binomial_operands")
            p = all_gather(p, self.mesh, axis, dim=dim, name="binomial_operands")
        return self._keep(torch.binomial(n, p.contiguous(), generator=self.gen), shape)


def data_parallel_env_step(core, mesh: Mesh, axis: str = "env"):
    """A batched env step over this rank's block of the replicas.

    Returns ``step(states, actions, gen=None)`` -> ``(states, obs, rewards,
    done)`` on the local block (``shard_batch`` of the whole batch): each
    rank steps its own replicas and a pure rollout needs no communication.
    ``gen`` (required when the core is stochastic) is in the same state on
    every rank; the draws are those of the unsharded batch."""

    def step(states, actions, gen: Optional[torch.Generator] = None):
        draws = None if gen is None else BlockDraws(gen, mesh, env_axis=axis)
        return core.batch_step(states, actions, draws)

    return step


# -- starting the ranks ---------------------------------------------------------

# a collective that waits this long for another rank fails, and so does
# spawn_ranks when its ranks have not all ended by then
RANK_TIMEOUT_S = 900.0


def init_rank(rank: int, world: int, store: str, device=DEFAULT):
    """Join the process group of ``world`` ranks through the ``file://``
    store ``store`` and return this rank's device.  CPU ranks use ``gloo``;
    card ranks use ``nccl`` when there is a card for each and otherwise
    share ``cuda:0`` over ``gloo`` (see the module note)."""
    device = resolve(device)
    backend = "gloo"
    if device.type == "cuda":
        if torch.cuda.device_count() >= world:
            device = torch.device("cuda", rank)
            backend = "nccl"
        else:
            device = torch.device("cuda", device.index or 0)
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=RANK_TIMEOUT_S))
    return device


def _rank_main(rank, world, store, device, out_dir, fn, args, threads):
    try:
        if threads:
            torch.set_num_threads(threads)
        dev = init_rank(rank, world, store, device)
        result = fn(rank, world, dev, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def spawn_ranks(fn: Callable, world: int, args: tuple = (), device=DEFAULT,
                threads: Optional[int] = None) -> list:
    """Run ``fn(rank, world, device, *args)`` in ``world`` spawned processes
    joined into one process group, and return their results in rank order
    (anything ``torch.save`` takes; keep it on the CPU).

    ``fn`` must be importable by name (a module-level function).  The
    processes are spawned, never forked, so the caller may have CUDA
    initialised; a caller on the card builds the kernel library first
    (``ops._build.build()``) so that the ranks only load it.  ``threads``
    bounds each rank's CPU threads.  If any rank fails or the time runs
    out, the others are stopped and a ``RuntimeError`` carries the first
    failure's traceback."""
    import torch.multiprocessing as mp

    resolve(device)
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="pednstream_ranks_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world, store, str(device), tmp, fn, args, threads))
                 for r in range(world)]
        for p in procs:
            p.start()
        failed = None
        try:
            deadline = time.monotonic() + RANK_TIMEOUT_S
            while failed is None and any(p.is_alive() for p in procs):
                for p in procs:
                    p.join(timeout=0.05)
                bad = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                if bad:
                    failed = f"rank {bad[0]} exited with code {procs[bad[0]].exitcode}"
                elif time.monotonic() > deadline:
                    failed = f"no result after {RANK_TIMEOUT_S:.0f} s"
            bad = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
            if failed is None and bad:
                failed = f"rank {bad[0]} exited with code {procs[bad[0]].exitcode}"
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join()
        if failed is not None:
            # the first rank to fail: the others fail after it, in a collective
            errs = sorted((os.path.getmtime(e), r, e) for r in range(world)
                          if os.path.exists(e := os.path.join(tmp, f"rank{r}.err")))
            if errs:
                with open(errs[0][2]) as f:
                    failed += f"\n--- rank {errs[0][1]} ---\n{f.read()}"
            raise RuntimeError(f"spawn_ranks({getattr(fn, '__name__', fn)}, world={world}): "
                               f"{failed}")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]
