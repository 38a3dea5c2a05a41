"""Link-axis state sharding demo (SURVEY §2.6's TP analog; the counterpart
of ``examples/link_sharded_scale.py``): one network too large for a single
device's ring budget, its simulation state blocked over ranks.

Builds an n x n 4-neighbour grid (default 165 -> 108,240 directed links),
blocks the O(E*H) ring state of ``--batch`` replicas over a 1-D ``link``
mesh of ``--ranks`` ranks (parallel/link_shard.py), runs a few hundred
stochastic steps, and reports per-rank block shapes and throughput.  With
``--hybrid`` the replicas are instead blocked over a 2-D env x link mesh
(DP over the first axis, state sharding over the second).

The ranks are processes started by ``parallel.spawn_ranks`` (the JAX
example's ``--cpu-mesh`` virtual devices become ``--ranks N``): gloo ranks
on the CPU; on the card, one card per rank over NCCL where there are
enough cards, else ranks sharing ``cuda:0`` over gloo.  Every rank builds
the scenario itself from the same seed, so the demand agrees.

No reference counterpart: the reference is a single-process object
graph (largest bundled network: melbourne, 938 directed links).

Run:  python -m pednstream_tpu_torch.examples.link_sharded_scale [--ranks 2] [--device cpu]
      python -m pednstream_tpu_torch.examples.link_sharded_scale --n 60 --steps 100 --ranks 4
"""

import argparse
import time

import torch

from ..device import DEFAULT, resolve
from ..scenario import build_scenario
from . import timed


def build(n: int = 165, steps: int = 200, window: int = 16, device=DEFAULT):
    from ..config import grid_adjacency

    N = n * n
    params = {
        "simulation_steps": steps + 1,
        "unit_time": 10,
        "seed": 0,
        "default_link": {
            "length": 80, "width": 3, "free_flow_speed": 1.2,
            "k_critical": 2, "k_jam": 6, "fd_type": "yperman", "bi_factor": 1,
        },
        "demand": {
            "origin_0": {"pattern": "constant", "base_lambda": 8},
            f"origin_{N - 1}": {"pattern": "constant", "base_lambda": 8},
        },
    }
    return build_scenario(grid_adjacency(n, n), params, [0, N - 1], [n - 1, N - n],
                          history_window=window, device=device)


def _rank(rank, world, device, opts):
    """One rank of the run: its block of the state stepped ``steps`` times;
    returns its block shape, launch counts and seconds, and on rank 0 the
    whole final state (gathered) on the CPU."""
    from .. import parallel as par
    from ..ops import fused_history_reads

    t0 = time.perf_counter()
    scn = build(opts["n"], opts["steps"], opts["window"], device)
    build_s = time.perf_counter() - t0
    if opts["hybrid"]:
        mesh = par.make_mesh_2d(2, world // 2, device=device)
        run = par.make_hybrid_sharded_simulate(scn, mesh, opts["steps"], stochastic=True)
        state = par.shard_hybrid_state(scn.init_state(opts["batch"]), mesh)
    else:
        mesh = par.make_mesh(world, axis="link", device=device)
        run = par.make_link_sharded_simulate(scn, mesh, opts["steps"], stochastic=True)
        state = par.shard_link_state(scn.init_state(opts["batch"]), mesh)
    ep = par.shard_link_params(scn.engine_params, mesh)
    gen = torch.Generator(device=device).manual_seed(opts["seed"])
    before = dict(fused_history_reads.launches)
    final, dt = timed(lambda: run(ep, state, gen), resolve(device))
    launches = {k: v - before[k] for k, v in fused_history_reads.launches.items()}
    block = tuple(final.cum_in_ring.shape)
    collectives = dict(mesh.collectives)
    whole = par.unshard_state(final, mesh, "link", "env" if opts["hybrid"] else None)
    return {"block": block, "launches": launches, "seconds": dt, "build_s": build_s,
            "n_links": scn.n_links, "H": scn.H, "collectives": collectives,
            "final": whole.to("cpu") if rank == 0 else None}


def run(n: int = 165, steps: int = 200, window: int = 16, hybrid: bool = False,
        batch: int = 4, ranks: int = 2, device=DEFAULT, seed: int = 0):
    """The sharded run over ``ranks`` spawned ranks; returns every rank's
    result (rank 0's holds the whole final state)."""
    from ..parallel import spawn_ranks

    if ranks < 2 or (hybrid and ranks % 2):
        raise ValueError(f"{ranks} rank(s): sharding needs at least 2 (an even number "
                         "with --hybrid)")
    if resolve(device).type == "cuda":
        from ..ops._build import build as build_kernels

        build_kernels()  # the ranks only load the kernel library
    opts = dict(n=n, steps=steps, window=window, hybrid=hybrid, batch=batch, seed=seed)
    results = spawn_ranks(_rank, ranks, (opts,), device=device)
    r0 = results[0]
    E, H = r0["n_links"], r0["H"]
    mass = float(r0["final"].num_peds.sum())
    secs = max(r["seconds"] for r in results)
    print(f"built {n * n} nodes / {E} directed links in {r0['build_s']:.1f}s; "
          f"ring state = {3 * batch * E * H * 4 / 1e6:.0f} MB over {ranks} ranks")
    layout = "hybrid" if hybrid else "link-sharded"
    print(f"{layout}: {batch} replicas x {steps} steps in {secs:.1f}s, per-rank ring block "
          f"{r0['block']}, final in-network mass {mass:.0f}")
    return results


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--n", type=int, default=165,
                   help="grid side; directed links = 4*n*(n-1)")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--window", type=int, default=16)
    p.add_argument("--hybrid", action="store_true",
                   help="replicas on a 2-D env x link mesh")
    p.add_argument("--batch", type=int, default=4, help="replicas")
    p.add_argument("--ranks", type=int, default=2, help="ranks (processes) to shard over")
    p.add_argument("--device", default=DEFAULT)
    a = p.parse_args(argv)
    return run(a.n, a.steps, a.window, a.hybrid, a.batch, a.ranks, a.device)


if __name__ == "__main__":
    main()
