"""Melbourne throughput sweep on the card: an H x B matrix of the batched
stochastic rollout (the counterpart of ``scripts/sweep_melbourne.py``).

Each row builds melbourne with ``history_window=H, binomial_mode="fast"``
and times ``simulate_batched`` over ``--steps`` stochastic steps of B
replicas: one warm run, then the best of ``--reps`` runs, each from fresh
initial states and a fresh generator, the clock read after the card has
drained.  A row that raises prints ``FAILED`` and the sweep goes on.

Run:  python -m pednstream_tpu_torch.scripts.sweep_melbourne [--device cpu]
          [--steps 500] [--reps 3]
"""

import argparse

import torch

from ..device import DEFAULT, resolve
from ..engine import simulate_batched
from ..examples import timed
from ..generator import NetworkEnvGenerator
from ..scenario import build_scenario

# (H, batches) rows, as scripts/sweep_melbourne.py sweeps them
GRID = ((32, (896, 1024, 1280)), (16, (1024, 1280, 1536)))


def measure(scn, batch, steps, seed0=1, reps=3, check=None):
    """env-steps/s of ``steps`` stochastic steps of ``batch`` replicas: the
    best of ``reps`` timed runs after one warm run.  ``check(final_state)``,
    when given, is called on every run's final state after its clock."""
    ep = scn.engine_params
    device = scn.device

    def one(seed):
        gen = torch.Generator(device=device).manual_seed(seed)
        st = scn.init_state(batch)
        out, dt = timed(lambda: simulate_batched(scn, ep, st, steps, gen, stochastic=True),
                        device)
        if check is not None:
            check(out)
        return dt

    one(0)  # warm run: the kernel library, the allocator's pools
    times = [one(seed0 + i) for i in range(reps)]
    return steps * batch / min(times)


def sweep(name, grid, line, steps=500, reps=3, device=DEFAULT, check=None):
    """One printed row per (H, B) of ``grid``: ``line(H, B, v)`` formats a
    measured rate, a raising row prints ``FAILED``.  Returns
    ``[(H, B, env-steps/s or the exception)]``."""
    device = resolve(device)
    gen = NetworkEnvGenerator(device=device)
    data = gen.load_network_data(name)
    rows = []
    for H, batches in grid:
        for B in batches:
            scn = build_scenario(
                data["adjacency_matrix"], gen.config["params"],
                gen.config["origin_nodes"], gen.config["destination_nodes"],
                history_window=H, binomial_mode="fast", device=device,
            )
            try:
                v = measure(scn, B, steps, reps=reps, check=check)
                print(line(H, B, v), flush=True)
                rows.append((H, B, v))
            except Exception as e:
                print(f"{name} H={H} B={B}: FAILED {type(e).__name__}: "
                      f"{str(e)[:200]}", flush=True)
                rows.append((H, B, e))
    return rows


def line(H, B, v):
    return f"melbourne H={H} B={B}: {v:.0f} env-steps/s ({B / v * 1e3:.2f} ms/step)"


def main(argv=None, check=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--steps", type=int, default=500,
                   help="steps per run (500: the full horizon)")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--device", default=DEFAULT, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    return sweep("melbourne", GRID, line, args.steps, args.reps, args.device, check)


if __name__ == "__main__":
    main()
