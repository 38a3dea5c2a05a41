"""Scale demo: the grid_50x50 benchmark network (2,500 nodes / 9,800
directed links, the BASELINE 10k-link design point), run with the
windowed-history engine and batched lockstep replicas on the card (the
counterpart of ``examples/grid_scale.py``).

No reference counterpart (the reference's largest bundled network is
melbourne, 938 directed links; its grids are 7x7 via data/create_grid.py).

The JAX example's ``--pallas`` switch chose between its Pallas history
read and its XLA one; the port has one path, the CUDA kernel of
``csrc/ncurve.cu`` on the card (its plain PyTorch version on the CPU), so
the switch is gone.

Run:  python -m pednstream_tpu_torch.examples.grid_scale [--batch 16] [--steps 100] [--device cpu]
"""

import argparse

import torch

from ..device import DEFAULT
from ..engine import simulate_batched
from ..generator import NetworkEnvGenerator
from ..scenario import build_scenario
from . import timed


def build(device=DEFAULT):
    gen = NetworkEnvGenerator(device=device)
    data = gen.load_network_data("grid_50x50")
    return build_scenario(
        data["adjacency_matrix"], gen.config["params"],
        gen.config["origin_nodes"], gen.config["destination_nodes"],
        history_window=64, binomial_mode="fast", device=device,
    )


def run(device=DEFAULT, batch=16, steps=100, seed=0):
    """A warm-up rollout, then a timed one, each of ``steps`` lockstep
    stochastic steps of ``batch`` fresh replicas."""
    scn = build(device)
    ep = scn.engine_params
    print(f"grid_50x50: {scn.n_nodes} nodes, {scn.n_links} directed links, H={scn.H}")
    gen = torch.Generator(device=scn.device).manual_seed(seed)
    simulate_batched(scn, ep, scn.init_state(batch), steps, gen, stochastic=True)
    out, dt = timed(lambda: simulate_batched(scn, ep, scn.init_state(batch), steps, gen,
                                             stochastic=True), scn.device)
    total_peds = float(out.num_peds.sum())
    rate = steps * batch / dt
    print(f"{steps} steps x {batch} replicas in {dt:.2f}s "
          f"= {rate:,.0f} env-steps/s "
          f"({rate * scn.n_links / 1e9:.2f}e9 link-updates/s); "
          f"{total_peds:,.0f} pedestrians in network")
    return {"scn": scn, "final": out, "steps": steps, "batch": batch, "seconds": dt,
            "rate": rate}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--device", default=DEFAULT)
    args = p.parse_args(argv)
    return run(args.device, args.batch, args.steps)


if __name__ == "__main__":
    main()
