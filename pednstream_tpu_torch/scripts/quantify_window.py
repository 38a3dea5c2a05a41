"""Quantify the windowed-history approximation error (H = 64, 32, 16 against
the exact full-horizon ring) in deterministic mode, where trajectory
differences are purely the lookback clamp (the counterpart of
``scripts/quantify_window.py``; stochastic runs diverge chaotically from
any perturbation, which would measure chaos, not the approximation).

Each dataset runs one replica over its whole horizon at nominal demand and
with demand inflated 8x to force jams (the regime where the windowed
approximation actually differs), once with the full ring and once per H.

Run:  python -m pednstream_tpu_torch.scripts.quantify_window [--device cpu]
"""

import argparse

import numpy as np

from ..device import DEFAULT, resolve
from ..engine import simulate
from ..generator import NetworkEnvGenerator
from ..scenario import build_scenario

DATASETS = ("grid_50x50", "melbourne")
WINDOWS = (64, 32, 16)
DEMANDS = ((1.0, "nominal"), (8.0, "jam-heavy 8x demand"))


def run(scn, steps, demand_mult=1.0):
    """Deterministic rollout of one replica: ``(density, num_peds)``, each
    ``[steps, E]`` on the host."""
    ep = scn.engine_params
    if demand_mult != 1.0:
        ep = ep.replace(demand=ep.demand * demand_mult)
    _, outs = simulate(scn, ep, scn.init_state(), steps, stochastic=False, record=True)
    return outs.density[:, 0].cpu().numpy(), outs.num_peds[:, 0].cpu().numpy()


def compare(name, label, H, d_w, n_w, d_exact, n_exact):
    """The printed error line of one windowed run against the exact one."""
    dd = np.abs(d_w - d_exact)
    dn = np.abs(n_w - n_exact)
    return (f"{name} [{label}] H={H}: density err mean "
            f"{dd.mean():.4f} max {dd.max():.3f} ped/m^2 "
            f"(exact mean density {d_exact.mean():.3f}); "
            f"num_peds err mean {dn.mean():.3f} max {dn.max():.1f}")


def main(argv=None):
    """Prints one line per (dataset, demand, H); returns ``{(name, label,
    H): (density err max, num_peds err max)}``."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default=DEFAULT, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = resolve(args.device)

    errors = {}
    for name in DATASETS:
        gen = NetworkEnvGenerator(device=device)
        data = gen.load_network_data(name)
        args_ = (data["adjacency_matrix"], gen.config["params"],
                 gen.config["origin_nodes"], gen.config["destination_nodes"])
        steps = gen.config["params"]["simulation_steps"] - 1
        for mult, label in DEMANDS:
            d_exact, n_exact = run(build_scenario(*args_, device=device), steps, mult)
            for H in WINDOWS:
                d_w, n_w = run(build_scenario(*args_, history_window=H, device=device),
                               steps, mult)
                print(compare(name, label, H, d_w, n_w, d_exact, n_exact), flush=True)
                errors[(name, label, H)] = (float(np.abs(d_w - d_exact).max()),
                                            float(np.abs(n_w - n_exact).max()))
    return errors


if __name__ == "__main__":
    main()
