"""grid_50x50 throughput sweep on the card: a B x H matrix of the batched
stochastic rollout on the 9,800-link grid (the counterpart of
``scripts/sweep_grid.py``).  Rows are timed as
:func:`~pednstream_tpu_torch.scripts.sweep_melbourne.measure` times them;
a row that raises (out of memory at a large B) prints ``FAILED`` and the
sweep goes on.

Run:  python -m pednstream_tpu_torch.scripts.sweep_grid [--device cpu]
          [--steps 500] [--reps 3]
"""

import argparse

from ..device import DEFAULT
from .sweep_melbourne import sweep

# (H, batches) rows, as scripts/sweep_grid.py sweeps them
GRID = ((64, (128, 256, 512)), (32, (128, 256, 512)))


def line(H, B, v):
    return (f"grid_50x50 H={H} B={B}: {v:.0f} env-steps/s "
            f"({v / B * 1e3:.2f} us/step/env-inv, {B / v * 1e3:.2f} ms/step)")


def main(argv=None, check=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--steps", type=int, default=500,
                   help="steps per run (500: the full horizon)")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--device", default=DEFAULT, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    return sweep("grid_50x50", GRID, line, args.steps, args.reps, args.device, check)


if __name__ == "__main__":
    main()
