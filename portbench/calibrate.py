#!/usr/bin/env python3
"""The readings that the limits of ``correct`` are set from, on the card at
the cell's own size.

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,3 \
        [--episodes 1] [--checks 8] [--faults]

In one process it builds the program's cell and the reference once, then
for each seed runs ``--episodes`` episodes of the cell's traffic with
``--checks`` sampled steps each (the records a run keeps, more of them to
an episode), and compares them three ways:

- ``program``: the program's records, as a run compares them (the lower
  readings);
- ``control``: the reference in bfloat16 storage put in the program's
  place (the upper readings);
- with ``--faults``, the program's records with each fault of
  ``check.plant`` that the cell can have (its reference's ``faults``)
  planted: a step that returns its state unchanged, the second half of the
  batch left unstepped, one link's inflow off by one, every speed computed
  wrongly, and in the env every reward, or every observation, computed
  wrongly.

It prints one JSON line per seed with each reading's ``group_mismatch``
and ``count_gap``, and the groups that mismatched.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

def worst_groups(tally, top: int = 6) -> list:
    """The groups with the largest share of mismatched elements:
    ``[group, elements, mismatches, largest relative gap, largest gap]``."""
    rows = [[k, *g] for k, g in tally.detail().items() if g[1]]
    return sorted(rows, key=lambda r: r[2] / r[1], reverse=True)[:top]


def calibrate(cell, seeds, episodes: int, checks: int, faults: bool, device) -> None:
    import numpy as np

    from portbench import check as ck
    from portbench import drivers, run

    driver = drivers.make_driver(cell.config, cell.traffic, device)
    run.warm_up(driver, cell.traffic, seeds[0], False)
    reference = drivers.make_reference(cell.config, cell.traffic, device)
    for seed in seeds:
        driver.begin(seed)
        w = run.Window(driver, np.random.default_rng(seed), cell.traffic["check_rows"],
                       checks=checks)
        while not (w.episode == episodes - 1 and w.ep_step == driver.horizon):
            w.step()
        run.sync(device)
        driver.release()
        line = {"workload": cell.name, "seed": seed, "records": len(w.records)}
        program = ck.run_checks(reference, w.records)
        line["program"] = {**program.numbers(), "worst": worst_groups(program)}
        control = ck.run_checks(reference, w.records, control=True)
        line["control"] = {**control.numbers(), "worst": worst_groups(control)}
        if faults:
            for fault in reference.faults:
                line[fault] = ck.run_checks(reference, w.records, fault=fault).numbers()
        print(json.dumps(line), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--episodes", type=int, default=1)
    ap.add_argument("--checks", type=int, default=8)
    ap.add_argument("--faults", action="store_true")
    args = ap.parse_args(argv)
    import torch

    from portbench import spec

    device = torch.device("cuda")
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    calibrate(cell, [int(s) for s in args.seeds.split(",")], args.episodes, args.checks,
              args.faults, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
