#!/usr/bin/env python3
"""Sizing probes of a cell on the card, outside the benchmark's runs.

    python3 portbench/probe.py sweep --workload <name> --batches 1024,2048 --seconds 8
    python3 portbench/probe.py along --workload <name> --chunk 50

``sweep`` runs the cell's traffic at each batch in one process: a warm-up,
a window of ``--seconds`` (env-steps/s over all of it), then the traced
segment of the traffic file (device idle share, kernel ms and launches
per step).  ``along`` times one whole episode in chunks of ``--chunk``
steps by CUDA events recorded between the chunks, the steps dispatched
ahead with no synchronize until the end: how a step's device time varies
along an episode.  Each prints one JSON line per batch or episode.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def sweep(cell, batches, seconds: float, seed: int) -> None:
    import numpy as np
    import torch

    from portbench import drivers, run

    for B in batches:
        traffic = dict(cell.traffic, batch=B)
        driver = drivers.make_driver(cell.config, traffic, torch.device("cuda"))
        run.warm_up(driver, traffic, seed, True)
        torch.cuda.reset_peak_memory_stats()
        driver.begin(seed)
        w = run.Window(driver, np.random.default_rng(seed), traffic["check_rows"], record=False)
        wall = w.run(seconds)
        seg = run.traced_segment(driver, traffic)
        busy = seg.busy_s()
        print(json.dumps({
            "workload": cell.name, "batch": B, "seconds": wall, "steps": w.steps,
            "env_steps_per_s": w.steps * B / wall, "ms_per_step": wall * 1e3 / w.steps,
            "traced_idle_share": 1.0 - busy / seg.window_s,
            "kernel_ms_per_step": busy * 1e3 / seg.steps,
            "launches_per_step": seg.launches / seg.steps,
            "memory_peak_bytes": torch.cuda.max_memory_allocated()}), flush=True)
        driver.release()
        del driver
        torch.cuda.empty_cache()


def along(cell, chunk: int, seed: int, episodes: int) -> None:
    import torch

    from portbench import drivers, run

    driver = drivers.make_driver(cell.config, cell.traffic, torch.device("cuda"))
    run.warm_up(driver, cell.traffic, seed, False)
    driver.begin(seed)
    for _ in range(episodes):
        driver.reset()
        torch.cuda.synchronize()
        events = [torch.cuda.Event(enable_timing=True)]
        events[0].record()
        t0 = time.perf_counter()
        for i in range(driver.horizon):
            driver.step()
            if (i + 1) % chunk == 0 or i + 1 == driver.horizon:
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
        print(json.dumps({"workload": cell.name, "batch": driver.batch, "chunk": chunk,
                          "episode_wall_s": wall, "chunk_ms_per_step": [m / chunk for m in ms]}),
              flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("sweep", "along"))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--batches", default="")
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--chunk", type=int, default=50)
    ap.add_argument("--episodes", type=int, default=2)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    import torch

    from portbench import spec

    if not torch.cuda.is_available():
        print("probe: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    if args.what == "sweep":
        sweep(cell, [int(b) for b in args.batches.split(",")], args.seconds, args.seed)
    else:
        along(cell, args.chunk, args.seed, args.episodes)
    return 0


if __name__ == "__main__":
    sys.exit(main())
