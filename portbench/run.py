#!/usr/bin/env python3
"""One run of one benchmark cell of the PyTorch and CUDA port.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell's configuration, traffic mix and limits are found by name
(``portbench/spec.py``).  A run builds the program's scenario on the card,
warms up the cell's own shapes from a seed of its own, then runs the
window: ``--seconds`` of episodes back to back, every step dispatched
ahead, closed by one ``torch.cuda.synchronize()``.  Every input of the
window comes from ``--seed``.  With ``--trace 1`` a segment of steps at a
fixed place in a further episode runs under ``torch.profiler`` and the
per-layer metrics are read from it.  After the window the plain reference
checks the sampled steps (``portbench/check.py``).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number beside its limit;
the same numbers close standard error.  Each metric is read by its own
file (``portbench/spec.py``).  Without a CUDA card, with fewer cards than
the cell asks for, with JAX or the JAX package loaded once the window has
closed (looked for after the window and again just before the result is
printed), or with an end-to-end metric that its reader cannot give, the
run prints no result and exits 2.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
if __name__ == "__main__":
    # the bytecode of every module a run imports, torch's included, cached
    # at a fixed place inside the checkout, where the environment asks for
    # none: only a checkout's first run compiles it
    sys.pycache_prefix = str(ROOT / "build" / "pycache")
    sys.dont_write_bytecode = False

import numpy as np  # noqa: E402
import torch  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "pednstream_tpu")
# the device names of the program's hand kernels, by launch counter
KERNEL_NAMES = {"binom_fast": "binom_fast_kernel", "fused_history_reads": "history_reads_kernel",
                "turning_fractions": "turning_fractions_kernel"}


def _profiled():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


class Window:
    """Runs episodes of ``driver`` back to back and keeps the check's
    records: each episode's start and ``checks`` sampled steps, at step
    indices and on replicas drawn from the host generator ``rng``."""

    def __init__(self, driver, rng, check_rows: int, record: bool = True, checks: int = 1):
        self.driver, self.rng, self.record = driver, rng, record
        self.check_rows, self.checks = check_rows, checks
        self.records = []
        self.steps = 0
        self.episode = -1
        self.ep_step = driver.horizon

    def _rows(self):
        B, k = self.driver.batch, self.check_rows
        half = B // 2
        low = self.rng.choice(half, k // 2, replace=False)
        high = half + self.rng.choice(B - half, k - k // 2, replace=False)
        rows = sorted(int(x) for x in list(low) + list(high))
        return torch.as_tensor(rows, device=self.driver.device)

    def step(self) -> None:
        d = self.driver
        if self.ep_step == d.horizon:
            self.episode += 1
            self.ep_step = 0
            d.reset()
            if self.record:
                self.rows = self._rows()
                self.check_at = {int(x) for x in self.rng.choice(d.horizon, self.checks,
                                                                  replace=False)}
                self.records.append({"kind": "start", "episode": self.episode,
                                     "rows": self.rows, **d.start_record(self.rows)})
        if self.record and self.ep_step in self.check_at:
            pre = d.snapshot(self.rows)
            post = d.captured_step(self.rows)
            self.records.append({"kind": "step", "episode": self.episode,
                                 "ep_step": self.ep_step, "rows": self.rows,
                                 "pre": pre, "post": post})
        else:
            d.step()
        self.ep_step += 1
        self.steps += 1

    def run(self, seconds: float) -> float:
        """Steps until ``seconds`` have passed on the host clock, then one
        synchronize; returns the wall seconds of the whole window, whose
        steps are ``timed_steps``."""
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while True:
            self.step()
            if time.perf_counter() >= deadline:
                break
        sync(self.driver.device)
        wall = time.perf_counter() - t0
        self.timed_steps = self.steps
        return wall

    def finish(self) -> None:
        """After the window, untimed: steps on to the first sampled step
        where the window closed before it, so that a run always has a step
        to judge."""
        while self.record and not any(r["kind"] == "step" for r in self.records):
            self.step()
        sync(self.driver.device)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def warm_up(driver, traffic: dict, seed: int, trace: bool) -> None:
    """Every shape of the cell's traffic once, from a seed of its own: an
    episode's start and its records, ``warm_steps`` steps (past the rings'
    and the travel-time window's first wrap) with a sampled step among
    them, and with ``trace`` a short profiled stretch."""
    driver.begin(seed ^ 0x5EED)
    driver.reset()
    rows = torch.arange(traffic["check_rows"], device=driver.device)
    driver.start_record(rows)
    for i in range(int(traffic["warm_steps"])):
        if i == 1:
            driver.snapshot(rows)
            driver.captured_step(rows)
        else:
            driver.step()
    if trace:
        with torch.profiler.profile(activities=_profiled()):
            for _ in range(2):
                driver.step()
            sync(driver.device)
    sync(driver.device)
    driver.release()


def traced_segment(driver, traffic: dict):
    """A fresh episode, ``trace.start`` steps untraced, then ``trace.steps``
    steps dispatched ahead under the profiler and synchronized once."""
    from portbench import trace as tr

    cfg = traffic["trace"]
    driver.reset()
    for _ in range(int(cfg["start"])):
        driver.step()
    sync(driver.device)
    before = launch_counts()
    prof = torch.profiler.profile(activities=_profiled())
    prof.start()
    t0 = time.perf_counter()
    for _ in range(int(cfg["steps"])):
        driver.step()
    sync(driver.device)
    window_s = time.perf_counter() - t0
    prof.stop()
    segment = tr.from_profiler(prof, int(cfg["steps"]), window_s)
    segment.counted = {k: v - before[k] for k, v in launch_counts().items()}
    return segment


def launch_counts() -> dict:
    """The program's own counts of its hand kernels' launches."""
    from pednstream_tpu_torch.ops import binom_fast, fused_history_reads, turning_fractions

    return {"binom_fast": sum(binom_fast.launches.values()),
            "fused_history_reads": sum(fused_history_reads.launches.values()),
            "turning_fractions": sum(turning_fractions.launches.values())}


class Context:
    """What a metric's reader reads: the cell, its driver and reference,
    ``setup_s``, the window (its steps, records and wall seconds
    ``window_s``) and, in a traced run, the traced segment ``trace``."""

    def __init__(self, cell, driver, reference, setup_s, window, window_s, trace=None):
        self.cell, self.driver, self.reference = cell, driver, reference
        self.setup_s, self.window, self.window_s, self.trace = setup_s, window, window_s, trace
        self.batch = int(cell.traffic["batch"])


def read_metrics(entries, ctx, required: bool) -> dict:
    """Each metric of ``entries`` by its own reader.  A reader that finds
    nothing returns None and its metric is left out, unless ``required``
    (the end-to-end metrics): then the run stops with no result."""
    from portbench import spec

    metrics = {}
    for m in entries:
        value = spec.metric_reader(m["name"])(ctx)
        if value is None:
            if required:
                raise MissingMetric(m["name"])
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return metrics


def run_cell(cell, seed: int, seconds: float, trace: bool, device, report=sys.stderr) -> dict:
    """One run of ``cell`` on ``device``; returns the result line's object
    (the tests rehearse it on the CPU, where it names no device metric)."""
    from portbench import check as ck
    from portbench import drivers

    on_card = device.type == "cuda"
    marks = [("imports", time.perf_counter())]
    driver = drivers.make_driver(cell.config, cell.traffic, device)
    marks.append(("scenario_build", time.perf_counter()))
    warm_up(driver, cell.traffic, seed, trace)
    marks.append(("warm_up", time.perf_counter()))
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    driver.begin(seed)
    window = Window(driver, np.random.default_rng(seed), cell.traffic["check_rows"])
    setup_s = time.perf_counter() - T_PROCESS
    # the parts of set-up, in seconds, for the record (standard error)
    setup_parts, last = {}, T_PROCESS
    for name, at in marks:
        setup_parts[name], last = at - last, at
    wall = window.run(seconds)
    window.finish()
    segment = traced_segment(driver, cell.traffic) if trace else None
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    driver.release()
    found = forbidden_modules()
    if found:
        raise Forbidden(found)

    reference = drivers.make_reference(cell.config, cell.traffic, device)
    tally = ck.run_checks(reference, window.records)
    verdicts = ck.judge(tally.numbers(), cell.limits)
    # a window that reached no sampled step has nothing of the step to judge
    stepped = any(rec["kind"] == "step" for rec in window.records)
    correct = stepped and all(n <= lim for n, lim in verdicts.values())

    ctx = Context(cell, driver, reference, setup_s, window, wall, segment)
    metrics = {}
    if on_card:  # a rehearsal on the CPU names no device metric
        metrics = (read_metrics(cell.end_to_end, ctx, True) if segment is None
                   else read_metrics(cell.per_layer, ctx, False))
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                   "count": cell.chips, "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": window.timed_steps * driver.batch, "failed": 0,
           "metrics": metrics, "device": device_info}
    if segment is not None:
        from portbench.trace import breakdown

        device_info.update(busy_s=segment.busy_s(), window_s=segment.window_s,
                           card=card_line() if on_card else "not read")
        out["breakdown"] = breakdown(segment)
    out["checks"] = verdicts
    extra = {}
    if segment is not None:
        # the program's launch counters beside the trace's kernels by name
        extra["traced_launches"] = {
            name: [n, segment.device_seconds((KERNEL_NAMES[name],))[1]]
            for name, n in segment.counted.items()}
    print(json.dumps({"setup_s": setup_s, "setup_parts": setup_parts,
                      "window_s": wall, "batch_steps": window.timed_steps,
                      "episodes": window.episode + 1, "records": len(window.records),
                      **extra, "check_detail": tally.detail()}), file=report)
    for name, (n, lim) in verdicts.items():
        print(f"check {name} {n!r} limit {lim!r}", file=report)
    return out


class Forbidden(RuntimeError):
    """JAX or the JAX package was loaded in the measuring process."""


class MissingMetric(RuntimeError):
    """An end-to-end metric of the cell whose reader found nothing."""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import spec

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {cell.chips} CUDA device(s); torch sees {seen}",
              file=sys.stderr)
        return 2
    try:
        out = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda"))
        # again at the last moment: the check and the readers ran since
        found = forbidden_modules()
        if found:
            raise Forbidden(found)
    except Forbidden as e:
        print(f"portbench: the measuring process loaded {e.args[0]}", file=sys.stderr)
        return 2
    except MissingMetric as e:
        print(f"portbench: no value for the end-to-end metric {e.args[0]}", file=sys.stderr)
        return 2
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
