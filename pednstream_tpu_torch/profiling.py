"""Where a step's time goes: the port's two batched paths under
``torch.profiler``.

    python -m pednstream_tpu_torch.profiling env [--binomial-mode fast]
    python -m pednstream_tpu_torch.profiling main

``env`` is the randomized RL env episode of ``chip_smoke.py``
(45_intersections with OD randomization, 256 replicas, each with its own
randomized EngineParams, uniform random actions, ``batch_step_randomized``);
``main`` is its main path (melbourne, 1024 replicas, H=16, fast binomial,
``simulate_batched``).  Each run steps ``--warm`` times, times ``--steps``
more steps on the host clock with the profiler off (ending in
``torch.cuda.synchronize()``), then profiles ``--steps`` more.  It prints
one JSON line: wall ms per step (profiler off), device kernels and
``cudaLaunch*`` calls per step, kernel ms per step (the profiler's summed
device self time), the device idle share ``1 - kernel / wall``, and the
kernels with the most device time, each with its count and ms per step.
On a CPU device there are no kernels; the counts read 0.
"""

import argparse
import json
import subprocess
import sys
import time
from typing import Callable

import torch
from torch.autograd import DeviceType

from .engine import simulate_batched
from .env.agents import build_agent_spec, build_spaces
from .env.core import PedNetEnvCore
from .generator import NetworkEnvGenerator
from .randomize import randomize_engine_params_batched
from .scenario import build_scenario

DEFAULTS = {"env": {"dataset": "45_intersections", "batch": 256, "warm": 130, "steps": 20,
                    "binomial_mode": "exact", "history_window": None},
            "main": {"dataset": "melbourne", "batch": 1024, "warm": 30, "steps": 20,
                     "binomial_mode": "fast", "history_window": 16}}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def env_stepper(dataset: str, batch: int, binomial_mode: str, device, seed: int = 0,
                history_window=None) -> Callable[[], None]:
    """One RL step of the randomized batched env per call."""
    scn = NetworkEnvGenerator(history_window=history_window, device=device) \
        .build_od_randomizable(dataset, binomial_mode=binomial_mode)
    spec = build_agent_spec(scn)
    core = PedNetEnvCore(scn, spec)
    action_spaces, _ = build_spaces(spec, core.obs_mode)
    g = torch.Generator(device=device).manual_seed(seed)
    eps = randomize_engine_params_batched(scn, g, batch)
    bounds = {a: [torch.as_tensor(x, device=device) for x in (sp.low, sp.high)]
              for a, sp in action_spaces.items()}
    box = {"states": core.batch_reset(batch)[0]}

    def step():
        actions = {a: lo + (hi - lo) * torch.rand((batch,) + lo.shape, generator=g,
                                                  device=device)
                   for a, (lo, hi) in bounds.items()}
        box["states"] = core.batch_step_randomized(box["states"], actions, eps, g)[0]
    return step


def main_stepper(dataset: str, batch: int, binomial_mode: str, device, seed: int = 0,
                 history_window=16) -> Callable[[], None]:
    """One stochastic step of the lockstep batch per call."""
    args = NetworkEnvGenerator().scenario_args(dataset)
    scn = build_scenario(**args, history_window=history_window,
                         binomial_mode=binomial_mode, device=device)
    g = torch.Generator(device=device).manual_seed(seed)
    box = {"states": scn.init_state(batch)}

    def step():
        box["states"] = simulate_batched(scn, scn.engine_params, box["states"], 1,
                                         gen=g, stochastic=True)
    return step


def profile(step: Callable[[], None], warm: int, steps: int, device, top: int = 12) -> dict:
    """Time and profile ``step`` (see the module docstring)."""
    for _ in range(warm):
        step()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    _sync(device)
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(steps):
            step()
        _sync(device)
    rows = prof.key_averages()
    kernels = [r for r in rows if r.device_type == DeviceType.CUDA]
    launches = sum(r.count for r in rows if r.key.startswith("cudaLaunch"))
    kernel_ms = sum(r.self_device_time_total for r in kernels) / 1e3 / steps
    kernels.sort(key=lambda r: r.self_device_time_total, reverse=True)
    return {
        "steps": steps, "warm": warm, "wall_ms_per_step": wall_ms,
        "kernels_per_step": sum(r.count for r in kernels) / steps,
        "launch_calls_per_step": launches / steps,
        "kernel_ms_per_step": kernel_ms,
        "device_idle_share": 1.0 - kernel_ms / wall_ms,
        "top_kernels": [{"name": r.key[:120], "per_step": r.count / steps,
                         "ms_per_step": r.self_device_time_total / 1e3 / steps}
                        for r in kernels[:top]],
    }


def run(path: str, device="cuda", **overrides) -> dict:
    """Build ``path`` ("env" or "main") with its defaults, ``overrides``
    applied, and profile it."""
    cfg = {**DEFAULTS[path], **overrides}
    make = env_stepper if path == "env" else main_stepper
    step = make(cfg["dataset"], cfg["batch"], cfg["binomial_mode"], device,
                history_window=cfg["history_window"])
    return {"path": path, **cfg, "device": str(device),
            **profile(step, cfg["warm"], cfg["steps"], device)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", choices=sorted(DEFAULTS))
    ap.add_argument("--device", default="cuda")
    for key in ("batch", "warm", "steps"):
        ap.add_argument(f"--{key}", type=int)
    ap.add_argument("--binomial-mode", choices=("exact", "fast"))
    args = ap.parse_args(argv)
    overrides = {k: v for k, v in vars(args).items()
                 if k not in ("path", "device") and v is not None}
    card = None
    if torch.device(args.device).type == "cuda":
        if not torch.cuda.is_available():
            print("profiling: no CUDA device", file=sys.stderr)
            return 1
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(json.dumps({**run(args.path, args.device, **overrides), "card": card}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
