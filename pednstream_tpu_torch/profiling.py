"""Where a step's time goes: the port's batched paths under
``torch.profiler``.

    python -m pednstream_tpu_torch.profiling env [--binomial-mode fast] [--with-plain]
    python -m pednstream_tpu_torch.profiling hetero
    python -m pednstream_tpu_torch.profiling main [--with-plain]
    python -m pednstream_tpu_torch.profiling ppo
    python -m pednstream_tpu_torch.profiling served

``env`` is the randomized RL env episode of ``chip_smoke.py``
(45_intersections with OD randomization, 256 replicas, each with its own
randomized EngineParams, uniform random actions, ``batch_step_randomized``);
``hetero`` is the same env with the replicas in 8 groups at different
times (10 engine steps apart), stepped with ``lockstep=False``: the
per-replica ring scatters, column gathers and time vector of the kernel
(its line also times the same env in lockstep in the same process, in
turns);
``main`` is its main path (melbourne, 1024 replicas, H=16, fast binomial,
``simulate_batched``); ``served`` is the tool server's simulation
(``mcp.server.create_environment("melbourne")``: one replica, exact binomial,
full-horizon rings), each call one ``run_simulation(steps=1)`` request, its
synchronize before the reply included.  Each run steps ``--warm`` times, times ``--steps``
more steps on the host clock with the profiler off (ending in
``torch.cuda.synchronize()``), then profiles ``--steps`` more, dispatched
ahead under one profiler and closed by one synchronize.  It prints one
JSON line: wall ms per step (profiler off), device kernels and
``cudaLaunch*`` calls per step, kernel ms per step (the profiler's summed
device self time), the device idle share of the profiled stretch (one
minus the union of its device intervals over its host wall), and the
kernels with the most device time, each with its count and ms per step.
``--with-plain`` adds the same numbers for the step with the three hot ops'
plain versions in place of their kernels (:func:`plain_hot_ops`: the step
as it was before them) and both timed in turns in the one process.
On a CPU device there are no kernels; the counts read 0.

``ppo`` is ``chip_smoke.py``'s trainer path: ``BatchedPPOTrainer`` as
``scripts/train_zoo.py`` configures it (``ZOO_PPO``: attention, open
anchor, randomized worlds, 256 replicas, 16 RL steps per iteration) on its
45_intersections env (``ZOO_PPO_ENV``: option2, action_gap 15, H=64, exact
binomial).  After ``--warm`` iterations it times
``--steps`` iterations on the host clock, each half (the rollout and the
update) ending in a synchronize, then profiles the two halves separately
over ``--steps`` iterations each.  It prints wall ms per iteration for
each half, device kernels per RL step of the rollout and per update,
kernel ms, idle shares and each half's top kernels.

:func:`trace_profile` is the counterpart of
``pednstream_tpu/utils/profiling.py``'s (``utils`` exports it): a
``torch.profiler`` trace written for Perfetto or ``chrome://tracing``, in
which the engine step's phases and the env step's parts show as the
spans of :mod:`.tracing`.
"""

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable

import torch
from torch.autograd import DeviceType

from .engine import simulate_batched
from .env.agents import build_agent_spec, build_spaces
from .env.core import PedNetEnvCore
from .generator import NetworkEnvGenerator
from .randomize import randomize_engine_params_batched
from .scenario import build_scenario
from .state import concat_states

# scripts/train_zoo.py's 45_intersections PPO run, the one that made the
# shipped ppo_agents_45_intersections: its env and its BatchedPPOTrainer
ZOO_PPO_ENV = dict(dataset="45_intersections", obs_mode="option2", action_gap=15,
                   history_window=64)
ZOO_PPO = dict(num_envs=256, rollout_len=16, net_type="attention", hidden_dim=64,
               gate_anchor="open", max_delta=4.0, randomize=True, randomize_fraction=1.0,
               lr=1e-4, epochs=4, minibatches=4, kl_target=0.02, reward_scale=1e-4)
DEFAULTS = {"env": {"dataset": "45_intersections", "batch": 256, "warm": 130, "steps": 20,
                    "binomial_mode": "exact", "history_window": None},
            "hetero": {"dataset": "45_intersections", "batch": 256, "warm": 100, "steps": 20,
                       "binomial_mode": "exact", "history_window": None},
            "main": {"dataset": "melbourne", "batch": 1024, "warm": 30, "steps": 20,
                     "binomial_mode": "fast", "history_window": 16},
            "served": {"dataset": "melbourne", "batch": 1, "warm": 100, "steps": 20,
                       "binomial_mode": "exact", "history_window": None},
            "ppo": {**ZOO_PPO_ENV, "batch": ZOO_PPO["num_envs"], "warm": 1, "steps": 2,
                    "rollout_len": ZOO_PPO["rollout_len"]}}


@contextlib.contextmanager
def trace_profile(log_dir: str = "outputs/profile"):
    """Capture a host and (where torch sees a card) device trace of the
    body: ``with trace_profile() as log_dir: run()`` writes
    ``log_dir/trace.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield log_dir
    finally:
        prof.stop()
        prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


HETERO_GROUPS = 8
HETERO_APART = 10


def env_stepper(dataset: str, batch: int, binomial_mode: str, device, seed: int = 0,
                history_window=None, hetero: bool = False) -> Callable[[], None]:
    """One RL step of the randomized batched env per call; with ``hetero``
    the replicas start in ``HETERO_GROUPS`` groups ``HETERO_APART`` engine
    steps apart and are stepped with ``lockstep=False``."""
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

    def step(lockstep=not hetero):
        actions = {a: lo + (hi - lo) * torch.rand((batch,) + lo.shape, generator=g,
                                                  device=device)
                   for a, (lo, hi) in bounds.items()}
        box["states"] = core.batch_step_randomized(box["states"], actions, eps, g,
                                                   lockstep=lockstep)[0]

    if hetero:
        # the batch in lockstep, one more group set aside every few steps
        per = batch // HETERO_GROUPS
        groups = []
        for k in range(HETERO_GROUPS):
            last = k == HETERO_GROUPS - 1
            groups.append(box["states"].take(slice(k * per, batch if last else (k + 1) * per)))
            if not last:
                for _ in range(HETERO_APART):
                    step(lockstep=True)
        box["states"] = concat_states(groups)
    return step


def main_stepper(dataset: str, batch: int, binomial_mode: str, device, seed: int = 0,
                 history_window=16) -> Callable[[], None]:
    """One stochastic step of the lockstep batch per call."""
    args = NetworkEnvGenerator(device=device).scenario_args(dataset)
    scn = build_scenario(**args, history_window=history_window,
                         binomial_mode=binomial_mode, device=device)
    g = torch.Generator(device=device).manual_seed(seed)
    box = {"states": scn.init_state(batch)}

    def step():
        box["states"] = simulate_batched(scn, scn.engine_params, box["states"], 1,
                                         gen=g, stochastic=True)
    return step


def served_stepper(dataset: str, batch: int, binomial_mode: str, device,
                   history_window=None) -> Callable[[], None]:
    """One one-step ``run_simulation`` request per call, on a simulation the
    tool server creates as it does for any client: ``batch``,
    ``binomial_mode`` and ``history_window`` must be the server's (1,
    "exact", None)."""
    from .mcp import server

    if (batch, binomial_mode, history_window) != (1, "exact", None):
        raise ValueError("the tool server steps one replica with the exact binomial and "
                         "full-horizon rings")
    reply = server.create_environment(dataset, device=str(device))
    if reply["status"] != "CREATED":
        raise RuntimeError(f"create_environment: {reply}")

    def step():
        done = server.run_simulation(reply["sim_id"], steps=1)
        if done.get("error") or done["status"] == "COMPLETED":
            raise RuntimeError(f"the served simulation cannot step further: {done}")
    return step


def _trace(calls, steps: int, device, top: int, between=None) -> dict:
    """Kernel statistics of ``steps`` calls of ``calls`` under
    ``torch.profiler``.  With no ``between`` the calls are dispatched ahead
    under one profiler and closed by one synchronize, and the stretch's
    host wall (``wall_ms``) and the union of its device intervals
    (``busy_ms``) come with them; else each call is profiled alone and
    ``between`` runs after it, untraced."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    kernels, launches, intervals, wall = {}, 0, [], 0.0
    for per_profile in [steps] if between is None else [1] * steps:
        with torch.profiler.profile(activities=activities) as prof:
            t0 = time.perf_counter()
            for _ in range(per_profile):
                calls()
            _sync(device)
            wall += time.perf_counter() - t0
        for r in prof.key_averages():
            if r.device_type == DeviceType.CUDA:
                n, us = kernels.get(r.key, (0, 0.0))
                kernels[r.key] = (n + r.count, us + r.self_device_time_total)
            elif r.key.startswith("cudaLaunch"):
                launches += r.count
        intervals += [(e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
                      if e.device_type() == DeviceType.CUDA]
        if between is not None:
            between()
    busy, end = 0, 0  # the length of the intervals' union
    for a, b in sorted(intervals):
        busy += max(b - max(a, end), 0)
        end = max(end, b)
    rows = sorted(kernels.items(), key=lambda kv: kv[1][1], reverse=True)
    return {
        "kernels": sum(n for n, _ in kernels.values()) / steps,
        "launch_calls": launches / steps,
        "kernel_ms": sum(us for _, us in kernels.values()) / 1e3 / steps,
        "busy_ms": busy / 1e6 / steps,
        "wall_ms": wall * 1e3 / steps,
        "top_kernels": [{"name": k[:120], "per_call": n / steps, "ms_per_call": us / 1e3 / steps}
                        for k, (n, us) in rows[:top]],
    }


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
    tr = _trace(step, steps, device, top)
    return {
        "steps": steps, "warm": warm, "wall_ms_per_step": wall_ms,
        "kernels_per_step": tr["kernels"], "launch_calls_per_step": tr["launch_calls"],
        "kernel_ms_per_step": tr["kernel_ms"],
        "device_idle_share": 1.0 - tr["busy_ms"] / tr["wall_ms"],
        "top_kernels": [{"name": r["name"], "per_step": r["per_call"],
                         "ms_per_step": r["ms_per_call"]} for r in tr["top_kernels"]],
    }


def ppo_profile(dataset: str, obs_mode: str, action_gap: int, history_window: int,
                batch: int, rollout_len: int, warm: int, steps: int, device, seed: int = 0,
                top: int = 8) -> dict:
    """The trainer path's two halves, timed and profiled (module docstring)."""
    from .env import PedNetParallelEnv
    from .rl.batched_ppo import BatchedPPOTrainer

    env = PedNetParallelEnv(dataset, obs_mode=obs_mode, action_gap=action_gap,
                            history_window=history_window, device=device)
    tr = BatchedPPOTrainer(env.core, **{**ZOO_PPO, "num_envs": batch,
                                        "rollout_len": rollout_len})
    ts = tr.init(seed)
    box = {}

    def rollout():
        box["rolled"] = tr._rollout(ts)

    def update():
        tr._learn(ts, box.pop("rolled"))

    for _ in range(warm):
        tr.train_iteration(ts)
    _sync(device)
    wall = {"rollout": 0.0, "update": 0.0}
    for _ in range(steps):
        for half, fn in (("rollout", rollout), ("update", update)):
            t0 = time.perf_counter()
            fn()
            _sync(device)
            wall[half] += (time.perf_counter() - t0) * 1e3 / steps
    out = {"steps": steps, "warm": warm, "engine_steps_per_iteration": rollout_len * action_gap,
           "wall_ms_per_iteration": wall["rollout"] + wall["update"]}
    traces = {"rollout": _trace(rollout, steps, device, top, between=update)}
    rollout()
    traces["update"] = _trace(update, steps, device, top, between=rollout)
    for half, tr_ in traces.items():
        out[half] = {"wall_ms": wall[half], "kernels": tr_["kernels"],
                     "launch_calls": tr_["launch_calls"], "kernel_ms": tr_["kernel_ms"],
                     "device_idle_share": 1.0 - tr_["kernel_ms"] / wall[half],
                     "top_kernels": tr_["top_kernels"]}
    out["rollout"]["kernels_per_rl_step"] = traces["rollout"]["kernels"] / rollout_len
    kernel_ms = traces["rollout"]["kernel_ms"] + traces["update"]["kernel_ms"]
    out["device_idle_share"] = 1.0 - kernel_ms / out["wall_ms_per_iteration"]
    return out


@contextlib.contextmanager
def plain_hot_ops():
    """The engine step's three hot ops through their plain PyTorch versions
    (``ops.binom_fast_plain``, ``routing.turning_fractions_step_plain``,
    ``ops.node_solve_plain``) instead of their kernels while it is entered:
    the step as it ran before the kernels, for a comparison in one process.
    It swaps module attributes, so no other thread may step meanwhile."""
    from . import engine
    from .ops import binom_fast_plain, node_solve_plain
    from .routing import turning_fractions_step_plain

    saved = (engine.binom_fast, engine.turning_fractions_step, engine._node_solve)
    engine.binom_fast = binom_fast_plain
    engine.turning_fractions_step = turning_fractions_step_plain
    engine._node_solve = node_solve_plain
    try:
        yield
    finally:
        engine.binom_fast, engine.turning_fractions_step, engine._node_solve = saved


def run(path: str, device="cuda", with_plain: bool = False, **overrides) -> dict:
    """Build ``path`` ("env", "hetero", "main", "served" or "ppo") with its defaults,
    ``overrides`` applied, and profile it.  ``with_plain`` (not ``ppo``)
    profiles a second stepper of the same path with the hot ops' plain
    versions (:func:`plain_hot_ops`) under ``"plain_hot_ops"``, and times the
    two in turns (kernels, plain, plain, kernels)."""
    cfg = {**DEFAULTS[path], **overrides}
    if path == "ppo":
        return {"path": path, **cfg, "device": str(device), **ppo_profile(**cfg, device=device)}
    make = {"main": main_stepper, "served": served_stepper}.get(path, env_stepper)
    extra = {"hetero": True} if path == "hetero" else {}
    step = make(cfg["dataset"], cfg["batch"], cfg["binomial_mode"], device,
                history_window=cfg["history_window"], **extra)
    out = {"path": path, **cfg, "device": str(device),
           **profile(step, cfg["warm"], cfg["steps"], device)}
    if with_plain:
        other = make(cfg["dataset"], cfg["batch"], cfg["binomial_mode"], device,
                     history_window=cfg["history_window"], **extra)

        def plain():
            with plain_hot_ops():
                other()

        out["plain_hot_ops"] = profile(plain, cfg["warm"], cfg["steps"], device)
        out["wall_ms_per_step_in_turns"] = in_turns(
            {"kernels": step, "plain": plain}, ("kernels", "plain", "plain", "kernels"),
            cfg["steps"], device)
    if path == "hetero":
        # the same env in lockstep, in the same process and in turns: two
        # processes' host paces differ by more than the paths do
        lock = make(cfg["dataset"], cfg["batch"], cfg["binomial_mode"], device,
                    history_window=cfg["history_window"])
        for _ in range(cfg["warm"]):
            lock()
        out["wall_ms_per_step_in_turns"] = in_turns(
            {"lockstep": lock, "hetero": step}, ("lockstep", "hetero", "hetero", "lockstep"),
            cfg["steps"], device)
    return out


def in_turns(steppers: dict, order, steps: int, device) -> list:
    """``[[name, wall ms per step], ...]``: ``steps`` steps of each stepper
    named in ``order``, one after the other, each ending in a synchronize."""
    out = []
    for name in order:
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(steps):
            steppers[name]()
        _sync(device)
        out.append([name, (time.perf_counter() - t0) * 1e3 / steps])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", choices=sorted(DEFAULTS))
    ap.add_argument("--device", default="cuda")
    for key in ("batch", "warm", "steps"):
        ap.add_argument(f"--{key}", type=int)
    ap.add_argument("--binomial-mode", choices=("exact", "fast"))
    ap.add_argument("--with-plain", action="store_true",
                    help="also profile the hot ops' plain versions, and time both in turns")
    args = ap.parse_args(argv)
    if args.path == "ppo" and args.binomial_mode is not None:
        ap.error("--binomial-mode does not apply to ppo: the zoo env samples exactly")
    if args.path == "ppo" and args.with_plain:
        ap.error("--with-plain applies to the stepped paths, not ppo")
    overrides = {k: v for k, v in vars(args).items()
                 if k not in ("path", "device", "with_plain") and v is not None}
    card = None
    if torch.device(args.device).type == "cuda":
        if not torch.cuda.is_available():
            print("profiling: no CUDA device", file=sys.stderr)
            return 1
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(json.dumps({**run(args.path, args.device, args.with_plain, **overrides),
                      "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
