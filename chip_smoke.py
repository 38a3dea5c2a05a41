#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printing one JSON line (a failing phase raises, and the script
exits non-zero):

1. device: a CUDA card must be present; prints its name and power limit.
2. build: compiles the kernels from ``pednstream_tpu_torch/csrc`` (or loads
   the library built for the same sources).
3. kernel vs plain: ``fused_history_reads`` on the card against its plain
   PyTorch version on the same CUDA inputs, bitwise, for each of its two
   instantiations: float32 at the main path's melbourne shape and at the
   env episode's 45_intersections shape, float64 at the exact path's
   melbourne shape (full-horizon rings), each also at an odd shape; all
   timed with CUDA events.
4. main path: the melbourne scenario (938 directed links), 1024 lockstep
   replicas, a 16-step history window, the fast binomial sampler, 500
   stochastic steps through ``simulate_batched`` on the card with no host
   sync allowed; checks the float32 kernel launched once per step, that the
   state is finite and non-negative, that mass is conserved and that
   pedestrians arrived.
5. gpu vs cpu: a deterministic butterfly_scC rollout on the card against
   the same rollout on the CPU (plain PyTorch history read).
6. golden: every fixture in ``tests/golden`` run on the card in float64
   exact-parity mode (``pednstream_tpu_torch.golden``), every field within
   1e-5 of the fixture (made by the original PedNStream code), the float64
   kernel launched once per step; optimal_diamond takes the host LP solve.
7. env: ``PedNetParallelEnv("45_intersections", od_randomize=True)`` on the
   card, its core stepping 256 replicas, each with its own randomized
   EngineParams, through the full 700-step episode of
   ``batch_step_randomized`` (exact binomial, full-horizon rings) under
   uniform random actions, with no host sync allowed; checks shapes,
   finiteness, termination, mass conservation, arrivals and one float32
   kernel launch per step.

It then prints the kernels' record, the card's ``nvidia-smi`` line and, as
the last line, ``{"ok": true, "device": {...}}``.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
MAIN = {"dataset": "melbourne", "batch": 1024, "history_window": 16, "steps": 500}
GPU_VS_CPU = {"dataset": "butterfly_scC", "history_window": 64, "steps": 120,
              "demand_seed": 3, "atol": 5e-3}
# melbourne in exact mode: one replica, full-horizon rings (T + 1 = 201)
EXACT_SHAPE = (1, 201, 938)
ENV = {"dataset": "45_intersections", "batch": 256, "steps": 700, "links": 168,
       "agent": "gate_24"}
# the env episode's read: full-horizon rings (H = steps + 1, checked in phase_env)
ENV_SHAPE = (ENV["batch"], ENV["steps"] + 1, ENV["links"])


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 200, warmup: int = 10) -> float:
    """Mean milliseconds per call of ``fn`` on the card (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def history_inputs(B: int, H: int, E: int, seed: int, device, ring_dtype="float32"):
    """Random operands of the fused read, made with numpy from ``seed``;
    indices run from below 0 to beyond H so negative slots and the
    mod-H wrap are both exercised.  Coefs are float32 for either ring
    dtype."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    rings = [rng.uniform(0, 100, (B, H, E)).astype(ring_dtype) for _ in range(3)]
    idx = [rng.integers(-5, 3 * H, (B, E)).astype(np.int32) for _ in range(3)]
    coefs = rng.uniform(0, 1, (B, 4, E)).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (*rings, *idx, coefs)]


def phase_kernel(card: str) -> dict:
    """Each instantiation against the plain version; returns
    ``{dtype: {"max_abs_err", "ms", "plain_ms"}}`` at its path's shape."""
    import torch
    from pednstream_tpu_torch.ops import fused_history_reads, fused_history_reads_ref

    cases = [("float32", (MAIN["batch"], MAIN["history_window"], 938)),
             ("float32", ENV_SHAPE),
             ("float32", (3, 40, 70)),
             ("float64", EXACT_SHAPE),
             ("float64", (3, 40, 70))]
    record = {}
    for dtype, (B, H, E) in cases:
        args = history_inputs(B, H, E, SEED, "cuda", dtype)
        before = dict(fused_history_reads.launches)
        got = fused_history_reads(*args, H)
        want = fused_history_reads_ref(*args, H)
        torch.cuda.synchronize()
        if fused_history_reads.launches[dtype] != before[dtype] + 1:
            raise AssertionError(f"a {dtype} call did not launch the {dtype} kernel")
        err = 0.0
        for name, a, b in zip(("ci", "co", "diff"), got, want):
            if a.dtype != getattr(torch, dtype):
                raise AssertionError(f"{name} came back as {a.dtype}, not {dtype}")
            err = max(err, (a - b).abs().max().item())
            if not torch.equal(a, b):
                raise AssertionError(f"{dtype} kernel != plain for {name} at B={B} H={H} "
                                     f"E={E}: max abs err {err}")
        ms = cuda_ms(lambda: fused_history_reads(*args, H))
        plain_ms = cuda_ms(lambda: fused_history_reads_ref(*args, H))
        emit("kernel_vs_plain", kernel="fused_history_reads", dtype=dtype, B=B, H=H, E=E,
             bitwise_equal=True, max_abs_err=err, ms=ms, plain_ms=plain_ms, card=card)
        record.setdefault(dtype, {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    return record


def phase_main(card: str) -> int:
    import torch
    from pednstream_tpu_torch import NetworkEnvGenerator, build_scenario, simulate_batched
    from pednstream_tpu_torch.ops import fused_history_reads

    # the batched fast path: the fast binomial sampler, as bench.py's rows
    args = NetworkEnvGenerator().scenario_args(MAIN["dataset"])
    scn = build_scenario(**args, history_window=MAIN["history_window"],
                         binomial_mode="fast", device="cuda")
    if scn.n_links != 938:
        raise AssertionError(f"melbourne has {scn.n_links} links, expected 938")
    ep = scn.engine_params
    g = torch.Generator(device="cuda").manual_seed(SEED)

    # warm-up on its own state: the build, the allocator and lazy CUDA init
    simulate_batched(scn, ep, scn.init_state(MAIN["batch"]), 5, gen=g, stochastic=True)
    states = scn.init_state(MAIN["batch"])
    torch.cuda.synchronize()

    reset_counts()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        final = simulate_batched(scn, ep, states, MAIN["steps"], gen=g, stochastic=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = fused_history_reads.launches["float32"]

    if launches != MAIN["steps"] or fused_history_reads.launches["float64"]:
        raise AssertionError(f"fused_history_reads launched {launches} times in "
                             f"{MAIN['steps']} steps")
    if final.t != 1 + MAIN["steps"]:
        raise AssertionError(f"final t = {final.t}")
    for name, x in vars(final).items():
        if not isinstance(x, torch.Tensor):
            continue
        if x.device.type != "cuda":
            raise AssertionError(f"state leaf {name} is on {x.device}")
        if not bool(torch.isfinite(x).all()) or bool((x < 0).any()):
            raise AssertionError(f"state leaf {name} is not finite and non-negative")
    # mass conservation: cum_in, cum_out and num_peds each gain one rounded
    # float32 add per step, so their drift is at most 1.5 ulp of the largest
    # cumulative count per step
    peak = final.cum_in.abs().max().item()
    tol = MAIN["steps"] * 1.5 * 2.0 ** -23 * max(peak, 1.0)
    mass_err = (final.cum_in - final.cum_out - final.num_peds).abs().max().item()
    if mass_err > tol:
        raise AssertionError(f"mass not conserved: {mass_err} > {tol}")
    arrivals = final.virt_arr_cum.sum().item()
    if not arrivals > 0:
        raise AssertionError("no pedestrian arrived")
    emit("main_path", dataset=MAIN["dataset"], links=scn.n_links, nodes=scn.n_nodes,
         batch=MAIN["batch"], history_window=scn.H, steps=MAIN["steps"],
         seconds=seconds, env_steps_per_s=MAIN["steps"] * MAIN["batch"] / seconds,
         kernel_launches=launches, mass_err=mass_err, mass_tol=tol,
         total_arrivals=arrivals, card=card)
    return launches


def phase_gpu_vs_cpu(card: str) -> None:
    import torch
    from pednstream_tpu_torch import NetworkEnvGenerator, build_scenario, simulate
    from pednstream_tpu_torch.ops import fused_history_reads

    args = NetworkEnvGenerator().scenario_args(GPU_VS_CPU["dataset"])
    args["params"]["seed"] = GPU_VS_CPU["demand_seed"]  # the dataset ships unseeded
    density = {}
    for device in ("cuda", "cpu"):
        scn = build_scenario(**args, history_window=GPU_VS_CPU["history_window"],
                             device=device)
        before = fused_history_reads.launches["float32"]
        final, _ = simulate(scn, scn.engine_params, scn.init_state(1),
                            GPU_VS_CPU["steps"], record=False)
        launched = fused_history_reads.launches["float32"] - before
        if device == "cuda" and launched != GPU_VS_CPU["steps"]:
            raise AssertionError("the cuda rollout did not go through the kernel")
        density[device] = final.density.cpu()
    err = (density["cuda"] - density["cpu"]).abs().max().item()
    if not err <= GPU_VS_CPU["atol"]:
        raise AssertionError(f"cuda vs cpu density differ by {err} > {GPU_VS_CPU['atol']}")
    emit("gpu_vs_cpu", dataset=GPU_VS_CPU["dataset"], steps=GPU_VS_CPU["steps"],
         history_window=GPU_VS_CPU["history_window"], max_abs_density_err=err,
         atol=GPU_VS_CPU["atol"], card=card)


def reset_counts() -> None:
    from pednstream_tpu_torch.ops import fused_history_reads

    for dtype in fused_history_reads.launches:
        fused_history_reads.launches[dtype] = 0


def phase_golden(card: str) -> int:
    """Every golden fixture on the card; returns the float64 launches."""
    from pednstream_tpu_torch.golden import FIELDS, TOL, golden_errors
    from pednstream_tpu_torch.ops import fused_history_reads

    paths = sorted((ROOT / "tests" / "golden").glob("*.npz"))
    if len(paths) != 10:
        raise AssertionError(f"expected 10 golden fixtures, found {[p.stem for p in paths]}")
    total = 0
    for path in paths:
        reset_counts()
        t0 = time.perf_counter()
        errors, scn, T = golden_errors(path, "cuda")
        seconds = time.perf_counter() - t0
        launches = fused_history_reads.launches["float64"]
        if launches != T - 1 or fused_history_reads.launches["float32"]:
            raise AssertionError(f"{path.stem}: the float64 kernel launched {launches} "
                                 f"times in {T - 1} steps")
        worst = max(errors.values())
        emit("golden", fixture=path.stem, links=scn.n_links, steps=T - 1,
             solve=scn.assign_flows_type, max_abs_err=worst, fields=len(errors),
             float64_kernel_launches=launches, build_and_run_seconds=seconds, card=card)
        if errors.keys() != FIELDS.keys() or not worst <= TOL:
            raise AssertionError(f"{path.stem}: max abs err per field {errors} > {TOL}")
        total += launches
    return total


def phase_env(card: str) -> int:
    """The randomized env episode; returns the float32 launches."""
    import torch
    from pednstream_tpu_torch.env import PedNetParallelEnv
    from pednstream_tpu_torch.ops import fused_history_reads
    from pednstream_tpu_torch.randomize import randomize_engine_params_batched

    env = PedNetParallelEnv(ENV["dataset"], od_randomize=True, device="cuda")
    scn, core, B, steps = env.scn, env.core, ENV["batch"], ENV["steps"]
    if scn.n_links != ENV["links"] or env.possible_agents != [ENV["agent"]]:
        raise AssertionError(f"{ENV['dataset']}: {scn.n_links} links, agents "
                             f"{env.possible_agents}")
    if scn.H != scn.simulation_steps + 1 or scn.binomial_mode != "exact":
        raise AssertionError(f"H={scn.H}, binomial_mode={scn.binomial_mode}")
    if steps != scn.simulation_steps:
        raise AssertionError(f"the episode has {scn.simulation_steps} steps")
    g = torch.Generator(device="cuda").manual_seed(SEED)
    eps = randomize_engine_params_batched(scn, g, B)
    bounds = {a: [torch.as_tensor(x, device="cuda") for x in
                  (env.action_space(a).low, env.action_space(a).high)]
              for a in env.possible_agents}

    def actions():
        # uniform over each action space: the rate clip engages
        return {a: lo + (hi - lo) * torch.rand((B,) + lo.shape, generator=g, device="cuda")
                for a, (lo, hi) in bounds.items()}

    # warm-up on its own batch: the allocator and lazy CUDA init
    warm, _ = core.batch_reset(B)
    for _ in range(3):
        warm = core.batch_step_randomized(warm, actions(), eps, g)[0]
    states, _ = core.batch_reset(B)
    torch.cuda.synchronize()

    finite = torch.ones((), dtype=torch.bool, device="cuda")
    dones = []
    reset_counts()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(steps):
            states, obs, rewards, done = core.batch_step_randomized(states, actions(), eps, g)
            for x in (*obs.values(), *rewards.values()):
                finite = finite & torch.isfinite(x).all()
            dones.append(done)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = fused_history_reads.launches["float32"]

    if launches != steps or fused_history_reads.launches["float64"]:
        raise AssertionError(f"fused_history_reads launched {launches} times in {steps} steps")
    for a in env.possible_agents:
        n_obs = env.observation_space(a).shape[0]
        if tuple(obs[a].shape) != (B, n_obs) or tuple(rewards[a].shape) != (B,):
            raise AssertionError(f"{a}: obs {tuple(obs[a].shape)}, "
                                 f"rewards {tuple(rewards[a].shape)}")
    if not bool(finite):
        raise AssertionError("an observation or reward was not finite")
    done = torch.stack(dones)  # [steps, B]
    if bool(done[:-1].any()) or not bool(done[-1].all()):
        raise AssertionError("done must be true at the last step only")
    for name, x in vars(states).items():
        if not isinstance(x, torch.Tensor):
            continue
        if x.device.type != "cuda":
            raise AssertionError(f"state leaf {name} is on {x.device}")
        if not bool(torch.isfinite(x).all()) or bool((x < 0).any()):
            raise AssertionError(f"state leaf {name} is not finite and non-negative")
    # per replica, the main path's float32 bound on its own peak count
    peak = states.cum_in.abs().amax(dim=1).clamp(min=1.0)
    mass_err = (states.cum_in - states.cum_out - states.num_peds).abs().amax(dim=1)
    tol = steps * 1.5 * 2.0 ** -23 * peak
    if bool((mass_err > tol).any()):
        raise AssertionError(f"mass not conserved: worst excess "
                             f"{(mass_err - tol).max().item()}")
    arrivals = states.virt_arr_cum.sum().item()
    if not arrivals > 0:
        raise AssertionError("no pedestrian arrived")
    emit("env", dataset=ENV["dataset"], links=scn.n_links, batch=B, steps=steps,
         history=scn.H, binomial_mode=scn.binomial_mode, agents=env.possible_agents,
         seconds=seconds, env_steps_per_s=steps * B / seconds, kernel_launches=launches,
         max_mass_err=mass_err.max().item(), total_arrivals=arrivals, card=card)
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1
    if not (ROOT / "pednstream_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT} is not a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from pednstream_tpu_torch.ops import _build

    card = card_line()
    print(card, flush=True)
    emit("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         nvidia_smi=card, torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    info = _build.build()
    _build.library()
    emit("build", seconds=time.perf_counter() - t0, compiled=info["built"],
         nvcc_seconds=info["seconds"], library=str(Path(info["path"]).relative_to(ROOT)),
         ptxas=[ln.strip() for ln in info["log"].splitlines() if "registers" in ln])

    record = phase_kernel(card)
    launches = {"float32": phase_main(card)}
    phase_gpu_vs_cpu(card)
    launches["float64"] = phase_golden(card)
    phase_env(card)

    print(json.dumps({"kernels": [{
        "name": "fused_history_reads", "route": "cuda", "dtype": dtype,
        "source": "pednstream_tpu_torch/csrc/ncurve.cu",
        "replaces": "pednstream_tpu/ops/ncurve.py:180",
        "launches": launches[dtype], **record[dtype],
    } for dtype in ("float32", "float64")]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
