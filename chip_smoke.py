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
   instantiations: float32 at the PPO and SAC trainers' shapes (the
   kernels line reports the PPO one), at the main path's melbourne shape
   and at the env episode's 45_intersections shape, float64 at the exact path's
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
8. ppo_train: the trainer that made the shipped ppo_agents_45_intersections
   (``scripts/train_zoo.py``): ``BatchedPPOTrainer`` with the attention
   policy, open-anchored deltas and randomized worlds over
   ``PedNetParallelEnv("45_intersections", obs_mode="option2",
   action_gap=15, history_window=64)``, 256 replicas, 16 RL steps per
   iteration; one warm-up iteration on its own state, then 4 iterations
   (960 engine steps, across the 700-step episode boundary: reset, carry
   reset and world redraw) with no host sync allowed until each
   iteration's metrics are read; checks one float32 kernel launch per
   engine step, finite losses, KL and rewards, moved parameters, all
   state on the card, the world redraw and per-replica mass conservation.
9. sac_train: ``BatchedSACTrainer`` at its JAX defaults (64 replicas, 8
   collect steps, 32 updates of 256 per iteration, warm-up 1024) on the
   same env, 4 iterations so updates run after warm-up; the same checks,
   and its export loads back through the port's ``build_agents`` +
   ``load_all_agents`` and acts as the trained actor does.
10. zoo: every shipped checkpoint in ``artifacts/zoo`` loaded by the port
   on the card and on the CPU: the same deterministic actions on seeded
   observations (normalized by the shipped stats where present), rtol
   1e-5.

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
# the trainers' env and the PPO trainer are scripts/train_zoo.py's for
# 45_intersections: profiling.ZOO_PPO_ENV and profiling.ZOO_PPO
SAC_TRAIN = {"num_envs": 64, "collect_steps": 8, "updates_per_iter": 32, "batch_size": 256,
             "warmup_transitions": 1024, "gate_anchor": "open", "max_delta": 4.0,
             "randomize": True}
TRAIN_ITERATIONS = 4
ZOO_RTOL = 1e-5


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
    from pednstream_tpu_torch.profiling import ZOO_PPO, ZOO_PPO_ENV

    # the trainers' reads: 168 links, H=64 rings, one row per replica
    H = ZOO_PPO_ENV["history_window"]
    cases = [("float32", (ZOO_PPO["num_envs"], H, ENV["links"])),  # the kernels line's entry
             ("float32", (SAC_TRAIN["num_envs"], H, ENV["links"])),
             ("float32", (MAIN["batch"], MAIN["history_window"], 938)),
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


def check_on_card(name: str, x) -> None:
    """Every tensor in ``x`` (a tensor, module, dataclass or container of
    them) lies on the card."""
    import dataclasses

    import torch

    if isinstance(x, torch.Tensor):
        if x.device.type != "cuda":
            raise AssertionError(f"{name} is on {x.device}")
    elif isinstance(x, torch.nn.Module):
        for k, p in x.state_dict().items():
            check_on_card(f"{name}.{k}", p)
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            check_on_card(f"{name}.{f.name}", getattr(x, f.name))
    elif isinstance(x, dict):
        for k, v in x.items():
            check_on_card(f"{name}[{k}]", v)
    elif isinstance(x, (tuple, list)):
        for i, v in enumerate(x):
            check_on_card(f"{name}[{i}]", v)


def check_mass(states) -> float:
    """Per replica, the main path's float32 bound over the steps since the
    last reset; returns the worst error."""
    import torch

    steps = states.t - 1
    peak = states.cum_in.abs().amax(dim=1).clamp(min=1.0)
    mass_err = (states.cum_in - states.cum_out - states.num_peds).abs().amax(dim=1)
    if bool((mass_err > steps * 1.5 * 2.0 ** -23 * peak).any()):
        raise AssertionError("mass not conserved")
    if not bool(torch.isfinite(states.cum_in).all()):
        raise AssertionError("state not finite")
    return mass_err.max().item()


def flat_params(modules):
    import torch

    return torch.cat([p.detach().reshape(-1).clone() for m in modules for p in m.parameters()])


def train_env():
    from pednstream_tpu_torch.env import PedNetParallelEnv
    from pednstream_tpu_torch.profiling import ZOO_PPO_ENV

    env = PedNetParallelEnv(**ZOO_PPO_ENV, device="cuda")
    scn = env.scn
    if (scn.n_links, scn.n_nodes, env.possible_agents, scn.H, scn.simulation_steps,
            scn.binomial_mode) != (ENV["links"], 49, [ENV["agent"]], 64, 700, "exact"):
        raise AssertionError(f"unexpected training env: {scn.n_links} links, {scn.n_nodes} "
                             f"nodes, agents {env.possible_agents}, H={scn.H}")
    if env.observation_space(ENV["agent"]).shape != (16,):
        raise AssertionError("gate_24 should observe 4 links x 4 features")
    return env


def timed_iterations(first, second, ts, iterations: int):
    """``iterations`` of ``second(ts, first(ts))`` with no host sync
    allowed, each followed by a synchronize and its metrics' conversion;
    returns ``(ts, metrics per iteration, wall s, first ms, second ms)``,
    the halves timed with CUDA events."""
    import torch

    metrics, wall, ms_a, ms_b = [], [], [], []
    for _ in range(iterations):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            ev[0].record()
            mid = first(ts)
            ev[1].record()
            ts, m = second(ts, mid)
            ev[2].record()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
        ms_a.append(ev[0].elapsed_time(ev[1]))
        ms_b.append(ev[1].elapsed_time(ev[2]))
        metrics.append({k: float(v) for k, v in m.items()})
    return ts, metrics, wall, ms_a, ms_b


def phase_ppo_train(card: str, env) -> int:
    """The slice's main path; returns the float32 launches."""
    import math

    import torch
    from pednstream_tpu_torch.ops import fused_history_reads
    from pednstream_tpu_torch.profiling import ZOO_PPO
    from pednstream_tpu_torch.rl import BatchedPPOTrainer

    aid = ENV["agent"]
    tr = BatchedPPOTrainer(env.core, **ZOO_PPO)
    tr.train_iteration(tr.init(seed=SEED + 1))  # warm-up on its own state
    ts = tr.init(seed=SEED)
    before = flat_params([ts.params[aid]])
    worlds = ts.engine_params.k_critical.clone()
    torch.cuda.synchronize()

    reset_counts()
    ts, metrics, wall, rollout_ms, update_ms = timed_iterations(
        tr._rollout, tr._learn, ts, TRAIN_ITERATIONS)
    launches = fused_history_reads.launches["float32"]

    T, gap, B = tr.T, env.core.action_gap, tr.B
    engine_steps = TRAIN_ITERATIONS * T * gap
    if launches != engine_steps or fused_history_reads.launches["float64"]:
        raise AssertionError(f"fused_history_reads launched {launches} times in "
                             f"{engine_steps} engine steps")
    for m in metrics:
        if not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"non-finite metrics {m}")
    if torch.equal(before, flat_params([ts.params[aid]])):
        raise AssertionError("the policy did not change")
    # 64 RL steps of 15 cross the 700-step horizon once, at RL step 47
    episode_rl_steps = -(-env.scn.simulation_steps // gap)
    if ts.env_states.t != 1 + (TRAIN_ITERATIONS * T - episode_rl_steps) * gap:
        raise AssertionError(f"no episode boundary: t = {ts.env_states.t}")
    if torch.equal(worlds, ts.engine_params.k_critical):
        raise AssertionError("the worlds were not redrawn at the boundary")
    for name in ("env_states", "obs", "params", "value_params", "opt_states", "actor_carry",
                 "critic_carry", "engine_params"):
        check_on_card(name, getattr(ts, name))
    mass_err = check_mass(ts.env_states)
    seconds = sum(wall)
    emit("ppo_train", dataset=ENV["dataset"], links=env.scn.n_links, batch=B,
         rollout_len=T, action_gap=gap, history_window=env.scn.H,
         iterations=TRAIN_ITERATIONS, engine_steps=engine_steps,
         seconds_per_iteration=wall, rollout_ms=rollout_ms, update_ms=update_ms,
         engine_env_steps_per_s=B * engine_steps / seconds, kernel_launches=launches,
         loss=[m[f"{aid}/loss"] for m in metrics], kl=[m[f"{aid}/kl"] for m in metrics],
         reward=[m[f"{aid}/reward"] for m in metrics], max_mass_err=mass_err, card=card)
    return launches


def phase_sac_train(card: str, env) -> int:
    """The batched SAC trainer; returns the float32 launches."""
    import math
    import tempfile

    import numpy as np
    import torch
    from pednstream_tpu_torch.ops import fused_history_reads
    from pednstream_tpu_torch.rl import BatchedSACTrainer
    from pednstream_tpu_torch.rl.rl_utils import RunningNormalizeWrapper, load_all_agents
    from pednstream_tpu_torch.rl.train import build_agents

    aid = ENV["agent"]
    tr = BatchedSACTrainer(env.core, **SAC_TRAIN)
    ts = tr.init(seed=SEED)
    before = flat_params([ts.params[aid]["actor"]])
    torch.cuda.synchronize()

    reset_counts()
    ts, metrics, wall, collect_ms, update_ms = timed_iterations(
        tr._collect, tr._learn, ts, TRAIN_ITERATIONS)
    launches = fused_history_reads.launches["float32"]

    engine_steps = TRAIN_ITERATIONS * tr.C * env.core.action_gap
    if launches != engine_steps or fused_history_reads.launches["float64"]:
        raise AssertionError(f"fused_history_reads launched {launches} times in "
                             f"{engine_steps} engine steps")
    updated = [m for m in metrics if m["buffer_size"] >= tr.warmup]
    if len(updated) < 2:
        raise AssertionError("fewer than two iterations ran updates")
    for m in updated:
        if not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"non-finite metrics {m}")
    if torch.equal(before, flat_params([ts.params[aid]["actor"]])):
        raise AssertionError("the actor did not change")
    for name in ("env_states", "obs", "stacks", "params", "rms", "returns", "buffers"):
        check_on_card(name, getattr(ts, name))
    mass_err = check_mass(ts.env_states)

    # export -> the port's build_agents + load_all_agents on the CPU: the
    # loaded agent acts on a stacked window as the trained actor does
    with tempfile.TemporaryDirectory() as out:
        tr.export(ts, out)
        wrapped = RunningNormalizeWrapper(env)
        agents = load_all_agents(build_agents(wrapped, algo="sac"), out, env=wrapped)
    window = ts.stacks[aid][:1]
    with torch.no_grad():
        want = torch.tanh(ts.params[aid]["actor"](window)[0])[0].cpu().numpy() * tr.max_delta
    agent = agents[aid]
    agent.reset_hidden()
    for frame in window[0].cpu().numpy():  # pushing the S frames rebuilds the window
        got = agent.take_action(frame, explore=False)
    if not np.allclose(got, want, rtol=ZOO_RTOL, atol=1e-6):
        raise AssertionError(f"exported agent acts {got}, the trainer's actor {want}")
    seconds = sum(wall)
    emit("sac_train", dataset=ENV["dataset"], batch=tr.B, collect_steps=tr.C,
         updates_per_iter=tr.U, batch_size=tr.batch_size, iterations=TRAIN_ITERATIONS,
         engine_steps=engine_steps, seconds_per_iteration=wall, collect_ms=collect_ms,
         update_ms=update_ms, engine_env_steps_per_s=tr.B * engine_steps / seconds,
         kernel_launches=launches, buffer_size=ts.size,
         critic_loss=[m[f"{aid}/critic_loss"] for m in metrics],
         actor_loss=[m[f"{aid}/actor_loss"] for m in metrics],
         alpha=[m[f"{aid}/alpha"] for m in metrics], reward=[m["reward"] for m in metrics],
         export_loaded=sorted(agents), max_mass_err=mass_err, card=card)
    return launches


def phase_zoo(card: str) -> None:
    """Every shipped checkpoint on the card against the port on the CPU."""
    import pickle
    from types import SimpleNamespace

    import numpy as np
    from pednstream_tpu_torch.rl import PPOAgent, SACAgent
    from pednstream_tpu_torch.rl.rl_utils import RunningNormalizeWrapper

    dirs = sorted(d for d in (ROOT / "artifacts" / "zoo").iterdir() if "_agents_" in d.name)
    if len(dirs) != 19:
        raise AssertionError(f"expected 19 zoo checkpoints, found {len(dirs)}")
    worst = 0.0
    for d in dirs:
        wrapper = None
        if (d / "norm_stats.json").exists():
            wrapper = RunningNormalizeWrapper(SimpleNamespace(obs_mode="option2"))
            wrapper.load_stats(str(d / "norm_stats.json"))
        for pkl in sorted(d.glob("*.pkl")):
            aid = pkl.stem
            cfg = pickle.load(open(pkl, "rb"))["config"]
            A = cfg["act_dim"]
            bounds = dict(action_low=np.zeros(A, np.float32),
                          action_high=np.full(A, 4.0, np.float32))
            agents = []
            for device in ("cuda", "cpu"):
                if cfg.get("algo") == "sac":
                    a = SACAgent(cfg["obs_dim"], A, stack_size=cfg["stack_size"],
                                 is_separator=aid.startswith("sep"), device=device, **bounds)
                else:
                    a = PPOAgent(cfg["obs_dim"], A, features_per_link=cfg["features_per_link"],
                                 net_type=cfg["net_type"], hidden_dim=cfg["hidden_dim"],
                                 device=device, **bounds)
                a.load(str(pkl))
                a.reset_hidden()
                agents.append(a)
            rng = np.random.default_rng(SEED)
            for _ in range(3):
                obs = rng.uniform(0.0, 4.0, cfg["obs_dim"]).astype(np.float32)
                if wrapper is not None:
                    obs = wrapper._norm_obs({aid: obs})[aid]
                card_act, cpu_act = (a.absolute_action(obs, a.take_action(obs, explore=False))
                                     for a in agents)
                if not np.allclose(card_act, cpu_act, rtol=ZOO_RTOL, atol=1e-6):
                    raise AssertionError(f"{d.name}/{aid}: card {card_act} vs cpu {cpu_act}")
                worst = max(worst, float(np.abs(card_act - cpu_act).max()))
    emit("zoo", checkpoints=len(dirs), rtol=ZOO_RTOL, max_abs_err=worst, card=card)


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
    launches["float32"] += phase_env(card)
    env = train_env()
    launches["float32"] += phase_ppo_train(card, env)
    launches["float32"] += phase_sac_train(card, env)
    phase_zoo(card)

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
