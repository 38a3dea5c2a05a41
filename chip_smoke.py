#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printing one JSON line (a failing phase raises, and the script
exits non-zero):

1. device: a CUDA card must be present; prints its name and power limit.
2. build: compiles the kernels from ``pednstream_tpu_torch/csrc`` (or loads
   the library built for the same sources).
3. kernel vs plain: ``fused_history_reads`` (the lookback and the three
   ring reads in one kernel) on the card against its plain PyTorch
   version on the same CUDA operands, bitwise, for each of its two
   instantiations: float32 at the main path's real operands (melbourne
   after 100 steps) and at random operands at the main path's, the env
   episode's and the PPO and SAC trainers' shapes (those two with
   per-replica shockwave lookbacks) and two odd shapes; float64 at the
   exact path's melbourne shape (full-horizon rings) and an odd shape.
   Then the per-replica-``t`` form of both instantiations (a random step
   per replica, some at t < 6 and some past a ring wrap): float32 at the
   env episode's and the main path's shapes, float64 at an odd shape, each
   beside the shared-``t`` form on the same operands.
   Each case prints the kernel's device time per launch (a CUDA graph of
   launches timed with CUDA events), the wrapper's host time per call, the
   plain version's time, the bound (each byte moved once, at the card's
   memory rate), the sector bound of the rings' layout (each distinct
   32-byte sector the scattered ring reads touch) and the shares reached.
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

11. hetero: the env of phase 7 with its 256 replicas at 8 different times
   (32 each, 50 engine steps apart), 100 RL steps through
   ``batch_step_randomized(..., lockstep=False)`` with no host sync
   allowed: one launch of the per-replica-``t`` kernel per engine step,
   mass conserved per replica, ``t`` advanced per replica; run
   deterministically, each group compared with the same group stepped alone
   in lockstep from the same state.  Then a float64 exact-parity batch at
   three different times against its groups in lockstep (the float64
   per-replica-``t`` form).
12. evaluate: ``evaluate_agents("45_intersections", ...)`` on the card as
   ``scripts/train_zoo.py`` evaluates the shipped PPO policy (option2,
   action_gap 15), with the rule-based and no-control policies, two runs
   each (run 1 on a randomized network); every run directory is checked
   (files, T + 1 columns, finite metrics, mass conservation); one more run
   is read back (``load_simulation``, ``NetworkVisualizer``) against the
   history the env recorded, exported to HTML and, where matplotlib is
   installed, drawn; an engine-state checkpoint round-trips bit for bit on
   the card; the MPC baseline runs one butterfly_scC episode.

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
# the main path's steps before its real operands are taken for phase 3
KERNEL_REAL_STEPS = 100
ZOO_RTOL = 1e-5
HETERO = {"groups": 8, "apart": 50, "rl_steps": 100, "deterministic_steps": 10,
          "exact_dataset": "butterfly_scC", "exact_steps": 40}
EVALUATE = {"dataset": "45_intersections", "obs_mode": "option2", "action_gap": 15,
            "algos": ["ppo", "rule_based", "no_control"], "num_runs": 2,
            "checkpoint": "artifacts/zoo/ppo_agents_45_intersections",
            "mpc_dataset": "butterfly_scC", "mpc_action_gap": 60}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 200, warmup: int = 10) -> float:
    """Mean milliseconds per call of ``fn`` on the card (CUDA events around
    back-to-back calls: a call that launches many kernels is paced by the
    host)."""
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


def device_ms(fn, calls: int = 20, replays: int = 10) -> float:
    """Device milliseconds per call of ``fn``, apart from the host's cost:
    ``calls`` calls captured in one CUDA graph, the graph replayed
    ``replays`` times between CUDA events; the median replay over
    ``calls``.  Replays run back to back, so operands that fit the 50 MB L2
    are read warm."""
    import statistics

    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):  # capture needs a warmed-up call
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def host_us(fn, calls: int = 200) -> float:
    """Host microseconds per call of ``fn``: the host clock over ``calls``
    calls with no sync in between (the median of three runs)."""
    import statistics

    import torch

    runs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        runs.append((time.perf_counter() - t0) * 1e6 / calls)
        torch.cuda.synchronize()
    return statistics.median(runs)


HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
OPS_PER_LINK = 16  # the lookback's and the diffusion sum's float operations


def history_operands(B: int, H: int, E: int, seed: int, ring_dtype="float32",
                     per_replica: bool = False, per_replica_t: bool = False) -> list:
    """Random operands of the fused read on the card, made with numpy from
    ``seed``: rings, avg_tt (lags over [0, 3H), a tenth on a half step),
    gamma and tau_shockwave (``[E]``, or ``[B, E]`` when ``per_replica``),
    then t = H + 7 (negative bases on full-horizon rings, slots that wrap),
    or with ``per_replica_t`` one step per replica over [1, 3H + 8], the
    first few at 1, 2, ... (lags before time 0) and the last past two ring
    wraps; unit_time 10 and windowed for H of at most 64 rows."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    unit_time = 10.0
    rings = [rng.uniform(0, 100, (B, H, E)).astype(ring_dtype) for _ in range(3)]
    avg_tt = rng.uniform(0, 3 * H * unit_time, (B, E)).astype(np.float32)
    halves = ((rng.integers(0, 3 * H, (B, E)) + 0.5) * unit_time).astype(np.float32)
    avg_tt = np.where(rng.uniform(size=(B, E)) < 0.1, halves, avg_tt)
    lead = (B,) if per_replica else ()
    gamma = rng.uniform(0.001, 0.1, lead + (E,)).astype(ring_dtype)
    tau_sw = rng.integers(0, 3 * H, lead + (E,)).astype(np.int32)
    tensors = [torch.from_numpy(a).to("cuda") for a in (*rings, avg_tt, gamma, tau_sw)]
    t = H + 7
    if per_replica_t:
        steps = rng.integers(1, 3 * H + 9, B).astype(np.int32)
        small = min(5, max(B // 2, 1))
        steps[:small] = np.arange(1, small + 1)
        steps[-1] = 2 * H + 5
        t = torch.from_numpy(steps).to("cuda")
    return tensors + [t, unit_time, H <= 64]


def real_operands(scn, steps: int) -> list:
    """The main path's operands after ``steps`` stochastic steps of a
    fresh batch: its rings, travel times, gamma, shockwave lookbacks and
    step."""
    import torch
    from pednstream_tpu_torch import simulate_batched

    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    st = simulate_batched(scn, scn.engine_params, scn.init_state(MAIN["batch"]), steps,
                          gen=g, stochastic=True)
    ep = scn.engine_params
    return [st.cum_in_ring, st.cum_out_ring, st.inflow_ring, st.avg_tt, ep.gamma,
            ep.tau_shockwave, st.t, scn.unit_time, scn.windowed]


def read_bound(ops) -> dict:
    """The least time the card could take for the read on ``ops``: each
    byte it must move counted once (the ring values this step's lags
    need, avg_tt, gamma and tau_shockwave once per distinct value, the
    three outputs) over the memory rate, against its float operations over
    the float32 rate.  Beside it, the sector bound of the rings' layout:
    the distinct 32-byte sectors the six per-link ring reads touch (a
    scattered row costs a whole sector), with the other bytes as before."""
    import torch
    from pednstream_tpu_torch.ops import lookback

    rings, (avg_tt, gamma, tau), (t, unit_time, windowed) = ops[:3], ops[3:6], ops[6:]
    B, H, E = rings[0].shape
    item = rings[0].element_size()
    _, _, idx_ci, base, idx_co = lookback(avg_tt.expand(B, E), gamma, tau, t, H, unit_time,
                                          windowed)
    t_bytes = 4 * B if isinstance(t, torch.Tensor) else 0  # one step per replica
    reads = [(0, idx_ci, None), (1, idx_co, None)] + [(2, base - k, base - k >= 0)
                                                      for k in range(4)]
    lags = sum(int(valid.sum()) for _, _, valid in reads[2:])
    col = (torch.arange(B, device=base.device)[:, None] * H * E
           + torch.arange(E, device=base.device)[None, :])
    sectors = torch.cat([((col + (idx % H).long() * E) * item // 32 * 3 + ring)[
        valid if valid is not None else slice(None)].reshape(-1) for ring, idx, valid in reads])

    def distinct(x):
        return x.element_size() * (x.numel() if x.dim() == 2 and x.stride(0) else E)

    other = distinct(avg_tt) + distinct(gamma) + distinct(tau) + 3 * item * B * E + t_bytes
    moved = item * (2 * B * E + lags) + other
    sector_bytes = 32 * torch.unique(sectors).numel() + other
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = OPS_PER_LINK * B * E / FP32_OPS_PER_S * 1e3
    return {"bound_bytes": moved, "lags_read": lags, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "sector_bytes": sector_bytes,
            "sector_bound_ms": max(sector_bytes / HBM_BYTES_PER_S * 1e3, ops_ms)}


def phase_kernel(card: str, scn) -> dict:
    """Each instantiation against the plain version at every path's shape
    and at the main path's real operands, with a shared and with a
    per-replica step; returns ``{launch count key: record}`` for the
    kernels line (float32: the main path's real operands; per-replica
    ``t``: the hetero path's shape)."""
    import torch
    from pednstream_tpu_torch.ops import (PER_REPLICA_T, fused_history_reads,
                                          fused_history_reads_plain)
    from pednstream_tpu_torch.profiling import ZOO_PPO, ZOO_PPO_ENV

    H_train = ZOO_PPO_ENV["history_window"]
    M = (MAIN["batch"], MAIN["history_window"], 938)
    cases = [("real", "float32", M, False),  # the kernels line's float32 entry
             ("random", "float32", M, False),
             ("random", "float32", ENV_SHAPE, True),
             ("random", "float32", (ZOO_PPO["num_envs"], H_train, ENV["links"]), True),
             ("random", "float32", (SAC_TRAIN["num_envs"], H_train, ENV["links"]), True),
             ("random", "float32", (1, 16, 1), False),
             ("random", "float32", (5, 17, 1000), False),
             ("random", "float64", EXACT_SHAPE, False),  # the kernels line's float64 entry
             ("random", "float64", (3, 40, 70), False),
             # a step per replica; the kernels line's per-replica-t entries
             # are the hetero path's shape and the float64 one
             ("per replica t", "float32", ENV_SHAPE, True),
             ("per replica t", "float32", M, False),
             ("per replica t", "float64", (3, 40, 70), False)]
    record = {}
    for source, dtype, (B, H, E), per_replica in cases:
        if source == "real":
            ops = real_operands(scn, KERNEL_REAL_STEPS)
        else:
            ops = history_operands(B, H, E, SEED, dtype, per_replica,
                                   per_replica_t=source == "per replica t")
        key = dtype + (PER_REPLICA_T if source == "per replica t" else "")
        before = dict(fused_history_reads.launches)
        got = fused_history_reads(*ops)
        want = fused_history_reads_plain(*ops)
        torch.cuda.synchronize()
        if fused_history_reads.launches != {**before, key: before[key] + 1}:
            raise AssertionError(f"a {key} call did not launch the {key} kernel once")
        err = 0.0
        for name, a, b in zip(("ci", "co", "diff"), got, want):
            if a.dtype != getattr(torch, dtype):
                raise AssertionError(f"{name} came back as {a.dtype}, not {dtype}")
            err = max(err, (a - b).abs().max().item())
            if not torch.equal(a, b):
                raise AssertionError(f"{dtype} kernel != plain for {name} at B={B} H={H} "
                                     f"E={E} ({source} operands): max abs err {err}")
        timing = {"device_ms": device_ms(lambda: fused_history_reads(*ops)),
                  "host_ms": host_us(lambda: fused_history_reads(*ops)) / 1e3,
                  "plain_ms": cuda_ms(lambda: fused_history_reads_plain(*ops))}
        bound = read_bound(ops)
        rings_mb = 3 * ops[0].numel() * ops[0].element_size() / 1e6
        t = ops[6]
        if source == "per replica t":
            # the shared-t form on the same operands, in the same call
            shared = ops[:6] + [H + 7] + ops[7:]
            timing["shared_t_device_ms"] = device_ms(lambda: fused_history_reads(*shared))
            timing["shared_t_bound_ms"] = read_bound(shared)["bound_ms"]
            t = {"min": int(t.min()), "max": int(t.max()), "below_6": int((t < 6).sum()),
                 "past_a_wrap": int((t > H).sum())}
            if not (t["below_6"] and t["past_a_wrap"]):
                raise AssertionError(f"the per-replica steps {t} miss a case")
        emit("kernel_vs_plain", kernel="fused_history_reads", dtype=dtype, operands=source,
             B=B, H=H, E=E, t=t, windowed=ops[8], per_replica_gamma_tau=per_replica,
             bitwise_equal=True, max_abs_err=err, **timing, **bound,
             share_of_bound=bound["bound_ms"] / timing["device_ms"],
             share_of_sector_bound=bound["sector_bound_ms"] / timing["device_ms"],
             rings_mb=rings_mb, rings_fit_l2=rings_mb < 50.0, card=card)
        if (source, dtype) in (("real", "float32"), ("random", "float64"),
                               ("per replica t", "float32"), ("per replica t", "float64")):
            record.setdefault(key, {"max_abs_err": err, "ms": timing["device_ms"],
                                    **timing, "bound_ms": bound["bound_ms"],
                                    "bound_by": bound["bound_by"], "library_ms": None})
    return record


def main_scenario():
    """The main path's scenario: melbourne, H=16, the fast binomial sampler
    (as bench.py's rows), on the card."""
    from pednstream_tpu_torch import NetworkEnvGenerator, build_scenario

    args = NetworkEnvGenerator().scenario_args(MAIN["dataset"])
    scn = build_scenario(**args, history_window=MAIN["history_window"],
                         binomial_mode="fast", device="cuda")
    if scn.n_links != 938:
        raise AssertionError(f"melbourne has {scn.n_links} links, expected 938")
    return scn


def phase_main(card: str, scn) -> int:
    import torch
    from pednstream_tpu_torch import simulate_batched
    from pednstream_tpu_torch.ops import fused_history_reads

    ep = scn.engine_params
    g = torch.Generator(device="cuda").manual_seed(SEED)

    # warm-up on its own state: the allocator and lazy CUDA init
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
    check_state(final)
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


def phase_gpu_vs_cpu(card: str) -> int:
    """The card against the CPU; returns the float32 launches."""
    import torch
    from pednstream_tpu_torch import NetworkEnvGenerator, build_scenario, simulate
    from pednstream_tpu_torch.ops import fused_history_reads

    args = NetworkEnvGenerator().scenario_args(GPU_VS_CPU["dataset"])
    args["params"]["seed"] = GPU_VS_CPU["demand_seed"]  # the dataset ships unseeded
    density = {}
    for device in ("cuda", "cpu"):
        scn = build_scenario(**args, history_window=GPU_VS_CPU["history_window"],
                             device=device)
        reset_counts()
        final, _ = simulate(scn, scn.engine_params, scn.init_state(1),
                            GPU_VS_CPU["steps"], record=False)
        launched = dict(fused_history_reads.launches)
        want = {**dict.fromkeys(launched, 0),
                "float32": GPU_VS_CPU["steps"] if device == "cuda" else 0}
        if launched != want:
            raise AssertionError(f"the {device} rollout launched {launched}, not {want}")
        density[device] = final.density.cpu()
    err = (density["cuda"] - density["cpu"]).abs().max().item()
    if not err <= GPU_VS_CPU["atol"]:
        raise AssertionError(f"cuda vs cpu density differ by {err} > {GPU_VS_CPU['atol']}")
    emit("gpu_vs_cpu", dataset=GPU_VS_CPU["dataset"], steps=GPU_VS_CPU["steps"],
         history_window=GPU_VS_CPU["history_window"], max_abs_density_err=err,
         atol=GPU_VS_CPU["atol"], card=card)
    return GPU_VS_CPU["steps"]


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
    check_state(states)
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


def check_launches(key: str, n: int, what: str) -> None:
    """The fused read launched ``n`` times under ``key`` and under no other
    key since the counts were set to 0."""
    from pednstream_tpu_torch.ops import fused_history_reads

    want = {**dict.fromkeys(fused_history_reads.launches, 0), key: n}
    if fused_history_reads.launches != want:
        raise AssertionError(f"{what}: launches {fused_history_reads.launches}, expected {want}")


def check_state(states) -> None:
    """Every tensor leaf on the card, finite and non-negative."""
    import torch

    for name, x in vars(states).items():
        if not isinstance(x, torch.Tensor):
            continue
        if x.device.type != "cuda":
            raise AssertionError(f"state leaf {name} is on {x.device}")
        if not bool(torch.isfinite(x).all()) or bool((x < 0).any()):
            raise AssertionError(f"state leaf {name} is not finite and non-negative")


def largest_difference(a, b) -> dict:
    """``{leaf: max abs difference}`` over the tensor leaves of two states
    that differ (empty when they are equal bit for bit)."""
    import torch

    out = {}
    for name, x in vars(a).items():
        y = getattr(b, name)
        if isinstance(x, torch.Tensor) and not torch.equal(x, y):
            out[name] = (x.double() - y.double()).abs().max().item()
    return out


def phase_hetero(card: str) -> dict:
    """Replicas at different times in one batch; returns the launches of
    the per-replica-t forms ``{count key: launches}``."""
    import torch
    from pednstream_tpu_torch import NetworkEnvGenerator, build_scenario, concat_states
    from pednstream_tpu_torch import simulate, step_fn
    from pednstream_tpu_torch.env import PedNetEnvCore, PedNetParallelEnv
    from pednstream_tpu_torch.ops import PER_REPLICA_T
    from pednstream_tpu_torch.randomize import randomize_engine_params_batched

    env = PedNetParallelEnv(ENV["dataset"], od_randomize=True, device="cuda")
    scn, core, B = env.scn, env.core, ENV["batch"]
    G, apart, steps = HETERO["groups"], HETERO["apart"], HETERO["rl_steps"]
    per = B // G
    if scn.H != ENV["steps"] + 1 or scn.n_links != ENV["links"] or core.action_gap != 1:
        raise AssertionError(f"H={scn.H}, links={scn.n_links}, action_gap={core.action_gap}")
    g = torch.Generator(device="cuda").manual_seed(SEED)
    eps = randomize_engine_params_batched(scn, g, B)
    if eps.demand.dim() != 3 or eps.od_table.dim() != 3:
        raise AssertionError("the randomized worlds carry no per-replica demand tables")
    bounds = {a: [torch.as_tensor(x, device="cuda") for x in
                  (env.action_space(a).low, env.action_space(a).high)]
              for a in env.possible_agents}

    def actions(n=B):
        return {a: lo + (hi - lo) * torch.rand((n,) + lo.shape, generator=g, device="cuda")
                for a, (lo, hi) in bounds.items()}

    # the whole batch stepped in lockstep; every `apart` steps one more
    # group of 32 is set aside at the time it has reached
    states, _ = core.batch_reset(B)
    groups = []
    for k in range(G):
        groups.append(states.take(slice(k * per, (k + 1) * per)))
        if k < G - 1:
            for _ in range(apart):
                states = core.batch_step_randomized(states, actions(), eps, g)[0]
    start = concat_states(groups)
    want_t = torch.arange(G, device="cuda").repeat_interleave(per) * apart + 1
    if start.t.dtype != torch.int32 or not torch.equal(start.t, want_t.int()):
        raise AssertionError(f"start times {start.t.tolist()}")

    # deterministic: the batch at 8 times against each group alone in lockstep
    det = PedNetEnvCore(scn, core.spec, stochastic=False)
    D = HETERO["deterministic_steps"]
    fixed = [actions() for _ in range(D)]
    het = start.take(slice(None))
    reset_counts()
    for a in fixed:
        het = det.batch_step_randomized(het, a, eps, lockstep=False)[0]
    check_launches("float32" + PER_REPLICA_T, D, "deterministic het steps")
    differences = {}
    for k in range(G):
        sl = slice(k * per, (k + 1) * per)
        alone = start.take(sl).replace(t=k * apart + 1)
        eps_k = eps.take(sl)
        for a in fixed:
            alone = det.batch_step_randomized(alone, {n: x[sl] for n, x in a.items()}, eps_k)[0]
        if alone.t != k * apart + 1 + D:
            raise AssertionError(f"group {k} ended at t={alone.t}")
        diff = largest_difference(het.take(sl).replace(t=alone.t), alone)
        if diff:
            differences[f"group {k}"] = diff
    worst = max((v for d in differences.values() for v in d.values()), default=0.0)
    if worst > GPU_VS_CPU["atol"]:
        raise AssertionError(f"het batch vs its groups in lockstep: {differences}")

    # the path: stochastic, 100 RL steps, no host sync
    states = start
    for _ in range(3):  # warm-up on a copy
        warm = core.batch_step_randomized(start.take(slice(None)), actions(), eps, g,
                                          lockstep=False)[0]
    del warm
    torch.cuda.synchronize()
    finite = torch.ones((), dtype=torch.bool, device="cuda")
    any_done = torch.zeros((), dtype=torch.bool, device="cuda")
    reset_counts()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(steps):
            states, obs, rewards, done = core.batch_step_randomized(
                states, actions(), eps, g, lockstep=False)
            for x in (*obs.values(), *rewards.values()):
                finite = finite & torch.isfinite(x).all()
            any_done = any_done | done.any()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    key = "float32" + PER_REPLICA_T
    check_launches(key, steps, "het rollout")
    launches = {key: steps}
    if not bool(finite) or bool(any_done):
        raise AssertionError("a non-finite observation or reward, or an early done")
    if not torch.equal(states.t, (want_t + steps).int()):
        raise AssertionError(f"end times {states.t.tolist()}")
    check_state(states)
    # per replica, the main path's float32 bound over its own steps so far
    peak = states.cum_in.abs().amax(dim=1).clamp(min=1.0)
    mass_err = (states.cum_in - states.cum_out - states.num_peds).abs().amax(dim=1)
    tol = (states.t - 1) * 1.5 * 2.0 ** -23 * peak
    if bool((mass_err > tol).any()):
        raise AssertionError(f"mass not conserved: worst excess {(mass_err - tol).max().item()}")
    emit("hetero", dataset=ENV["dataset"], links=scn.n_links, batch=B, groups=G,
         steps_apart=apart, rl_steps=steps, history=scn.H, seconds=seconds,
         env_steps_per_s=steps * B / seconds, kernel_launches=steps,
         t_start=[k * apart + 1 for k in range(G)], t_end=states.t[::per].tolist(),
         max_mass_err=mass_err.max().item(), deterministic_steps=D,
         groups_equal_lockstep_bitwise=not differences,
         largest_difference_from_lockstep=differences, card=card)

    # float64 exact parity: three times in one batch against each alone
    args = NetworkEnvGenerator().scenario_args(HETERO["exact_dataset"])
    args["params"]["seed"] = GPU_VS_CPU["demand_seed"]
    xscn = build_scenario(**args, ftype=torch.float64, exact_parity=True, device="cuda")
    ep, n = xscn.engine_params, HETERO["exact_steps"]
    parts = [simulate(xscn, ep, xscn.init_state(2), k, record=False)[0] for k in (0, 7, 90)]
    het = concat_states(parts)
    reset_counts()
    for _ in range(n):
        het = step_fn(xscn, ep, het, record=False)[0]
    key64 = "float64" + PER_REPLICA_T
    check_launches(key64, n, "float64 het steps")
    launches[key64] = n
    for _ in range(n):
        parts = [step_fn(xscn, ep, p, record=False)[0] for p in parts]
    diff = largest_difference(het, concat_states(parts))
    if diff:
        raise AssertionError(f"float64 het batch differs from its groups: {diff}")
    emit("hetero_exact", dataset=HETERO["exact_dataset"], links=xscn.n_links, batch=het.batch,
         t_end=het.t.tolist(), steps=n, float64_kernel_launches=n,
         equal_lockstep_bitwise=True, card=card)
    return launches


def phase_evaluate(card: str) -> int:
    """The evaluation harness on the card; returns the float32 launches."""
    import importlib.util
    import math
    import tempfile

    import numpy as np
    import torch
    from pednstream_tpu_torch.env import PedNetParallelEnv
    from pednstream_tpu_torch.io import OutputHandler
    from pednstream_tpu_torch.ops import fused_history_reads
    from pednstream_tpu_torch.rl import evaluate
    from pednstream_tpu_torch.rl.metrics import evaluate_run
    from pednstream_tpu_torch.rl.train import build_agents
    from pednstream_tpu_torch.utils import load_engine_state, save_engine_state
    from pednstream_tpu_torch.viz import NetworkVisualizer, export_interactive_html

    cfg = EVALUATE
    gap = cfg["action_gap"]
    save_seconds = [0.0]
    save = OutputHandler.save_scenario_state

    def timed_save(self, *args, **kw):
        t0 = time.perf_counter()
        save(self, *args, **kw)
        save_seconds[0] += time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as tmp:
        OutputHandler.save_scenario_state = timed_save
        reset_counts()
        t0 = time.perf_counter()
        try:
            results = evaluate.evaluate_agents(
                cfg["dataset"], cfg["algos"], num_runs=cfg["num_runs"], output_dir=tmp,
                obs_mode=cfg["obs_mode"], action_gap=gap,
                checkpoint_dirs={"ppo": str(ROOT / cfg["checkpoint"])}, device="cuda")
        finally:
            OutputHandler.save_scenario_state = save
        seconds = time.perf_counter() - t0
        T = ENV["steps"]
        runs = len(cfg["algos"]) * cfg["num_runs"]
        engine_steps = runs * -(-T // gap) * gap
        check_launches("float32", engine_steps, "evaluate")
        launches = engine_steps
        rewards = {}
        for algo in cfg["algos"]:
            rows = results[algo]
            if [r["run"] for r in rows] != list(range(cfg["num_runs"])):
                raise AssertionError(f"{algo}: runs {rows}")
            rewards[algo] = [r["total_reward"] for r in rows]
            for r in rows:
                data = OutputHandler.load_simulation(r["save_dir"])
                if set(data) != {"link_data", "node_data", "network_params"}:
                    raise AssertionError(f"{r['save_dir']} holds {sorted(data)}")
                if data["network_params"]["simulation_steps"] != T:
                    raise AssertionError("the saved horizon changed")
                for link, entry in data["link_data"].items():
                    n_in, n_out, n = (np.asarray(entry[k]) for k in (
                        "cumulative_inflow", "cumulative_outflow", "num_pedestrians"))
                    if not n_in.shape == n_out.shape == n.shape == (T + 1,):
                        raise AssertionError(f"{link}: {n_in.shape} columns, expected {T + 1}")
                    # float32 counts: the main path's bound on the link's peak
                    tol = T * 1.5 * 2.0 ** -23 * max(n_in.max(), 1.0)
                    if np.abs(n_in - n_out - n).max() > tol:
                        raise AssertionError(f"{link}: mass not conserved in the saved run")
                numbers = [v for k, v in r.items() if "." in k] + [r["total_reward"]]
                if len(numbers) < 6 or not all(math.isfinite(v) for v in numbers):
                    raise AssertionError(f"non-finite metrics {r}")
        emit("evaluate", dataset=cfg["dataset"], algos=cfg["algos"], runs=runs,
             action_gap=gap, engine_steps=engine_steps, seconds=seconds,
             env_steps_per_s=engine_steps / seconds, save_seconds=save_seconds[0],
             kernel_launches=launches, total_reward=rewards,
             table=evaluate.summarize(results).splitlines(), card=card)

        # one more run, its recorded history kept, read back from the disk
        env = PedNetParallelEnv(cfg["dataset"], obs_mode=cfg["obs_mode"], action_gap=gap,
                                seed=SEED, record_history=True, device="cuda")
        reset_counts()
        evaluate.rollout_and_save(env, build_agents(env, algo="no_control"),
                                  str(Path(tmp) / "kept"))
        launches += fused_history_reads.launches["float32"]
        check_launches("float32", -(-T // gap) * gap, "the kept run")
        check_on_card("history", env._history)
        recorded = {k: torch.cat([getattr(h, k) for h in env._history])[:T, 0].cpu().numpy()
                    for k in ("density", "cum_in", "num_peds", "speed")}
        run_dir = str(Path(tmp) / "kept")
        data = OutputHandler.load_simulation(run_dir)
        viz = NetworkVisualizer(simulation_dir=run_dir)
        names = {"density": "density", "cum_in": "cumulative_inflow",
                 "num_peds": "num_pedestrians", "speed": "speed"}
        for e, (u, v) in enumerate(env.scn.topo.link_nodes):
            link = f"{int(u)}-{int(v)}"
            for field, saved in names.items():
                want = recorded[field][:, e].astype(np.float64)
                for got in (np.asarray(data["link_data"][link][saved]), viz._series(link, saved)):
                    if got.shape != (T + 1,) or not np.array_equal(got[1:], want):
                        raise AssertionError(f"{link} {saved}: read back != recorded")
        metrics = evaluate_run(run_dir)
        html = export_interactive_html(simulation_dir=run_dir,
                                       out_path=str(Path(tmp) / "map.html"))
        html_bytes = Path(html).stat().st_size
        if html_bytes < 10_000:
            raise AssertionError(f"the HTML map holds {html_bytes} bytes")
        snapshot = "matplotlib not installed: no snapshot drawn"
        if importlib.util.find_spec("matplotlib") is not None:
            import matplotlib

            matplotlib.use("Agg")
            png = Path(tmp) / "snapshot.png"
            viz.visualize_network_state(T // 2, save_path=str(png))
            snapshot = f"matplotlib snapshot of {png.stat().st_size} bytes"

        # engine-state checkpoint: every leaf back bit for bit on the card
        state = env._state
        path = str(Path(tmp) / "state.npz")
        save_engine_state(state, path)
        back = load_engine_state(path, env.scn.init_state(1))
        check_on_card("restored", back)
        if back.t != state.t or largest_difference(state, back):
            raise AssertionError("the restored engine state differs")
        emit("evaluate_readback", links=env.scn.n_links, columns=T + 1,
             fields=sorted(names.values()), metrics=sorted(metrics), html_bytes=html_bytes,
             snapshot=snapshot, checkpoint_bitwise=True, card=card)

        # the MPC baseline: host search per action, state read from the card
        reset_counts()
        t0 = time.perf_counter()
        mpc = evaluate.evaluate_agents(
            cfg["mpc_dataset"], ["optimization"], num_runs=1, output_dir=tmp,
            obs_mode=cfg["obs_mode"], action_gap=cfg["mpc_action_gap"], device="cuda")
        mpc_seconds = time.perf_counter() - t0
        (row,) = mpc["optimization"]
        mpc_launches = fused_history_reads.launches["float32"]
        check_launches("float32", mpc_launches, "mpc")
        actions = mpc_launches // cfg["mpc_action_gap"]
        if not actions or not math.isfinite(row["total_reward"]):
            raise AssertionError(f"mpc: {row}")
        launches += mpc_launches
        emit("evaluate_mpc", dataset=cfg["mpc_dataset"], action_gap=cfg["mpc_action_gap"],
             actions=actions, seconds=mpc_seconds, seconds_per_action=mpc_seconds / actions,
             total_reward=row["total_reward"], throughput=row["throughput.throughput"],
             card=card)
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

    scn = main_scenario()
    from pednstream_tpu_torch.ops import PER_REPLICA_T

    record = phase_kernel(card, scn)
    # each path's launches of each form of the kernel, counted from 0
    t_main = time.perf_counter()
    launches = {"float32": {"main": phase_main(card, scn),
                            "gpu_vs_cpu": phase_gpu_vs_cpu(card)},
                "float64": {"golden": phase_golden(card)}}
    launches["float32"]["env"] = phase_env(card)
    env = train_env()
    launches["float32"]["ppo_train"] = phase_ppo_train(card, env)
    launches["float32"]["sac_train"] = phase_sac_train(card, env)
    phase_zoo(card)
    del env
    seconds = {"earlier_paths": time.perf_counter() - t_main}
    t0 = time.perf_counter()
    for key, n in phase_hetero(card).items():
        launches[key] = {"hetero": n}
    seconds["hetero"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    launches["float32"]["evaluate"] = phase_evaluate(card)
    seconds["evaluate"] = time.perf_counter() - t0
    emit("seconds_per_path", **seconds, card=card)

    print(json.dumps({"kernels": [{
        "name": "fused_history_reads", "route": "cuda", "dtype": key.removesuffix(PER_REPLICA_T),
        "t": "per replica" if key.endswith(PER_REPLICA_T) else "shared",
        "source": "pednstream_tpu_torch/csrc/ncurve.cu",
        "replaces": "pednstream_tpu/ops/ncurve.py:180",
        "launches": sum(launches[key].values()), "launches_per_path": launches[key],
        **record[key],
    } for key in launches]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
