#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

(``python3 chip_smoke.py kernel``, ``hot``, ``parallel``, ``zoo_cli``,
``examples``, ``sweeps``, ``window`` or ``scripts`` runs phase 3, 3b, 14,
15, 16, 17, 18 or 19 alone and prints no result line.)

Phases, each printing one JSON line (a failing phase raises, and the script
exits non-zero):

1. device: a CUDA card must be present; prints its name and power limit.
2. build: compiles the kernels from ``pednstream_tpu_torch/csrc``, one
   ``nvcc`` per source, all at once, linked into one library (or loads the
   library built for the same sources).
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
3b. hot ops: the hand kernels of the step's three eager hot spots against
   their plain versions on the same CUDA operands, bitwise: the fast
   binomial (``ops.binom_fast``, ``csrc/binom.cu``) at the main path's three
   call sites (real operands: release, activity, reverse occupancy) and at
   random operands at the other fast-sampling paths' shapes; the routed
   turning fractions (``ops.turning_fractions``, ``csrc/routing.cu``) at the
   main path's and the env episode's real operands and at random operands
   on every other table form (the env's with a shared od flow and at the
   benchmark's batch with the env's strided od column, the served
   melbourne, the trainers' env, butterfly_scC, delft, grid_50x50, float64
   exact parity: the het batch and a routed golden scenario).  Each case
   prints device µs (a CUDA graph of launches), wrapper host µs, the plain
   version's time and the bound (bytes this data needs over the memory
   rate against float operations over the float32 or float64 rate); where
   the batch takes the routing kernel's streamed design, its walk is held
   and timed on the same operands too.  The node solve (``ops.node_solve``,
   ``csrc/node_solve.cu``) at the main path's and the env episode's real
   operands, and random operands at every other form the paths give it:
   delft at B=1024, the served melbourne at B=1, grid_50x50 at the sweeps'
   B=512 and the window's B=1, the 108,240-link grid of link_sharded_scale,
   float64 flows, and exact parity's dense phi (golden grid10 and the het
   batch in float64, butterfly_scC in float32); each output bit for bit,
   the same times against its bound.  Then
   100 stochastic main-path steps and 50 env RL steps, each with the kernels
   and with the plain versions from one seed: every state leaf (and the
   env's observations and rewards) bit for bit.
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
   action_gap 15), with the rule-based and no-control policies, one run
   each on the nominal network (phase 15 runs a randomized one); every run
   directory is checked
   (files, T + 1 columns, finite metrics, mass conservation); one more run
   is read back (``load_simulation``, ``NetworkVisualizer``) against the
   history the env recorded, exported to HTML and, where matplotlib is
   installed, drawn; an engine-state checkpoint round-trips bit for bit on
   the card; the MPC baseline runs one butterfly_scC episode.
13. mcp: the service layer (``pednstream_tpu_torch.mcp``).  The tool server
   creates melbourne on the card as the dataset ships it (938 links, 341
   nodes, the 500-step horizon, float32, stochastic, exact binomial,
   full-horizon rings, one replica) and serves it in chunks (``steps=`` 1,
   10 and 100, then ``until=`` 250, then to the end) to ``COMPLETED``: one
   float32 kernel launch per served step, state and history on the card,
   finite, non-negative, mass conserved, arrivals; ``save_outputs`` (four
   files, T + 1 columns), the four resources read back, the interactive map
   and, where matplotlib is installed, a snapshot.  Then the stdlib HTTP
   transport on 127.0.0.1: the tool list, create -> run -> status -> save
   -> resource for butterfly_scC, the 404s, and two simulations stepped at
   once by two requests, a third request to one of them getting the busy
   reply; each ends bitwise equal to the same simulation stepped alone
   (in a thread where a host sync is an error).  Then the scripted
   workflow (``run_workflow``) on the card.  Prints served steps per
   second, wall ms per reply by chunk size and the seconds of saving and
   of the map export (host-bound numbers).

14. parallel: the multi-device layer (``pednstream_tpu_torch.parallel``), as
   groups of ranks spawned over ``torch.distributed`` that share this card
   (``gloo``, which moves the exchanged CUDA tensors through host memory
   itself; ``nccl`` where there is a card per rank), each rank launching the kernel on its own
   block.  Link-sharded: melbourne, 1024 replicas, H = 16, the fast
   sampler, 50 stochastic steps over 2 link ranks with no host sync
   allowed outside the exchange, every state field BITWISE equal to the
   unsharded run in this process from the same state and seed, one float32
   launch per step per rank at (1024, 16, 469), the collectives per step
   and their largest size against a ring's, and the bytes a rank holds
   beside the unsharded run's.  Hybrid: the same on a 2 x 2 (env x link)
   mesh, 25 steps, (512, 16, 469) per rank.  Data-parallel trainer: phase
   8's trainer (env with the fast sampler) over 2 ranks, one iteration from
   the same seed as an unsharded one here: env state bitwise, metrics and
   parameters within rtol 1e-4 (atol 1e-6 and 1e-5), 240 launches per rank
   at (128, 64, 168).  Then ``dryrun_multichip_torch.py``'s five stages at
   4 ranks.  A rank that fails fails the phase.
15. zoo_cli: the zoo pipeline (``pednstream_tpu_torch.scripts.train_zoo``)
   on butterfly_scC at the shipped trainer's configuration (256 replicas,
   16 RL steps, H = 64, attention, action_gap 15) into a temporary
   ``--out``: ``train_ppo`` for 2 iterations over 2 seeds (snapshot,
   selection, export, then the no-regress gate against the shipped
   policy), ``train_ppo`` again for 1 iteration into the same ``--out``
   (the gate: it replaces the checkpoint or leaves a ``.candidate``, and
   says which), ``train_sac_batched`` for 1 iteration, validated, and
   ``evaluate_zoo`` with 2 runs of every policy, MPC included.  Checks the
   exported files against the shipped checkpoint's, the export acting on
   the card as on the CPU (rtol 1e-5), ``results.json``'s policies and row
   keys against ``artifacts/eval/butterfly_scC``, one float32 launch per
   engine step, and that no file under ``artifacts/`` changed (sizes and
   mtimes).  Prints wall ms per PPO iteration, validation and evaluation
   seconds.
16. examples: each ``pednstream_tpu_torch.examples`` module's run at its
   shipped network and horizon on the card (melbourne, long_corridor,
   six_node, spike, forky_queues, nine_node, delft_exp, big_network,
   grid_scale at 16 replicas x 100 steps, metered_corridor's four
   policies), then link_sharded_scale's 165 x 165 grid (108,240 links, 4
   replicas, H = 16, 200 steps) over 2 ranks sharing the card.  For each:
   env-steps per second, one float32 launch per engine step (per rank),
   mass conserved, state finite and non-negative, arrivals (departures on
   the grids, whose origins lie farther from a destination than the
   horizon walks).
17. sweeps: ``pednstream_tpu_torch.scripts.sweep_melbourne`` and
   ``sweep_grid`` at every shipped row (melbourne H = 32 x B = 896, 1024,
   1280 and H = 16 x B = 1024, 1280, 1536; grid_50x50's 9,800 links at H =
   64 and 32 x B = 128, 256, 512), each row one warm and one timed run of
   50 stochastic steps (the scripts' 500 and best of 3 cut for time): no
   ``FAILED`` row, one float32 launch per engine step, every run's final
   state finite, non-negative and mass-conserving; prints the rows.
18. window: ``quantify_window`` at full horizon (melbourne and grid_50x50,
   nominal and 8x demand, the full ring against H = 64, 32 and 16): its
   table, one float32 launch per engine step, every final state checked as
   the main path's, and whether melbourne stays identical to the exact
   ring.
19. scripts: ``reset_determinism_report``'s report on butterfly_scC
   (``deterministic: true``), ``retrain_r3 --phase eval`` on long_corridor
   at one run, ``ablate_global_reward`` on metered_corridor at one
   iteration with coefs 0.0 and 0.1 and one run, the dashboard's ``--html``
   on a run the examples phase saved, and ``entry()``'s step: one float32
   launch per engine step, the last state of each checked as the main
   path's, no ``FAILED`` line, ``artifacts/`` unchanged.

Phase 3 also holds the kernel at phases 17 and 18's new shapes: (1536, 16,
938), (1280, 32, 938), (512, 64, 9800), (512, 32, 9800) and (1, 501, 9800).
Every path also holds the hot-op kernels' launches to what its engine steps
expect (``HotSteps``, counted from the steps' scenarios): one routing launch
per step of a routed scenario, three binomial launches per stochastic
fast-binomial step (two where the activity stay is decided zero); the
parallel phase's ranks report theirs.
It then prints the kernels' record (the fused read per form, the routing
kernel per flow dtype, the binomial kernel, each with its launches per
path: those of the path's checked runs, each counted from 0 set just
before it, warm-ups and comparisons left out), the card's ``nvidia-smi`` line and, as the last line, ``{"ok":
true, "device": {...}}``.
"""

import contextlib
import json
import subprocess
import sys
import tempfile
import threading
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
            "algos": ["ppo", "rule_based", "no_control"], "num_runs": 1,
            "checkpoint": "artifacts/zoo/ppo_agents_45_intersections",
            "mpc_dataset": "butterfly_scC", "mpc_action_gap": 60}
# the served simulation: melbourne as the dataset ships it, one replica
MCP = {"dataset": "melbourne", "links": 938, "nodes": 341, "steps": 500,
       "chunks": (1, 10, 100), "until": 250,
       "socket": {"butterfly_scC": 300, "nine_intersections": 300}, "socket_steps": 40,
       "demand_seed": 3, "workflow_steps": 40}
# its read: one replica, full-horizon rings (H = steps + 1, checked in phase_mcp)
MCP_SHAPE = (1, MCP["steps"] + 1, MCP["links"])
# the sharded runs: melbourne's 938 links over 2 link ranks, whole batch and
# (on the 2 x 2 mesh) half; the zoo trainer's 256 replicas over 2 ranks
PARALLEL = {"link_ranks": 2, "steps": 50, "hybrid": (2, 2), "hybrid_steps": 25,
            "trainer_ranks": 2, "dryrun_ranks": 4, "rtol": 1e-4, "metric_atol": 1e-6,
            "param_atol": 1e-5}
LINK_BLOCK = (MAIN["batch"], MAIN["history_window"], 938 // 2)
HYBRID_BLOCK = (MAIN["batch"] // 2, MAIN["history_window"], 938 // 2)
# the zoo pipeline (pednstream_tpu_torch.scripts.train_zoo) on butterfly_scC
# at the shipped trainer's configuration: 20 links, H = 64, 600 steps
ZOO_CLI = {"dataset": "butterfly_scC", "action_gap": 15, "links": 20, "iterations": 2,
           "seeds": 2, "regate_iterations": 1, "sac_iterations": 1, "eval_runs": 2,
           "with_mpc": True, "shipped": "artifacts/zoo/ppo_agents_butterfly_scC",
           "results": "artifacts/eval/butterfly_scC/results.json"}
ZOO_TRAIN_SHAPE = (256, 64, ZOO_CLI["links"])  # its trainer's read
ZOO_VALIDATE_SHAPE = (1, 64, ZOO_CLI["links"])  # its validation and evaluation episodes
# the examples (pednstream_tpu_torch.examples) at their shipped networks and
# horizons; grid_50x50's batch and the link-sharded grid over 2 ranks
EXAMPLES = {"grid_batch": 16, "grid_steps": 100, "grid_links": 9800,
            "sharded_n": 165, "sharded_ranks": 2, "sharded_batch": 4, "sharded_window": 16,
            "sharded_steps": 200}
GRID_SHAPE = (EXAMPLES["grid_batch"], 64, EXAMPLES["grid_links"])
SHARDED_BLOCK = (EXAMPLES["sharded_batch"], EXAMPLES["sharded_window"],
                 4 * EXAMPLES["sharded_n"] * (EXAMPLES["sharded_n"] - 1)
                 // EXAMPLES["sharded_ranks"])
DELFT_SHAPE = (1, 501, 818)  # delft_exp: full-horizon rings
# the throughput sweeps (pednstream_tpu_torch.scripts.sweep_melbourne and
# sweep_grid) at every shipped (H, B) row, the depth cut to 50 steps and one
# timed run after the warm one (the scripts run 500 steps, best of 3)
SWEEPS = {"steps": 50, "reps": 1}
SWEEP_SHAPES = [(1536, 16, 938), (1280, 32, 938), (512, 64, 9800), (512, 32, 9800)]
# quantify_window's full-horizon ring on grid_50x50 (H = T + 1)
WINDOW_SHAPE = (1, 501, 9800)
# the other drivers: the reset-determinism report, retrain_r3's eval phase
# (long_corridor: separator-only, so evaluate_zoo runs no MPC there), the
# ablation at one iteration, the dashboard's HTML export, entry()
SCRIPTS = {"reset_dataset": "butterfly_scC", "eval_dataset": "long_corridor", "eval_runs": 1,
           "ablate_dataset": "metered_corridor", "ablate_coefs": ("0.0", "0.1"),
           "ablate_iters": 1, "ablate_runs": 1}


# phase 3b (hot ops): the bitwise rollouts' depth, and the fast binomial's
# shapes on the other paths that sample with it (random operands): the
# sweeps' largest rows, the link-sharded, hybrid and trainer blocks, the
# grid example's batch and the sharded grid's block
HOT_OPS = {"main_steps": 100, "env_rl_steps": 50, "env_bench_batch": 8192}
BINOM_SHAPES = [(1536, 938), (512, 9800), LINK_BLOCK[::2], HYBRID_BLOCK[::2], (256, 168),
                (128, 168), (16, 9800), (4, 54120)]

def dryrun_blocks() -> dict:
    """The ring blocks of the dry run's stages at ``PARALLEL["dryrun_ranks"]``
    ranks, from its own scenario: two replicas a rank in the three trainer
    stages, one replica over the link axis, the 2 x n/2 hybrid."""
    import dryrun_multichip_torch
    from pednstream_tpu_torch import build_scenario

    cfg = dryrun_multichip_torch.load_config_for_dryrun()
    scn = build_scenario(cfg["adjacency_matrix"], cfg["params"], cfg["origin_nodes"],
                         cfg["destination_nodes"], od_candidates=([4], [1]), device="cuda")
    world = PARALLEL["dryrun_ranks"]
    link_n = max(d for d in range(1, world + 1) if scn.n_links % d == 0)
    return {"replicas": (2, scn.H, scn.n_links), "link": (1, scn.H, scn.n_links // link_n),
            "hybrid": (2, scn.H, scn.n_links // (world // 2))}


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
    dry = dryrun_blocks()
    M = (MAIN["batch"], MAIN["history_window"], 938)
    cases = [("real", "float32", M, False),  # the kernels line's float32 entry
             ("random", "float32", M, False),
             ("random", "float32", ENV_SHAPE, True),
             ("random", "float32", (ZOO_PPO["num_envs"], H_train, ENV["links"]), True),
             ("random", "float32", (SAC_TRAIN["num_envs"], H_train, ENV["links"]), True),
             ("random", "float32", (1, 16, 1), False),
             ("random", "float32", (5, 17, 1000), False),
             ("random", "float32", MCP_SHAPE, False),  # the served simulation's
             # the sharded runs' blocks: link-sharded, hybrid, the trainer's half
             ("random", "float32", LINK_BLOCK, False),
             ("random", "float32", HYBRID_BLOCK, False),
             ("random", "float32", (ZOO_PPO["num_envs"] // 2, H_train, ENV["links"]), True),
             # the dry run's: the plain and the randomized trainers' replicas,
             # the link block, the hybrid block
             ("random", "float32", dry["replicas"], False),
             ("random", "float32", dry["replicas"], True),
             ("random", "float32", dry["link"], False),
             ("random", "float32", dry["hybrid"], False),
             # the zoo pipeline's trainer and B=1 episodes; the examples'
             # grid_50x50 batch, link-sharded grid block and delft
             ("random", "float32", ZOO_TRAIN_SHAPE, True),
             ("random", "float32", ZOO_VALIDATE_SHAPE, False),
             ("random", "float32", GRID_SHAPE, False),
             ("random", "float32", SHARDED_BLOCK, False),
             ("random", "float32", DELFT_SHAPE, False),
             # the sweeps' largest rows and quantify_window's full ring
             *[("random", "float32", shape, False) for shape in SWEEP_SHAPES],
             ("random", "float32", WINDOW_SHAPE, False),
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


FP64_OPS_PER_S = 34e12  # H100 SXM float64 outside the tensor cores (NVIDIA's data sheet)
# the hot-op kernels' sources and the XLA-fused JAX functions they replace
# (not Pallas kernels)
HOT_KERNELS = {
    "turning_fractions": {"source": "pednstream_tpu_torch/csrc/routing.cu",
                          "replaces": "pednstream_tpu/routing.py:405"},
    "binom_fast": {"source": "pednstream_tpu_torch/csrc/binom.cu",
                   "replaces": "pednstream_tpu/engine.py:109"},
    "node_solve": {"source": "pednstream_tpu_torch/csrc/node_solve.cu",
                   "replaces": "pednstream_tpu/engine.py:446,458"}}


@contextlib.contextmanager
def captured(name: str, calls: list):
    """Appends the arguments of every call of ``engine.<name>`` to ``calls``."""
    import pednstream_tpu_torch.engine as engine

    inner = getattr(engine, name)

    def record(*args):
        calls.append(args)
        return inner(*args)

    setattr(engine, name, record)
    try:
        yield
    finally:
        setattr(engine, name, inner)


def bits_equal(a, b) -> bool:
    """Equal bit for bit (``torch.equal`` takes -0.0 for +0.0)."""
    import torch

    view = {torch.float32: torch.int32, torch.float64: torch.int64}[a.dtype]
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.contiguous().view(view), b.contiguous().view(view)))


def hold_hot_kernel(card, kernel, key, label, fn, plain, ops, bound_s, plain_iters) -> dict:
    """One launch of ``fn`` against ``plain`` on the same CUDA operands,
    bitwise, then the kernel's device and host time and the plain
    version's beside ``bound_s``, the least seconds of the call
    (``portbench/bounds/``); prints and returns the case."""
    import torch

    counts = kernel_counts()[kernel]
    before = dict(counts)
    got = fn(*ops)
    want = plain(*ops)
    torch.cuda.synchronize()
    if counts != {**before, key: before[key] + 1}:
        raise AssertionError(f"{kernel} ({label}) did not launch its {key} kernel once")
    err = (got.double() - want.double()).abs().max().item() if got.numel() else 0.0
    if not bits_equal(got, want):
        raise AssertionError(f"{kernel} kernel != plain ({label}): max abs err {err}")
    case = {"device_ms": device_ms(lambda: fn(*ops)), "host_ms": host_us(lambda: fn(*ops)) / 1e3,
            "plain_ms": cuda_ms(lambda: plain(*ops), iters=plain_iters, warmup=1),
            "bound_ms": 1e3 * bound_s}
    emit("hot_kernel_vs_plain", kernel=kernel, dtype=key, operands=label, bitwise_equal=True,
         max_abs_err=err, **case, share_of_bound=case["bound_ms"] / case["device_ms"],
         card=card)
    return {"max_abs_err": err, "ms": case["device_ms"], **case, "library_ms": None,
            "operands": label}


def hold_node_solve(card, label, scn, ops, per_replica, plain_iters) -> dict:
    """``hold_hot_kernel`` for the node solve on ``scn`` and ``ops`` (the
    wrapper's arguments after the scenario): one launch under the flows'
    dtype, its four outputs bitwise to the plain version's, then the times
    beside the bound (``portbench/bounds/node_solve.py``: the rows and
    virtual vectors moved once, ``phi_base`` once, the live compact rows
    per replica, or a dense phi's valid pairs per replica; the demand and
    virtual receiving of the virtual nodes per replica where
    ``per_replica``).  Prints and returns the case."""
    import torch
    from pednstream_tpu_torch.ops import node_solve, node_solve_plain
    from portbench.bounds.node_solve import bytes_and_ops

    S, phi = ops[2], ops[5]
    key = str(S.dtype).removeprefix("torch.")
    before = dict(node_solve.launches)
    got = node_solve(scn, *ops)
    want = node_solve_plain(scn, *ops)
    torch.cuda.synchronize()
    if node_solve.launches != {**before, key: before[key] + 1}:
        raise AssertionError(f"node_solve ({label}) did not launch its {key} kernel once")
    err = max((a.double() - b.double()).abs().max().item() for a, b in zip(got, want))
    if not all(bits_equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"node_solve kernel != plain ({label}): max abs err {err}")
    moved, n_ops = bytes_and_ops(scn, S.shape[0], per_replica, S.element_size(),
                                 phi is not None)
    rate = FP32_OPS_PER_S if S.element_size() == 4 else FP64_OPS_PER_S
    bytes_ms, ops_ms = moved / HBM_BYTES_PER_S * 1e3, n_ops / rate * 1e3
    bound = {"bound_bytes": moved, "bound_ops": n_ops, "bound_ms": max(bytes_ms, ops_ms),
             "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
    case = {"device_ms": device_ms(lambda: node_solve(scn, *ops)),
            "host_ms": host_us(lambda: node_solve(scn, *ops)) / 1e3,
            "plain_ms": cuda_ms(lambda: node_solve_plain(scn, *ops), iters=plain_iters,
                                warmup=1), **bound}
    emit("hot_kernel_vs_plain", kernel="node_solve", dtype=key, operands=label,
         bitwise_equal=True, max_abs_err=err, **case,
         share_of_bound=bound["bound_ms"] / case["device_ms"], card=card)
    return {"max_abs_err": err, "ms": case["device_ms"], **case, "library_ms": None,
            "operands": label}


def node_solve_operands(scn, B, rng, dense=False):
    """Random operands of the node solve on ``scn`` at ``B`` replicas, in
    its flow dtype: whole sending and receiving flows with zeros and ties,
    random compact turning fractions where routed (or, where ``dense``, the
    exact path's dense phi: ``phi_base`` with random rows at the routed
    nodes' valid slots), the scenario's parameters, a mid-run step."""
    import numpy as np
    import torch

    E, f = scn.n_links, scn.ftype
    S = np.floor(rng.uniform(0, 30, (B, E)))
    S[rng.uniform(size=S.shape) < 0.3] = 0.0
    R = np.floor(rng.uniform(0, 40, (B, E)))
    R[rng.uniform(size=R.shape) < 0.2] = 0.0
    phi_c = phi = None
    if scn.routing is not None:
        NR, M = scn.routing.num_routed, scn.max_deg
        phi_c = torch.from_numpy(rng.uniform(0, 1, (B, NR, M, M))).to("cuda", f)
    if dense:
        ep = scn.engine_params
        phi = ep.phi_base.expand(B, *ep.phi_base.shape[-3:]).clone()
        if phi_c is not None:
            ids = scn.routing.routed_ids
            valid = scn.slot_valid[ids]
            phi[:, ids] = phi_c * (valid[:, :, None] & valid[:, None, :])
        phi_c = None
    S, R = (torch.from_numpy(x).to("cuda", f) for x in (S, R))
    return [scn.engine_params, scn.simulation_steps // 3, S, R, phi_c, phi]


@contextlib.contextmanager
def routing_walk():
    """The routing kernel's walk at any batch while entered: the streamed
    design given no warps, so that both designs run on the same operands.
    It swaps a module attribute, so no other thread may route meanwhile."""
    import pednstream_tpu_torch.ops.routing as kernel

    saved = kernel.lane_warps
    kernel.lane_warps = lambda *args: 0
    try:
        yield
    finally:
        kernel.lane_warps = saved


def hold_routing(card, key, label, scn, ops, plain_iters) -> dict:
    """``hold_hot_kernel`` for the routing kernel on ``scn``'s tables and
    ``ops``, under the design the batch takes, beside the bound of
    ``portbench/bounds/turning_fractions.py`` (which counts the kernel's
    node offsets with the routing tables); where that is the streamed
    design, the walk is held bitwise on the same operands too, and its
    device time kept beside (``walk_ms``).  Prints the case, and returns it
    with its design."""
    from types import SimpleNamespace

    import torch
    from pednstream_tpu_torch.ops import turning_fractions, turning_fractions_step_plain
    from portbench.bounds.turning_fractions import least_seconds_call

    def fn(*o):
        return turning_fractions(scn, *o)

    def plain(*o):
        return turning_fractions_step_plain(scn, *o)

    rt, (dens, recv, _, od) = scn.routing, ops
    links = torch.unique(rt.te_down_link[rt.te_down_link >= 0])
    tables = SimpleNamespace(**vars(rt), node_offsets=scn.routing_kernel_tables.node_offsets)
    bound_s = least_seconds_call(tables, scn.max_deg, dens.shape[0],
                                 int((recv[:, links] < 0).sum()), od.dim() == 2)
    before = dict(turning_fractions.launches_by_design)
    case = hold_hot_kernel(card, "turning_fractions", key, label, fn, plain, ops, bound_s,
                           plain_iters)
    design, = (d for d, n in turning_fractions.launches_by_design.items() if n != before[d])
    case["design"] = design
    if design == "lanes":
        with routing_walk():
            got, want = fn(*ops), plain(*ops)
            torch.cuda.synchronize()
            if not bits_equal(got, want):
                raise AssertionError(f"turning_fractions walk != plain ({label})")
            case["walk_ms"] = device_ms(lambda: fn(*ops))
        emit("hot_kernel_walk", kernel="turning_fractions", dtype=key, operands=label,
             bitwise_equal=True, device_ms=case["walk_ms"], streamed_ms=case["device_ms"],
             share_of_bound=case["bound_ms"] / case["walk_ms"], card=card)
    return case


def phase_hot_ops(card: str, scn) -> dict:
    """Phase 3b: the hand kernels of the step's hot ops against their plain
    versions, bitwise, at every path's shape and table form, with device
    time against the bound; then the main path's stochastic rollout and the
    env episode with the kernels and with the plain versions from one seed,
    bitwise.  Returns the kernels line's record per (kernel, dtype)."""
    import numpy as np
    import torch
    from pednstream_tpu_torch import (NetworkEnvGenerator, build_scenario, simulate_batched)
    from pednstream_tpu_torch.env import PedNetParallelEnv
    from pednstream_tpu_torch.examples import link_sharded_scale
    from pednstream_tpu_torch.golden import fixture_args
    from pednstream_tpu_torch.ops import binom_fast, binom_fast_plain
    from pednstream_tpu_torch.profiling import ZOO_PPO, plain_hot_ops
    from pednstream_tpu_torch.randomize import randomize_engine_params_batched
    from portbench.bounds.binom_fast import SMALL_N
    from portbench.bounds.binom_fast import least_seconds_call as binom_seconds

    record = {}
    rng = np.random.default_rng(SEED)

    # the main path, kernels then plain versions from one seed; its last
    # step's binomial and routing operands kept
    finals, binom_calls, routing_calls, node_calls = [], [], [], []
    for plain in (False, True):
        g = torch.Generator(device="cuda").manual_seed(SEED + 2)
        st = scn.init_state(MAIN["batch"])
        reset_counts()
        with plain_hot_ops() if plain else contextlib.nullcontext():
            st = simulate_batched(scn, scn.engine_params, st, HOT_OPS["main_steps"] - 1, gen=g,
                                  stochastic=True)
            with captured("binom_fast", binom_calls), \
                    captured("turning_fractions_step", routing_calls), \
                    captured("_node_solve", node_calls):
                st = simulate_batched(scn, scn.engine_params, st, 1, gen=g, stochastic=True)
        torch.cuda.synchronize()
        hot = {n: dict(kernel_counts()[n]) for n in HotSteps.want}
        if plain:
            if any(v for counts in hot.values() for v in counts.values()):
                raise AssertionError(f"the plain main path launched {hot}")
        else:
            check_hot("the main path with kernels")
        finals.append(st)
    bad = [n for n, x in vars(finals[0]).items()
           if isinstance(x, torch.Tensor) and not bits_equal(x, getattr(finals[1], n))]
    if bad or finals[0].t != finals[1].t:
        raise AssertionError(f"main path with kernels != plain versions: {bad}")
    emit("hot_main_path_bitwise", steps=HOT_OPS["main_steps"], batch=MAIN["batch"],
         binomial_launches=3 * HOT_OPS["main_steps"], routing_launches=HOT_OPS["main_steps"],
         node_solve_launches=HOT_OPS["main_steps"], bitwise_equal=True, card=card)

    # the fast binomial: the main path's three call sites at its real
    # operands, then random operands at the other paths' shapes
    sites = ("release", "activity", "reverse occupancy")
    if len(binom_calls) != 6:
        raise AssertionError(f"{len(binom_calls)} binomial calls in two main-path steps")
    for site, ops in zip(sites, binom_calls[:3]):
        nf, p = ops[:2]
        bound_s = binom_seconds(nf.numel(), p.numel(), int((nf <= SMALL_N).sum()))
        case = hold_hot_kernel(card, "binom_fast", "float32", f"main path {site}, real",
                               binom_fast, binom_fast_plain, ops, bound_s, 20)
        if site == "release":
            record[("binom_fast", "float32")] = case
    for shape in BINOM_SHAPES:
        n = rng.integers(0, 40, shape).astype(np.float32)
        p = rng.uniform(0.5, 0.95, shape).astype(np.float32)
        u = rng.uniform(0, 1, shape).astype(np.float32)
        z = rng.standard_normal(shape).astype(np.float32)
        ops = [torch.from_numpy(x).to("cuda") for x in (n, p, u, z)]
        bound_s = binom_seconds(n.size, p.size, int((n <= SMALL_N).sum()))
        hold_hot_kernel(card, "binom_fast", "float32", f"random {shape}", binom_fast,
                        binom_fast_plain, ops, bound_s, 20)

    # the routing kernel at the main path's real operands
    (_, *ops), = routing_calls[:1]
    hold_routing(card, "float32", "main path, real", scn, ops, 20)

    # the env episode, kernels then plain versions from one seed; its last
    # step's routing operands kept
    env = PedNetParallelEnv(ENV["dataset"], od_randomize=True, device="cuda")
    core, B = env.core, ENV["batch"]
    runs, env_calls, env_node_calls = [], [], []
    for plain in (False, True):
        g = torch.Generator(device="cuda").manual_seed(SEED + 3)
        eps = randomize_engine_params_batched(env.scn, g, B)
        states, _ = core.batch_reset(B)
        bounds = {a: [torch.as_tensor(x, device="cuda") for x in
                      (env.action_space(a).low, env.action_space(a).high)]
                  for a in env.possible_agents}
        reset_counts()
        with plain_hot_ops() if plain else contextlib.nullcontext():
            for i in range(HOT_OPS["env_rl_steps"]):
                acts = {a: lo + (hi - lo) * torch.rand((B,) + lo.shape, generator=g,
                                                      device="cuda")
                        for a, (lo, hi) in bounds.items()}
                keep = i == HOT_OPS["env_rl_steps"] - 1 and not plain
                with (captured("turning_fractions_step", env_calls) if keep
                      else contextlib.nullcontext()), \
                        (captured("_node_solve", env_node_calls) if keep
                         else contextlib.nullcontext()):
                    states, obs, rewards, _ = core.batch_step_randomized(states, acts, eps, g)
        torch.cuda.synchronize()
        if not plain:
            check_hot("the env episode with kernels")
        runs.append((states, obs, rewards))
    (s0, o0, r0), (s1, o1, r1) = runs
    bad = [n for n, x in vars(s0).items()
           if isinstance(x, torch.Tensor) and not bits_equal(x, getattr(s1, n))]
    bad += [f"obs {a}" for a in o0 if not bits_equal(o0[a], o1[a])]
    bad += [f"reward {a}" for a in r0 if not bits_equal(r0[a], r1[a])]
    if bad:
        raise AssertionError(f"env episode with the routing kernel != plain: {bad}")
    emit("hot_env_bitwise", rl_steps=HOT_OPS["env_rl_steps"], batch=B,
         routing_launches=HOT_OPS["env_rl_steps"], bitwise_equal=True, card=card)
    (escn, *ops), = env_calls
    record[("turning_fractions", "float32")] = hold_routing(
        card, "float32", "env, real (RL step 50)", escn, ops, 5)

    # the node solve at the main path's and the env episode's real operands
    # (its worlds drawn per replica), delft at B=1024 and the served
    # melbourne at B=1, random
    gen = NetworkEnvGenerator()
    delft_scn = build_scenario(**gen.scenario_args("delft"), device="cuda")
    (_, *ops), = node_calls[:1]
    record[("node_solve", "float32")] = hold_node_solve(card, "main path, real", scn, ops,
                                                        False, 5)
    (escn, *ops), = env_node_calls
    hold_node_solve(card, "env, real (RL step 50)", escn, ops, True, 5)
    hold_node_solve(card, "delft B=1024, random", delft_scn,
                    node_solve_operands(delft_scn, 1024, rng), False, 5)
    hold_node_solve(card, "served melbourne B=1, random", scn,
                    node_solve_operands(scn, 1, rng), False, 5)
    # every other form the paths give it, random operands: grid_50x50's
    # 9,800 links at the sweeps' B=512 and the window's B=1, the 108,240-link
    # grid of link_sharded_scale (its node solve takes all links) at its
    # batch, float64 flows on the fast path, and the exact path's dense phi
    # with the column sums left to right: golden grid10 and the het
    # butterfly_scC batch in float64, butterfly_scC in float32
    grid = build_scenario(**gen.scenario_args("grid_50x50"), device="cuda")
    for batch in (512, 1):
        hold_node_solve(card, f"grid_50x50 B={batch}, random", grid,
                        node_solve_operands(grid, batch, rng), False, 3)
    big = link_sharded_scale.build(EXAMPLES["sharded_n"], device="cuda")
    hold_node_solve(card, f"{big.n_links:,}-link grid B={EXAMPLES['sharded_batch']}, random",
                    big, node_solve_operands(big, EXAMPLES["sharded_batch"], rng), False, 3)
    del big
    butterfly = gen.scenario_args("butterfly_scC")
    butterfly["params"]["seed"] = GPU_VS_CPU["demand_seed"]
    golden, _, _ = fixture_args(ROOT / "tests" / "golden" / "grid10.npz")
    golden_scn = build_scenario(**golden, ftype=torch.float64, exact_parity=True, device="cuda")
    het_scn = build_scenario(**butterfly, ftype=torch.float64, exact_parity=True, device="cuda")
    record[("node_solve", "float64")] = hold_node_solve(
        card, "golden grid10 float64, dense phi, B=1, random", golden_scn,
        node_solve_operands(golden_scn, 1, rng, dense=True), False, 3)
    hold_node_solve(card, "het butterfly_scC float64, dense phi, B=6, random", het_scn,
                    node_solve_operands(het_scn, 6, rng, dense=True), False, 3)
    for exact in (False, True):
        fscn = build_scenario(**butterfly, ftype=torch.float64 if not exact else torch.float32,
                              exact_parity=exact, device="cuda")
        hold_node_solve(card, f"butterfly_scC {str(fscn.ftype)[6:]}"
                        f"{', dense phi' if exact else ''}, B=256, random", fscn,
                        node_solve_operands(fscn, 256, rng, dense=exact), False, 3)

    # every other table form at its path's batch, random operands: the env's
    # with a shared od flow, the served melbourne, the trainers' env, the
    # zoo pipeline's butterfly_scC, delft (examples), grid_50x50 (sweeps,
    # window), the het float64 batch, a routed golden scenario (float64 one
    # row per segment: the dense path's kernel)
    tables = [("env, shared od", env.scn, B),
              # the benchmark's env batch, od flows a column of a [B, P, T+1]
              # table as the env passes them
              ("env, od column", env.scn, HOT_OPS["env_bench_batch"]),
              ("served melbourne", scn, 1),
              ("trainer env", train_env().scn, ZOO_PPO["num_envs"]),
              ("trainer env", None, SAC_TRAIN["num_envs"]),
              ("butterfly_scC", build_scenario(**butterfly, device="cuda"), ZOO_TRAIN_SHAPE[0]),
              ("butterfly_scC", None, 1),
              ("delft", delft_scn, 1),
              ("grid_50x50", grid, 512),
              ("grid_50x50", None, 1),
              ("het butterfly_scC float64", het_scn, 6),
              ("golden grid10 float64", golden_scn, 1)]
    last = None
    for label, tscn, batch in tables:
        tscn = tscn or last
        last = tscn
        E, f = tscn.n_links, tscn.routing.dist_util.dtype
        key = str(f).removeprefix("torch.")
        dens = torch.from_numpy(rng.uniform(0, 6, (batch, E)).astype(np.float32)).to("cuda")
        recv = torch.from_numpy(np.where(rng.uniform(size=(batch, E)) < 0.3, -1.0,
                                         rng.integers(0, 40, (batch, E)))).to("cuda", f)
        cap = torch.from_numpy(rng.uniform(5, 60, (batch, E))).to("cuda", f)
        table = tscn.engine_params.od_table
        od = table[:, table.shape[1] // 3]
        if "column" in label:
            scale = torch.from_numpy(rng.uniform(0, 2, (batch, 1, 1))).to("cuda", od.dtype)
            od = (table[None] * scale)[:, :, table.shape[1] // 3]
        ops = [dens, recv, cap, od]
        case = hold_routing(card, key, f"{label}, B={batch}, random", tscn, ops, 5)
        if label.startswith("golden"):
            record[("turning_fractions", key)] = case
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
    hot = check_hot("main path")
    if (hot["binom_fast"]["float32"], hot["turning_fractions"]["float32"]) != (
            3 * MAIN["steps"], MAIN["steps"]):
        raise AssertionError(f"main path: hot-op launches {hot}, expected three binomial "
                             f"and one routing launch per step")
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
         kernel_launches=launches, hot_launches=hot, mass_err=mass_err, mass_tol=tol,
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
        check_hot(f"the {device} rollout")
        density[device] = final.density.cpu()
    err = (density["cuda"] - density["cpu"]).abs().max().item()
    if not err <= GPU_VS_CPU["atol"]:
        raise AssertionError(f"cuda vs cpu density differ by {err} > {GPU_VS_CPU['atol']}")
    emit("gpu_vs_cpu", dataset=GPU_VS_CPU["dataset"], steps=GPU_VS_CPU["steps"],
         history_window=GPU_VS_CPU["history_window"], max_abs_density_err=err,
         atol=GPU_VS_CPU["atol"], card=card)
    return GPU_VS_CPU["steps"]


def kernel_counts() -> dict:
    """The launch-count dict of each kernel wrapper, by kernel name."""
    from pednstream_tpu_torch.ops import (binom_fast, fused_history_reads, node_solve,
                                          turning_fractions)

    return {"fused_history_reads": fused_history_reads.launches,
            "turning_fractions": turning_fractions.launches, "binom_fast": binom_fast.launches,
            "node_solve": node_solve.launches}


# the hot-op launches of the path being run: one entry per stretch since a
# reset_counts(), the stretch's last check_hot reading (None before one)
HOT_READINGS = [None]


def reset_counts() -> None:
    """Every kernel's launch counts and the steps' expected hot-op launches
    set to 0; opens a new stretch of ``HOT_READINGS``."""
    for counts in kernel_counts().values():
        for key in counts:
            counts[key] = 0
    HotSteps.reset()
    HOT_READINGS.append(None)


class HotSteps:
    """What the engine steps taken since the last ``reset_counts()`` should
    have launched of the hot-op kernels, counted from the scenarios of the
    steps, not from the kernels: one routing launch per step of a routed
    scenario (under its tables' dtype); per stochastic step with the fast
    sampler, one binomial launch for the release, one for the activity stay
    unless the scenario decided it zero at build time, one for the reverse
    occupancy; one node solve launch per step of every classic solve (the
    fast path and exact parity's dense phi; not the "optimal" solve's host
    LP), under the flow dtype.  ``install()`` wraps ``engine.step_fn`` and the modules that
    import it by name; the steps of spawned ranks count in their own
    process."""

    lock = threading.Lock()
    want = {"turning_fractions": {"float32": 0, "float64": 0}, "binom_fast": {"float32": 0},
            "node_solve": {"float32": 0, "float64": 0}}
    installed = False

    @classmethod
    def reset(cls) -> None:
        with cls.lock:
            for counts in cls.want.values():
                for key in counts:
                    counts[key] = 0

    @classmethod
    def count(cls, scn, st, stochastic: bool) -> None:
        if st.num_peds.device.type != "cuda":
            return  # the wrappers run the plain versions on the CPU
        with cls.lock:
            if scn.routing is not None:
                key = str(scn.routing.dist_util.dtype).removeprefix("torch.")
                cls.want["turning_fractions"][key] += 1
            if stochastic and scn.binomial_mode == "fast":
                cls.want["binom_fast"]["float32"] += 2 if scn.act_statically_zero else 3
            if scn.assign_flows_type != "optimal":
                cls.want["node_solve"][str(scn.ftype).removeprefix("torch.")] += 1

    @classmethod
    def install(cls) -> None:
        if cls.installed:
            return
        import pednstream_tpu_torch
        import pednstream_tpu_torch.engine as engine
        import pednstream_tpu_torch.env.core as core
        import pednstream_tpu_torch.network as network

        inner = engine.step_fn

        def counted(scn, ep, st, gen=None, stochastic=False, *args, **kwargs):
            cls.count(scn, st, stochastic)
            return inner(scn, ep, st, gen, stochastic, *args, **kwargs)

        for module in (engine, core, network, pednstream_tpu_torch):
            module.step_fn = counted
        cls.installed = True


# the hot-op launches of spawned ranks, per path: {path: {kernel: {key: n}}}
RANK_HOT = {}


def sum_hot(counts: list) -> dict:
    """The sum of several ``check_hot`` readings."""
    return {name: {key: sum(c[name][key] for c in counts) for key in keys}
            for name, keys in HotSteps.want.items()}


def check_hot(what: str) -> dict:
    """The hot-op kernels launched as ``HotSteps`` expects since the counts
    were set to 0; returns their launches."""
    got = {name: dict(kernel_counts()[name]) for name in HotSteps.want}
    with HotSteps.lock:
        want = {name: dict(counts) for name, counts in HotSteps.want.items()}
    if got != want:
        raise AssertionError(f"{what}: hot-op launches {got}, the steps expect {want}")
    HOT_READINGS[-1] = got
    return got


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
        hot = check_hot(path.stem)
        worst = max(errors.values())
        emit("golden", fixture=path.stem, links=scn.n_links, steps=T - 1,
             solve=scn.assign_flows_type, max_abs_err=worst, fields=len(errors),
             float64_kernel_launches=launches,
             routing_launches=hot["turning_fractions"]["float64"],
             build_and_run_seconds=seconds, card=card)
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
    hot = check_hot("env")
    if hot["turning_fractions"]["float32"] != steps:
        raise AssertionError(f"env: {hot['turning_fractions']} routing launches in {steps} "
                             f"steps")
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
         hot_launches=hot, max_mass_err=mass_err.max().item(), total_arrivals=arrivals,
         card=card)
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


def train_env(seed=None):
    from pednstream_tpu_torch.env import PedNetParallelEnv
    from pednstream_tpu_torch.profiling import ZOO_PPO_ENV

    env = PedNetParallelEnv(**ZOO_PPO_ENV, seed=seed, device="cuda")
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
    check_hot("ppo_train")
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
    check_hot("sac_train")
    updated = [m for m in metrics if m["buffer_size"] >= tr.warmup]
    if len(updated) < 2:
        raise AssertionError("fewer than two iterations ran updates")
    # before warm-up too: the losses of the unchanged parameters
    for m in metrics:
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
    dirs = sorted(d for d in (ROOT / "artifacts" / "zoo").iterdir() if "_agents_" in d.name)
    if len(dirs) != 19:
        raise AssertionError(f"expected 19 zoo checkpoints, found {len(dirs)}")
    worst = max(checkpoint_card_vs_cpu(d) for d in dirs)
    emit("zoo", checkpoints=len(dirs), rtol=ZOO_RTOL, max_abs_err=worst, card=card)


def checkpoint_card_vs_cpu(d) -> float:
    """Every agent of the checkpoint directory ``d`` loaded on the card and
    on the CPU: the same deterministic actions on seeded observations
    (normalized by its stats where present) within ``ZOO_RTOL``; returns
    the largest difference."""
    import pickle
    from types import SimpleNamespace

    import numpy as np
    from pednstream_tpu_torch.rl import PPOAgent, SACAgent
    from pednstream_tpu_torch.rl.rl_utils import RunningNormalizeWrapper

    d = Path(d)
    worst = 0.0
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
    return worst


def check_launches(key: str, n: int, what: str) -> None:
    """The fused read launched ``n`` times under ``key`` and under no other
    key since the counts were set to 0, and the hot-op kernels as the steps
    taken since then expect (``check_hot``): one routing launch per routed
    step, three binomial launches per fast-binomial step (two where the
    activity stay is decided zero)."""
    from pednstream_tpu_torch.ops import fused_history_reads

    want = {**dict.fromkeys(fused_history_reads.launches, 0), key: n}
    if fused_history_reads.launches != want:
        raise AssertionError(f"{what}: launches {fused_history_reads.launches}, expected {want}")
    check_hot(what)


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


def phase_mcp(card: str) -> int:
    """The service layer on the card; returns the float32 launches."""
    import importlib.util
    import tempfile
    import threading
    import urllib.error
    import urllib.request

    import numpy as np
    import torch
    from pednstream_tpu_torch.mcp import http_server, server
    from pednstream_tpu_torch.mcp.run_mcp import run_workflow

    cfg = MCP
    T = cfg["steps"]
    seeded = {"params": {"seed": cfg["demand_seed"]}}  # the socket datasets ship unseeded
    expected = 0  # launches since the counts were set to 0

    def ok(reply, **want):
        if reply.get("error") or any(reply.get(k) != v for k, v in want.items()):
            raise AssertionError(f"reply {reply}, expected {want}")
        json.dumps(reply)  # no default=: a tensor or numpy scalar raises
        return reply

    with tempfile.TemporaryDirectory() as tmp:
        server._manager.base_output_dir = Path(tmp) / "outputs"

        # warm-up on a simulation of its own: the allocator, lazy CUDA init
        warm = ok(server.create_environment(cfg["dataset"]), status="CREATED")
        ok(server.run_simulation(warm["sim_id"], steps=5), current_step=5)

        # -- melbourne, served in chunks to the end ---------------------------
        reset_counts()
        t0 = time.perf_counter()
        env = ok(server.create_environment(cfg["dataset"]), status="CREATED",
                 num_nodes=cfg["nodes"], num_links=cfg["links"], simulation_steps=T)
        create_seconds = time.perf_counter() - t0
        sid = env["sim_id"]
        sim = server._manager.get(sid)
        scn = sim.scenario
        if (scn.H, scn.binomial_mode, scn.ftype, sim.engine_state.batch) != (
                T + 1, "exact", torch.float32, 1) or MCP_SHAPE != tuple(
                sim.engine_state.cum_in_ring.shape):
            raise AssertionError(f"H={scn.H}, {scn.binomial_mode}, {scn.ftype}, rings "
                                 f"{tuple(sim.engine_state.cum_in_ring.shape)}")
        reply_ms, served_seconds, done = {}, 0.0, 0
        requests = [{"steps": n} for n in cfg["chunks"]] + [{"until": cfg["until"]}, {}]
        for kw in requests:
            want = min(kw.get("until", done + kw.get("steps", T)), T - 1)
            t0 = time.perf_counter()
            # in this thread a host sync is an error while the loop steps;
            # the tool's one explicit synchronize before its reply is not
            torch.cuda.set_sync_debug_mode("error")
            try:
                reply = server.run_simulation(sid, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            seconds = time.perf_counter() - t0
            ok(reply, current_step=want, total_steps=T,
               status="COMPLETED" if want == T - 1 else "CREATED")
            reply_ms[f"{want - done} steps"] = seconds * 1e3
            served_seconds += seconds
            done = want
            check_launches("float32", done, f"served {done} steps")
        expected = done
        final = sim.engine_state
        if final.t != T or len(sim.history) != T - 1 or sim.step_fn is None:
            raise AssertionError(f"t={final.t}, {len(sim.history)} recorded steps")
        check_state(final)
        check_on_card("history", sim.history)
        if sim.gen.device.type != "cuda" or sim.device.type != "cuda":
            raise AssertionError(f"generator on {sim.gen.device}, simulation on {sim.device}")
        mass_err = check_mass(final)
        arrivals = final.virt_arr_cum.sum().item()
        if not arrivals > 0:
            raise AssertionError("no pedestrian arrived")

        t0 = time.perf_counter()
        saved = ok(server.save_outputs(sid))
        save_seconds = time.perf_counter() - t0
        files = ["link_data.json", "node_data.json", "network_params.json", "time_series.csv"]
        out_dir = Path(saved["output_dir"])
        if saved["files"] != files or sorted(f.name for f in out_dir.iterdir()) != sorted(files):
            raise AssertionError(f"saved {saved['files']}")
        t0 = time.perf_counter()
        resources = {name: fn(sid) for name, fn in server.RESOURCES.items()}
        for (name, text), filename in zip(resources.items(), files):
            if text != (out_dir / filename).read_text():
                raise AssertionError(f"{name} is not {filename}")
        link_data = json.loads(resources["sim://{sim_id}/link_data"])
        if len(link_data) != cfg["links"]:
            raise AssertionError(f"{len(link_data)} links saved")
        for link, entry in link_data.items():
            n_in, n_out, n = (np.asarray(entry[k]) for k in (
                "cumulative_inflow", "cumulative_outflow", "num_pedestrians"))
            if not n_in.shape == n_out.shape == n.shape == (T + 1,):
                raise AssertionError(f"{link}: {n_in.shape} columns, expected {T + 1}")
            if np.abs(n_in - n_out - n).max() > T * 1.5 * 2.0 ** -23 * max(n_in.max(), 1.0):
                raise AssertionError(f"{link}: mass not conserved in the saved run")
        if json.loads(resources["sim://{sim_id}/network_params"])["simulation_steps"] != T:
            raise AssertionError("the saved horizon changed")
        rows = resources["sim://{sim_id}/time_series"].count("\n")
        if rows != 1 + cfg["links"] * (T - 1):
            raise AssertionError(f"time_series.csv holds {rows} rows")
        readback_seconds = time.perf_counter() - t0
        t0 = time.perf_counter()
        html = ok(server.export_interactive_map(sid))["html_path"]
        map_seconds = time.perf_counter() - t0
        html_bytes = Path(html).stat().st_size
        if html_bytes < 10_000:
            raise AssertionError(f"the HTML map holds {html_bytes} bytes")
        snapshot = "matplotlib not installed: no snapshot drawn"
        if importlib.util.find_spec("matplotlib") is not None:
            png = ok(server.visualize_snapshot(sid, time_step=T // 2))["image_path"]
            snapshot = f"matplotlib snapshot of {Path(png).stat().st_size} bytes"
        emit("mcp", dataset=cfg["dataset"], links=scn.n_links, nodes=scn.n_nodes, batch=1,
             history=scn.H, binomial_mode=scn.binomial_mode, served_steps=done,
             status=reply["status"], create_seconds=create_seconds,
             served_seconds=served_seconds, served_steps_per_s=done / served_seconds,
             reply_ms_by_chunk=reply_ms, kernel_launches=done, mass_err=mass_err,
             total_arrivals=arrivals, save_seconds=save_seconds,
             readback_seconds=readback_seconds, map_seconds=map_seconds,
             html_bytes=html_bytes, snapshot=snapshot, card=card)

        # -- over the live socket ----------------------------------------------
        httpd, _ = http_server.serve(port=0, background=True)
        base = f"http://127.0.0.1:{httpd.server_address[1]}"

        def get(path):
            with urllib.request.urlopen(base + path, timeout=120) as r:
                return r.status, r.read().decode()

        def post(tool, **payload):
            req = urllib.request.Request(
                f"{base}/tools/{tool}", data=json.dumps(payload).encode(),
                headers={"Content-Type": "application/json"}, method="POST")
            with urllib.request.urlopen(req, timeout=300) as r:
                return json.loads(r.read().decode())

        def code_of(call, *args, **kw):
            try:
                call(*args, **kw)
            except urllib.error.HTTPError as e:
                return e.code
            raise AssertionError(f"{args} {kw} raised no HTTP error")

        try:
            code, body = get("/tools")
            tools = {t["name"]: t for t in json.loads(body)["tools"]}
            if code != 200 or set(tools) != set(server.TOOLS) or "device" not in tools[
                    "create_environment"]["parameters"]["properties"]:
                raise AssertionError(f"GET /tools: {code}, {sorted(tools)}")
            first, n = next(iter(cfg["socket"])), cfg["socket_steps"]
            s1 = ok(post("create_environment", config_name=first, overrides=seeded),
                    status="CREATED")["sim_id"]
            ok(post("run_simulation", sim_id=s1, steps=n), current_step=n, status="CREATED")
            ok(post("get_status", sim_id=s1), current_step=n, status="CREATED")
            expected += n
            saved = ok(post("save_outputs", sim_id=s1))
            code, text = get(f"/resources/sim/{s1}/link_data")
            if code != 200 or text != (Path(saved["output_dir"]) / "link_data.json").read_text():
                raise AssertionError("GET link_data is not the saved file")
            codes = [code_of(post, "nonexistent"), code_of(post, "get_status", sim_id="nosuch"),
                     code_of(get, f"/resources/sim/{s1}/banana"), code_of(get, "/nowhere"),
                     code_of(post, "run_simulation", no_such_argument=1)]
            if codes != [404, 404, 404, 404, 400]:
                raise AssertionError(f"error codes {codes}")

            # two simulations stepped at once, each by a request of its own
            together = {name: ok(post("create_environment", config_name=name, overrides=seeded),
                                 status="CREATED")["sim_id"] for name in cfg["socket"]}
            replies = {}

            def request(name):
                replies[name] = post("run_simulation", sim_id=together[name],
                                     steps=cfg["socket"][name])

            t0 = time.perf_counter()
            threads = [threading.Thread(target=request, args=(name,)) for name in together]
            for th in threads:
                th.start()
            # a second request to a simulation that is being stepped
            while 0 == post("get_status", sim_id=together[first])["current_step"]:
                time.sleep(0.001)
            busy = post("run_simulation", sim_id=together[first], steps=0)
            for th in threads:
                th.join()
            together_seconds = time.perf_counter() - t0
            if busy.get("note") != "step loop busy in another request" or busy[
                    "status"] != "RUNNING":
                raise AssertionError(f"a busy simulation replied {busy}")
            for name, steps in cfg["socket"].items():
                ok(replies[name], current_step=steps, status="CREATED")
                expected += steps
            check_launches("float32", expected, "two simulations at once")
        finally:
            httpd.shutdown()
            httpd.server_close()

        # each against itself stepped alone, in a thread where a host sync
        # is an error (a per-thread setting)
        alone, failure, alone_seconds = {}, [], {}

        def step_alone():
            try:
                for name, steps in cfg["socket"].items():
                    # building copies the scenario to the card: outside the mode
                    alone[name] = ok(server.create_environment(name, overrides=seeded),
                                     status="CREATED")["sim_id"]
                    t0 = time.perf_counter()
                    torch.cuda.set_sync_debug_mode("error")
                    try:
                        reply = server.run_simulation(alone[name], steps=steps)
                    finally:
                        torch.cuda.set_sync_debug_mode("default")
                    alone_seconds[name] = time.perf_counter() - t0
                    ok(reply, current_step=steps)
            except BaseException as e:  # re-raised in the main thread below
                failure.append(e)

        th = threading.Thread(target=step_alone)
        th.start()
        th.join()
        if failure:
            raise failure[0]
        for name, steps in cfg["socket"].items():
            expected += steps
            a = server._manager.get(together[name]).engine_state
            b = server._manager.get(alone[name]).engine_state
            check_state(a)
            check_mass(a)
            diff = largest_difference(a, b)
            if a.t != b.t or diff or not a.cum_in.sum().item() > 0:
                raise AssertionError(f"{name} stepped beside another simulation differs "
                                     f"from itself stepped alone: {diff}")
        check_launches("float32", expected, "the simulations stepped alone")
        emit("mcp_socket", datasets=cfg["socket"], error_codes=codes, busy_reply=busy,
             two_at_once_seconds=together_seconds,
             two_at_once_steps_per_s=sum(cfg["socket"].values()) / together_seconds,
             one_after_the_other_seconds=alone_seconds,
             one_after_the_other_steps_per_s=(sum(cfg["socket"].values())
                                              / sum(alone_seconds.values())),
             equal_alone_bitwise=True, card=card)

        # -- the scripted workflow (authors a three-node config) ---------------
        n = cfg["workflow_steps"]
        t0 = time.perf_counter()
        log = run_workflow(steps=n, data_dir=str(Path(tmp) / "authored"), verbose=False)
        workflow_seconds = time.perf_counter() - t0
        expected += n
        if [s["current_step"] for s in log["get_status"]] != [n // 2, n]:
            raise AssertionError(f"workflow statuses {log['get_status']}")
        wsim = server._manager.get(log["create_environment"][0]["sim_id"])
        check_state(wsim.engine_state)
        check_launches("float32", expected, "the workflow")
        emit("mcp_workflow", steps=n, seconds=workflow_seconds, tools=sorted(log),
             snapshot=log["visualize_snapshot"][0], simulations=len(server._manager.list()),
             card=card)
    return expected


# -- phase 14: the multi-device layer; the *_rank functions run in spawned ranks --

def _card_setup():
    import torch

    sys.path.insert(0, str(ROOT))
    if not torch.cuda.is_available():
        raise RuntimeError("a rank of the parallel phase found no CUDA card")
    HotSteps.install()
    return torch


def state_bytes(tree) -> int:
    import torch

    return sum(x.numel() * x.element_size() for x in vars(tree).values()
               if isinstance(x, torch.Tensor))


def compare_block(mine, whole, rows, cols) -> dict:
    """Largest absolute difference per field between this rank's block and
    its part of the whole reference state; every field must be bitwise
    equal."""
    import dataclasses

    import torch

    worst = {}
    for f in dataclasses.fields(mine):
        a, b = getattr(mine, f.name), getattr(whole, f.name)
        if not isinstance(a, torch.Tensor):
            if a != b:
                raise AssertionError(f"{f.name}: {a} != {b}")
            continue
        b = b[rows]
        if f.name not in ("virt_dep", "virt_arr", "virt_dep_cum", "virt_arr_cum"):
            b = b[..., cols]
        worst[f.name] = (a - b).abs().max().item()
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(f"sharded {f.name} != unsharded: max abs diff {worst[f.name]}")
    return worst


def link_rank(rank, world, device, mesh_shape, steps, ref_path):
    """One rank of the link-sharded (1 x P) or hybrid (Pe x Pl) melbourne
    run; compares its final block with the unsharded reference on the card."""
    torch = _card_setup()
    from pednstream_tpu_torch import parallel as par
    from pednstream_tpu_torch.ops import fused_history_reads

    scn = main_scenario()
    n_env, n_link = mesh_shape
    hybrid = n_env > 1
    mesh = (par.make_mesh_2d(n_env, n_link) if hybrid else par.make_mesh(n_link, axis="link"))
    # the block is cut on the host: the card never holds the whole state
    whole = scn.init_state(MAIN["batch"], device="cpu")
    whole_bytes = state_bytes(whole)
    block = (par.shard_hybrid_state(whole, mesh) if hybrid
             else par.shard_link_state(whole, mesh)).to(device)
    del whole
    make = par.make_hybrid_sharded_simulate if hybrid else par.make_link_sharded_simulate
    ep = par.shard_link_params(scn.engine_params, mesh)
    # warm-up on its own block (allocator, lazy init, gloo's buffers)
    warm = block.take(slice(None))
    make(scn, mesh, 5, stochastic=True)(
        ep, warm, torch.Generator(device=device).manual_seed(SEED + 1))
    del warm
    g = torch.Generator(device=device).manual_seed(SEED)
    run = make(scn, mesh, steps, stochastic=True)
    mesh.collectives.clear()
    mesh.host_trips = 0
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    reset_counts()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        final = run(ep, block, g)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(fused_history_reads.launches)
    hot = check_hot(f"rank {rank}")
    peak = torch.cuda.max_memory_allocated()
    ring_bytes = MAIN["batch"] * scn.H * scn.n_links * 4
    n_coll, n_bad = par.assert_no_full_ring_collectives(mesh, ring_bytes)
    record = {k: list(v) for k, v in mesh.collectives.items()}
    host_trips = mesh.host_trips
    ref = torch.load(ref_path, map_location=device, weights_only=False)
    rows = mesh.block("env", MAIN["batch"]) if hybrid else slice(None)
    worst = compare_block(final, ref, rows, mesh.block("link", scn.n_links))
    return {"rank": rank, "coords": mesh.coords, "backend": torch.distributed.get_backend(),
            "through_host": mesh.via_host, "host_trips": host_trips,
            "block": tuple(final.cum_in_ring.shape), "launches": launches, "hot": hot,
            "seconds": seconds, "collectives": n_coll, "violations": n_bad,
            "record": record, "ring_bytes": ring_bytes,
            "state_bytes": state_bytes(final), "whole_state_bytes": whole_bytes,
            "held_bytes_before_run": held, "peak_bytes": peak,
            "max_abs_diff": max(worst.values()), "fields": len(worst)}


def transport_rank(rank, world, device, rounds):
    """The link-sharded step's largest exchange (four stacked [B, E/P]
    float32 vectors) as the mesh makes it, handed to gloo as CUDA tensors,
    and staged through a pinned host buffer of this function's own;
    milliseconds per exchange of each."""
    torch = _card_setup()
    from pednstream_tpu_torch import parallel as par

    mesh = par.make_mesh(world, axis="link")
    g = torch.Generator(device=device).manual_seed(SEED + rank)
    four = torch.rand((4,) + LINK_BLOCK[::2], generator=g, device=device)
    pinned = torch.empty(four.shape, pin_memory=True)
    out = {"backend": torch.distributed.get_backend(), "through_host": mesh.via_host,
           "bytes": four.numel() * 4 * world}
    for how in ("direct", "staged", "direct", "staged"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(rounds):
            if how == "direct":
                got = par.all_gather(four, mesh, "link", name="transport")
            else:
                parts = [torch.empty_like(pinned) for _ in range(world)]
                torch.distributed.all_gather(parts, pinned.copy_(four),
                                             group=mesh.group("link"))
                if not torch.equal(torch.cat(parts, dim=-1).to(device), got):
                    raise AssertionError("the staged exchange disagrees with gloo's own")
        torch.cuda.synchronize()
        out.setdefault(how + "_ms", []).append((time.perf_counter() - t0) / rounds * 1e3)
    return out


def parallel_trainer():
    """Phase 8's trainer over an env that draws with the fast sampler.  The
    dataset ships unseeded (fresh demand per build), and every rank must
    build the same scenario: the env is seeded."""
    from pednstream_tpu_torch.profiling import ZOO_PPO

    env = train_env(seed=SEED)
    env.scn.binomial_mode = "fast"
    return env, ZOO_PPO


def trainer_rank(rank, world, device, ref_path):
    """One rank of the data-parallel PPO iteration."""
    torch = _card_setup()
    from pednstream_tpu_torch import parallel as par
    from pednstream_tpu_torch.ops import fused_history_reads
    from pednstream_tpu_torch.rl import BatchedPPOTrainer

    env, kw = parallel_trainer()
    mesh = par.make_mesh(world)
    tr = BatchedPPOTrainer(env.core, mesh=mesh, **kw)
    tr.train_iteration(tr.init(seed=SEED + 1))  # warm-up on its own state
    ts = tr.init(seed=SEED)
    block = tuple(ts.env_states.cum_in_ring.shape)
    mesh.collectives.clear()
    mesh.host_trips = 0
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ts, metrics = tr._learn(ts, tr._rollout(ts))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(fused_history_reads.launches)
    hot = check_hot(f"trainer rank {rank}")
    ref = torch.load(ref_path, map_location=device, weights_only=False)
    worst = compare_block(ts.env_states, ref["state"], mesh.block("env", tr.B), slice(None))
    check_on_card("env_states", ts.env_states)
    check_on_card("params", ts.params)
    aid = ENV["agent"]
    return {"rank": rank, "block": block, "launches": launches, "hot": hot,
            "seconds": seconds, "metrics": {k: float(v) for k, v in metrics.items()},
            "params": flat_params([ts.params[aid], ts.value_params[aid]]).cpu(),
            "record": {k: list(v) for k, v in mesh.collectives.items()},
            "host_trips": mesh.host_trips, "state_max_abs_diff": max(worst.values()),

            "backend": torch.distributed.get_backend()}


def phase_parallel(card: str, scn) -> dict:
    """The sharded paths on the card; returns the float32 launches of all
    ranks, per path."""
    import math
    import tempfile

    import torch
    from pednstream_tpu_torch import parallel as par, simulate_batched
    from pednstream_tpu_torch.ops import fused_history_reads
    from pednstream_tpu_torch.rl import BatchedPPOTrainer

    import dryrun_multichip_torch

    ep = scn.engine_params
    B, steps, hsteps = MAIN["batch"], PARALLEL["steps"], PARALLEL["hybrid_steps"]
    launches = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_parallel_") as tmp:
        # the unsharded run, from the same initial state and seed
        simulate_batched(scn, ep, scn.init_state(B), 5,
                         gen=torch.Generator(device="cuda").manual_seed(SEED + 1),
                         stochastic=True)
        states = scn.init_state(B)
        whole_bytes = state_bytes(states)
        g = torch.Generator(device="cuda").manual_seed(SEED)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        reset_counts()
        t0 = time.perf_counter()
        mid = simulate_batched(scn, ep, states, hsteps, gen=g, stochastic=True)
        torch.cuda.synchronize()
        torch.save(mid.to("cpu"), f"{tmp}/ref_{hsteps}.pt")
        t1 = time.perf_counter()
        final = simulate_batched(scn, ep, mid, steps - hsteps, gen=g, stochastic=True)
        torch.cuda.synchronize()
        unsharded_s = (time.perf_counter() - t1) / (steps - hsteps)
        peak = torch.cuda.max_memory_allocated()
        check_launches("float32", steps, "the unsharded reference")
        check_state(final)
        torch.save(final.to("cpu"), f"{tmp}/ref_{steps}.pt")
        del states, mid, final
        emit("parallel_unsharded", dataset=MAIN["dataset"], batch=B, history_window=scn.H,
             steps=steps, ms_per_step=unsharded_s * 1e3, state_bytes=whole_bytes,
             held_bytes_before_run=held, peak_bytes=peak, card=card)

        for name, mesh_shape, n, want_block in (
                ("link_sharded", (1, PARALLEL["link_ranks"]), steps, LINK_BLOCK),
                ("hybrid", PARALLEL["hybrid"], hsteps, HYBRID_BLOCK)):
            world = mesh_shape[0] * mesh_shape[1]
            ranks = par.spawn_ranks(link_rank, world,
                                    (mesh_shape, n, f"{tmp}/ref_{n}.pt"), device="cuda")
            for r in ranks:
                want = {**dict.fromkeys(r["launches"], 0), "float32": n}
                if r["launches"] != want or r["block"] != want_block:
                    raise AssertionError(f"{name} rank {r['rank']}: launches {r['launches']} "
                                         f"at block {r['block']}, expected {want} at "
                                         f"{want_block}")
                if r["violations"] or not r["collectives"] or r["max_abs_diff"] != 0.0:
                    raise AssertionError(f"{name} rank {r['rank']}: {r}")
            r0 = ranks[0]
            largest = max(v[1] for v in r0["record"].values())
            emit("parallel_" + name, dataset=MAIN["dataset"], batch=B, history_window=scn.H,
                 mesh=list(mesh_shape), ranks=world, steps=n, block=list(r0["block"]),
                 bitwise_equal_to_unsharded=True, fields_compared=r0["fields"],
                 backend=r0["backend"], through_host=r0["through_host"],
                 host_round_trips_per_step=r0["host_trips"] / n,
                 kernel_launches_per_rank=n, collectives_per_step=r0["collectives"] / n,
                 largest_collective_bytes=largest, ring_bytes=r0["ring_bytes"],
                 collective_bytes_per_step=sum(v[2] for v in r0["record"].values()) / n,
                 ms_per_step=[r["seconds"] / n * 1e3 for r in ranks],
                 unsharded_ms_per_step=unsharded_s * 1e3,
                 state_bytes_per_rank=[r["state_bytes"] for r in ranks],
                 unsharded_state_bytes=whole_bytes,
                 peak_bytes_per_rank=[r["peak_bytes"] for r in ranks],
                 held_bytes_before_run_per_rank=[r["held_bytes_before_run"] for r in ranks],
                 unsharded_peak_bytes=peak, card=card)
            launches[name] = sum(r["launches"]["float32"] for r in ranks)
            RANK_HOT[name] = sum_hot([r["hot"] for r in ranks])
            if RANK_HOT[name]["binom_fast"]["float32"] != 3 * n * world or RANK_HOT[name][
                    "turning_fractions"]["float32"] != n * world:
                raise AssertionError(f"{name}: hot-op launches {RANK_HOT[name]} over {world} "
                                     f"ranks of {n} steps")

        # the data-parallel trainer against the unsharded one, same seed
        env, kw = parallel_trainer()
        aid = ENV["agent"]
        tr = BatchedPPOTrainer(env.core, **kw)
        tr.train_iteration(tr.init(seed=SEED + 1))
        ts = tr.init(seed=SEED)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        ts, metrics = tr.train_iteration(ts)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        engine_steps = tr.T * env.core.action_gap
        check_launches("float32", engine_steps, "the unsharded trainer")
        plain_params = flat_params([ts.params[aid], ts.value_params[aid]]).cpu()
        torch.save({"state": ts.env_states.to("cpu")}, f"{tmp}/ref_trainer.pt")
        world = PARALLEL["trainer_ranks"]
        ranks = par.spawn_ranks(trainer_rank, world, (f"{tmp}/ref_trainer.pt",), device="cuda")
        want_block = (tr.B // world, env.scn.H, env.scn.n_links)
        param_err = metric_err = 0.0
        for r in ranks:
            want = {**dict.fromkeys(r["launches"], 0), "float32": engine_steps}
            if r["launches"] != want or r["block"] != want_block:
                raise AssertionError(f"trainer rank {r['rank']}: launches {r['launches']} at "
                                     f"block {r['block']}")
            if r["state_max_abs_diff"] != 0.0 or not torch.equal(r["params"],
                                                                 ranks[0]["params"]):
                raise AssertionError(f"trainer rank {r['rank']}: env state or replicated "
                                     f"parameters differ")
            for k, v in metrics.items():
                got = r["metrics"][k]
                if not (math.isfinite(got) and abs(got - v) <= PARALLEL["metric_atol"]
                        + PARALLEL["rtol"] * abs(v)):
                    raise AssertionError(f"trainer metric {k}: {got} vs unsharded {v}")
                metric_err = max(metric_err, abs(got - v))
            diff = (r["params"] - plain_params).abs()
            if bool((diff > PARALLEL["param_atol"] + PARALLEL["rtol"] * plain_params.abs()).any()):
                raise AssertionError(f"trainer parameters differ by {diff.max().item()}")
            param_err = max(param_err, diff.max().item())
        r0 = ranks[0]
        emit("parallel_trainer", dataset=ENV["dataset"], batch=tr.B, ranks=world,
             block=list(r0["block"]), engine_steps=engine_steps,
             kernel_launches_per_rank=engine_steps, env_state_bitwise_equal=True,
             max_abs_param_err=param_err, max_abs_metric_err=metric_err,
             rtol=PARALLEL["rtol"], param_atol=PARALLEL["param_atol"],
             metric_atol=PARALLEL["metric_atol"], backend=r0["backend"],
             collectives={k: v[0] for k, v in r0["record"].items()},
             collective_bytes={k: v[2] for k, v in r0["record"].items()},
             host_round_trips=r0["host_trips"],
             seconds_per_iteration=[r["seconds"] for r in ranks],
             unsharded_seconds_per_iteration=plain_s, metrics=r0["metrics"], card=card)
        launches["trainer"] = sum(r["launches"]["float32"] for r in ranks)
        RANK_HOT["trainer"] = sum_hot([r["hot"] for r in ranks])
        del env, tr, ts

    # the five dry-run stages at 4 ranks
    t0 = time.perf_counter()
    world = PARALLEL["dryrun_ranks"]
    report = dryrun_multichip_torch.dryrun_multichip(world)
    want = 1 + 3 + 2 + 3 + 2  # engine steps of the five stages on every rank
    blocks = dryrun_blocks()  # the shapes phase 3 held the kernel to
    for rank, (got, at) in enumerate(zip(report["launches_per_rank"],
                                         report["blocks_per_rank"])):
        if got != {**dict.fromkeys(got, 0), "float32": want} or at != blocks:
            raise AssertionError(f"dry run rank {rank}: launches {got} at {at}, expected "
                                 f"{want} float32 ones at {blocks}")
    if len(report["launches_per_rank"]) != world or report["device"] != "cuda:0" and (
            torch.cuda.device_count() < world):
        raise AssertionError(f"dry run: {report}")
    emit("parallel_dryrun", ranks=world, seconds=time.perf_counter() - t0,
         kernel_launches_per_rank=[r["float32"] for r in report["launches_per_rank"]],
         blocks=blocks, backend=report["backend"],
         host_round_trips=report["host_trips"],
         **{k: report[k] for k in ("pg_loss", "ppo_loss", "sac_loss", "link_mass", "link_n",
                                   "hybrid", "t")}, card=card)
    launches["dryrun"] = sum(r["float32"] for r in report["launches_per_rank"])
    return launches


def artifacts_listing() -> dict:
    """``{path: (size, mtime ns)}`` of every file under ``artifacts/``."""
    return {str(p.relative_to(ROOT)): (p.stat().st_size, p.stat().st_mtime_ns)
            for p in sorted((ROOT / "artifacts").rglob("*")) if p.is_file()}


class EngineSteps:
    """Counts the engine steps the env core takes while it is entered (the
    number the kernel's launches are held to on env-driven paths)."""

    def __enter__(self):
        import pednstream_tpu_torch.env.core as core

        self.core, self.inner, self.n = core, core.step_fn, 0

        def counted(*args, **kwargs):
            self.n += 1
            return self.inner(*args, **kwargs)

        core.step_fn = counted
        return self

    def __exit__(self, *exc):
        self.core.step_fn = self.inner


def phase_zoo_cli(card: str) -> int:
    """The zoo pipeline's functions on the card into a temporary ``--out``;
    returns the float32 launches."""
    import os
    import shutil
    import tempfile

    import pednstream_tpu_torch.scripts.train_zoo as tz
    from pednstream_tpu_torch.ops import fused_history_reads

    c = ZOO_CLI
    ds, gap = c["dataset"], c["action_gap"]
    before = artifacts_listing()
    validation_s = [0.0]
    originals = {n: getattr(tz, n) for n in ("_validate_ppo_dir", "_validate_sac_dir")}

    def timed_validation(inner):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return inner(*args, **kwargs)
            finally:
                validation_s[0] += time.perf_counter() - t0
        return run

    for name, fn in originals.items():
        setattr(tz, name, timed_validation(fn))
    try:
        with tempfile.TemporaryDirectory(prefix="zoo_cli_") as out, EngineSteps() as steps:
            reset_counts()
            t0 = time.perf_counter()
            tz.train_ppo(ds, gap, c["iterations"], seeds=c["seeds"], out=out, device="cuda")
            ppo_s = time.perf_counter() - t0
            mine = Path(out) / "zoo" / f"ppo_agents_{ds}"
            candidate = Path(str(mine) + ".candidate")
            exported = mine if mine.is_dir() else candidate
            files = sorted(os.listdir(exported))
            if files != sorted(os.listdir(ROOT / c["shipped"])):
                raise AssertionError(f"exported {files}, shipped {os.listdir(ROOT / c['shipped'])}")
            curve = json.loads((exported / "curve.json").read_text())
            if len(curve) != c["iterations"]:
                raise AssertionError(f"curve has {len(curve)} iterations")
            act_err = checkpoint_card_vs_cpu(exported)
            # the second run meets the no-regress gate of the first's (or the shipped) policy
            shutil.rmtree(candidate, ignore_errors=True)
            standing = tz.train_ppo(ds, gap, c["regate_iterations"], out=out, device="cuda")
            if Path(standing) == mine and mine.is_dir() and not candidate.exists():
                gate = "replaced"
            elif candidate.is_dir() and Path(standing) != mine:
                gate = "kept, candidate left"
            else:
                raise AssertionError(f"the gate left {standing} and no candidate")
            t0 = time.perf_counter()
            sac = tz.train_sac_batched(ds, gap, c["sac_iterations"], val_every=1, out=out,
                                       device="cuda")
            sac_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            tz.evaluate_zoo(ds, gap, standing, sac, with_mpc=c["with_mpc"],
                            num_runs=c["eval_runs"], out=out, device="cuda")
            eval_s = time.perf_counter() - t0
            got = json.loads((Path(out) / "eval" / ds / "results.json").read_text())
            want = json.loads((ROOT / c["results"]).read_text())
            if list(got) != list(want):
                raise AssertionError(f"policies {list(got)}, shipped {list(want)}")
            for algo, rows in got.items():
                if len(rows) != c["eval_runs"] or any(
                        sorted(r) != sorted(want[algo][0]) for r in rows):
                    raise AssertionError(f"{algo}: rows or keys differ from the shipped table")
            launches = fused_history_reads.launches["float32"]
            check_launches("float32", steps.n, "zoo_cli")
            rows = {a: [r["total_reward"] for r in v] for a, v in got.items()}
    finally:
        for name, fn in originals.items():
            setattr(tz, name, fn)
    after = artifacts_listing()
    if after != before:
        changed = sorted(k for k in before.keys() | after.keys() if before.get(k) != after.get(k))
        raise AssertionError(f"artifacts/ changed: {changed[:10]}")
    emit("zoo_cli", dataset=ds, iterations=c["iterations"], seeds=c["seeds"],
         exported_files=files, card_vs_cpu_max_abs_err=act_err, rtol=ZOO_RTOL, gate=gate,
         ppo_wall_ms_per_iteration=[1e3 * x["wall_s"] for x in curve], ppo_seconds=ppo_s,
         sac_seconds=sac_s, validation_seconds=validation_s[0], evaluation_seconds=eval_s,
         eval_total_reward=rows, engine_steps=steps.n, kernel_launches=launches,
         artifacts_unchanged=len(after), card=card)
    return launches


def check_finite_nonnegative(states) -> None:
    import torch

    for name, x in vars(states).items():
        if isinstance(x, torch.Tensor) and (not bool(torch.isfinite(x).all())
                                            or bool((x < 0).any())):
            raise AssertionError(f"state leaf {name} is not finite and non-negative")


def phase_examples(card: str, out: str) -> dict:
    """Each example's run at its shipped network and horizon on the card,
    its saved runs under ``out``; returns the float32 launches per
    example."""
    from pednstream_tpu_torch.examples import (big_network, delft_exp, forky_queues,
                                               grid_scale, link_sharded_scale, long_corridor,
                                               melbourne, metered_corridor, nine_node, six_node,
                                               spike)
    from pednstream_tpu_torch.ops import fused_history_reads

    x = EXAMPLES
    launches = {}
    cases = [
        ("melbourne", lambda: melbourne.run("cuda", out=out)),
        ("long_corridor", lambda: long_corridor.run("cuda", out=out)),
        ("six_node", lambda: six_node.run("cuda")),
        ("spike", lambda: spike.run("cuda")),
        ("forky_queues", lambda: forky_queues.run("cuda")),
        ("nine_node", lambda: nine_node.run("cuda", out=out)),
        ("delft_exp", lambda: delft_exp.run("cuda")),
        ("big_network", lambda: big_network.run(False, "cuda", out=out)),
        ("grid_scale", lambda: grid_scale.run("cuda", x["grid_batch"], x["grid_steps"])),
        ("metered_corridor", lambda: metered_corridor.run("cuda", out=out)),
    ]
    for name, run in cases:
        reset_counts()
        t0 = time.perf_counter()
        with EngineSteps() as env_steps:
            r = run()
        seconds = time.perf_counter() - t0
        # grid_scale runs a warm-up rollout before the timed one
        engine_steps = r["steps"] * (2 if name == "grid_scale" else 1)
        if name == "metered_corridor" and env_steps.n != engine_steps:
            raise AssertionError(f"{name}: {env_steps.n} env steps, {engine_steps} counted")
        check_launches("float32", engine_steps, name)
        final = r["final"]
        check_state(final)
        mass_err = check_mass(final)
        arrivals = float(final.virt_arr_cum.sum())
        departures = float(final.virt_dep_cum.sum())
        # on grid_50x50 the origins are corners, 25+ links from a destination
        if not (arrivals > 0 or (name == "grid_scale" and departures > 0)):
            raise AssertionError(f"{name}: no pedestrian arrived")
        launches[name] = engine_steps
        emit("example", name=name, links=r["scn"].n_links if "scn" in r else None,
             batch=r["batch"], steps=r["steps"], engine_steps=engine_steps,
             env_steps_per_s=r["steps"] * r["batch"] / r["seconds"],
             run_seconds=r["seconds"], seconds_with_saving=seconds,
             launches_per_step=fused_history_reads.launches["float32"] / engine_steps,
             max_mass_err=mass_err, arrivals=arrivals, departures=departures,
             rows=[list(row) for row in r.get("rows", [])], card=card)

    # the link-sharded grid over ranks sharing this card
    reset_counts()
    t0 = time.perf_counter()
    ranks = link_sharded_scale.run(n=x["sharded_n"], steps=x["sharded_steps"],
                                   window=x["sharded_window"], batch=x["sharded_batch"],
                                   ranks=x["sharded_ranks"], device="cuda")
    seconds = time.perf_counter() - t0
    for r in ranks:
        if r["launches"] != {**dict.fromkeys(r["launches"], 0), "float32": x["sharded_steps"]}:
            raise AssertionError(f"link_sharded_scale: a rank launched {r['launches']}")
        if r["block"] != SHARDED_BLOCK:
            raise AssertionError(f"link_sharded_scale: block {r['block']}, not {SHARDED_BLOCK}")
    final = ranks[0]["final"]
    check_finite_nonnegative(final)
    mass_err = check_mass(final)
    departures = float(final.virt_dep_cum.sum())
    if not departures > 0:
        raise AssertionError("link_sharded_scale: no pedestrian departed")
    launches["link_sharded_scale"] = sum(r["launches"]["float32"] for r in ranks)
    run_s = max(r["seconds"] for r in ranks)
    emit("example", name="link_sharded_scale", links=ranks[0]["n_links"],
         ranks=x["sharded_ranks"], block=ranks[0]["block"], batch=x["sharded_batch"],
         steps=x["sharded_steps"], env_steps_per_s=x["sharded_steps"] * x["sharded_batch"] / run_s,
         run_seconds=run_s, build_seconds=ranks[0]["build_s"], seconds_with_spawn=seconds,
         launches_per_step=launches["link_sharded_scale"] / x["sharded_steps"] / len(ranks),
         collectives=ranks[0]["collectives"], max_mass_err=mass_err,
         arrivals=float(final.virt_arr_cum.sum()), departures=departures, card=card)
    return launches


class CheckedSteps(EngineSteps):
    """Counts the env core's engine steps, as :class:`EngineSteps`, and
    holds the last state one returned to the checks of the main path
    (finite, non-negative, mass conserved) when it is left."""

    def __enter__(self):
        super().__enter__()
        counted, self.last = self.core.step_fn, None

        def kept(*args, **kwargs):
            out = counted(*args, **kwargs)
            self.last = out[0]
            return out

        self.core.step_fn = kept
        return self

    def __exit__(self, *exc):
        super().__exit__(*exc)
        if exc[0] is None and self.last is not None:
            check_finite_nonnegative(self.last)
            self.mass_err = check_mass(self.last)


def phase_sweeps(card: str) -> dict:
    """Both throughput sweeps at every shipped row, the depth cut; returns
    the float32 launches per sweep."""
    import io
    from contextlib import redirect_stdout

    from pednstream_tpu_torch.ops import fused_history_reads
    from pednstream_tpu_torch.scripts import sweep_grid, sweep_melbourne

    launches = {}
    for name, mod in (("sweep_melbourne", sweep_melbourne), ("sweep_grid", sweep_grid)):
        mass = []

        def check(final):
            check_state(final)
            mass.append(check_mass(final))

        reset_counts()
        printed = io.StringIO()
        t0 = time.perf_counter()
        with redirect_stdout(printed):
            rows = mod.main(["--steps", str(SWEEPS["steps"]), "--reps", str(SWEEPS["reps"]),
                             "--device", "cuda"], check=check)
        seconds = time.perf_counter() - t0
        lines = printed.getvalue().splitlines()
        print(printed.getvalue(), end="", flush=True)
        failed = [ln for ln in lines if "FAILED" in ln]
        if failed or len(rows) != 6 or len(lines) != 6:
            raise AssertionError(f"{name}: {failed or lines}")
        engine_steps = len(rows) * (1 + SWEEPS["reps"]) * SWEEPS["steps"]
        check_launches("float32", engine_steps, name)
        if len(mass) != len(rows) * (1 + SWEEPS["reps"]):
            raise AssertionError(f"{name}: {len(mass)} runs checked")
        launches[name] = engine_steps
        emit("sweep", name=name, steps=SWEEPS["steps"], reps=SWEEPS["reps"],
             rows=[{"H": H, "B": B, "env_steps_per_s": v, "ms_per_step": B / v * 1e3}
                   for H, B, v in rows], engine_steps=engine_steps,
             launches_per_step=fused_history_reads.launches["float32"] / engine_steps,
             max_mass_err=max(mass), seconds=seconds, card=card)
    return launches


def phase_window(card: str) -> int:
    """quantify_window at full horizon on the card; returns the float32
    launches."""
    import torch
    from pednstream_tpu_torch.scripts import quantify_window as qw

    real = qw.simulate
    seen = {"steps": 0, "mass": 0.0, "shapes": set()}

    def checked(scn, ep, state, steps, *args, **kwargs):
        final, outs = real(scn, ep, state, steps, *args, **kwargs)
        check_finite_nonnegative(final)
        seen["mass"] = max(seen["mass"], check_mass(final))
        seen["steps"] += steps
        seen["shapes"].add((1, scn.H, scn.n_links))
        if not bool(torch.isfinite(outs.density).all()) or bool((outs.num_peds < 0).any()):
            raise AssertionError("quantify_window: a recorded density or count is bad")
        return final, outs

    reset_counts()
    qw.simulate = checked
    t0 = time.perf_counter()
    try:
        errors = qw.main(["--device", "cuda"])
    finally:
        qw.simulate = real
    seconds = time.perf_counter() - t0
    check_launches("float32", seen["steps"], "quantify_window")
    if WINDOW_SHAPE not in seen["shapes"] or len(errors) != 12:
        raise AssertionError(f"quantify_window ran {sorted(seen['shapes'])}, {len(errors)} rows")
    emit("window", errors={f"{n} [{label}] H={H}": {"density_max": d, "num_peds_max": c}
                           for (n, label, H), (d, c) in errors.items()},
         melbourne_identical_to_exact={f"{label} H={H}": d == 0.0 and c == 0.0
                                       for (n, label, H), (d, c) in errors.items()
                                       if n == "melbourne"},
         engine_steps=seen["steps"], shapes=sorted(seen["shapes"]), max_mass_err=seen["mass"],
         seconds=seconds, card=card)
    return seen["steps"]


def phase_scripts(card: str, saved_runs: str) -> dict:
    """The reset-determinism report, retrain_r3's eval phase, the ablation,
    the dashboard's HTML export of a run the examples phase saved, and
    entry()'s step; returns the float32 launches per driver."""
    import io
    import os
    import tempfile
    from contextlib import redirect_stdout

    import torch
    from pednstream_tpu_torch.entry import entry
    from pednstream_tpu_torch.scripts import (ablate_global_reward, network_dashboard,
                                              reset_determinism_report, retrain_r3)

    c = SCRIPTS
    before = artifacts_listing()
    launches, report = {}, {}

    def driver(name, run):
        reset_counts()
        printed = io.StringIO()
        t0 = time.perf_counter()
        with CheckedSteps() as steps, redirect_stdout(printed):
            result = run()
        report[name] = {"seconds": time.perf_counter() - t0, "engine_steps": steps.n,
                        "max_mass_err": steps.mass_err}
        if "FAILED" in printed.getvalue():
            raise AssertionError(f"{name}: {printed.getvalue()[-2000:]}")
        check_launches("float32", steps.n, name)
        launches[name] = steps.n
        return result, printed.getvalue()

    with tempfile.TemporaryDirectory(prefix="scripts_") as out:
        driver("reset_determinism_report", lambda: reset_determinism_report.report(
            c["reset_dataset"], out=os.path.join(out, "reset"), device="cuda"))
        stats = json.loads(Path(out, "reset", "statistics.json").read_text())
        if stats["deterministic"] is not True:
            raise AssertionError(f"reset determinism: {stats['max_cross_episode_deviation']}")
        report["reset_determinism_report"]["deterministic"] = True

        driver("retrain_r3", lambda: retrain_r3.main([
            "--phase", "eval", "--datasets", c["eval_dataset"], "--num-runs",
            str(c["eval_runs"]), "--out", os.path.join(out, "retrain"), "--device", "cuda"]))
        results = json.loads(Path(out, "retrain", "eval", c["eval_dataset"],
                                  "results.json").read_text())
        report["retrain_r3"]["total_reward"] = {a: [r["total_reward"] for r in rows]
                                                for a, rows in results.items()}
        if not all(len(rows) == c["eval_runs"] for rows in results.values()):
            raise AssertionError(f"retrain_r3 eval: {list(results)}")

        rows, _ = driver("ablate_global_reward", lambda: ablate_global_reward.main([
            "--dataset", c["ablate_dataset"], "--coefs", *c["ablate_coefs"], "--iters",
            str(c["ablate_iters"]), "--num-runs", str(c["ablate_runs"]), "--out",
            os.path.join(out, "ablate"), "--device", "cuda"]))
        if [r["coef"] for r in rows] != [float(x) for x in c["ablate_coefs"]] or not all(
                isinstance(r["reward_mean"], float) for r in rows):
            raise AssertionError(f"ablation rows: {rows}")
        report["ablate_global_reward"]["reward_mean"] = [r["reward_mean"] for r in rows]

        sim_dir = next(p.parent for p in sorted(Path(saved_runs).rglob("network_params.json")))
        html = os.path.join(out, "map.html")
        t0 = time.perf_counter()
        network_dashboard.main(["--sim-dir", str(sim_dir), "--html", html])
        text = Path(html).read_text()
        if "<svg" not in text or len(text) < 10_000:
            raise AssertionError("the dashboard's HTML export is empty")
        report["network_dashboard"] = {"sim_dir": sim_dir.name, "html_bytes": len(text),
                                       "seconds": time.perf_counter() - t0}

    reset_counts()
    fn, (state,) = entry()
    t0 = time.perf_counter()
    new = fn(state)
    torch.cuda.synchronize()
    check_launches("float32", 1, "entry")
    check_state(new)
    check_mass(new)
    if new.t != 2 or new.num_peds.device.type != "cuda":
        raise AssertionError(f"entry: t = {new.t} on {new.num_peds.device}")
    launches["entry"] = 1
    report["entry"] = {"seconds": time.perf_counter() - t0, "engine_steps": 1}

    after = artifacts_listing()
    if after != before:
        raise AssertionError("artifacts/ changed")
    emit("scripts", **report, artifacts_unchanged=len(after), card=card)
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
    HotSteps.install()

    scn = main_scenario()
    from pednstream_tpu_torch.ops import PER_REPLICA_T

    if sys.argv[1:] == ["transport"]:
        # the choice of transport that parallel.mesh made, measured; not a
        # phase of the smoke run, and prints no result
        from pednstream_tpu_torch import parallel as par

        emit("transport", ranks=par.spawn_ranks(
            transport_rank, PARALLEL["link_ranks"], (20,), device="cuda"), card=card)
        return 0
    if sys.argv[1:] == ["parallel"]:
        # phase 14 alone, for work on the multi-device layer; prints no result
        emit("parallel_only", launches=phase_parallel(card, scn), card=card)
        return 0
    if sys.argv[1:] in (["zoo_cli"], ["examples"], ["sweeps"], ["window"], ["scripts"]):
        # one of phases 15-19 alone, for work on the entry points; prints no
        # result (scripts exports a run that long_corridor's example saves)
        only = sys.argv[1]
        with tempfile.TemporaryDirectory(prefix="examples_") as saved:
            if only == "scripts":
                from pednstream_tpu_torch.examples import long_corridor

                long_corridor.run("cuda", out=saved)
                got = phase_scripts(card, saved)
            elif only == "examples":
                got = phase_examples(card, saved)
            else:
                got = {"zoo_cli": phase_zoo_cli, "sweeps": phase_sweeps,
                       "window": phase_window}[only](card)
        emit(only + "_only", launches=got, card=card)
        return 0
    if sys.argv[1:] == ["kernel"]:
        # phase 3 alone, to time the kernel of one tree against another's
        # in one call; prints no result
        emit("kernel_only", record=phase_kernel(card, scn), card=card)
        return 0
    if sys.argv[1:] == ["hot"]:
        # phase 3b alone, to time the hot-op kernels; prints no result
        emit("hot_only", record={"/".join(k): v for k, v in phase_hot_ops(card, scn).items()},
             card=card)
        return 0
    record = phase_kernel(card, scn)
    t0 = time.perf_counter()
    hot_record = phase_hot_ops(card, scn)
    seconds = {"hot_ops": time.perf_counter() - t0}
    # each path's launches of each hot-op kernel form: {(kernel, key): {path: n}}
    hot = {}

    def path(name, fn, *args):
        # the path's hot-op launches: the sum of its stretches' readings,
        # each counted from 0 just before the run it checks
        HOT_READINGS[:] = [None]
        out = fn(*args)
        for kernel, keys in sum_hot([r for r in HOT_READINGS if r]).items():
            for key, n in keys.items():
                if n:
                    hot.setdefault((kernel, key), {})[name] = n
        return out

    # each path's launches of each form of the kernel, counted from 0
    t_main = time.perf_counter()
    launches = {"float32": {"main": path("main", phase_main, card, scn),
                            "gpu_vs_cpu": path("gpu_vs_cpu", phase_gpu_vs_cpu, card)},
                "float64": {"golden": path("golden", phase_golden, card)}}
    launches["float32"]["env"] = path("env", phase_env, card)
    env = train_env()
    launches["float32"]["ppo_train"] = path("ppo_train", phase_ppo_train, card, env)
    launches["float32"]["sac_train"] = path("sac_train", phase_sac_train, card, env)
    phase_zoo(card)
    del env
    seconds["earlier_paths"] = time.perf_counter() - t_main
    t0 = time.perf_counter()
    for key, n in path("hetero", phase_hetero, card).items():
        launches[key] = {"hetero": n}
    seconds["hetero"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    launches["float32"]["evaluate"] = path("evaluate", phase_evaluate, card)
    seconds["evaluate"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    launches["float32"]["mcp"] = path("mcp", phase_mcp, card)
    seconds["mcp"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for name, n in path("parallel", phase_parallel, card, scn).items():
        launches["float32"]["parallel_" + name] = n
    for name, counts in RANK_HOT.items():
        for kernel, keys in counts.items():
            for key, n in keys.items():
                if n:
                    hot.setdefault((kernel, key), {})["parallel_" + name] = n
    seconds["parallel"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    launches["float32"]["zoo_cli"] = path("zoo_cli", phase_zoo_cli, card)
    seconds["zoo_cli"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix="examples_") as saved_runs:
        t0 = time.perf_counter()
        for name, n in path("examples", phase_examples, card, saved_runs).items():
            launches["float32"]["examples_" + name] = n
        seconds["examples"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        for name, n in path("sweeps", phase_sweeps, card).items():
            launches["float32"][name] = n
        seconds["sweeps"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        launches["float32"]["quantify_window"] = path("window", phase_window, card)
        seconds["window"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        for name, n in path("scripts", phase_scripts, card, saved_runs).items():
            launches["float32"][name] = n
        seconds["scripts"] = time.perf_counter() - t0
    emit("seconds_per_path", **seconds, card=card)

    kernels = [{
        "name": "fused_history_reads", "route": "cuda", "dtype": key.removesuffix(PER_REPLICA_T),
        "t": "per replica" if key.endswith(PER_REPLICA_T) else "shared",
        "source": "pednstream_tpu_torch/csrc/ncurve.cu",
        "replaces": "pednstream_tpu/ops/ncurve.py:180",
        "launches": sum(launches[key].values()), "launches_per_path": launches[key],
        **record[key],
    } for key in launches]
    for (kernel, key), rec in hot_record.items():
        per_path = hot.get((kernel, key), {})
        kernels.append({"name": kernel, "route": "cuda", "dtype": key,
                        "source": HOT_KERNELS[kernel]["source"],
                        "replaces": HOT_KERNELS[kernel]["replaces"],
                        "launches": sum(per_path.values()), "launches_per_path": per_path,
                        **rec})
    if not (hot.get(("binom_fast", "float32"), {}).get("main")
            and hot.get(("turning_fractions", "float32"), {}).get("env")
            and hot.get(("node_solve", "float32"), {}).get("main")):
        raise AssertionError(f"the main path's binomial or node solve, or the env path's "
                             f"routing kernel never launched: {hot}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
