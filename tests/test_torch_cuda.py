"""The port on the card: the CUDA kernels of fused_history_reads (float32
and float64, the lookback folded in) against their plain version at every
path's shape, with shared, per-replica and broadcast per-link operands and
with a shared and a per-replica step ``t``; a batch of replicas at
different times stepped on the card against the CPU;
an entry point called with no device; engine rollouts on cuda against the
CPU, a golden fixture in exact-parity mode, a short randomized env
episode, the network families on the card against the CPU, one batched
PPO iteration, the service layer (the MCP workflow, and two
simulations stepped from two threads), and a link-sharded rollout over two
ranks that share the card; the kernels of the step's hot ops -- the fast
binomial, the routed turning fractions (both of its designs) and the node
solve (both of its designs) -- bitwise to their plain versions at every
path's shape and table form, and a stochastic main-path rollout, a delft
rollout and an env episode bitwise equal with the kernels and with the
plain versions from one seed.  Every test here needs a GPU, skips without one (decided in
the ``cuda`` fixture), and is marked ``slow``, so the default tiers leave it
out.  The file imports no JAX (nor does it need tests/conftest.py), so on
a machine with a card it runs as

    python -m pytest --noconftest -p no:cacheprovider -m slow tests/test_torch_cuda.py
"""

from contextlib import nullcontext
from pathlib import Path

import numpy as np
import pytest
import torch

from pednstream_tpu_torch import NetworkEnvGenerator, build_scenario, concat_states, simulate
from pednstream_tpu_torch.env import PedNetParallelEnv
from pednstream_tpu_torch.golden import FIELDS, TOL, golden_errors
from pednstream_tpu_torch.ops import (PER_REPLICA_T, binom_fast, binom_fast_plain,
                                      fused_history_reads, fused_history_reads_plain,
                                      node_solve, node_solve_plain, turning_fractions,
                                      turning_fractions_step_plain)
from pednstream_tpu_torch.ops.routing import LANE_TILE, lane_warps
from pednstream_tpu_torch.profiling import plain_hot_ops
from pednstream_tpu_torch.randomize import randomize_engine_params_batched
from routing_fan import fan_scenario

pytestmark = pytest.mark.slow


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


UNIT_TIME = 10.0


def make_operands(B, H, E, seed, device, ring_dtype=np.float32, per_replica=False):
    """The fused read's operands made with numpy from ``seed``: rings,
    avg_tt (lags over [0, 3H), a tenth on a half step), gamma and
    tau_shockwave (``[E]``, or ``[B, E]`` when ``per_replica``), then the
    step t = H + 7 (negative bases on a full-horizon ring, slots that wrap),
    unit_time and windowed (H of at most 64 rows is a window)."""
    rng = np.random.default_rng(seed)
    rings = [rng.uniform(0, 100, (B, H, E)).astype(ring_dtype) for _ in range(3)]
    avg_tt = rng.uniform(0, 3 * H * UNIT_TIME, (B, E)).astype(np.float32)
    halves = ((rng.integers(0, 3 * H, (B, E)) + 0.5) * UNIT_TIME).astype(np.float32)
    avg_tt = np.where(rng.uniform(size=(B, E)) < 0.1, halves, avg_tt)
    lead = (B,) if per_replica else ()
    gamma = rng.uniform(0.001, 0.1, lead + (E,)).astype(ring_dtype)
    tau_sw = rng.integers(0, 3 * H, lead + (E,)).astype(np.int32)
    tensors = [torch.from_numpy(a).to(device) for a in (*rings, avg_tt, gamma, tau_sw)]
    return tensors + [H + 7, UNIT_TIME, H <= 64]


def assert_kernel_is_plain(ops, dtype=torch.float32):
    """One launch of the ``dtype`` kernel (counted apart when ``t`` is per
    replica), bitwise equal to the plain version on the same CUDA operands."""
    name = str(dtype).removeprefix("torch.")
    if isinstance(ops[6], torch.Tensor):
        name += PER_REPLICA_T
    before = dict(fused_history_reads.launches)
    got = fused_history_reads(*ops)
    want = fused_history_reads_plain(*ops)
    torch.cuda.synchronize()
    assert fused_history_reads.launches == {**before, name: before[name] + 1}
    for a, b in zip(got, want):
        assert a.dtype == dtype
        assert torch.equal(a, b)


# then: the main path's melbourne shape, the env episode's
# 45_intersections shape (256 replicas, full-horizon rings, 168 links) and
# the PPO and SAC trainers' (256 and 64 replicas, H=64, 168 links) and
# the served simulation's (melbourne, one replica, full-horizon rings)
@pytest.mark.parametrize("B,H,E", [(1, 16, 1), (5, 17, 1000), (2, 64, 4097), (1024, 16, 938),
                                   (256, 701, 168), (256, 64, 168), (64, 64, 168),
                                   (1, 501, 938),
                                   # the link-sharded and hybrid blocks of melbourne
                                   (1024, 16, 469), (512, 16, 469),
                                   # the zoo pipeline's trainer and B=1 episodes on
                                   # butterfly_scC; grid_50x50; the link-sharded
                                   # grid's block; delft
                                   (256, 64, 20), (1, 64, 20), (16, 64, 9800),
                                   (4, 16, 54120), (1, 501, 818),
                                   # the sweeps' largest rows; quantify_window's
                                   # full ring on grid_50x50
                                   (1536, 16, 938), (1280, 32, 938), (512, 64, 9800),
                                   (512, 32, 9800), (1, 501, 9800)])
def test_kernel_equals_plain_bitwise(cuda, B, H, E):
    assert_kernel_is_plain(make_operands(B, H, E, seed=B + H + E, device=cuda))


@pytest.mark.parametrize("B,H,E", [(1, 201, 938), (3, 40, 70), (2, 601, 4097)])
def test_float64_kernel_equals_plain_bitwise(cuda, B, H, E):
    """The float64 instantiation (the exact path's full-horizon rings)
    against the plain version: float64 outputs, bit for bit."""
    ops = make_operands(B, H, E, seed=B + H + E, device=cuda, ring_dtype=np.float64)
    assert_kernel_is_plain(ops, torch.float64)


@pytest.mark.parametrize("ring_dtype", [np.float32, np.float64])
@pytest.mark.parametrize("form", ["per replica", "broadcast view"])
def test_kernel_per_replica_operands(cuda, ring_dtype, form):
    """gamma and tau_shockwave per replica ``[B, E]`` (randomized worlds)
    and avg_tt, gamma and tau_shockwave as broadcast ``[B, E]`` views
    (replica stride 0): bitwise equal to the plain version."""
    ops = make_operands(6, 16, 300, seed=9, device=cuda, ring_dtype=ring_dtype,
                        per_replica=form == "per replica")
    if form == "broadcast view":
        ops[3:6] = [x[0].expand(6, -1) if x.dim() == 2 else x.expand(6, -1) for x in ops[3:6]]
        assert all(x.stride(0) == 0 for x in ops[3:6])
    assert_kernel_is_plain(ops, getattr(torch, np.dtype(ring_dtype).name))


def replica_times(B, H, seed, device):
    """One step per replica: the first few at t = 1, 2, ... (lags before
    time 0), the last past two ring wraps, the rest anywhere up to three."""
    rng = np.random.default_rng(seed)
    t = rng.integers(1, 3 * H + 9, B).astype(np.int32)
    small = min(5, max(B // 2, 1))
    t[:small] = np.arange(1, small + 1)
    t[-1] = 2 * H + 5
    return torch.from_numpy(t).to(device)


@pytest.mark.parametrize("B,H,E,ring_dtype,per_replica", [
    (256, 701, 168, np.float32, True), (1024, 16, 938, np.float32, False),
    (256, 64, 168, np.float32, True), (7, 17, 1000, np.float32, False),
    (3, 40, 70, np.float64, False), (6, 201, 938, np.float64, True)])
def test_kernel_per_replica_t_equals_plain_bitwise(cuda, B, H, E, ring_dtype, per_replica):
    """The per-replica-``t`` form of both instantiations: replicas at
    t < 6 beside replicas past a ring wrap in one launch, bit for bit the
    plain version; and each replica equal to the scalar form at its t."""
    ops = make_operands(B, H, E, seed=B + H + E, device=cuda, ring_dtype=ring_dtype,
                        per_replica=per_replica)
    ops[6] = replica_times(B, H, seed=E, device=cuda)
    dtype = getattr(torch, np.dtype(ring_dtype).name)
    assert_kernel_is_plain(ops, dtype)
    got = fused_history_reads(*ops)
    for b in (0, 4 % B, B - 1):
        one = [x[b:b + 1] if x.dim() > 1 and x.shape[0] == B else x for x in ops[:6]]
        want = fused_history_reads(*one, int(ops[6][b]), *ops[7:])
        for a, w in zip(got, want):
            assert torch.equal(a[b:b + 1], w)


def test_kernel_rejects_a_bad_time_tensor(cuda):
    ops = make_operands(4, 16, 10, seed=2, device=cuda)
    for t in (torch.ones(4, dtype=torch.int64, device=cuda),
              torch.ones(3, dtype=torch.int32, device=cuda),
              torch.ones(4, dtype=torch.int32)):
        with pytest.raises((TypeError, ValueError)):
            fused_history_reads(*ops[:6], t, *ops[7:])


def test_het_env_step_on_cuda_matches_cpu(cuda):
    """Replicas at three different times in one batch, deterministic RL
    steps with ``lockstep=False`` under no host sync on the card (the
    per-replica-``t`` kernel, one launch per engine step) against the same
    batch on the CPU (the plain version): densities within the rollout
    atol 5e-3, ``t`` and ``done`` equal."""
    results = {}
    for device in ("cuda", "cpu"):
        env = PedNetParallelEnv("butterfly_scC", obs_mode="option2", action_gap=5,
                                history_window=16, stochastic=False, seed=3, device=device)
        scn, core = env.scn, env.core
        parts = [simulate(scn, scn.engine_params, scn.init_state(2), n, record=False)[0]
                 for n in (0, 9, 37)]
        states = concat_states(parts)
        actions = {a: torch.from_numpy(np.tile(env.action_space(a).high * 0.5, (6, 1))).to(device)
                   for a in env.possible_agents}
        key = "float32" + PER_REPLICA_T
        before = fused_history_reads.launches[key]
        if device == "cuda":
            torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(8):
                states, obs, rewards, done = core.batch_step(states, actions, lockstep=False)
        finally:
            if device == "cuda":
                torch.cuda.set_sync_debug_mode("default")
        assert fused_history_reads.launches[key] - before == (40 if device == "cuda" else 0)
        assert states.t.tolist() == [41, 41, 50, 50, 78, 78]
        assert bool(torch.isfinite(obs[env.possible_agents[0]]).all())
        results[device] = (states.density.cpu(), done.cpu())
    torch.testing.assert_close(results["cuda"][0], results["cpu"][0], rtol=0, atol=5e-3)
    assert torch.equal(results["cuda"][1], results["cpu"][1])


def test_kernel_unbatched_call(cuda):
    ops = make_operands(1, 24, 300, seed=1, device=cuda)
    single = fused_history_reads(*(x[0] for x in ops[:4]), *ops[4:])
    batched = fused_history_reads(*ops)
    for a, b in zip(single, batched):
        assert torch.equal(a, b[0])


def test_kernel_rejects_mixed_devices(cuda):
    ops = make_operands(2, 16, 10, seed=2, device=cuda)
    ops[3] = ops[3].cpu()
    with pytest.raises(ValueError):
        fused_history_reads(*ops)


def test_entry_points_default_to_the_card(cuda):
    """Called with no device, the port builds on the card and its step
    reads history through the kernel."""
    scn = build_scenario(**NetworkEnvGenerator().scenario_args("butterfly_scC"))
    assert scn.device.type == "cuda" and scn.engine_params.gamma.device.type == "cuda"
    before = fused_history_reads.launches["float32"]
    final, _ = simulate(scn, scn.engine_params, scn.init_state(2), 3, record=False)
    assert final.cum_in.device.type == "cuda"
    assert fused_history_reads.launches["float32"] - before == 3
    from pednstream_tpu_torch.rl import PPOAgent

    agent = PPOAgent(obs_dim=16, act_dim=4, features_per_link=4)
    assert all(p.device.type == "cuda" for p in agent.actor.parameters())


def test_rollout_on_cuda_matches_cpu(cuda):
    """Deterministic butterfly_scC, H=64, 120 steps: the card (kernel)
    against the CPU (plain version), at the 5e-3 density atol the CPU
    tests hold the port to against JAX."""
    args = NetworkEnvGenerator().scenario_args("butterfly_scC")
    args["params"]["seed"] = 3
    density = {}
    for device in ("cuda", "cpu"):
        scn = build_scenario(**args, history_window=64, device=device)
        before = fused_history_reads.launches["float32"]
        final, _ = simulate(scn, scn.engine_params, scn.init_state(2), 120, record=False)
        launched = fused_history_reads.launches["float32"] - before
        assert launched == (120 if device == "cuda" else 0)
        density[device] = final.density.cpu()
    torch.testing.assert_close(density["cuda"], density["cpu"], rtol=0, atol=5e-3)


@pytest.mark.parametrize("binomial_mode", ["fast", "exact"])
def test_stochastic_rollout_on_cuda(cuda, binomial_mode):
    """melbourne, 64 replicas, H=16, 100 stochastic steps on the card with
    each binomial sampler (``fast`` is the main path's): finite,
    non-negative, mass conserved to float32 rounding."""
    scn = build_scenario(**NetworkEnvGenerator().scenario_args("melbourne"),
                         history_window=16, binomial_mode=binomial_mode, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    final, _ = simulate(scn, scn.engine_params, scn.init_state(64), 100, gen=gen,
                        stochastic=True, record=False)
    for name, x in vars(final).items():
        if isinstance(x, torch.Tensor):
            assert x.device.type == "cuda", name
            assert bool(torch.isfinite(x).all()) and not bool((x < 0).any()), name
    peak = final.cum_in.abs().max().item()
    err = (final.cum_in - final.cum_out - final.num_peds).abs().max().item()
    assert err <= 100 * 1.5 * 2.0 ** -23 * max(peak, 1.0)


def test_golden_fixture_on_cuda(cuda):
    """butterfly's golden fixture (routed turning fractions) in float64
    exact-parity mode on the card, through the float64 kernel: every
    recorded field within 1e-5 (tests/test_golden_parity.py's target)."""
    before = (fused_history_reads.launches["float64"], node_solve.launches["float64"])
    errors, scn, T = golden_errors(Path(__file__).parent / "golden" / "butterfly.npz", cuda)
    assert fused_history_reads.launches["float64"] - before[0] == T - 1
    # the node solve kernel on the dense phi, unless the "optimal" host LP
    solves = 0 if scn.assign_flows_type == "optimal" else T - 1
    assert node_solve.launches["float64"] - before[1] == solves
    assert errors.keys() == FIELDS.keys()
    bad = {k: v for k, v in errors.items() if not v <= TOL}
    assert not bad, bad


def test_randomized_env_episode_on_cuda(cuda):
    """45_intersections with OD randomization, 16 replicas each with its
    own randomized EngineParams, 60 stochastic RL steps (exact binomial)
    with no host sync: finite obs and rewards of shape [16, ...], one
    kernel launch per engine step, mass conserved."""
    env = PedNetParallelEnv("45_intersections", od_randomize=True, device=cuda)
    core, B = env.core, 16
    gen = torch.Generator(device=cuda).manual_seed(0)
    eps = randomize_engine_params_batched(env.scn, gen, B)
    states, _ = core.batch_reset(B)
    actions = {a: torch.from_numpy(np.tile(env.action_space(a).high, (B, 1))).to(cuda)
               for a in env.possible_agents}
    before = fused_history_reads.launches["float32"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(60):
            states, obs, rewards, done = core.batch_step_randomized(states, actions, eps, gen)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert fused_history_reads.launches["float32"] - before == 60
    for k in env.possible_agents:
        assert obs[k].shape[0] == B and bool(torch.isfinite(obs[k]).all())
        assert rewards[k].shape == (B,) and bool(torch.isfinite(rewards[k]).all())
    err = (states.cum_in - states.cum_out - states.num_peds).abs().max().item()
    assert err <= 60 * 1.5 * 2.0 ** -23 * max(states.cum_in.abs().max().item(), 1.0)


@pytest.mark.parametrize("family", ["attention", "lstm", "udlstm", "gat", "stacked", "mlp",
                                    "sac"])
def test_networks_on_cuda_match_cpu(cuda, family):
    """Each network family at the zoo's width (hidden 64) on the card
    against the same module on the CPU, three recurrent steps: forward
    rtol 1e-5 (the card's float32 products, no TF32)."""
    from pednstream_tpu_torch.rl import networks as nets

    gen = torch.Generator().manual_seed(0)
    B, L, F, K = 5, 4, 4, 4
    if family == "sac":
        mods = [nets.SACActor(L * F, L, K), nets.SACCritic(L * F, L, K)]
    else:
        mods = list(nets.build_family(family, L * F, L, F, 64, stack_size=K))
    obs_shape = {"stacked": (K, L * F), "sac": (K, L * F), "lstm": (L * F,),
                 "mlp": (L * F,)}.get(family, (L, F))
    obs = [torch.randn((B,) + obs_shape, generator=gen) for _ in range(3)]
    act = torch.rand((B, L), generator=gen)
    adj = (torch.ones(L, L),) if family == "gat" else ()
    for mod in mods:
        nets.init_flax_(mod, gen)
        outs = {}
        for device in ("cpu", "cuda"):
            m = mod.to(device)
            carry = nets.family_carry(family, B, L, 64, device) if family != "sac" else ()
            res = []
            with torch.no_grad():
                for o in obs:
                    o = o.to(device)
                    if isinstance(m, nets.SACCritic):
                        res.extend(m(o, act.to(device)))
                    elif isinstance(m, nets.SACActor):
                        res.extend(m(o))
                    else:
                        *out, carry = m(o, carry, *(a.to(device) for a in adj))
                        res.extend([*out, *carry])
            outs[device] = [r.cpu() for r in res]
        for a, b in zip(outs["cuda"], outs["cpu"]):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_batched_ppo_iteration_on_cuda(cuda):
    """One BatchedPPOTrainer iteration (attention, randomized worlds) on
    butterfly_scC on the card with no host sync until the metrics are
    read: one float32 kernel launch per engine step, finite metrics,
    parameters and state on the card."""
    from pednstream_tpu_torch.rl import BatchedPPOTrainer

    env = PedNetParallelEnv("butterfly_scC", obs_mode="option2", action_gap=5,
                            history_window=16, device=cuda)
    tr = BatchedPPOTrainer(env.core, num_envs=8, rollout_len=4, net_type="attention",
                           gate_anchor="open", max_delta=4.0, randomize=True)
    ts = tr.init(seed=0)
    before = fused_history_reads.launches["float32"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        ts, metrics = tr._learn(ts, tr._rollout(ts))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert fused_history_reads.launches["float32"] - before == 4 * 5
    assert all(np.isfinite(float(v)) for v in metrics.values())
    for module in (*ts.params.values(), *ts.value_params.values()):
        assert all(p.device.type == "cuda" for p in module.parameters())
    assert ts.env_states.cum_in.device.type == "cuda" and ts.iteration == 1


def test_mcp_workflow_on_cuda(cuda, tmp_path, monkeypatch):
    """The scripted workflow through the tool server with no device given:
    the simulation lives on the card, one float32 kernel launch per served
    step, every reply plain JSON."""
    import json

    from pednstream_tpu_torch.mcp import server
    from pednstream_tpu_torch.mcp.run_mcp import run_workflow

    monkeypatch.setattr(server._manager, "base_output_dir", tmp_path / "outputs")
    before = fused_history_reads.launches["float32"]
    log = run_workflow(steps=20, data_dir=str(tmp_path), verbose=False)
    assert fused_history_reads.launches["float32"] - before == 20
    assert [s["current_step"] for s in log["get_status"]] == [10, 20]
    sim = server._manager.get(log["create_environment"][0]["sim_id"])
    assert sim.device.type == "cuda" and sim.gen.device.type == "cuda"
    assert sim.engine_state.cum_in_ring.device.type == "cuda"
    assert all(h.density.device.type == "cuda" for h in sim.history)
    assert float(sim.engine_state.cum_in.sum()) > 0
    for replies in log.values():
        for reply in replies:
            assert json.loads(json.dumps(reply)) == reply
    assert (Path(log["save_outputs"][0]["output_dir"]) / "time_series.csv").exists()


def test_mcp_two_threads_on_cuda(cuda, tmp_path, monkeypatch):
    """Two simulations stepped at once from two threads, each thread with
    host syncs made an error while it steps: every launch is counted, and
    each simulation ends bitwise equal to itself stepped alone."""
    import threading

    from pednstream_tpu_torch.mcp import server

    monkeypatch.setattr(server._manager, "base_output_dir", tmp_path / "outputs")
    names = ("butterfly_scC", "nine_intersections")
    steps = 60

    def create(name):
        r = server.create_environment(name, overrides={"params": {"seed": 3}})
        assert r["status"] == "CREATED", r
        return server._manager.get(r["sim_id"])

    def run(sim, replies):
        # a per-thread setting: the loop must not wait for the card, the
        # one synchronize before the reply is explicit and allowed
        torch.cuda.set_sync_debug_mode("error")
        try:
            replies.append(server.run_simulation(sim.sim_id, steps=steps // 2))
            replies.append(server.run_simulation(sim.sim_id, until=steps))
        finally:
            torch.cuda.set_sync_debug_mode("default")

    server.run_simulation(create(names[0]).sim_id, steps=2)  # the library is loaded
    together = [create(n) for n in names]
    replies = [[] for _ in together]
    before = fused_history_reads.launches["float32"]
    threads = [threading.Thread(target=run, args=a) for a in zip(together, replies)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert fused_history_reads.launches["float32"] - before == 2 * steps
    for sim, got, name in zip(together, replies, names):
        assert [r.get("current_step") for r in got] == [steps // 2, steps], got
        alone = create(name)
        assert server.run_simulation(alone.sim_id, steps=steps)["current_step"] == steps
        for leaf, x in vars(sim.engine_state).items():
            if isinstance(x, torch.Tensor):
                assert torch.equal(x, getattr(alone.engine_state, leaf)), (name, leaf)
        assert float(sim.engine_state.cum_in.sum()) > 0


def link_sharded_butterfly_rank(rank, world, device, steps, seed):
    """One of the ranks of test_link_sharded_rollout_on_cuda."""
    from pednstream_tpu_torch import parallel as par

    args = NetworkEnvGenerator(device=device).scenario_args("butterfly_scC")
    args["params"]["seed"] = 3  # the dataset ships unseeded
    scn = build_scenario(**args, history_window=64, binomial_mode="fast", device=device)
    mesh = par.make_mesh(world, axis="link", device=device)
    block = par.shard_link_state(scn.init_state(8), mesh)
    run = par.make_link_sharded_simulate(scn, mesh, steps, stochastic=True)
    ep = par.shard_link_params(scn.engine_params, mesh)
    before = fused_history_reads.launches["float32"]
    torch.cuda.set_sync_debug_mode("error")  # host trips only inside the exchange
    try:
        final = run(ep, block, torch.Generator(device=device).manual_seed(seed))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    launches = fused_history_reads.launches["float32"] - before
    n_coll, n_bad = par.assert_no_full_ring_collectives(mesh, 8 * scn.H * scn.n_links * 4)
    assert final.cum_in_ring.is_cuda and final.cum_in_ring.shape[-1] == scn.n_links // world
    return {"state": par.unshard_state(final, mesh).to("cpu"), "launches": launches,
            "collectives": n_coll, "host_trips": mesh.host_trips,
            "backend": torch.distributed.get_backend()}


def test_link_sharded_rollout_on_cuda(cuda):
    """butterfly_scC, 8 replicas, 60 fast-stochastic steps link-sharded over
    two ranks on the card (each launching the kernel on its block), bitwise
    equal to the unsharded rollout on the card from the same seed."""
    from pednstream_tpu_torch import parallel as par
    from pednstream_tpu_torch.ops import _build

    steps, seed = 60, 5
    _build.build()  # the ranks only load the library
    args = NetworkEnvGenerator().scenario_args("butterfly_scC")
    args["params"]["seed"] = 3
    scn = build_scenario(**args, history_window=64, binomial_mode="fast", device=cuda)
    assert scn.n_links % 2 == 0
    ref, _ = simulate(scn, scn.engine_params, scn.init_state(8), steps,
                      gen=torch.Generator(device=cuda).manual_seed(seed), stochastic=True,
                      record=False)
    assert float(ref.num_peds.sum()) > 0
    for r in par.spawn_ranks(link_sharded_butterfly_rank, 2, (steps, seed), device="cuda"):
        assert r["launches"] == steps and r["collectives"] == 4 * steps
        for leaf, x in vars(ref).items():
            got = getattr(r["state"], leaf)
            if isinstance(x, torch.Tensor):
                assert torch.equal(x.cpu(), got), leaf
            else:
                assert x == got


def test_train_zoo_export_round_trip_on_cuda(cuda, tmp_path):
    """The zoo pipeline's PPO export from a trainer on the card: the
    checkpoint loads back on the card and on the CPU and both act alike
    (rtol 1e-5); the trainer's own policy gives the same actions."""
    import pickle

    from pednstream_tpu_torch.rl.batched_ppo import BatchedPPOTrainer
    from pednstream_tpu_torch.rl.rl_utils import load_all_agents
    from pednstream_tpu_torch.rl.train import build_agents
    from pednstream_tpu_torch.scripts import train_zoo

    env = PedNetParallelEnv("butterfly_scC", obs_mode="option2", seed=0, action_gap=15,
                            history_window=64, device="cuda")
    tr = BatchedPPOTrainer(env.core, num_envs=16, rollout_len=2, net_type="attention",
                           gate_anchor="open", max_delta=4.0, randomize=True)
    ts, _ = tr.train_iteration(tr.init(0))
    out = tmp_path / "ppo"
    train_zoo._export_ppo(str(out), tr, ts, env, "attention", 1, "butterfly_scC", 16, 2, 15,
                          0.0, [])
    assert sorted(p.name for p in out.iterdir()) == ["config.json", "curve.json", "gate_2.pkl"]
    saved = pickle.load(open(out / "gate_2.pkl", "rb"))
    assert isinstance(saved["actor"]["params"]["Dense_0"]["kernel"], np.ndarray)
    rng = np.random.default_rng(0)
    obs = rng.uniform(0, 4, env.observation_space("gate_2").shape).astype(np.float32)
    acts = []
    for device in ("cuda", "cpu"):
        agents = load_all_agents(build_agents(env, algo="ppo", device=device), str(out))
        a = agents["gate_2"]
        a.reset_hidden()
        acts.append(a.absolute_action(obs, a.take_action(obs, explore=False)))
    np.testing.assert_allclose(acts[0], acts[1], rtol=1e-5, atol=1e-6)


def test_grid_scale_on_cuda(cuda):
    """grid_50x50 (9,800 links) at 16 replicas for a few steps through the
    example's run: one float32 launch per engine step (warm-up and timed
    rollouts), state finite and non-negative, mass conserved."""
    from pednstream_tpu_torch.examples import grid_scale

    before = dict(fused_history_reads.launches)
    r = grid_scale.run("cuda", batch=16, steps=5)
    assert r["scn"].n_links == 9800 and r["final"].cum_in.shape == (16, 9800)
    assert fused_history_reads.launches == {**before, "float32": before["float32"] + 10}
    st = r["final"]
    for name, x in vars(st).items():
        if isinstance(x, torch.Tensor):
            assert x.is_cuda and bool(torch.isfinite(x).all()) and not bool((x < 0).any()), name
    err = (st.cum_in - st.cum_out - st.num_peds).abs().max().item()
    assert err <= 5 * 1.5 * 2.0 ** -23 * max(st.cum_in.abs().max().item(), 1.0)


def test_sweep_row_on_cuda(cuda):
    """One melbourne sweep row, cut short: a warm run and one timed run of
    5 stochastic steps of 64 replicas, one launch per step, the final
    states on the card and mass-conserving."""
    from pednstream_tpu_torch.scripts.sweep_melbourne import measure

    args = NetworkEnvGenerator().scenario_args("melbourne")
    scn = build_scenario(**args, history_window=16, binomial_mode="fast")
    finals = []
    before = fused_history_reads.launches["float32"]
    rate = measure(scn, 64, 5, reps=1, check=finals.append)
    assert rate > 0 and fused_history_reads.launches["float32"] == before + 10
    for final in finals:
        assert final.density.device.type == "cuda" and final.t == 6
        err = (final.cum_in - final.cum_out - final.num_peds).abs().max().item()
        assert err <= 5 * 1.5 * 2.0 ** -23 * max(final.cum_in.abs().max().item(), 1.0)


def test_entry_on_cuda(cuda):
    """``entry()`` with no device: one launch, a step on the card equal to
    ``make_step``'s with a generator of the same seed."""
    from pednstream_tpu_torch.engine import make_step
    from pednstream_tpu_torch.entry import entry

    fn, (state,) = entry(seed=3)
    before = fused_history_reads.launches["float32"]
    got = fn(state)
    assert fused_history_reads.launches["float32"] == before + 1
    scn = NetworkEnvGenerator().create_network("melbourne")
    step = make_step(scn, stochastic=True, gen=torch.Generator(device="cuda").manual_seed(3))
    want, _ = step(scn.engine_params, scn.init_state())
    assert got.t == want.t == 2 and got.num_peds.device.type == "cuda"
    for f in ("num_peds", "cum_in", "cum_out", "avg_tt", "cum_in_ring"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


# --- the hand kernels of the step's hot ops: the fast binomial (csrc/binom.cu)
# and the routed turning fractions (csrc/routing.cu), each bitwise to its
# plain version on the same CUDA operands
_BITS = {torch.float32: torch.int32, torch.float64: torch.int64}


def assert_bits_equal(a, b):
    """Equal bit for bit (``torch.equal`` takes -0.0 for +0.0)."""
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a.contiguous().view(_BITS[a.dtype]), b.contiguous().view(_BITS[b.dtype]))


def binom_operands(shape, p_shape, seed, device):
    """Trial counts 0-40 (a tenth at n = 0, 1, 16, 17), probabilities with
    p = 0, 1 and p near 1 (subnormal pmf terms), uniforms and normals."""
    rng = np.random.default_rng(seed)
    n = rng.integers(0, 40, shape).astype(np.float32)
    flat = n.reshape(-1)
    flat[: flat.size // 10] = np.resize(np.array([0, 1, 16, 17], np.float32), flat.size // 10)
    p = rng.uniform(0.0, 1.0, p_shape).astype(np.float32)
    pf = p.reshape(-1)
    if pf.size > 4:
        pf[:2], pf[2:4] = 0.0, 1.0
        pf[4: 4 + pf.size // 8] = 1.0 - rng.uniform(0, 0.01, pf.size // 8)
    u = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    z = rng.standard_normal(shape).astype(np.float32)
    return [torch.from_numpy(x).to(device) for x in (n, p, u, z)]


@pytest.mark.parametrize("shape,p_shape", [
    ((1024, 938), (1024, 938)),  # the main path: releasing probability per replica
    ((1024, 938), (938,)),  # the activity probability per link
    ((1024, 938), ()),  # the reverse-occupancy scalar
    ((256, 168), (256, 168))])  # the env's links
def test_binom_kernel_equals_plain_bitwise(cuda, shape, p_shape):
    ops_ = binom_operands(shape, p_shape, 3, cuda)
    before = binom_fast.launches["float32"]
    got = binom_fast(*ops_)
    want = binom_fast_plain(*ops_)
    torch.cuda.synchronize()
    assert binom_fast.launches["float32"] == before + 1
    assert_bits_equal(got, want)
    assert bool((got[ops_[0] <= 16] > 0).any())


def test_binom_kernel_rejects_another_broadcast(cuda):
    """A p that does not repeat as a trailing block raises: no copy."""
    with pytest.raises(ValueError, match="trailing block"):
        binom_fast(*binom_operands((7, 33), (7, 1), 3, cuda))


def routing_scenarios(device):
    """Every form of the routing tables a path builds: the env's
    OD-candidate tables (float32 GEMV lanes), melbourne's (the main path,
    4 entries), delft's in float32, float64 and exact parity, a routed
    golden scenario in exact parity (float64, one row per segment), and the
    fan of ``routing_fan`` (softmax groups of six entries)."""
    from pednstream_tpu_torch.golden import fixture_args

    gen = NetworkEnvGenerator()
    out = {"env": (PedNetParallelEnv("45_intersections", od_randomize=True, seed=0,
                                     device=device).scn, 256),
           "melbourne": (build_scenario(**gen.scenario_args("melbourne"), device=device), 1024)}
    for name, kw in (("delft_f32", {}), ("delft_f64", {"ftype": torch.float64}),
                     ("delft_exact", {"ftype": torch.float64, "exact_parity": True})):
        out[name] = (build_scenario(**gen.scenario_args("delft"), **kw, device=device), 16)
    args, _, _ = fixture_args(Path(__file__).parent / "golden" / "grid10.npz")
    out["grid10_exact"] = (build_scenario(**args, ftype=torch.float64, exact_parity=True,
                                          device=device), 1)
    out["fan"] = (fan_scenario(device), 64)
    return out


def routing_operands(scn, B, seed, per_replica_od, device):
    rng = np.random.default_rng(seed)
    E, f = scn.n_links, scn.routing.dist_util.dtype
    dens = torch.from_numpy(rng.uniform(0, 6, (B, E)).astype(np.float32)).to(device)
    recv = torch.from_numpy(np.where(rng.uniform(size=(B, E)) < 0.3, -1.0,
                                     rng.integers(0, 40, (B, E)))).to(device, f)
    cap = torch.from_numpy(rng.uniform(5, 60, (B, E))).to(device, f)
    od = scn.engine_params.od_table[:, scn.engine_params.od_table.shape[1] // 3]
    if per_replica_od:
        scale = torch.from_numpy(rng.uniform(0.0, 2.0, (B, 1))).to(device, od.dtype)
        scale[0] = 0.0
        od = od[None] * scale
    return dens, recv, cap, od


@pytest.fixture(scope="module")
def routed_scenarios():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return routing_scenarios("cuda")


@pytest.mark.parametrize("name", ["env", "melbourne", "delft_f32", "delft_f64", "delft_exact",
                                  "grid10_exact", "fan"])
@pytest.mark.parametrize("per_replica_od", [False, True])
@pytest.mark.parametrize("batch", ["path", 1, LANE_TILE - 1, LANE_TILE, 77, 4127])
def test_routing_kernel_equals_plain_bitwise(cuda, routed_scenarios, name, per_replica_od,
                                             batch):
    """At the path's own batch and at batches that take each design and
    geometry: one replica, one short of a warp (the walk), a warp and a
    ragged 77 (the streamed design: eight warps a block on the env, at
    least two where a unit has the groups), 4127 (two warps a block, a
    ragged last tile); each call counted once, under its design and,
    streamed, under its warps a block (one where a unit has one group, as
    melbourne's)."""
    scn, B = routed_scenarios[name]
    B = B if batch == "path" else batch
    ops_ = routing_operands(scn, B, 5, per_replica_od, cuda)
    key = str(scn.routing.dist_util.dtype).removeprefix("torch.")
    design = "lanes" if B >= LANE_TILE else "rows"
    warps = lane_warps(scn.routing_kernel_tables, B, cuda) if design == "lanes" else None
    if design == "lanes" and name != "grid10_exact":
        assert warps == 1 if name == "melbourne" else warps == 2 if B == 4127 else warps >= 2
    before = (turning_fractions.launches[key], dict(turning_fractions.launches_by_design),
              dict(turning_fractions.launches_by_warps))
    got = turning_fractions(scn, *ops_)
    want = turning_fractions_step_plain(scn, *ops_)
    torch.cuda.synchronize()
    assert turning_fractions.launches[key] == before[0] + 1
    assert turning_fractions.launches_by_design == {**before[1], design: before[1][design] + 1}
    assert turning_fractions.launches_by_warps == (
        before[2] if warps is None else {**before[2], warps: before[2][warps] + 1})
    assert_bits_equal(got, want)


def test_stochastic_main_path_bitwise_with_kernels_and_plain(cuda):
    """melbourne, 1024 replicas, H=16, the fast sampler, 100 stochastic steps
    from one seed: with the kernels (3 binomial and 1 routing launch per
    step) and with the plain versions, every state leaf bit for bit; the
    node solve kernel launches once a step."""
    scn = build_scenario(**NetworkEnvGenerator().scenario_args("melbourne"),
                         history_window=16, binomial_mode="fast", device=cuda)
    finals = []
    for plain in (False, True):
        gen = torch.Generator(device=cuda).manual_seed(7)
        counts = (binom_fast.launches["float32"], turning_fractions.launches["float32"],
                  node_solve.launches["float32"])
        if plain:
            with plain_hot_ops():
                final, _ = simulate(scn, scn.engine_params, scn.init_state(1024), 100, gen=gen,
                                    stochastic=True, record=False)
        else:
            final, _ = simulate(scn, scn.engine_params, scn.init_state(1024), 100, gen=gen,
                                stochastic=True, record=False)
        n_binom = 2 if scn.act_statically_zero else 3
        assert (binom_fast.launches["float32"] - counts[0],
                turning_fractions.launches["float32"] - counts[1],
                node_solve.launches["float32"] - counts[2]) == (
            (0, 0, 0) if plain else (n_binom * 100, 100, 100))
        finals.append(final)
    for name, x in vars(finals[0]).items():
        if isinstance(x, torch.Tensor):
            assert_bits_equal(x, getattr(finals[1], name))


def test_env_episode_bitwise_with_kernels_and_plain(cuda):
    """45_intersections with OD randomization, 256 replicas with randomized
    worlds, 50 RL steps under random actions from one seed: with the routing
    and node solve kernels and with their plain versions, states,
    observations and rewards bit for bit."""
    env = PedNetParallelEnv("45_intersections", od_randomize=True, seed=0, device=cuda)
    core, B = env.core, 256
    runs = []
    for plain in (False, True):
        gen = torch.Generator(device=cuda).manual_seed(5)
        eps = randomize_engine_params_batched(env.scn, gen, B)
        states, _ = core.batch_reset(B)
        bounds = {a: [torch.as_tensor(x, device=cuda) for x in
                      (env.action_space(a).low, env.action_space(a).high)]
                  for a in env.possible_agents}
        before = (turning_fractions.launches["float32"], node_solve.launches["float32"])
        with plain_hot_ops() if plain else nullcontext():
            for _ in range(50):
                acts = {a: lo + (hi - lo) * torch.rand((B,) + lo.shape, generator=gen,
                                                      device=cuda)
                        for a, (lo, hi) in bounds.items()}
                states, obs, rewards, _ = core.batch_step_randomized(states, acts, eps, gen)
        assert (turning_fractions.launches["float32"] - before[0],
                node_solve.launches["float32"] - before[1]) == ((0, 0) if plain else (50, 50))
        runs.append((states, obs, rewards))
    (s0, o0, r0), (s1, o1, r1) = runs
    for name, x in vars(s0).items():
        if isinstance(x, torch.Tensor):
            assert_bits_equal(x, getattr(s1, name))
    for a in env.possible_agents:
        assert_bits_equal(o0[a], o1[a])
        assert_bits_equal(r0[a], r1[a])


# --- the node solve (csrc/node_solve.cu), bitwise to its plain version


@pytest.fixture(scope="module")
def node_scenarios():
    """melbourne (the main path), delft (194 routed nodes) and the env's
    45_intersections with OD candidates, on the card; grid_50x50's 9,800
    links; delft in float32 exact parity (the dense phi in float32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = NetworkEnvGenerator()
    out = {name: build_scenario(**gen.scenario_args(name), history_window=16,
                                binomial_mode="fast", device="cuda")
           for name in ("melbourne", "delft", "grid_50x50")}
    out["delft_f32_exact"] = build_scenario(**gen.scenario_args("delft"), exact_parity=True,
                                            device="cuda")
    out["45_intersections"] = PedNetParallelEnv("45_intersections", od_randomize=True, seed=0,
                                                device="cuda").scn
    return out


def node_operands(scn, B, seed, per_replica_t, device, dense=False):
    """Whole sending and receiving flows with zeros and ties, every in-link
    of a few nodes dry (columns summing to 0), random compact turning
    fractions where routed, in the scenario's flow dtype; the env's
    parameters drawn per replica as its traffic mix draws them (per-replica
    demand and virtual receiving, phi_base an expand); a shared step, or one
    per replica.  Where ``dense``, the exact path's dense phi in place of the
    compact rows: phi_base with random rows at the routed nodes' slots."""
    rng = np.random.default_rng(seed)
    E, f = scn.n_links, scn.ftype
    S = np.floor(rng.uniform(0, 30, (B, E))).astype(np.float32)
    S[rng.uniform(size=S.shape) < 0.3] = 0.0
    dry = scn.node_tables.in_link.cpu().numpy()[rng.integers(0, scn.n_nodes, 8)]
    S[:, dry[dry >= 0]] = 0.0
    R = np.floor(rng.uniform(0, 40, (B, E))).astype(np.float32)
    R[rng.uniform(size=R.shape) < 0.2] = 0.0
    R[rng.uniform(size=R.shape) < 0.2] = 7.0
    ep = scn.engine_params
    if scn.od_randomizable:
        ep = randomize_engine_params_batched(
            scn, torch.Generator(device=device).manual_seed(seed), B)
    phi_c = phi = None
    if scn.routing is not None:
        NR, M = scn.routing.num_routed, scn.max_deg
        phi_c = torch.from_numpy(rng.uniform(0, 1, (B, NR, M, M))).to(device, f)
    if dense:
        phi = ep.phi_base.expand(B, *ep.phi_base.shape[-3:]).clone()
        if phi_c is not None:
            ids = scn.routing.routed_ids
            valid = scn.slot_valid[ids]
            phi[:, ids] = phi_c * (valid[:, :, None] & valid[:, None, :])
        phi_c = None
    t = (torch.from_numpy(rng.integers(1, 500, B).astype(np.int32)).to(device) if per_replica_t
         else int(rng.integers(1, 500)))
    S, R = (torch.from_numpy(x).to(device, f) for x in (S, R))
    return (ep, t, S, R, phi_c) + ((phi,) if dense else ())


def assert_node_solve_is_plain(scn, ops_):
    key = str(ops_[2].dtype).removeprefix("torch.")
    before = dict(node_solve.launches)
    got = node_solve(scn, *ops_)
    want = node_solve_plain(scn, *ops_)
    torch.cuda.synchronize()
    assert node_solve.launches == {**before, key: before[key] + 1}
    for a, b in zip(got, want):
        assert_bits_equal(a, b)


@pytest.mark.parametrize("name", ["melbourne", "delft", "45_intersections"])
@pytest.mark.parametrize("batch", [1, 33, 1024])
@pytest.mark.parametrize("per_replica_t", [False, True])
def test_node_solve_kernel_equals_plain_bitwise(cuda, node_scenarios, name, batch,
                                                per_replica_t):
    """One replica, a ragged 33 and the main path's 1024; the column sums in
    the order of PyTorch's reduction."""
    scn = node_scenarios[name]
    assert_node_solve_is_plain(scn, node_operands(scn, batch, 11, per_replica_t, cuda))


@pytest.mark.parametrize("batch", [1, 16, 512])
def test_node_solve_gathered_design_equals_plain_bitwise(cuda, node_scenarios, batch):
    """grid_50x50: 9,800 links, at the window's one replica and the sweeps'
    512; the rows read in place, as on every network."""
    scn = node_scenarios["grid_50x50"]
    assert_node_solve_is_plain(scn, node_operands(scn, batch, 12, False, cuda))


@pytest.mark.parametrize("name,dense,batch", [
    ("delft_f64", False, 33), ("delft_exact", True, 1), ("delft_exact", True, 33),
    ("grid10_exact", True, 1), ("grid10_exact", True, 6), ("delft_f32_exact", True, 33)])
def test_node_solve_float64_and_exact_parity_equal_plain_bitwise(
        cuda, routed_scenarios, node_scenarios, name, dense, batch):
    """float64 flows on the fast path (the compact rows in float64), and
    exact parity's dense phi, one per replica, with the column sums added
    left to right (``ops.routing.seq_sum``), in float64 (the golden and het
    paths) and float32."""
    scn = node_scenarios[name] if name in node_scenarios else routed_scenarios[name][0]
    assert scn.exact_parity == dense
    assert_node_solve_is_plain(scn, node_operands(scn, batch, 14, False, cuda, dense))


def test_node_solve_raises_on_operands_it_cannot_take(cuda, node_scenarios):
    scn = node_scenarios["melbourne"]
    ep, t, S, R, phi_c = node_operands(scn, 2, 13, False, cuda)
    with pytest.raises(TypeError, match="one flow dtype"):
        node_solve(scn, ep.replace(virt_recv=ep.virt_recv.double()), t, S, R, phi_c)
    with pytest.raises(TypeError, match="float32 or float64"):
        node_solve(scn, ep, t, S.half(), R.half(), phi_c)
    with pytest.raises(ValueError, match="links"):
        node_solve(scn, ep, t, S[:, :-1], R[:, :-1], phi_c)


def test_delft_rollout_bitwise_with_kernels_and_plain(cuda, node_scenarios):
    """delft, 64 replicas, 20 stochastic fast-path steps from one seed: with
    the kernels (one node solve launch a step) and with the plain versions,
    every state leaf bit for bit."""
    scn = node_scenarios["delft"]
    finals = []
    for plain in (False, True):
        gen = torch.Generator(device=cuda).manual_seed(9)
        before = node_solve.launches["float32"]
        with plain_hot_ops() if plain else nullcontext():
            final, _ = simulate(scn, scn.engine_params, scn.init_state(64), 20, gen=gen,
                                stochastic=True, record=False)
        assert node_solve.launches["float32"] - before == (0 if plain else 20)
        finals.append(final)
    for name, x in vars(finals[0]).items():
        if isinstance(x, torch.Tensor):
            assert_bits_equal(x, getattr(finals[1], name))


def test_exact_parity_rollout_bitwise_with_kernels_and_plain(cuda, routed_scenarios):
    """delft in float64 exact parity, 8 replicas, 20 deterministic steps:
    with the kernels (one float64 node solve launch a step, on the dense
    phi) and with the plain versions, every state leaf bit for bit."""
    scn = routed_scenarios["delft_exact"][0]
    finals = []
    for plain in (False, True):
        before = node_solve.launches["float64"]
        with plain_hot_ops() if plain else nullcontext():
            final, _ = simulate(scn, scn.engine_params, scn.init_state(8), 20, record=False)
        assert node_solve.launches["float64"] - before == (0 if plain else 20)
        finals.append(final)
    for name, x in vars(finals[0]).items():
        if isinstance(x, torch.Tensor):
            assert_bits_equal(x, getattr(finals[1], name))
