"""The port on the card: the CUDA kernels of fused_history_reads (float32
and float64, the lookback folded in) against their plain version at every
path's shape, with shared, per-replica and broadcast per-link operands and
with a shared and a per-replica step ``t``; a batch of replicas at
different times stepped on the card against the CPU;
an entry point called with no device; engine rollouts on cuda against the
CPU, a golden fixture in exact-parity mode, a short randomized env
episode, the network families on the card against the CPU and one batched
PPO iteration.  Every test here needs a GPU, skips without one (decided in
the ``cuda`` fixture), and is marked ``slow``, so the default tiers leave it
out.  The file imports no JAX (nor does it need tests/conftest.py), so on
a machine with a card it runs as

    python -m pytest --noconftest -p no:cacheprovider -m slow tests/test_torch_cuda.py
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from pednstream_tpu_torch import NetworkEnvGenerator, build_scenario, concat_states, simulate
from pednstream_tpu_torch.env import PedNetParallelEnv
from pednstream_tpu_torch.golden import FIELDS, TOL, golden_errors
from pednstream_tpu_torch.ops import (PER_REPLICA_T, fused_history_reads,
                                      fused_history_reads_plain)
from pednstream_tpu_torch.randomize import randomize_engine_params_batched

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
# the PPO and SAC trainers' (256 and 64 replicas, H=64, 168 links)
@pytest.mark.parametrize("B,H,E", [(1, 16, 1), (5, 17, 1000), (2, 64, 4097), (1024, 16, 938),
                                   (256, 701, 168), (256, 64, 168), (64, 64, 168)])
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
    before = fused_history_reads.launches["float64"]
    errors, _, T = golden_errors(Path(__file__).parent / "golden" / "butterfly.npz", cuda)
    assert fused_history_reads.launches["float64"] - before == T - 1
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
