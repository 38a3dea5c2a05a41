"""What the port's two hand kernels for the step's hot ops compute, on the
CPU: the fast binomial sampler (``ops.binom``, ``csrc/binom.cu``) and the
routed turning fractions (``ops.routing``, ``csrc/routing.cu``).

On CPU tensors both wrappers run their plain versions, so here:

- the plain fast binomial is held bit for bit to the JAX package's fast
  sampler under ``jax.jit``, fed the uniforms and normals that sampler
  draws from its key (edge cases: n = 0, 1, 16, 17, p = 0, 1, u on a cdf
  step);
- the kernel's two designs are written out in torch and held bit for bit
  to the plain version on the delft and 45_intersections tables in every
  table form (float32 GEMV lanes, float64 lanes, exact parity) with shared
  and per-replica od flows: the walk of the routing tables -- one block
  per (routed node, replica) reading its node's ranges through
  ``node_offsets``, each (segment, lane) walked to its first -1, the lanes
  combined in XLA's order (:func:`kernel_walk`) -- and the streamed design
  -- each routed node's up slot on its own, its groups and entries in
  ascending id through the ``lane_*`` codes into per-(segment, GEMV lane)
  accumulators (:func:`kernel_stream`);
- the dense turning fractions, now the compact rows placed at
  ``routed_ids``, are held to the JAX exact path on a routed golden
  scenario;
- both dispatch points (``ops.binom_fast``, ``routing.
  turning_fractions_step``) take the plain version for CPU tensors and
  count no launch; the routing kernel's launcher refuses them.

The card tests (``tests/test_torch_cuda.py``) hold the kernels to these
plain versions on the card.
"""

import contextlib
import copy
from functools import partial
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pednstream_tpu.engine import _binom as jax_binom
from pednstream_tpu.routing import turning_fractions_step as jax_turning
from pednstream_tpu.scenario import build_scenario as jax_build
from pednstream_tpu_torch import engine, generator, ops
from pednstream_tpu_torch.golden import fixture_args
from pednstream_tpu_torch.ops.binom import binom_fast_plain
from pednstream_tpu_torch.routing import (NODE_TABLES, exp_like_xla, turning_fractions_dense,
                                          turning_fractions_step,
                                          turning_fractions_step_plain)
from pednstream_tpu_torch.scenario import build_scenario

NetworkEnvGenerator = partial(generator.NetworkEnvGenerator, device="cpu")
torch_build = partial(build_scenario, device="cpu")

torch.set_num_threads(1)

_BITS = {torch.float32: torch.int32, torch.float64: torch.int64}


@pytest.fixture(autouse=True)
def float32_jax():
    """Another test file in the same worker may have switched JAX to
    float64 for the whole worker process; the sampler is float32."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def assert_bits_equal(a, b):
    """Equal bit for bit (``torch.equal`` takes -0.0 for +0.0)."""
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a.contiguous().view(_BITS[a.dtype]), b.contiguous().view(_BITS[b.dtype]))


# ---------------------------------------------------------------------------
# the fast binomial
# ---------------------------------------------------------------------------

def _sampler_inputs(seed, shape):
    """Trial counts and probabilities with the edge cases, the JAX key, and
    the uniforms and normals the JAX fast sampler draws from it
    (``pednstream_tpu/engine.py:132-148``: split, uniform, normal)."""
    rng = np.random.default_rng(seed)
    n = rng.integers(0, 40, shape).astype(np.float32)
    p = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    flat_n, flat_p = n.reshape(-1), p.reshape(-1)
    edges = np.array([0, 1, 16, 17], dtype=np.float32)
    flat_n[:400] = np.repeat(edges, 100)
    flat_p[:50] = 0.0
    flat_p[50:100] = 1.0
    flat_p[400:500] = 0.0
    flat_p[500:600] = 1.0
    key = jax.random.PRNGKey(seed)
    k1, k2 = jax.random.split(key)
    u = np.array(jax.random.uniform(k1, shape, dtype=jnp.float32))
    z = np.array(jax.random.normal(k2, shape, dtype=jnp.float32))
    # u on a cdf step: n = 1 and 1 - p = u exactly, so u == P[X <= 0]
    step = np.flatnonzero(u.reshape(-1)[600:] >= 0.5)[:200] + 600
    flat_n[step] = 1.0
    flat_p[step] = np.float32(1.0) - u.reshape(-1)[step]
    assert np.all(np.float32(1.0) - flat_p[step] == u.reshape(-1)[step])
    return n, p, key, u, z


@pytest.mark.parametrize("shape", [(20_000,), (16, 1500)])
def test_binom_fast_bitwise_to_the_jax_fast_sampler(shape):
    """The plain fast binomial fed the JAX sampler's uniforms and normals
    returns the JAX sampler's samples bit for bit, the pmf recursion's
    division by ``k + 1`` a multiply by the float32 reciprocal as XLA
    compiles it (its HLO has one divide, the odds ratio)."""
    n, p, key, u, z = _sampler_inputs(5, shape)
    want = np.asarray(jax.jit(lambda k, n, p: jax_binom(k, n, p, True, "fast"))(
        key, jnp.asarray(n), jnp.asarray(p)))
    got = engine.binom_fast(*(torch.from_numpy(x) for x in (n, p, u, z)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.any(want[n <= 16] > 0) and np.any(n > 16)


@pytest.mark.parametrize("form", ["per link", "scalar"])
def test_binom_fast_broadcast_p_bitwise_to_jax(form):
    """``p`` broadcast as the step passes it: an activity probability per
    link against [B, E] counts, the reverse-occupancy scalar."""
    n, _, key, u, z = _sampler_inputs(6, (8, 700))
    rng = np.random.default_rng(6)
    p = (rng.uniform(0.0, 1.0, (700,)) if form == "per link" else np.array(0.9)).astype(
        np.float32)
    want = np.asarray(jax.jit(lambda k, n, p: jax_binom(k, n, p, True, "fast"))(
        key, jnp.asarray(n), jnp.asarray(p)))
    got = engine.binom_fast(*(torch.from_numpy(x) for x in (n, p, u, z)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_binom_wrapper_takes_the_plain_version_on_the_cpu():
    n, p, _, u, z = _sampler_inputs(7, (3000,))
    before = dict(ops.binom_fast.launches)
    args = [torch.from_numpy(x) for x in (n, p, u, z)]
    assert_bits_equal(ops.binom_fast(*args), binom_fast_plain(*args))
    assert engine.binom_fast is ops.binom_fast
    assert ops.binom_fast.launches == before == {"float32": 0}


# ---------------------------------------------------------------------------
# the routed turning fractions
# ---------------------------------------------------------------------------

def kernel_walk(rt, M, density, recv_prev, cap_default, od_flow_t):
    """``csrc/routing.cu`` written out in torch: for each routed node r (a
    block, all replicas at once) its ranges of the tables from
    ``node_offsets``, its values staged as node-local vectors, every
    (segment, lane) walked left to right to its first -1 (+0.0 added once
    when the row is shorter than the table), the lanes combined, then the
    guard with its row sum left to right."""
    f = rt.dist_util.dtype
    B, Q = density.shape[0], rt.group_members.shape[1]
    MM = M * M
    od = od_flow_t.to(f)
    od = od.expand(B, -1) if od.dim() == 1 else od
    dens_all, rp_all, cd_all = density.to(torch.float32), recv_prev.to(f), cap_default.to(f)
    out = torch.empty((B, rt.num_routed, M, M), dtype=f)

    def sums(members, s0, count, id0, vals):
        rows = members[s0:s0 + count]  # [S, Q, L]
        L = rows.shape[-1]
        live = (rows >= 0).to(torch.int64).cumprod(-1).bool()  # up to the first -1
        acc = torch.zeros((B,) + rows.shape[:2], dtype=f)
        for c in range(L):
            v = vals[:, (rows[..., c] - id0).clamp(min=0)]
            acc = torch.where(live[..., c], v if c == 0 else acc + v, acc)
        n = live.sum(-1)
        acc = torch.where((n > 0) & (n < L), acc + 0.0, acc)
        lane = acc.unbind(-1)
        if Q == 5:
            return ((lane[0] + lane[2]) + (lane[1] + lane[3])) + lane[4]
        if Q == 3:
            return (lane[0] + lane[1]) + lane[2]
        return lane[0]

    off = rt.node_offsets.tolist()
    for r in range(rt.num_routed):
        (k0, g0, u0, ug0), (k1, g1, u1, ug1) = off[r], off[r + 1]
        w = od[:, rt.uo_od[u0:u1]]
        link = rt.te_down_link[k0:k1]
        real, safe = link >= 0, link.clamp(min=0)
        rp = rp_all[:, safe]
        cap = torch.where(real, torch.where(rp >= 0, rp, cd_all[:, safe]), 100.0)
        dens = torch.where(real, dens_all[:, safe], 0.0)
        bn = (rt.beta * (torch.clamp(dens - 2.0, min=0.0) / 8.0)).to(f)

        tot = sums(rt.uo_group_members, ug0, ug1 - ug0, u0, w)[:, rt.uo_group[u0:u1] - ug0]
        p_uo = torch.where(tot > 0, w / torch.where(tot > 0, tot, 1.0),
                           rt.uo_inv_count[u0:u1])
        grp = rt.te_group[k0:k1] - g0
        cap_sum = sums(rt.group_members, g0, g1 - g0, k0, cap)[:, grp]
        util = (rt.dist_util[k0:k1] + bn) - (rt.omega * cap) / (cap_sum + 1e-6)
        z = exp_like_xla(-rt.temp * util)
        zsum = sums(rt.group_members, g0, g1 - g0, k0, z)[:, grp]
        contrib = (z / zsum) * p_uo[:, rt.te_uo_idx[k0:k1] - u0]

        phi = sums(rt.phi_c_members, r * MM, MM, k0, contrib).reshape(B, M, M)
        rowsum = phi[..., 0]
        for j in range(1, M):
            rowsum = rowsum + phi[..., j]
        rowsum = rowsum.unsqueeze(-1)
        need, pos = torch.abs(rowsum - 1.0) > 1e-3, rowsum > 1e-6
        out[:, r] = torch.where(need & pos, phi / rowsum,
                                torch.where(need, rt.offdiag_uniform[r], phi))
    return out


def kernel_stream(rt, M, density, recv_prev, cap_default, od_flow_t):
    """``csrc/routing.cu``'s streamed design written out in torch, every
    replica at once: for each unit (a routed node's up slot) its down
    slots' capacity and density terms; its groups' od flows in ascending
    id into the (node, up) sum's accumulator of their GEMV row; then group
    by group in ascending id the capacity sums, z and its sums, and each
    entry's share into the accumulator of its phi slot and GEMV row, every
    accumulator starting at -0.0 and adding +0.0 once where its row is
    shorter than the table (the codes' short bits); the rows combined in
    XLA's order; the guard of the unit's row."""
    f = rt.dist_util.dtype
    B, Q = density.shape[0], rt.group_members.shape[1]
    od = od_flow_t.to(f)
    od = od.expand(B, -1) if od.dim() == 1 else od
    dens_all, rp_all, cd_all = density.to(torch.float32), recv_prev.to(f), cap_default.to(f)
    out = torch.empty((B, rt.num_routed, M, M), dtype=f)
    entry, group, unit = rt.lane_entry.tolist(), rt.lane_group.tolist(), rt.lane_unit.tolist()
    dist_util = rt.lane_dist_util

    def fresh(n):
        return [torch.full((B,), -0.0, dtype=f) for _ in range(n)]

    def rows_sum(rows, short):
        lane = [v + 0.0 if short >> q & 1 else v for q, v in enumerate(rows)]
        if Q == 5:
            return ((lane[0] + lane[2]) + (lane[1] + lane[3])) + lane[4]
        if Q == 3:
            return (lane[0] + lane[1]) + lane[2]
        return lane[0]

    for r in range(rt.num_routed):
        link = rt.lane_down_link[r].long()
        real, safe = link >= 0, link.clamp(min=0)
        rp = rp_all[:, safe]
        cap = torch.where(real, torch.where(rp >= 0, rp, cd_all[:, safe]), 100.0)
        dens = torch.where(real, dens_all[:, safe], 0.0)
        bn = (rt.beta * (torch.clamp(dens - 2.0, min=0.0) / 8.0)).to(f)
        for u in range(M):
            (g0, k, ug), (g1, _, _) = unit[r * M + u], unit[r * M + u + 1]
            acc = fresh(Q)
            for p, code, _, _ in group[g0:g1]:
                acc[code >> 8 & 7] = acc[code >> 8 & 7] + od[:, p]
            tot = rows_sum(acc, rt.lane_uo_short[ug].item()) if ug >= 0 else None
            inv = torch.tensor(1.0, dtype=f) / (g1 - g0)
            phi = fresh(M * Q)
            for p, code, owners, _ in group[g0:g1]:
                n, short = code & 255, code >> 11
                codes = [(e & 31, e >> 5 & 7) for e in entry[k:k + n]]
                # the warps that own an accumulator of the group work it
                assert owners & 0xFFFFFFFF == sum({1 << (d * Q + q) % 32 for d, q in codes})
                pu = torch.where(tot > 0, od[:, p] / torch.where(tot > 0, tot, 1.0), inv)
                acc = fresh(Q)
                for d, lane in codes:
                    acc[lane] = acc[lane] + cap[:, d]
                cap_sum = rows_sum(acc, short) + 1e-6
                acc, z = fresh(Q), []
                for i, (d, lane) in enumerate(codes):
                    util = (dist_util[k + i] + bn[:, d]) - (rt.omega * cap[:, d]) / cap_sum
                    z.append(exp_like_xla(-rt.temp * util))
                    acc[lane] = acc[lane] + z[-1]
                zsum = rows_sum(acc, short)
                for zi, (d, lane) in zip(z, codes):
                    phi[d * Q + lane] = phi[d * Q + lane] + (zi / zsum) * pu
                k += n
            row = torch.stack([rows_sum(phi[d * Q:(d + 1) * Q],
                                        rt.lane_phi_short[(r * M + u) * M + d].item())
                               for d in range(M)], -1)
            rowsum = row[:, :1]
            for j in range(1, M):
                rowsum = rowsum + row[:, j:j + 1]
            need, pos = torch.abs(rowsum - 1.0) > 1e-3, rowsum > 1e-6
            out[:, r, u] = torch.where(need & pos, row / rowsum,
                                       torch.where(need, rt.offdiag_uniform[r, u], row))
    return out


KERNEL_MODELS = {"walk": kernel_walk, "stream": kernel_stream}


@pytest.fixture(scope="module")
def env_tables():
    """The 45_intersections env's OD-candidate tables (K = 18,616 turn
    entries, 43 routed nodes, (node, up) groups of up to 301 members)."""
    from pednstream_tpu_torch.env import PedNetParallelEnv

    return PedNetParallelEnv("45_intersections", od_randomize=True, seed=0,
                             device="cpu").scn


_DELFT = {}


def delft(ftype, exact):
    key = (ftype, exact)
    if key not in _DELFT:
        args = NetworkEnvGenerator().scenario_args("delft")
        _DELFT[key] = torch_build(**args, ftype=ftype, exact_parity=exact)
    return _DELFT[key]


def routing_operands(scn, B, seed, per_replica_od):
    """Random congestion on the scenario's links (a third of the receiving
    flows unset), its od flows at a mid-run step (some replicas with no
    flow: the 1/count share)."""
    rng = np.random.default_rng(seed)
    E, f = scn.n_links, scn.routing.dist_util.dtype
    dens = torch.from_numpy(rng.uniform(0, 6, (B, E)).astype(np.float32))
    recv = torch.from_numpy(np.where(rng.uniform(size=(B, E)) < 0.3, -1.0,
                                     rng.integers(0, 40, (B, E)))).to(f)
    cap = torch.from_numpy(rng.uniform(5, 60, (B, E))).to(f)
    od = scn.engine_params.od_table[:, scn.engine_params.od_table.shape[1] // 3]
    if per_replica_od:
        scale = torch.from_numpy(rng.uniform(0.0, 2.0, (B, 1))).to(od.dtype)
        scale[0] = 0.0
        od = od[None] * scale
    return dens, recv, cap, od


def check_node_offsets(rt, M):
    """Each routed node's ranges hold its own rows and nothing else."""
    off = rt.node_offsets
    assert tuple(off.shape) == (rt.num_routed + 1, len(NODE_TABLES))
    assert off[-1].tolist() == [rt.num_entries, rt.num_groups, len(rt.uo_od),
                                rt.num_uo_groups]
    assert tuple(rt.node_max) == tuple(torch.diff(off, dim=0).amax(dim=0).tolist())
    node = torch.repeat_interleave(torch.arange(rt.num_routed), torch.diff(off[:, 0]))
    assert torch.equal(node, rt.te_phi_c // (M * M))
    for col, ids in ((1, rt.te_group), (2, rt.te_uo_idx)):
        start, end = off[node, col], off[node + 1, col]
        assert bool(((ids >= start) & (ids < end)).all())
    uo_node = torch.repeat_interleave(torch.arange(rt.num_routed), torch.diff(off[:, 2]))
    start, end = off[uo_node, 3], off[uo_node + 1, 3]
    assert bool(((rt.uo_group >= start) & (rt.uo_group < end)).all())


@pytest.mark.parametrize("model", KERNEL_MODELS)
@pytest.mark.parametrize("per_replica_od", [False, True])
def test_kernel_walk_is_the_plain_version_on_env_tables(env_tables, per_replica_od, model):
    scn = env_tables
    rt, M = scn.routing, scn.max_deg
    assert rt.group_members.shape[1] == 5 and rt.num_routed == 43
    check_node_offsets(rt, M)
    ops_ = routing_operands(scn, 3, 11, per_replica_od)
    assert_bits_equal(KERNEL_MODELS[model](rt, M, *ops_),
                      turning_fractions_step_plain(rt, M, *ops_))


@pytest.mark.parametrize("model", KERNEL_MODELS)
@pytest.mark.parametrize("ftype,exact,Q", [(torch.float32, False, 5),
                                           (torch.float64, False, 3),
                                           (torch.float64, True, 1)])
def test_kernel_walk_is_the_plain_version_on_delft_tables(ftype, exact, Q, model):
    scn = delft(ftype, exact)
    rt, M = scn.routing, scn.max_deg
    assert rt.group_members.shape[1] == Q and rt.dist_util.dtype == ftype
    check_node_offsets(rt, M)
    for per_replica_od in (False, True):
        ops_ = routing_operands(scn, 4, 12, per_replica_od)
        assert_bits_equal(KERNEL_MODELS[model](rt, M, *ops_),
                          turning_fractions_step_plain(rt, M, *ops_))


def test_routing_wrapper_takes_the_plain_version_on_the_cpu():
    scn = delft(torch.float32, False)
    ops_ = routing_operands(scn, 2, 13, False)
    before = dict(ops.turning_fractions.launches)
    got = turning_fractions_step(scn.routing, scn.max_deg, *ops_)
    assert_bits_equal(got, turning_fractions_step_plain(scn.routing, scn.max_deg, *ops_))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.turning_fractions(scn.routing, scn.max_deg, *ops_)
    assert ops.turning_fractions.launches == before == {"float32": 0, "float64": 0}


def test_dense_placement_is_the_jax_exact_path():
    """grid10 (a routed golden scenario) on the exact-parity tables (one
    left-to-right row per segment): the port's dense turning fractions --
    the compact rows placed at ``routed_ids`` over ``phi_base`` -- equal
    JAX's ``turning_fractions_step(exact=True)`` (every slot summed, every
    node guarded, ``phi_base`` kept off the routed nodes) bit for bit, on
    random congestion with and without od flow.  In float32, where both
    packages take XLA's exp: in float64 the JAX package's exp is XLA's own
    and differs from torch's and NumPy's (the reference's, which the golden
    fixtures hold) by an ulp on ~15 % of arguments (ROADMAP.md §3)."""
    args, _, _ = fixture_args(Path(__file__).parent / "golden" / "grid10.npz")
    js = jax_build(**copy.deepcopy(args), ftype=jnp.float32, exact_parity=True)
    ts = torch_build(**copy.deepcopy(args), ftype=torch.float32, exact_parity=True)
    assert ts.routing is not None and ts.routing.group_members.shape[1] == 1
    assert 0 < ts.routing.num_routed < ts.n_nodes
    jt = jax.jit(lambda d, r, c, o, pb: jax_turning(
        js.routing, js.n_nodes, js.max_deg, js.node_arity, js.slot_valid, d, r, c, o, pb,
        exact=True))
    for scale, seed in ((1.0, 21), (0.0, 22)):
        dens, recv, cap, od = routing_operands(ts, 1, seed, False)
        od = od * scale
        want = np.asarray(jt(*(jnp.asarray(x[0].numpy()) for x in (dens, recv, cap)),
                             jnp.asarray(od.numpy()), jnp.asarray(js.engine_params.phi_base)))
        phi_c = turning_fractions_step(ts.routing, ts.max_deg, dens, recv, cap, od)
        got = turning_fractions_dense(ts.routing, phi_c, ts.engine_params.phi_base)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got[0].numpy(), want)


def test_plain_hot_ops_swaps_and_restores():
    """``profiling.plain_hot_ops`` routes the step's two hot ops to their
    plain versions while entered (the card's 'before' in one process) and
    puts the wrappers back; on the CPU both give the same step."""
    from pednstream_tpu_torch.profiling import plain_hot_ops

    wrappers = (engine.binom_fast, engine.turning_fractions_step)
    scn = torch_build(**NetworkEnvGenerator().scenario_args("melbourne"), history_window=16,
                      binomial_mode="fast")
    finals = []
    for plain in (False, True):
        gen = torch.Generator().manual_seed(3)
        with plain_hot_ops() if plain else contextlib.nullcontext():
            if plain:
                assert engine.binom_fast is binom_fast_plain
                assert engine.turning_fractions_step is turning_fractions_step_plain
            finals.append(engine.simulate_batched(scn, scn.engine_params, scn.init_state(3), 4,
                                                  gen=gen, stochastic=True))
    assert (engine.binom_fast, engine.turning_fractions_step) == wrappers
    for name, x in vars(finals[0]).items():
        if isinstance(x, torch.Tensor):
            assert_bits_equal(x, getattr(finals[1], name))
