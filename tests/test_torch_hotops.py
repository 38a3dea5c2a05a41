"""What the port's three hand kernels for the step's hot ops compute, on
the CPU: the fast binomial sampler (``ops.binom``, ``csrc/binom.cu``), the
routed turning fractions (``ops.routing``, ``csrc/routing.cu``) and the node
solve (``ops.node_solve``, ``csrc/node_solve.cu``).

On CPU tensors the wrappers run their plain versions, so here:

- the plain fast binomial is held bit for bit to the JAX package's fast
  sampler under ``jax.jit``, fed the uniforms and normals that sampler
  draws from its key (edge cases: n = 0, 1, 16, 17, p = 0, 1, u on a cdf
  step);
- the kernel's two designs are written out in torch and held bit for bit
  to the plain version on the delft and 45_intersections tables in every
  table form (float32 GEMV lanes, float64 lanes, exact parity) with shared
  and per-replica od flows: the walk of the routing tables -- one block
  per (routed node, replica) reading its node's ranges through the kernel
  tables' ``node_offsets``, each (segment, lane) walked to its first -1,
  the lanes combined in XLA's order (:func:`kernel_walk`) -- and the
  streamed design -- each routed node's up slot on its own, its groups and
  entries in ascending id through the kernel tables' ``lane_*`` codes into
  per-(segment, GEMV lane) accumulators (:func:`kernel_stream`);
- the dense turning fractions, now the compact rows placed at
  ``routed_ids``, are held to the JAX exact path on a routed golden
  scenario;
- both dispatch points (``ops.binom_fast``, ``ops.turning_fractions``)
  take the plain version for CPU tensors and count no launch;
- the node solve's static tables (each link's (node, slot) on both ends,
  the routed rows, the flags, the order) are checked against the
  topology; its kernel's walk over them is written out in numpy and held
  bit for bit to the plain version where the column sums are exact; the
  plain version is the step's node solve as the benchmark's frozen copy
  has it; the wrapper takes it for CPU tensors and counts no launch; the
  argument block reads each path's operands by their strides; and the
  benchmark's bound (``portbench/bounds/node_solve.py``) counts a small
  network's bytes as worked out by hand;
- no module under ``ops/`` imports the engine or a step function of the
  host compiler (``routing.py``), and ``routing.py`` imports nothing from
  ``ops/``.

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
from pednstream_tpu_torch.ops.routing import (LANE_CHUNK, NODE_TABLES, exp_like_xla,
                                              turning_fractions, turning_fractions_dense,
                                              turning_fractions_step_plain)
from pednstream_tpu_torch.scenario import build_scenario
from routing_fan import fan_scenario

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

def kernel_walk(scn, density, recv_prev, cap_default, od_flow_t):
    """``csrc/routing.cu`` written out in torch: for each routed node r (a
    block, all replicas at once) its ranges of the tables from
    ``node_offsets``, its values staged as node-local vectors, every
    (segment, lane) walked left to right to its first -1 (+0.0 added once
    when the row is shorter than the table), the lanes combined, then the
    guard with its row sum left to right."""
    rt, M = scn.routing, scn.max_deg
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

    off = scn.routing_kernel_tables.node_offsets.tolist()
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


def kernel_stream(scn, density, recv_prev, cap_default, od_flow_t):
    """``csrc/routing.cu``'s streamed design written out in torch, every
    replica at once: for each unit (a routed node's up slot) its down
    slots' capacity and density terms; its groups' od flows in ascending
    id into the (node, up) sum's accumulator of their GEMV row; then group
    by group in ascending id the capacity sums, z and its sums, and each
    entry's share into the accumulator of its phi slot and GEMV row, every
    accumulator starting at -0.0 and adding +0.0 once where its row is
    shorter than the table (the codes' short bits); the rows combined in
    XLA's order; the guard of the unit's row."""
    rt, tabs, M = scn.routing, scn.routing_kernel_tables, scn.max_deg
    f = rt.dist_util.dtype
    B, Q = density.shape[0], rt.group_members.shape[1]
    od = od_flow_t.to(f)
    od = od.expand(B, -1) if od.dim() == 1 else od
    dens_all, rp_all, cd_all = density.to(torch.float32), recv_prev.to(f), cap_default.to(f)
    out = torch.empty((B, rt.num_routed, M, M), dtype=f)
    entry, group, unit = (tabs.lane_entry.tolist(), tabs.lane_group.tolist(),
                          tabs.lane_unit.tolist())
    dist_util = tabs.lane_dist_util

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
        link = tabs.lane_down_link[r].long()
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
            tot = rows_sum(acc, tabs.lane_uo_short[ug].item()) if ug >= 0 else None
            inv = torch.tensor(1.0, dtype=f) / (g1 - g0)
            phi = fresh(M * Q)
            k_unit = k
            for p, code, first, packed in group[g0:g1]:
                n, short = code & 255, code >> 11 & 31
                codes = [(e & 31, e >> 5 & 7) for e in entry[k:k + n]]
                check_plan(codes, code, packed, Q)
                assert first == k - k_unit
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
                                        tabs.lane_phi_short[(r * M + u) * M + d].item())
                               for d in range(M)], -1)
            rowsum = row[:, :1]
            for j in range(1, M):
                rowsum = rowsum + row[:, j:j + 1]
            need, pos = torch.abs(rowsum - 1.0) > 1e-3, rowsum > 1e-6
            out[:, r, u] = torch.where(need & pos, row / rowsum,
                                       torch.where(need, rt.offdiag_uniform[r, u], row))
    return out


def plan_of(code, packed):
    """A group's sum plan from its record: its entries as (down slot,
    place in the group) in the order its sums take them, ``balanced``, and
    the zero its sums end with."""
    n = code & 255
    order = [(packed >> 8 * i & 31, packed >> 8 * i + 5 & 3) for i in range(n)]
    return order, bool(code >> 16 & 1), 0.0 if code >> 17 & 1 else -0.0


def plan_sum(vals, balanced, zero):
    """``csrc/routing.cu``'s ``plan_sum``: the values in their plan's order."""
    s = vals[0]
    if len(vals) == 2:
        s = vals[0] + vals[1]
    elif len(vals) == 3:
        s = (vals[0] + vals[1]) + vals[2]
    elif len(vals) == 4:
        s = (((vals[0] + vals[1]) + (vals[2] + vals[3])) if balanced
             else ((vals[0] + vals[1]) + vals[2]) + vals[3])
    return s + zero


_PLANS_CHECKED = set()


def check_plan(codes, code, packed, Q):
    """A group of at most four entries carries each entry's down slot and
    place, a permutation of its entries; the plan's bits are 0 on a longer
    group; a plan takes every member once, and on random values (signed
    zeros among them) sums to what the Q row accumulators give."""
    n = code & 255
    if n > 4:
        assert packed == 0 and code >> 16 == 0
        return
    order, balanced, zero = plan_of(code, packed)
    assert sorted(at for _, at in order) == list(range(n))
    assert all(codes[at][0] == d for d, at in order)
    key = (tuple(q for _, q in codes), code, tuple(at for _, at in order), Q)
    if key in _PLANS_CHECKED:
        return
    _PLANS_CHECKED.add(key)
    rng = np.random.default_rng(n)
    for vals in (rng.normal(size=(64, n)), np.where(rng.uniform(size=(64, n)) < 0.5, -0.0, 0.0),
                 np.full((64, n), -0.0)):
        vals = torch.from_numpy(vals).float()
        acc = [torch.full((64,), -0.0) for _ in range(Q)]
        for i, (_, q) in enumerate(codes):
            acc[q] = acc[q] + vals[:, i]
        lane = [v + 0.0 if code >> 11 + q & 1 else v for q, v in enumerate(acc)]
        want = (((lane[0] + lane[2]) + (lane[1] + lane[3])) + lane[4] if Q == 5
                else (lane[0] + lane[1]) + lane[2] if Q == 3 else lane[0])
        got = plan_sum([vals[:, at] for _, at in order], balanced, zero)
        assert_bits_equal(got, want)


def kernel_chunked(scn, density, recv_prev, cap_default, od_flow_t, warps=4):
    """``csrc/routing.cu``'s streamed design as its block of ``warps``
    warps works a unit, every replica at once: the unit's down slots'
    terms; the (node, up) sum, each warp adding the groups of its GEMV rows
    (q % W == w); then chunk by chunk of the unit's groups (those that end
    within ``LANE_CHUNK`` entries of the chunk's first), each warp working
    the groups w, w + W, ... on its own (a group of at most four entries
    by its record's plan, a longer one through row accumulators) and
    writing each entry's contribution to the chunk's buffer at its entry,
    then each warp adding the buffer's entries of its accumulators
    (s % W == w) into phi in ascending id; the guard of the unit's row."""
    rt, tabs, M = scn.routing, scn.routing_kernel_tables, scn.max_deg
    f = rt.dist_util.dtype
    B, Q = density.shape[0], rt.group_members.shape[1]
    od = od_flow_t.to(f)
    od = od.expand(B, -1) if od.dim() == 1 else od
    dens_all, rp_all, cd_all = density.to(torch.float32), recv_prev.to(f), cap_default.to(f)
    out = torch.empty((B, rt.num_routed, M, M), dtype=f)
    entry, group, unit = (tabs.lane_entry.tolist(), tabs.lane_group.tolist(),
                          tabs.lane_unit.tolist())
    dist_util = tabs.lane_dist_util

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
        link = tabs.lane_down_link[r].long()
        real, safe = link >= 0, link.clamp(min=0)
        rp = rp_all[:, safe]
        cap = torch.where(real, torch.where(rp >= 0, rp, cd_all[:, safe]), 100.0)
        dens = torch.where(real, dens_all[:, safe], 0.0)
        bn = (rt.beta * (torch.clamp(dens - 2.0, min=0.0) / 8.0)).to(f)
        for u in range(M):
            (g0, k_unit, ug), (g1, _, _) = unit[r * M + u], unit[r * M + u + 1]
            tot_rows = [None] * Q
            for w in range(warps):
                acc = fresh(Q)
                for p, code, _, _ in group[g0:g1]:
                    if (code >> 8 & 7) % warps == w:
                        acc[code >> 8 & 7] = acc[code >> 8 & 7] + od[:, p]
                for q in range(w, Q, warps):
                    tot_rows[q] = acc[q]
            tot = rows_sum(tot_rows, tabs.lane_uo_short[ug].item()) if ug >= 0 else None
            inv = torch.tensor(1.0, dtype=f) / (g1 - g0)
            phi = fresh(M * Q)
            c = g0
            while c < g1:
                recs = group[c:min(c + 32, g1)]
                first = recs[0][2]
                ends = [at - first + (code & 255) for _, code, at, _ in recs]
                fits = [end <= LANE_CHUNK for end in ends]
                mc = sum(fits)
                assert all(fits[:mc]) and mc >= 1
                chunk, k0 = ends[mc - 1], k_unit + first
                cbuf = [None] * chunk
                for w in range(warps):
                    for p, code, at, packed in recs[w:mc:warps]:
                        n, short, at = code & 255, code >> 11 & 31, at - first
                        pu = torch.where(tot > 0, od[:, p] / torch.where(tot > 0, tot, 1.0),
                                         inv)
                        if n <= 4:
                            # the group's sums by its plan, its entries from its record
                            order, balanced, zero = plan_of(code, packed)
                            cap_sum = plan_sum([cap[:, d] for d, _ in order], balanced,
                                               zero) + 1e-6
                            z = [exp_like_xla(-rt.temp * ((dist_util[k0 + at + i] + bn[:, d])
                                                          - (rt.omega * cap[:, d]) / cap_sum))
                                 for d, i in order]
                            zsum = plan_sum(z, balanced, zero)
                            for zi, (_, i) in zip(z, order):
                                cbuf[at + i] = (zi / zsum) * pu
                            continue
                        codes = [(e & 31, e >> 5 & 7) for e in entry[k0 + at:k0 + at + n]]
                        acc = fresh(Q)
                        for d, lane in codes:
                            acc[lane] = acc[lane] + cap[:, d]
                        cap_sum = rows_sum(acc, short) + 1e-6
                        acc, z = fresh(Q), []
                        for i, (d, lane) in enumerate(codes):
                            util = ((dist_util[k0 + at + i] + bn[:, d])
                                    - (rt.omega * cap[:, d]) / cap_sum)
                            z.append(exp_like_xla(-rt.temp * util))
                            acc[lane] = acc[lane] + z[-1]
                        zsum = rows_sum(acc, short)
                        for i, zi in enumerate(z):
                            cbuf[at + i] = (zi / zsum) * pu
                assert all(x is not None for x in cbuf)
                for w in range(warps):
                    for e in range(chunk):
                        s = (entry[k0 + e] & 31) * Q + (entry[k0 + e] >> 5 & 7)
                        if s % warps == w:
                            phi[s] = phi[s] + cbuf[e]
                c += mc
            row = torch.stack([rows_sum(phi[d * Q:(d + 1) * Q],
                                        tabs.lane_phi_short[(r * M + u) * M + d].item())
                               for d in range(M)], -1)
            rowsum = row[:, :1]
            for j in range(1, M):
                rowsum = rowsum + row[:, j:j + 1]
            need, pos = torch.abs(rowsum - 1.0) > 1e-3, rowsum > 1e-6
            out[:, r, u] = torch.where(need & pos, row / rowsum,
                                       torch.where(need, rt.offdiag_uniform[r, u], row))
    return out


KERNEL_MODELS = {"walk": kernel_walk, "stream": kernel_stream, "chunked": kernel_chunked}


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


def check_node_offsets(scn):
    """Each routed node's ranges hold its own rows and nothing else."""
    rt, tabs, M = scn.routing, scn.routing_kernel_tables, scn.max_deg
    off = tabs.node_offsets
    assert tuple(off.shape) == (rt.num_routed + 1, len(NODE_TABLES))
    assert off[-1].tolist() == [rt.num_entries, rt.num_groups, len(rt.uo_od),
                                rt.num_uo_groups]
    assert tuple(tabs.node_max) == tuple(torch.diff(off, dim=0).amax(dim=0).tolist())
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
    rt = scn.routing
    assert rt.group_members.shape[1] == 5 and rt.num_routed == 43
    check_node_offsets(scn)
    ops_ = routing_operands(scn, 3, 11, per_replica_od)
    assert_bits_equal(KERNEL_MODELS[model](scn, *ops_), turning_fractions_step_plain(scn, *ops_))


@pytest.mark.parametrize("model", KERNEL_MODELS)
@pytest.mark.parametrize("ftype,exact,Q", [(torch.float32, False, 5),
                                           (torch.float64, False, 3),
                                           (torch.float64, True, 1)])
def test_kernel_walk_is_the_plain_version_on_delft_tables(ftype, exact, Q, model):
    scn = delft(ftype, exact)
    rt = scn.routing
    assert rt.group_members.shape[1] == Q and rt.dist_util.dtype == ftype
    check_node_offsets(scn)
    for per_replica_od in (False, True):
        ops_ = routing_operands(scn, 4, 12, per_replica_od)
        assert_bits_equal(KERNEL_MODELS[model](scn, *ops_),
                          turning_fractions_step_plain(scn, *ops_))


@pytest.mark.parametrize("model", KERNEL_MODELS)
@pytest.mark.parametrize("ftype,exact", [(torch.float32, False), (torch.float64, False),
                                         (torch.float64, True)])
def test_kernel_models_are_the_plain_version_on_a_fan(ftype, exact, model):
    """A softmax group of six entries (``routing_fan``): the streamed
    design's record carries no plan for it and its sums take the row
    accumulators; two such groups share a unit."""
    scn = fan_scenario("cpu", ftype=ftype, exact_parity=exact)
    tabs = scn.routing_kernel_tables
    assert tabs.group_max == 6 and tabs.unit_groups == 2
    check_node_offsets(scn)
    for per_replica_od in (False, True):
        ops_ = routing_operands(scn, 4, 14, per_replica_od)
        assert_bits_equal(KERNEL_MODELS[model](scn, *ops_),
                          turning_fractions_step_plain(scn, *ops_))


def test_routing_wrapper_takes_the_plain_version_on_the_cpu():
    scn = delft(torch.float32, False)
    ops_ = routing_operands(scn, 2, 13, False)
    tf = ops.turning_fractions
    before = (dict(tf.launches), dict(tf.launches_by_design), dict(tf.launches_by_warps))
    got = ops.turning_fractions(scn, *ops_)
    assert_bits_equal(got, turning_fractions_step_plain(scn, *ops_))
    assert engine.turning_fractions_step is ops.turning_fractions
    assert (tf.launches, tf.launches_by_design, tf.launches_by_warps) == before
    assert before == ({"float32": 0, "float64": 0}, {"lanes": 0, "rows": 0},
                      {1: 0, 2: 0, 4: 0, 8: 0})


@pytest.mark.parametrize("name,batch,warps", [
    ("env", 32768, 2), ("env", 256, 4), ("env", 64, 8), ("env", 32, 8),
    ("delft", 10240, 2), ("delft", 32, 8), ("melbourne", 16384, 1), ("melbourne", 32, 1)])
def test_streamed_geometry_follows_batch_and_tables(env_tables, monkeypatch, name, batch,
                                                    warps):
    """The streamed design's warps a block on an H100's 132 SMs: at least
    two where the units hold the groups to share out (the env's and
    delft's benchmark batches), more where the units and tiles leave SMs
    short of 40 warps (small batches), never more than a unit's groups
    (melbourne's one group a unit: one warp) or the launch bounds' 8; the
    block's shared memory whatever its warps; the walk below a warp of
    replicas."""
    from pednstream_tpu_torch.ops import routing as kernel

    monkeypatch.setattr(kernel, "_sm_count", lambda device: 132)
    scn = {"env": env_tables, "delft": delft(torch.float32, False),
           "melbourne": torch_build(**NetworkEnvGenerator().scenario_args("melbourne"))}[name]
    tabs = scn.routing_kernel_tables
    assert kernel._geometry(tabs, batch, "cuda") == (warps, kernel.lane_bytes(tabs))
    words = scn.max_deg * (2 + tabs.rows) + tabs.rows + LANE_CHUNK
    assert kernel.lane_bytes(tabs) == 32 * 4 * words
    assert kernel._geometry(tabs, 31, "cuda") == (0, tabs.rows_shared_bytes)
    assert warps in ops.turning_fractions.launches_by_warps


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
        phi_c = turning_fractions(ts, dens, recv, cap, od)
        got = turning_fractions_dense(ts.routing, phi_c, ts.engine_params.phi_base)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got[0].numpy(), want)


def test_plain_hot_ops_swaps_and_restores():
    """``profiling.plain_hot_ops`` routes the step's three hot ops to their
    plain versions while entered (the card's 'before' in one process) and
    puts the wrappers back; on the CPU both give the same step."""
    from pednstream_tpu_torch.profiling import plain_hot_ops

    wrappers = (engine.binom_fast, engine.turning_fractions_step, engine._node_solve)
    scn = torch_build(**NetworkEnvGenerator().scenario_args("melbourne"), history_window=16,
                      binomial_mode="fast")
    finals = []
    for plain in (False, True):
        gen = torch.Generator().manual_seed(3)
        with plain_hot_ops() if plain else contextlib.nullcontext():
            if plain:
                assert engine.binom_fast is binom_fast_plain
                assert engine.turning_fractions_step is turning_fractions_step_plain
                assert engine._node_solve is ops.node_solve_plain
            finals.append(engine.simulate_batched(scn, scn.engine_params, scn.init_state(3), 4,
                                                  gen=gen, stochastic=True))
    assert (engine.binom_fast, engine.turning_fractions_step, engine._node_solve) == wrappers
    for name, x in vars(finals[0]).items():
        if isinstance(x, torch.Tensor):
            assert_bits_equal(x, getattr(finals[1], name))


def _imported(path: Path, package: list) -> list:
    """``(module, name)`` of every import in the module at ``path`` of the
    package ``package`` (its dotted parts), at any depth of the module,
    relative imports resolved; ``name`` is None for ``import module``."""
    import ast

    out = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out += [(a.name, None) for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = package[:len(package) - node.level + 1] if node.level else []
            module = ".".join(base + ([node.module] if node.module else []))
            out += [(module, a.name) for a in node.names]
    return out


def test_ops_import_neither_the_engine_nor_a_routing_step():
    """The hand kernels' seam points one way: engine -> ops/<op>.py ->
    ops/_build.py.  No module under ``ops/`` imports the engine (nor the
    engine's names through the package), and from the host compiler
    ``routing.py`` it takes only its tables' type and the GEMV row rule,
    never a step function; ``routing.py`` imports nothing from ``ops/``."""
    pkg = Path(ops.__file__).parent.parent
    host_compiler = {"RoutingTables", "_gemv_rows"}
    bad = []
    for path in sorted((pkg / "ops").glob("*.py")):
        for module, name in _imported(path, ["pednstream_tpu_torch", "ops"]):
            full = module if name is None else f"{module}.{name}"
            if (module.startswith("pednstream_tpu_torch.engine")
                    or full == "pednstream_tpu_torch.engine"
                    or (module == "pednstream_tpu_torch.routing"
                        and name not in host_compiler)):
                bad.append(f"ops/{path.name}: {full}")
    for module, name in _imported(pkg / "routing.py", ["pednstream_tpu_torch"]):
        full = module if name is None else f"{module}.{name}"
        if full.startswith("pednstream_tpu_torch.ops"):
            bad.append(f"routing.py: {full}")
    assert not bad, bad


# ---------------------------------------------------------------------------
# the node solve
# ---------------------------------------------------------------------------

_NODE_SCENARIOS = {}
_NODE_FORMS = {"_f32_exact": {"ftype": torch.float32, "exact_parity": True},
               "_exact": {"ftype": torch.float64, "exact_parity": True},
               "_f64": {"ftype": torch.float64}}


def node_scenario(name):
    """The scenario of ``name`` as the benchmark's cells and the served path
    step it (float32, the fast binomial; the env's with OD candidates);
    ``<name>_f64`` in float64 flows, ``<name>_exact`` (float64) and
    ``<name>_f32_exact`` in exact parity, ``grid10`` the golden fixture's."""
    if name not in _NODE_SCENARIOS:
        base, kw = name, {}
        for suffix, form in _NODE_FORMS.items():
            if name.endswith(suffix):
                base, kw = name.removesuffix(suffix), form
                break
        if base == "grid10":
            args, _, _ = fixture_args(Path(__file__).parent / "golden" / "grid10.npz")
            scn = torch_build(**args, **kw)
        elif kw:
            args = NetworkEnvGenerator().scenario_args(base)
            args["params"].setdefault("seed", 1)
            scn = torch_build(**args, **kw)
        elif name == "45_intersections":
            from pednstream_tpu_torch.env import PedNetParallelEnv

            scn = PedNetParallelEnv(name, od_randomize=True, seed=0, device="cpu").scn
        else:
            args = NetworkEnvGenerator().scenario_args(name)
            args["params"].setdefault("seed", 1)
            scn = torch_build(**args, history_window=16, binomial_mode="fast")
        _NODE_SCENARIOS[name] = scn
    return _NODE_SCENARIOS[name]


def node_operands(scn, B, seed, per_replica):
    """Whole sending and receiving flows (zeros and ties among them), the
    scenario's parameters (drawn per replica where ``per_replica``, as the
    env randomizes them: per-replica demand, virtual receiving and od
    tables, ``phi_base`` an expand), random compact turning fractions where
    routed, and a shared step or one per replica; in the scenario's flow
    dtype."""
    from pednstream_tpu_torch.randomize import randomize_engine_params_batched

    rng = np.random.default_rng(seed)
    E = scn.n_links
    S = np.floor(rng.uniform(0, 30, (B, E))).astype(np.float32)
    S[rng.uniform(size=S.shape) < 0.3] = 0.0
    R = np.floor(rng.uniform(0, 40, (B, E))).astype(np.float32)
    R[rng.uniform(size=R.shape) < 0.2] = 0.0
    R[rng.uniform(size=R.shape) < 0.2] = 7.0
    ep = scn.engine_params
    if per_replica:
        ep = randomize_engine_params_batched(scn, torch.Generator().manual_seed(seed), B)
    f = scn.ftype
    phi_c = None
    if scn.routing is not None:
        NR, M = scn.routing.num_routed, scn.max_deg
        phi_c = torch.from_numpy(rng.uniform(0, 1, (B, NR, M, M))).to(f)
    t = (torch.from_numpy(rng.integers(1, 500, B).astype(np.int32)) if per_replica
         else int(rng.integers(1, 500)))
    return ep, t, torch.from_numpy(S).to(f), torch.from_numpy(R).to(f), phi_c


def dense_phi(scn, ep, phi_c):
    """The exact path's dense phi from compact rows: ``phi_base`` with the
    routed nodes' rows at their valid slots (``turning_fractions_dense``)."""
    B = phi_c.shape[0]
    phi = ep.phi_base.expand(B, *ep.phi_base.shape[-3:]).clone()
    ids = scn.routing.routed_ids
    valid = scn.slot_valid[ids]
    phi[:, ids] = phi_c * (valid[:, :, None] & valid[:, None, :])
    return phi


def kernel_node_walk(scn, ep, t, S, R, phi_c, phi=None):
    """The kernel's walk (``csrc/node_solve.cu``) in numpy: each node's
    slots read through the scenario's ``NodeTables`` (the in- and out-link
    of each slot, the virtual pair at slot 0, the routed row, or the dense
    ``phi``'s rows for every node), the crossing rule at OneToOne nodes, the
    classic allocation elsewhere over the node's own slots (its arity; the
    padded ones add nothing) with each column summed in the kernel's order
    (element i into accumulator i % 4, combined ((a0 + a1) + a2) + a3; on a
    dense phi of exact parity left to right), and the flows written back at
    each node's own links (every link written once), in the flows' dtype."""
    from pednstream_tpu_torch.ops.node_solve import _column

    tabs = scn.node_tables
    B, E = S.shape
    N, M = scn.n_nodes, scn.max_deg
    in_link, out_link = tabs.in_link.numpy(), tabs.out_link.numpy()
    flags, pos = tabs.node_flags.numpy(), tabs.routed_pos.numpy()
    otoo, virt, arity = (flags & 1) > 0, (flags & 2) > 0, flags >> 2
    S, R = S.numpy(), R.numpy()
    f = S.dtype.type
    demand = np.broadcast_to(_column(ep.demand, t - 1).numpy(), (B, N))
    virt_recv = np.broadcast_to(ep.virt_recv.numpy(), (B, N))
    s = np.where(in_link >= 0, S[:, np.maximum(in_link, 0)], f(0))
    r = np.where(out_link >= 0, R[:, np.maximum(out_link, 0)], f(0))
    s[:, virt, 0] = demand[:, virt]
    r[:, virt, 0] = virt_recv[:, virt]
    seq = phi is not None and scn.exact_parity
    if phi is not None:
        phi = np.broadcast_to(phi.numpy(), (B, N, M, M)).copy()
    else:
        phi = np.broadcast_to(ep.phi_base.numpy(), (B, N, M, M)).copy()
        routed = pos >= 0
        if phi_c is not None:
            phi[:, routed] = phi_c.numpy()[:, pos[routed]]
    live = np.arange(M) < arity[:, None]  # the padded slots add nothing
    dem = np.where(live[:, :, None] & live[:, None, :], phi * s[..., None], f(0))
    acc = [np.zeros((B, N, M), dtype=f) for _ in range(4)]
    for i in range(M):
        acc[0 if seq else i % 4] = acc[0 if seq else i % 4] + dem[:, :, i, :]
    col = ((acc[0] + acc[1]) + acc[2]) + acc[3]
    den = np.where(col != 0, col, f(1e-5))
    g = np.floor(np.minimum(dem, r[:, :, None, :] * (dem / den[:, :, None, :])))
    q_in, q_out = np.maximum(g.sum(-1), 0), np.maximum(g.sum(-2), 0)
    q_in[:, otoo] = 0
    q_out[:, otoo] = 0
    so, ro = s[:, otoo], r[:, otoo]
    q_in[:, otoo, 0] = np.minimum(so[..., 0], ro[..., 1])
    q_in[:, otoo, 1] = np.minimum(so[..., 1], ro[..., 0])
    q_out[:, otoo, 0] = np.minimum(so[..., 1], ro[..., 0])
    q_out[:, otoo, 1] = np.minimum(so[..., 0], ro[..., 1])
    outflow = np.full((B, E), np.nan, dtype=f)
    inflow = np.full((B, E), np.nan, dtype=f)
    outflow[:, in_link[in_link >= 0]] = q_in[:, in_link >= 0]
    inflow[:, out_link[out_link >= 0]] = q_out[:, out_link >= 0]
    assert not np.isnan(outflow).any() and not np.isnan(inflow).any()
    virt_dep = np.where(virt, q_in[..., 0], f(0))
    virt_arr = np.where(virt, q_out[..., 0], f(0))
    return tuple(torch.from_numpy(np.ascontiguousarray(x))
                 for x in (inflow, outflow, virt_dep, virt_arr))


@pytest.mark.parametrize("name", ["melbourne", "delft", "45_intersections", "small_network",
                                  "long_corridor"])
def test_node_tables_name_each_links_slots(name):
    """Each link's (end node, slot) holds it in ``in_link`` and its (start
    node, slot) in ``out_link``, and no other slot does; ``routed_pos``
    gives each routed node its row of the compact turning fractions and -1
    elsewhere; the flags and the order (the classic nodes, the largest
    arity first, then the OneToOne nodes) follow the topology."""
    scn = node_scenario(name)
    tabs, topo = scn.node_tables, scn.topo
    E, N = scn.n_links, scn.n_nodes
    links = np.arange(E)
    for table, node, slot in ((tabs.in_link, topo.end_node, topo.end_slot),
                              (tabs.out_link, topo.start_node, topo.start_slot)):
        table = table.numpy()
        assert table.dtype == np.int32 and table.shape == (N, scn.max_deg)
        np.testing.assert_array_equal(table[node, slot], links)
        assert int((table >= 0).sum()) == E
        assert not (table[:, 0][topo.has_virtual] >= 0).any()  # the virtual slot
    pos = tabs.routed_pos.numpy()
    routed = [] if scn.routing is None else scn.routing.routed_ids.tolist()
    want = np.full(N, -1)
    want[routed] = np.arange(len(routed))
    np.testing.assert_array_equal(pos, want)
    flags = tabs.node_flags.numpy()
    np.testing.assert_array_equal(flags & 1, topo.is_otoo)
    np.testing.assert_array_equal((flags >> 1) & 1, topo.has_virtual)
    arity = flags >> 2
    np.testing.assert_array_equal(arity, topo.slot_valid.sum(axis=1))
    np.testing.assert_array_equal(topo.slot_valid, np.arange(scn.max_deg) < arity[:, None])
    order = tabs.order.numpy()
    classic = np.flatnonzero(~topo.is_otoo)
    want = sorted(classic, key=lambda n: (-arity[n], n))
    np.testing.assert_array_equal(order[:classic.size], want)
    np.testing.assert_array_equal(order[classic.size:], np.flatnonzero(topo.is_otoo))


@pytest.mark.parametrize("name,per_replica,dense", [
    ("melbourne", False, False), ("melbourne", True, False), ("delft", False, False),
    ("45_intersections", True, False), ("small_network", False, False),
    ("small_network_f64", False, False), ("small_network_exact", False, True),
    ("small_network_f32_exact", True, True), ("grid10_exact", False, True)])
def test_kernel_node_walk_is_the_plain_version(name, per_replica, dense):
    """The kernel's walk over the node tables equals the plain version bit
    for bit where the column sums are exact (whole flows, turning fractions
    in sixteenths, so the kernel's summation order cannot show): the
    tables, the virtual slot, the routed rows, the crossing rule and the
    write-back; float64 flows, and exact parity's dense phi (the rows of
    every node, one set per replica).  The card tests hold the kernel
    itself to the plain version on real fractions."""
    scn = node_scenario(name)
    ep, t, S, R, phi_c = node_operands(scn, 3, 31, per_replica)
    rng = np.random.default_rng(32)
    B, N, M, f = S.shape[0], scn.n_nodes, scn.max_deg, S.dtype
    mask = (ep.phi_base != 0).expand(B, N, M, M)
    ep = ep.replace(phi_base=torch.where(
        mask, torch.from_numpy(rng.integers(1, 17, (B, N, M, M)) / 16).to(f), 0.0))
    if phi_c is not None:
        phi_c = torch.from_numpy(rng.integers(0, 17, phi_c.shape) / 16).to(f)
    phi = None
    if dense:
        phi, phi_c = dense_phi(scn, ep, phi_c), None
    got = kernel_node_walk(scn, ep, t, S, R, phi_c, phi)
    want = ops.node_solve_plain(scn, ep, t, S, R, phi_c, phi)
    for a, b in zip(got, want):
        assert a.dtype == f
        assert_bits_equal(a, b)


@pytest.mark.parametrize("name,per_replica", [("melbourne", False), ("delft", True),
                                              ("45_intersections", True)])
def test_node_solve_plain_is_the_step_it_replaced(name, per_replica):
    """``ops.node_solve_plain`` is the step's node solve as it was before
    the kernel (the frozen copy in ``portbench/reference/engine.py``): the
    float32 fast path with routed rows, per-replica parameters and steps."""
    from portbench.reference.engine import _node_solve as frozen

    scn = node_scenario(name)
    ep, t, S, R, phi_c = node_operands(scn, 4, 33, per_replica)
    for a, b in zip(ops.node_solve_plain(scn, ep, t, S, R, phi_c),
                    frozen(scn, ep, t, S, R, phi_c)):
        assert_bits_equal(a, b)


def test_node_solve_wrapper_takes_the_plain_version_on_the_cpu():
    scn = node_scenario("melbourne")
    ep, t, S, R, phi_c = node_operands(scn, 2, 34, False)
    before = dict(ops.node_solve.launches)
    for a, b in zip(engine._node_solve(scn, ep, t, S, R, phi_c),
                    ops.node_solve_plain(scn, ep, t, S, R, phi_c)):
        assert_bits_equal(a, b)
    assert engine._node_solve is ops.node_solve
    assert before == ops.node_solve.launches == {"float32": 0, "float64": 0}


def test_node_solve_kernel_args_take_each_path_without_a_copy():
    """The argument block the wrapper would launch with, on each path's
    operands: the shared demand column and the per-replica ones read in
    place by their strides, ``phi_base``'s expand with replica stride 0, a
    dense phi of exact parity in ``phi_base``'s place with its replica
    stride, no compact rows and the sums left to right, the float64 entry
    for float64 flows; the four outputs views of one buffer; one plan kept
    per operand layout; operands it cannot take raise."""
    import sys

    kernel = sys.modules["pednstream_tpu_torch.ops.node_solve"]

    mel = node_scenario("melbourne")
    mel.node_tables.plans.clear()
    ep, t, S, R, phi_c = node_operands(mel, 3, 35, False)
    args, outs, entry = kernel.kernel_args(mel, ep, t, S, R, phi_c)
    T1 = ep.demand.shape[-1]
    assert entry == "node_solve"
    assert (args.demand_sb, args.demand_sn, args.virt_recv_sb, args.phi_base_sb) == (0, T1, 0, 0)
    assert args.demand == ep.demand[:, t - 1].data_ptr()
    assert (args.phi_c, args.phi_c_sb, args.phi_base) == (
        phi_c.data_ptr(), 4 * 36, ep.phi_base.data_ptr())
    assert (args.B, args.E, args.N, args.M, args.NR, args.seq_sum) == (3, 938, 341, 6, 4, 0)
    assert [tuple(x.shape) for x in outs] == [(3, 938), (3, 938), (3, 341), (3, 341)]
    base = outs[0].untyped_storage().data_ptr()
    assert all(x.untyped_storage().data_ptr() == base and x.is_contiguous() for x in outs)
    assert [x.data_ptr() for x in outs] == [args.inflow, args.outflow, args.virt_dep,
                                            args.virt_arr]
    assert [x.data_ptr() - base for x in outs] == [0, 4 * 3 * 938, 8 * 3 * 938,
                                                   8 * 3 * 938 + 4 * 3 * 341]
    # the same layout again takes the kept plan; another batch makes one more
    kernel.kernel_args(mel, ep, t + 1, S, R, phi_c)
    assert len(mel.node_tables.plans) == 1
    ep2, t2, S2, R2, phi_c2 = node_operands(mel, 5, 35, False)
    kernel.kernel_args(mel, ep2, t2, S2, R2, phi_c2)
    assert len(mel.node_tables.plans) == 2

    env = node_scenario("45_intersections")
    ep, t, S, R, phi_c = node_operands(env, 6, 36, True)
    args, _, _ = kernel.kernel_args(env, ep, 9, S, R, phi_c)
    N, T1 = env.n_nodes, ep.demand.shape[-1]
    assert ep.phi_base.stride(0) == 0
    assert (args.demand_sb, args.demand_sn) == (N * T1, T1)
    assert (args.virt_recv_sb, args.virt_recv_sn, args.phi_base_sb) == (N, 1, 0)
    # a per-replica step gathers each replica's column: [B, N] by its strides
    args, _, _ = kernel.kernel_args(env, ep, t, S, R, phi_c)
    assert (args.demand_sb, args.demand_sn) == (N, 1)

    # exact parity in float64: the dense phi in phi_base's place
    ex = node_scenario("small_network_exact")
    ep, t, S, R, phi_c = node_operands(ex, 2, 37, False)
    phi = dense_phi(ex, ep, phi_c)
    args, outs, entry = kernel.kernel_args(ex, ep, t, S, R, phi_c, phi)
    N, M = ex.n_nodes, ex.max_deg
    assert entry == "node_solve_f64" and all(x.dtype == torch.float64 for x in outs)
    assert (args.phi_base, args.phi_base_sb, args.phi_c, args.seq_sum) == (
        phi.data_ptr(), N * M * M, None, 1)
    # float64 on the fast path: the compact rows, PyTorch's order
    f64 = node_scenario("small_network_f64")
    ep, t, S, R, phi_c = node_operands(f64, 2, 38, False)
    args, _, entry = kernel.kernel_args(f64, ep, t, S, R, phi_c)
    assert (entry, args.seq_sum, args.phi_c) == ("node_solve_f64", 0, phi_c.data_ptr())

    ep, t, S, R, phi_c = node_operands(mel, 1, 1, False)
    with pytest.raises(TypeError, match="one flow dtype"):
        kernel.kernel_args(mel, ep.replace(virt_recv=ep.virt_recv.double()), t, S, R, phi_c)
    with pytest.raises(TypeError, match="float32 or float64"):
        kernel.kernel_args(mel, ep, t, S.half(), R.half(), phi_c)
    with pytest.raises(ValueError, match="links"):
        kernel.kernel_args(mel, ep, t, S[:, :-1], R[:, :-1], phi_c)


@pytest.mark.parametrize("mix", ["rollout", "env", "exact"])
def test_node_solve_bound_counts_by_hand(mix):
    """``portbench/bounds/node_solve.py`` on small_network (6 nodes, 14
    links, M = 4; nodes 1 and 5 of arity 4 are the only classic ones, both
    routed; nodes 0 and 5 have a virtual pair), B = 3: per replica S, R,
    inflow and outflow (4 x 14 words) and the two virtual vectors (2 x 6);
    demand and virtual receiving of the 2 virtual nodes once, or per replica
    in the env; phi_c's 12 valid off-diagonal slots of each routed node per
    replica; no phi_base pair (both classic nodes are routed).  Without the
    routing, phi_base's 2 x 12 pairs once instead.  Operations: 5 per valid
    (node, in slot, out slot) of the classic nodes, 2 x 16 a replica.  On
    exact parity's dense phi in float64, the classic nodes' 2 x 12 pairs
    per replica, 8 bytes a word."""
    from portbench.bounds.node_solve import bytes_and_ops

    scn = node_scenario("small_network")
    if mix == "exact":
        assert bytes_and_ops(scn, 3, False, 8, dense_phi=True) == (
            8 * (4 * 3 * 14 + 2 * 3 * 6 + 2 * 2 + 3 * 24), 5 * 3 * 32)
        return
    per_replica = mix == "env"
    virt = 2 * 2 * (3 if per_replica else 1)
    assert bytes_and_ops(scn, 3, per_replica) == (4 * (4 * 3 * 14 + 2 * 3 * 6 + virt + 3 * 24),
                                                  5 * 3 * 32)
    unrouted = copy.copy(scn)
    unrouted.routing = None
    assert bytes_and_ops(unrouted, 3, per_replica) == (4 * (4 * 3 * 14 + 2 * 3 * 6 + virt + 24),
                                                       5 * 3 * 32)
