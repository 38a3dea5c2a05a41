"""The LTM engine step on tensors (the counterpart of ``pednstream_tpu/engine.py``).

One step is ``network_loading(t)`` of the reference (SURVEY.md §3.2) over
all links and nodes at once: sending flows from state t-1, receiving flows
(which need the sending flow of the reverse link), the padded per-node
merge/diverge solve, the cumulative-curve write-back and the density/FD
update.  Every state leaf carries a leading replica axis ``B``, and the
whole batch advances by one call per step.  ``NetworkState.t`` is a Python
int shared by a lockstep batch, or an int32 ``[B]`` tensor when the
replicas sit at different times: ring rows are then written and read, and
demand columns gathered, per replica (what XLA makes of the JAX engine's
``ring.at[t % H].set`` under ``vmap``), with no host read of ``t``.

The lookback and the three per-link ring reads come from one
:func:`ops.fused_history_reads` call per step (a CUDA kernel on the card,
float32 or float64 by the rings' dtype), which the JAX engine reaches with
``use_pallas=True``; its float64 instantiation sums the diffusion terms in
the reference's order, so the exact-parity path goes through it too.

Two modes share the step:

- the fast path (float32 flows, compact routed turning fractions);
- ``scn.exact_parity`` (float64 flows from ``scn.ftype``): dtype staging
  exactly where the JAX engine casts, a dense ``[B, N, M, M]`` phi, and
  every sum of non-integers added left to right in the reference's order
  (``routing.seq_sum``, ``routing.segment_sum``).  Eager PyTorch forms no
  fused multiply-add across operations, so the JAX engine's ``_nofma``
  barriers have no counterpart here; this mode uses no ``addcmul``,
  ``lerp`` or ``torch.compile``.

The ``"optimal"`` node solve runs the host LP (``lp_solver``) on the dense
phi, one round trip to the host per step.

Stochastic steps draw from an explicit ``torch.Generator`` in a fixed order:
release, activity (skipped when every link's activity probability is zero),
reverse occupancy, speed noise.  ``binomial_mode="exact"`` draws with
``torch.binomial``, ``"fast"`` with :func:`binom_fast`.  The JAX PRNG
streams cannot be reproduced, so stochastic runs agree with the JAX engine
in distribution only.

:class:`EngineParams` may be the scenario's (every leaf unbatched) or drawn
per replica (every leaf with a leading ``B``, ``randomize``): the step
indexes the last axes only.

``step_fn`` updates the ring buffers of the state it is given in place
(``ring[:, t % H] = x``, a ``scatter_`` for a per-replica ``t``): the state it returns shares them, and the old
state must not be stepped again.
"""

from typing import Optional, Tuple

import numpy as np
import torch

from .fd import link_flow_kv, speed_from_density
from .ops import fused_history_reads
from .routing import seq_sum, turning_fractions_dense, turning_fractions_step
from .state import EngineParams, NetworkState, StepOutputs
from .topology import FD_TYPES

_f32 = torch.float32
_FAST_BINOM_EXACT_N = 16


def binom_fast(nf, p, u, z):
    """The hybrid binomial sampler of ``pednstream_tpu.engine._binom``
    (mode='fast') as a pure function of its random inputs.

    ``nf`` holds whole non-negative trial counts, ``p`` the success
    probabilities, ``u`` one uniform [0, 1) and ``z`` one standard normal
    per element.  For n <= 16 the sample is the exact inverse CDF of u,
    walking the pmf by its term recursion; above, it is the normal
    approximation round(n p + sqrt(n p (1-p)) z) clipped to [0, n].
    """
    pc = torch.clamp(p, 0.0, 1.0)
    q = 1.0 - pc
    ratio = pc / torch.clamp(q, min=1e-12)
    pmf = torch.pow(q, nf)  # P[X = 0]
    cdf = pmf
    cnt = torch.zeros_like(nf)
    for k in range(_FAST_BINOM_EXACT_N):
        # u >= P[X <= k]  =>  the sample exceeds k
        cnt = cnt + ((u >= cdf) & (nf > k)).to(nf.dtype)
        pmf = pmf * ((nf - k) / (k + 1.0)) * ratio
        pmf = torch.where(nf >= k + 1.0, pmf, 0.0)
        cdf = cdf + pmf
    mu = nf * pc
    sigma = torch.sqrt(torch.clamp(mu * (1.0 - pc), min=0.0))
    gauss = torch.minimum(torch.clamp(torch.round(mu + sigma * z), min=0.0), nf)
    return torch.where(nf <= _FAST_BINOM_EXACT_N, cnt, gauss)


def _binom(n, p, gen: Optional[torch.Generator], stochastic: bool, mode: str = "exact"):
    """Binomial with numpy-style truncation of a float ``n``.  Deterministic
    mode returns the expectation floor(n) * p.  Stochastic mode draws from
    ``gen``: ``"exact"`` with ``torch.binomial`` on floor(n) trials,
    ``"fast"`` one uniform, then one normal per element for
    :func:`binom_fast` (in float32, as the JAX sampler computes)."""
    nf = torch.floor(torch.clamp(n, min=0.0))
    if not stochastic:
        return nf * p
    if mode == "exact":
        pc = torch.clamp(p, 0.0, 1.0).to(nf.dtype).expand_as(nf).contiguous()
        return torch.binomial(nf, pc, generator=gen)
    u = torch.rand(nf.shape, generator=gen, dtype=_f32, device=nf.device)
    z = torch.randn(nf.shape, generator=gen, dtype=_f32, device=nf.device)
    return binom_fast(nf.to(_f32), p.to(_f32), u, z).to(nf.dtype)


def _column(x: torch.Tensor, t) -> torch.Tensor:
    """Column ``t`` of ``x``'s last (time) axis, clamped into range as the
    JAX engine's traced index is: an RL step whose ``action_gap`` engine
    steps run past the horizon reads the last column.  With a per-replica
    ``t [B]``, replica b reads its own column of ``x [N, T+1]`` (shared) or
    ``x [B, N, T+1]`` (per-replica tables); the result is ``[B, N]``."""
    last = x.shape[-1] - 1
    if not isinstance(t, torch.Tensor):
        return x[..., min(max(t, 0), last)]
    col = torch.clamp(t, 0, last).long()
    if x.dim() == 2:
        return x.index_select(1, col).T
    return x.gather(2, col.view(-1, 1, 1).expand(-1, x.shape[1], 1)).squeeze(2)


def _write_row(ring: torch.Tensor, t, period: int, value: torch.Tensor) -> None:
    """``ring[b, t_b % period] = value[b]`` in place: one row slice for a
    shared ``t``, a scatter along the row axis for a per-replica one."""
    if isinstance(t, torch.Tensor):
        row = torch.remainder(t, period).long().view(-1, 1, 1).expand(-1, 1, ring.shape[2])
        ring.scatter_(1, row, value.unsqueeze(1))
    else:
        ring[:, t % period] = value


def _rev(scn, x):
    """Value of the reverse link of every link (last axis)."""
    return x[..., scn.reverse_idx]


def _area(scn, ep: EngineParams, st: NetworkState):
    return torch.where(scn.is_separator, ep.length * st.sep_width, ep.length * ep.width)


def _history(scn, ep: EngineParams, st: NetworkState, t):
    """The lookback (tau link.py:260, diffusion coefficients link.py:199-214,
    shockwave lookback link.py:380, with the windowed-ring clamps) and the
    three ring reads of this step in one fused kernel
    (``pednstream_tpu.engine._lookback_state`` + ``_fused_hist``).  The
    clamped shockwave lookback is also returned: the receiving flow reads it."""
    ci, co, diff = fused_history_reads(
        st.cum_in_ring, st.cum_out_ring, st.inflow_ring, st.avg_tt, ep.gamma,
        ep.tau_shockwave, t, scn.unit_time, scn.windowed)
    tau_shock = ep.tau_shockwave
    if scn.windowed:
        tau_shock = torch.clamp(tau_shock, max=scn.H - 1)
    return {"tau_shock": tau_shock, "ci": ci, "co": co, "diff": diff}


def _sending_flows(scn, ep: EngineParams, st: NetworkState, t, hist,
                   gen, stochastic: bool):
    """Link.cal_sending_flow(t-1) over all links (link.py:216-370); ``t`` is
    an int or a per-replica ``[B, 1]``.

    Dtype staging mirrors the reference's NumPy promotion: density,
    congestion and release factors and the diffusion coefficient are
    float32 (the reference's state arrays, link.py:82-97), N-curve and
    flow arithmetic runs in the flow dtype.
    """
    dt = scn.unit_time
    ts = t - 1
    num_peds = st.num_peds  # float32
    area32 = _area(scn, ep, st).to(_f32)
    # get_density(ts): shared bidirectional for a Link (link.py:190-197),
    # the stored own density for a Separator (link.py:427-428)
    shared_density = torch.where(
        scn.is_separator, st.density, (num_peds + _rev(scn, num_peds)) / area32)
    early = ts < ep.free_flow_tau  # link.py:267-269

    # free-flow / congestion blended N-curve boundary (link.py:274-288)
    kc32 = ep.k_critical.to(_f32)
    cf = torch.clamp((st.density - kc32) / (ep.k_jam - ep.k_critical).to(_f32), 0.0, 1.0)
    boundary_freeflow = torch.clamp(hist["ci"] - st.cum_out, min=0.0)
    # float32 product widened to the flow dtype + float32 factor times a flow
    boundary = cf * num_peds + (1.0 - cf) * boundary_freeflow

    front_gate = _rev(scn, st.back_gate)  # link.py:110-126 cross-coupling
    cap = front_gate * ep.k_critical * ep.free_flow_speed * dt  # link.py:296
    sending = torch.minimum(boundary, cap)
    original = sending

    # stochastic release mitigation (link.py:309-346)
    releasing_factor = torch.clamp(shared_density / ep.k_jam.to(_f32), 0.0, 1.0)
    releasing_prob = 0.7 + 0.15 * torch.pow(releasing_factor, 0.8)  # link.py:80

    diffusion = torch.clamp(torch.ceil(hist["diff"]), min=0.0)
    freeflow = shared_density <= kc32
    # platoon mix (link.py:329-330); (1.0 - 0.8) is the reference's
    # 0.19999999999999996, not 0.2
    w_mix = 0.8
    mixed = torch.floor(torch.minimum(w_mix * diffusion + (1.0 - w_mix) * sending, sending))
    released = _binom(sending, releasing_prob, gen, stochastic,
                      scn.binomial_mode)  # link.py:336-343
    s_pos = torch.where(freeflow, torch.where(diffusion > 0, mixed, released), released)
    sending = torch.where(sending > 0, s_pos, sending)

    # activity stay (link.py:350-358), skipped when decided zero at build time
    if not scn.act_statically_zero:
        act_p = ep.activity_probability
        staying = _binom(sending, act_p, gen, stochastic, scn.binomial_mode)
        sending = torch.where((act_p > 0) & (sending > 1), sending - staying, sending)

    # EMA smoothing against the previous sending flow (link.py:362-364)
    sending = torch.clamp(sending, min=0.0)
    sending = torch.minimum(torch.floor(0.8 * sending + 0.2 * st.sending_prev), original)
    S = torch.where(early, 0.0, sending)
    return S, shared_density


def _receiving_flows(scn, ep: EngineParams, st: NetworkState, t, S, hist,
                     gen, stochastic: bool):
    """cal_receiving_flow(_with_reverse) (link.py:372-416) and the
    Separator variant (link.py:480-512); ``t`` is an int or a per-replica
    ``[B, 1]``."""
    dt = scn.unit_time
    area = _area(scn, ep, st)
    cum_out_at = hist["co"]
    early = (t - hist["tau_shock"]) < 0  # ts + 1 - tau_shockwave < 0

    # the count is cast to the flow dtype first (engine.py:374)
    rev_rand = _binom(_rev(scn, st.num_peds).to(scn.ftype), scn.p_reverse, gen, stochastic,
                      scn.binomial_mode)  # link.py:382
    kjam_area = ep.k_jam * area
    b_link = torch.where(
        early, kjam_area - rev_rand,
        torch.clamp(cum_out_at + kjam_area - rev_rand - st.cum_in, min=0.0))
    b_sep = torch.where(early, kjam_area, cum_out_at + kjam_area - st.cum_in)
    boundary = torch.where(scn.is_separator, b_sep, b_link)

    cap = st.back_gate * ep.k_critical * ep.free_flow_speed * dt  # link.py:393
    rf = torch.clamp(torch.minimum(boundary, cap), min=0.0)

    # smoothing against the stored receiving flow (link.py:399-401)
    rf = torch.where(
        st.recv_prev >= 0,
        torch.minimum(torch.floor(rf * 0.8 + st.recv_prev * 0.2), rf),
        rf)

    # reverse-sending subtraction (link.py:407-416); separators skip it
    return torch.where(scn.is_separator, torch.clamp(rf, min=0.0),
                       torch.clamp(rf - _rev(scn, S), min=0.0))


def _classic_solve(dem_mat, r_pad, exact: bool = False):
    """'classic' proportional supply allocation (node.py:272-300) over any
    leading axes: ``dem_mat [..., M, M]``, ``r_pad [..., M]``.  ``exact``
    adds the column sums left to right (the sums of the floored ``g`` are
    of whole numbers, exact in any order)."""
    if exact:
        col_sums = seq_sum(dem_mat, -2).unsqueeze(-2)
    else:
        col_sums = dem_mat.sum(dim=-2, keepdim=True)
    share = dem_mat / torch.where(col_sums != 0, col_sums, 1e-5)
    supply = r_pad.unsqueeze(-2) * share
    g = torch.floor(torch.minimum(dem_mat, supply))
    q_in = torch.clamp(g.sum(dim=-1), min=0.0)  # outflow of incoming slot i
    q_out = torch.clamp(g.sum(dim=-2), min=0.0)  # inflow to outgoing slot j
    return q_in, q_out


def _host_lp(scn, s_pad, r_pad, phi):
    """The ``"optimal"`` LP solve (node.py:248-271) on the host, replica by
    replica, as the JAX engine's ``pure_callback`` runs it."""
    phi = phi.expand(s_pad.shape[:1] + phi.shape[-3:])
    s_np, r_np, phi_np = (x.cpu().numpy() for x in (s_pad, r_pad, phi))
    q = [scn.optimal_solver(s_np[b], r_np[b], phi_np[b]) for b in range(s_np.shape[0])]
    q_in, q_out = (torch.as_tensor(np.stack([qq[i] for qq in q]), device=s_pad.device)
                   .to(s_pad.dtype) for i in (0, 1))
    return q_in, q_out


def _node_solve(scn, ep: EngineParams, t, S, R, phi_c=None, phi=None):
    """Padded merge/diverge over all nodes at once (node.py:164-300).

    Gathers per-node sending/receiving vectors ``[B, N, M]`` (with the
    origin-demand and destination big-M virtual slot 0) and solves
    OneToOne nodes by the crossing rule.  The others take the classic
    allocation, on one of:

    - ``phi [B, N, M, M]``, dense turning fractions (exact-parity mode, with
      the column sums added in order; the ``"optimal"`` solve sends this
      phi to the host LP instead);
    - ``phi_base``, with the NR routed nodes re-solved on their dynamic
      ``phi_c [B, NR, M, M]`` and written over the result.

    The flows are then gathered back to the link axis.
    """
    B = S.shape[0]
    N, M = scn.n_nodes, scn.max_deg
    demand_t = _column(ep.demand, t - 1)  # node.py:176; [N] or per replica [B, N]

    s_pad = torch.where(scn.in_valid, S[:, scn.in_safe], 0.0)
    s_pad = torch.where(scn.virt_slot, demand_t[..., None], s_pad)
    s_pad = torch.where(scn.slot_valid, s_pad, 0.0)
    r_pad = torch.where(scn.out_valid, R[:, scn.out_safe], 0.0)
    r_pad = torch.where(scn.virt_slot, ep.virt_recv[..., None], r_pad)
    r_pad = torch.where(scn.slot_valid, r_pad, 0.0)

    if phi is not None and scn.assign_flows_type == "optimal":
        q_in_reg, q_out_reg = _host_lp(scn, s_pad, r_pad, phi)
    elif phi is not None:
        q_in_reg, q_out_reg = _classic_solve(phi * s_pad.unsqueeze(-1), r_pad,
                                             exact=scn.exact_parity)
    else:
        q_in_reg, q_out_reg = _classic_solve(ep.phi_base * s_pad.unsqueeze(-1), r_pad)
    if phi_c is not None:
        ids = scn.routing.routed_ids
        q_in_c, q_out_c = _classic_solve(phi_c * s_pad[:, ids].unsqueeze(-1), r_pad[:, ids])
        q_in_reg[:, ids] = q_in_c
        q_out_reg[:, ids] = q_out_c

    # OneToOne crossing solve (node.py:230-242): slot k <-> slot 1-k
    s2, r2 = s_pad[..., :2], r_pad[..., :2]
    pad = torch.zeros((B, N, M - 2), dtype=s_pad.dtype, device=s_pad.device)
    q_in_oto = torch.cat([torch.minimum(s2, r2.flip(-1)), pad], dim=-1)
    q_out_oto = torch.cat([torch.minimum(s2.flip(-1), r2), pad], dim=-1)
    otoo = scn.is_otoo[:, None]
    q_in = torch.where(otoo, q_in_oto, q_in_reg)
    q_out = torch.where(otoo, q_out_oto, q_out_reg)

    # write-back: each directed link is incoming to exactly one node and
    # outgoing from exactly one node (node.py:146-162)
    outflow_e = q_in.reshape(B, N * M)[:, scn.end_flat]
    inflow_e = q_out.reshape(B, N * M)[:, scn.start_flat]
    virt_dep = torch.where(scn.has_virtual, q_in[..., 0], 0.0)
    virt_arr = torch.where(scn.has_virtual, q_out[..., 0], 0.0)
    return inflow_e, outflow_e, virt_dep, virt_arr


def _update_link_states(scn, ep: EngineParams, st: NetworkState, t,
                        inflow_e, outflow_e, gen, stochastic: bool):
    """Density and FD speed/travel-time update (network.py:257-264,
    link.py:133-188, Separator variant link.py:430-452).  Writes this
    step's travel time into ``st.tt_ring`` in place."""
    W = scn.avg_tt_window
    num_peds = (st.num_peds.to(scn.ftype) + (inflow_e - outflow_e)).to(_f32)
    density = num_peds / _area(scn, ep, st).to(_f32)  # float32 division (link.py:136)

    k_opp = torch.where(scn.is_separator, 0.0, _rev(scn, density))
    k_eff = density + ep.bi_factor.to(_f32) * k_opp
    v = speed_from_density(k_eff, ep.free_flow_speed, ep.k_critical, ep.k_jam, scn.fd_type)
    if stochastic:
        noise = torch.randn(v.shape, generator=gen, dtype=scn.ftype, device=v.device)
        v = torch.where(ep.speed_noise_std > 0,
                        (v.to(scn.ftype) + noise * ep.speed_noise_std).to(_f32), v)
    v = torch.clamp(v, min=0.0)

    # in the reference's free-flow branch (yperman/greenshields, no noise)
    # the speed is a Python float, so length/speed divides in float64:
    # ep.tt_freeflow32 carries that value
    ff_exact = (k_eff <= ep.k_critical.to(_f32)) & (scn.fd_type != FD_TYPES["smulders"])
    if stochastic:
        ff_exact = ff_exact & (ep.speed_noise_std <= 0)
    tt_f32div = ep.length.to(_f32) / torch.where(v > 0, v, 1.0)
    travel_time = torch.where(
        v > 0, torch.where(ff_exact, ep.tt_freeflow32, tt_f32div), ep.max_travel_time)
    link_flow = link_flow_kv(density, v)

    # rolling average travel time over the last W steps (link.py:84-91,183-186);
    # the oldest slot is read before this step's value overwrites it
    run_sum = st.tt_run_sum + travel_time
    if isinstance(t, torch.Tensor):
        # per replica: its own oldest slot, and the t >= W branch by where
        slot = torch.remainder(t - W, W).long().view(-1, 1, 1).expand(-1, 1, run_sum.shape[1])
        full = (t >= W).unsqueeze(1)
        run_sum = torch.where(full, run_sum - st.tt_ring.gather(1, slot).squeeze(1), run_sum)
        avg_tt = torch.where(full, run_sum / W, ep.travel_time0)
    elif t >= W:
        run_sum = run_sum - st.tt_ring[:, (t - W) % W]
        avg_tt = run_sum / W
    else:
        avg_tt = ep.travel_time0.expand_as(run_sum)
    _write_row(st.tt_ring, t, W, travel_time)
    return num_peds, density, v, travel_time, link_flow, avg_tt, run_sum


def step_fn(scn, ep: EngineParams, st: NetworkState,
            gen: Optional[torch.Generator] = None, stochastic: bool = False,
            record: bool = True) -> Tuple[NetworkState, Optional[StepOutputs]]:
    """One ``network_loading(t)`` step of the whole batch, lockstep (an int
    ``st.t``) or with each replica at its own time (an int32 ``[B]`` one).

    ``gen`` (on the state's device) is required when ``stochastic``.  The
    rings of ``st`` are updated in place and shared with the returned
    state.  Returns ``(new_state, outputs)``; outputs are None unless
    ``record``.
    """
    if stochastic and gen is None:
        raise ValueError("a stochastic step needs a torch.Generator")
    t = st.t
    H = scn.H
    # against per-link values a per-replica t stands as [B, 1]
    t_link = t.unsqueeze(1) if isinstance(t, torch.Tensor) else t

    # 0) the three ring lookbacks in one fused kernel pass
    hist = _history(scn, ep, st, t)

    # 1) sending flows from state t-1
    S, shared_density = _sending_flows(scn, ep, st, t_link, hist, gen, stochastic)

    # 2) dynamic turning fractions (path_finder.py:717-737): dense for the
    #    exact and "optimal" solves, else compact over the routed nodes
    phi_c = phi = None
    dense = scn.exact_parity or scn.assign_flows_type == "optimal"
    if scn.routing is not None:
        cap_default = st.back_gate * ep.k_critical * ep.free_flow_speed * scn.unit_time
        od_flow_t = _column(ep.od_table, t)
        if dense:
            phi = turning_fractions_dense(
                scn.routing, scn.n_nodes, scn.max_deg, scn.node_arity, scn.slot_valid,
                shared_density, st.recv_prev, cap_default, od_flow_t, ep.phi_base)
        else:
            phi_c = turning_fractions_step(
                scn.routing, scn.max_deg, shared_density, st.recv_prev, cap_default,
                od_flow_t)
    elif dense:
        phi = ep.phi_base

    # 3) receiving flows (need S of the reverse links)
    R = _receiving_flows(scn, ep, st, t_link, S, hist, gen, stochastic)

    # 4) node merge/diverge and write-back
    inflow_e, outflow_e, virt_dep, virt_arr = _node_solve(scn, ep, t, S, R, phi_c, phi)

    # 5) cumulative curves (node.py:146-162), ring rows written in place;
    #    the inflow ring feeds the fused read's diffusion taps
    cum_in = st.cum_in + inflow_e
    cum_out = st.cum_out + outflow_e
    _write_row(st.cum_in_ring, t, H, cum_in)
    _write_row(st.cum_out_ring, t, H, cum_out)
    _write_row(st.inflow_ring, t, H, inflow_e)

    # 6) density, speed and travel-time updates
    num_peds, density, speed, travel_time, link_flow, avg_tt, run_sum = (
        _update_link_states(scn, ep, st, t, inflow_e, outflow_e, gen, stochastic))

    new_state = st.replace(
        t=t + 1,
        cum_in=cum_in,
        cum_out=cum_out,
        inflow=inflow_e,
        outflow=outflow_e,
        num_peds=num_peds,
        density=density,
        speed=speed,
        travel_time=travel_time,
        link_flow=link_flow,
        avg_tt=avg_tt,
        tt_run_sum=run_sum,
        sending_prev=S,
        recv_prev=R,
        virt_dep=virt_dep,
        virt_arr=virt_arr,
        virt_dep_cum=st.virt_dep_cum + virt_dep,
        virt_arr_cum=st.virt_arr_cum + virt_arr,
    )
    out = None
    if record:
        out = StepOutputs(
            inflow=inflow_e, outflow=outflow_e, cum_in=cum_in, cum_out=cum_out,
            num_peds=num_peds, density=density, speed=speed,
            travel_time=travel_time, link_flow=link_flow, sending=S,
            receiving=R, back_gate=st.back_gate, sep_width=st.sep_width,
            virt_dep=virt_dep, virt_arr=virt_arr,
        )
    return new_state, out


def simulate_batched(scn, ep: EngineParams, states: NetworkState, num_steps: int,
                     gen: Optional[torch.Generator] = None,
                     stochastic: bool = False) -> NetworkState:
    """Rollout of the batch for ``num_steps`` steps; returns the final
    state.  The rings of ``states`` are advanced in place."""
    for _ in range(num_steps):
        states, _ = step_fn(scn, ep, states, gen, stochastic, record=False)
    return states


def simulate(scn, ep: EngineParams, state: NetworkState, num_steps: int,
             gen: Optional[torch.Generator] = None, stochastic: bool = False,
             record: bool = True):
    """Run ``num_steps`` loading steps (the reference driver loop
    ``for t in range(1, simulation_steps): network.network_loading(t)``).
    Returns ``(final_state, outputs)``, the outputs stacked over time into
    ``[num_steps, B, ...]`` when ``record``, else None."""
    outs = []
    for _ in range(num_steps):
        state, out = step_fn(scn, ep, state, gen, stochastic, record)
        if record:
            outs.append(out)
    if not record:
        return state, None
    stacked = StepOutputs(**{
        name: torch.stack([getattr(o, name) for o in outs])
        for name in StepOutputs.__dataclass_fields__
    })
    return state, stacked
