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
  (``ops.routing.seq_sum``, ``ops.routing.segment_sum``).  Eager PyTorch forms no
  fused multiply-add across operations, so the JAX engine's ``_nofma``
  barriers have no counterpart here; this mode uses no ``addcmul``,
  ``lerp`` or ``torch.compile``.

The routed turning fractions (``turning_fractions_step``:
:func:`ops.turning_fractions`) are one launch of a CUDA kernel on the card
(two where per-replica od flows are copied for its streamed design), and
their plain version (``ops.turning_fractions_step_plain``) on the CPU.
The node solve (``_node_solve``: :func:`ops.node_solve`) is one launch of
a CUDA kernel on the card, on the fast path and on the exact-parity dense
phi alike, and its plain version (``ops.node_solve_plain``) on the CPU.
The ``"optimal"`` node solve runs the host LP (``lp_solver``) on the dense
phi, one round trip to the host per step.  Each hand kernel's op in
``ops/`` chooses between its kernel and its plain version by the
operands' device, and reads the tables the scenario built for it.

Stochastic steps draw from an explicit ``torch.Generator`` in a fixed order:
release, activity (skipped when every link's activity probability is zero),
reverse occupancy, speed noise.  ``binomial_mode="exact"`` draws with
``torch.binomial``, ``"fast"`` with :func:`binom_fast` (``ops.binom``: a
CUDA kernel on the card, its plain version on the CPU, fed the same
uniforms and normals, so the stream is the same either way).  The JAX PRNG
streams cannot be reproduced, so stochastic runs agree with the JAX engine
in distribution only.

:class:`EngineParams` may be the scenario's (every leaf unbatched) or drawn
per replica (every leaf with a leading ``B``, ``randomize``): the step
indexes the last axes only.

``step_fn`` updates the ring buffers of the state it is given in place
(``ring[:, t % H] = x``, a ``scatter_`` for a per-replica ``t``): the state it returns shares them, and the old
state must not be stepped again.
A step runs under the span ``engine.step`` and each of its numbered
phases under its own (``engine.history``, ``engine.sending``,
``engine.routing``, ``engine.receiving``, ``engine.node_solve``,
``engine.link_update``; :mod:`.tracing`), which a running profiler's
trace shows and which cost one flag check each otherwise.
"""

from typing import Optional, Tuple

import torch

from .fd import link_flow_kv, speed_from_density
from .ops.binom import binom_fast
from .ops.ncurve import fused_history_reads, reciprocal_f32
from .ops.node_solve import _column, node_solve as _node_solve
from .ops.routing import turning_fractions as turning_fractions_step, turning_fractions_dense
from .state import EngineParams, NetworkState, StepOutputs
from .topology import FD_TYPES
from .tracing import span

_f32 = torch.float32


def draw(gen, normal: bool, shape, dtype, device) -> torch.Tensor:
    """Uniform [0, 1) (or, ``normal``, standard normal) draws of ``shape``
    from ``gen``: a ``torch.Generator``, or the block draws of a sharded run
    (``parallel.mesh.BlockDraws``), which draw at the unsharded shape and
    keep this rank's block."""
    if isinstance(gen, torch.Generator):
        fn = torch.randn if normal else torch.rand
        return fn(tuple(shape), generator=gen, dtype=dtype, device=device)
    return gen.draw(normal, tuple(shape), dtype, device)


def _binom(n, p, gen, stochastic: bool, mode: str = "exact"):
    """Binomial with numpy-style truncation of a float ``n``.  Deterministic
    mode returns the expectation floor(n) * p.  Stochastic mode draws from
    ``gen`` (see :func:`draw`): ``"exact"`` with ``torch.binomial`` on
    floor(n) trials, ``"fast"`` one uniform, then one normal per element for
    :func:`binom_fast` (in float32, as the JAX sampler computes): one kernel
    launch on the card."""
    nf = torch.floor(torch.clamp(n, min=0.0))
    if not stochastic:
        return nf * p
    if mode == "exact":
        pc = torch.clamp(p, 0.0, 1.0).to(nf.dtype).expand_as(nf).contiguous()
        if isinstance(gen, torch.Generator):
            return torch.binomial(nf, pc, generator=gen)
        return gen.binomial(nf, pc)
    u = draw(gen, False, nf.shape, _f32, nf.device)
    z = draw(gen, True, nf.shape, _f32, nf.device)
    return binom_fast(nf.to(_f32), p.to(_f32), u, z).to(nf.dtype)


def _write_row(ring: torch.Tensor, t, period: int, value: torch.Tensor) -> None:
    """``ring[b, t_b % period] = value[b]`` in place: one row slice for a
    shared ``t``, a scatter along the row axis for a per-replica one."""
    if isinstance(t, torch.Tensor):
        row = torch.remainder(t, period).long().view(-1, 1, 1).expand(-1, 1, ring.shape[2])
        ring.scatter_(1, row, value.unsqueeze(1))
    else:
        ring[:, t % period] = value


def _rev(scn, x_all):
    """Value of the reverse link of every link of ``scn``, read from the
    vector over ALL links ``x_all`` (last axis).  On a block of links
    (``parallel.link_shard``) ``scn.reverse_idx`` holds the block's rows and
    ``x_all`` is gathered over the link axis first."""
    return x_all[..., scn.reverse_idx]


class AllLinks:
    """The cross-link reads of a step that holds every link: nothing to
    exchange.  ``parallel.link_shard.LinkExchange`` is its counterpart for
    a step on one rank's block of the links."""

    @staticmethod
    def gather(*xs):
        """The vector over all links of each per-link vector in ``xs``."""
        return xs

    @staticmethod
    def own(x_all):
        """This step's links of a vector over all links."""
        return x_all


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
                   num_peds_all, gate_all, gen, stochastic: bool):
    """Link.cal_sending_flow(t-1) over the step's links (link.py:216-370);
    ``t`` is an int or a per-replica ``[B, 1]``, ``num_peds_all`` and
    ``gate_all`` the state's counts and gates over all links.

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
        scn.is_separator, st.density, (num_peds + _rev(scn, num_peds_all)) / area32)
    early = ts < ep.free_flow_tau  # link.py:267-269

    # free-flow / congestion blended N-curve boundary (link.py:274-288)
    kc32 = ep.k_critical.to(_f32)
    cf = torch.clamp((st.density - kc32) / (ep.k_jam - ep.k_critical).to(_f32), 0.0, 1.0)
    boundary_freeflow = torch.clamp(hist["ci"] - st.cum_out, min=0.0)
    # float32 product widened to the flow dtype + float32 factor times a flow
    boundary = cf * num_peds + (1.0 - cf) * boundary_freeflow

    front_gate = _rev(scn, gate_all)  # link.py:110-126 cross-coupling
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


def _receiving_flows(scn, ep: EngineParams, st: NetworkState, t, hist,
                     num_peds_all, S_all, gen, stochastic: bool):
    """cal_receiving_flow(_with_reverse) (link.py:372-416) and the
    Separator variant (link.py:480-512); ``t`` is an int or a per-replica
    ``[B, 1]``, ``num_peds_all`` and ``S_all`` the state's counts and this
    step's sending flows over all links."""
    dt = scn.unit_time
    area = _area(scn, ep, st)
    cum_out_at = hist["co"]
    early = (t - hist["tau_shock"]) < 0  # ts + 1 - tau_shockwave < 0

    # the count is cast to the flow dtype first (engine.py:374)
    rev_rand = _binom(_rev(scn, num_peds_all).to(scn.ftype), scn.p_reverse, gen, stochastic,
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
                       torch.clamp(rf - _rev(scn, S_all), min=0.0))


def _div_by(scn, x, c):
    """``x / c`` for a constant ``c`` as the JAX step computes it: XLA turns
    the fast path's float32 division into a multiply by the float32
    reciprocal; the exact-parity path divides."""
    if scn.exact_parity or x.dtype != _f32:
        return x / c
    return x * reciprocal_f32(c)


def _update_link_states(scn, ep: EngineParams, st: NetworkState, t,
                        inflow_e, outflow_e, links, gen, stochastic: bool):
    """Density and FD speed/travel-time update (network.py:257-264,
    link.py:133-188, Separator variant link.py:430-452).  Writes this
    step's travel time into ``st.tt_ring`` in place.  The updated density
    of the reverse links is read through ``links.gather``."""
    W = scn.avg_tt_window
    num_peds = (st.num_peds.to(scn.ftype) + (inflow_e - outflow_e)).to(_f32)
    density = num_peds / _area(scn, ep, st).to(_f32)  # float32 division (link.py:136)

    density_all, = links.gather(density)
    k_opp = torch.where(scn.is_separator, 0.0, _rev(scn, density_all))
    k_eff = density + ep.bi_factor.to(_f32) * k_opp
    v = speed_from_density(k_eff, ep.free_flow_speed, ep.k_critical, ep.k_jam, scn.fd_type)
    if stochastic:
        noise = draw(gen, True, v.shape, scn.ftype, v.device)
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
        avg_tt = torch.where(full, _div_by(scn, run_sum, W), ep.travel_time0)
    elif t >= W:
        run_sum = run_sum - st.tt_ring[:, (t - W) % W]
        avg_tt = _div_by(scn, run_sum, W)
    else:
        avg_tt = ep.travel_time0.expand_as(run_sum)
    _write_row(st.tt_ring, t, W, travel_time)
    return num_peds, density, v, travel_time, link_flow, avg_tt, run_sum


def step_fn(scn, ep: EngineParams, st: NetworkState,
            gen: Optional[torch.Generator] = None, stochastic: bool = False,
            record: bool = True, links=AllLinks) -> Tuple[NetworkState, Optional[StepOutputs]]:
    """One ``network_loading(t)`` step of the whole batch, lockstep (an int
    ``st.t``) or with each replica at its own time (an int32 ``[B]`` one).

    ``gen`` (on the state's device) is required when ``stochastic``.  The
    rings of ``st`` are updated in place and shared with the returned
    state.  Returns ``(new_state, outputs)``; outputs are None unless
    ``record``.

    ``links`` names where the step crosses links.  The per-link chains run
    on the links that ``scn``, ``ep`` and ``st`` hold; the reverse-link
    reads, the routing and the node solve take vectors over ALL links from
    ``links.gather``, and ``links.own`` cuts the solved link flows back.
    With every link in one place (:class:`AllLinks`) both return their
    input; ``parallel.link_shard`` passes the exchange of a block of links.
    """
    if stochastic and gen is None:
        raise ValueError("a stochastic step needs a torch.Generator")
    with span("engine.step"):
        t = st.t
        H = scn.H
        # 0) the three ring lookbacks in one fused kernel pass
        with span("engine.history"):
            hist = _history(scn, ep, st, t)

        # 1) sending flows from state t-1
        with span("engine.sending"):
            # against per-link values a per-replica t stands as [B, 1]
            t_link = t.unsqueeze(1) if isinstance(t, torch.Tensor) else t
            num_peds_all, gate_all = links.gather(st.num_peds, st.back_gate)
            S, shared_density = _sending_flows(scn, ep, st, t_link, hist, num_peds_all,
                                               gate_all, gen, stochastic)

        # 2) dynamic turning fractions (path_finder.py:717-737): dense for the
        #    exact and "optimal" solves, else compact over the routed nodes
        with span("engine.routing"):
            phi_c = phi = None
            dense = scn.exact_parity or scn.assign_flows_type == "optimal"
            if scn.routing is not None:
                cap_default = st.back_gate * ep.k_critical * ep.free_flow_speed * scn.unit_time
                S_all, density_all, recv_prev_all, cap_all = links.gather(
                    S, shared_density, st.recv_prev, cap_default)
                od_flow_t = _column(ep.od_table, t)
                phi_c = turning_fractions_step(scn, density_all, recv_prev_all, cap_all,
                                               od_flow_t)
                if dense:
                    phi, phi_c = turning_fractions_dense(scn.routing, phi_c, ep.phi_base), None
            else:
                S_all, = links.gather(S)
                if dense:
                    phi = ep.phi_base

        # 3) receiving flows (need S of the reverse links)
        with span("engine.receiving"):
            R = _receiving_flows(scn, ep, st, t_link, hist, num_peds_all, S_all, gen,
                                 stochastic)

        # 4) node merge/diverge over all links, and write-back to this step's
        with span("engine.node_solve"):
            R_all, = links.gather(R)
            inflow_all, outflow_all, virt_dep, virt_arr = _node_solve(
                scn, ep, t, S_all, R_all, phi_c, phi)
            inflow_e, outflow_e = links.own(inflow_all), links.own(outflow_all)

        with span("engine.link_update"):
            # 5) cumulative curves (node.py:146-162), ring rows written in
            #    place; the inflow ring feeds the fused read's diffusion taps
            cum_in = st.cum_in + inflow_e
            cum_out = st.cum_out + outflow_e
            _write_row(st.cum_in_ring, t, H, cum_in)
            _write_row(st.cum_out_ring, t, H, cum_out)
            _write_row(st.inflow_ring, t, H, inflow_e)

            # 6) density, speed and travel-time updates
            num_peds, density, speed, travel_time, link_flow, avg_tt, run_sum = (
                _update_link_states(scn, ep, st, t, inflow_e, outflow_e, links, gen,
                                    stochastic))

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


def make_step(scn, stochastic: bool = False, record: bool = False, donate: bool = False,
              gen: Optional[torch.Generator] = None):
    """Single-step function ``(params, state) -> (state, outputs)`` over
    :func:`step_fn`, with ``gen`` (on the state's device) bound; a
    stochastic step with none raises when it is called, as ``step_fn`` does.

    ``donate`` is accepted for the JAX signature and has no effect: the
    rings of the input state are already advanced in place and shared with
    the returned state, so the previous state must not be stepped again
    whether or not it is set."""

    def _step(ep: EngineParams, st: NetworkState):
        return step_fn(scn, ep, st, gen, stochastic, record)

    return _step


def simulate_batched(scn, ep: EngineParams, states: NetworkState, num_steps: int,
                     gen: Optional[torch.Generator] = None,
                     stochastic: bool = False, links=AllLinks) -> NetworkState:
    """Rollout of the batch for ``num_steps`` steps; returns the final
    state.  The rings of ``states`` are advanced in place.  ``links`` as
    in :func:`step_fn`."""
    for _ in range(num_steps):
        states, _ = step_fn(scn, ep, states, gen, stochastic, record=False, links=links)
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
