"""Per-replica domain randomization (a frozen copy of the program's): link
capacity and speed incidents on about a fifth of the corridors, demand
levels, OD flow weights and, for a scenario built with ``od_candidates``,
OD nodes that open and close per replica, all drawn from an explicit
``torch.Generator`` in the parameters' float dtype.
"""

import numpy as np
import torch

from .scenario import derive_link_constants
from .state import EngineParams


def _draw(scn, gen: torch.Generator, lead: tuple) -> EngineParams:
    """Randomized EngineParams with leading axes ``lead`` (``()`` for one
    draw, ``(B,)`` for one per replica) on every leaf."""
    ep = scn.engine_params
    dev, f = ep.k_critical.device, ep.k_critical.dtype
    E, N = scn.n_links, scn.n_nodes
    nc = E // 2

    def uniform(n, low=0.0, high=1.0):
        u = torch.rand(lead + (n,), generator=gen, dtype=f, device=dev)
        return low + (high - low) * u

    def pairs(x):  # one value per corridor, both directions identically
        return torch.repeat_interleave(x, 2, dim=-1)

    # ~20% of corridors get an incident
    hit = pairs(uniform(nc) < 0.2)
    # capacity change with p=0.5: factor U(0.6, 1.2) on k_critical / k_jam
    cap_on = pairs(uniform(nc) < 0.5) & hit
    cap_f = pairs(uniform(nc, 0.6, 1.2))
    k_crit = torch.where(cap_on, torch.clamp(ep.k_critical * cap_f, min=0.5), ep.k_critical)
    k_jam = torch.where(cap_on, torch.maximum(k_crit * 2.0, ep.k_jam * cap_f), ep.k_jam)
    # speed reduction with p=0.5: factor U(0.6, 0.9)
    spd_on = pairs(uniform(nc) < 0.5) & hit
    spd_f = pairs(uniform(nc, 0.6, 0.9))
    ffs = torch.where(spd_on, ep.free_flow_speed * spd_f, ep.free_flow_speed)

    # OD-node activation (the k-hop OD edit moves of env_loader.py:261-359
    # as independent activations): nominal nodes stay active w.p. 0.75,
    # candidates open w.p. 0.5 / n_candidates; a draw that empties a side
    # falls back to the nominal set
    if scn.od_randomizable:
        def mask(a):
            return torch.as_tensor(a, device=dev)

        nom_o, nom_d = mask(scn.nominal_origin_mask), mask(scn.nominal_dest_mask)
        cand_o, cand_d = mask(scn.candidate_origin_mask), mask(scn.candidate_dest_mask)
        p_cand_o = 0.5 / max(int(np.sum(scn.candidate_origin_mask)), 1)
        p_cand_d = 0.5 / max(int(np.sum(scn.candidate_dest_mask)), 1)
        u_o, u_d = uniform(N), uniform(N)
        o_act = (nom_o & (u_o < 0.75)) | (cand_o & (u_o < p_cand_o))
        d_act = (nom_d & (u_d < 0.75)) | (cand_d & (u_d < p_cand_d))
        o_act = torch.where(o_act.any(dim=-1, keepdim=True), o_act, nom_o)
        d_act = torch.where(d_act.any(dim=-1, keepdim=True), d_act, nom_d)
        base_demand = torch.as_tensor(scn.demand_full, device=dev).to(ep.demand.dtype) \
            * o_act[..., None]
        pair_act = (o_act[..., mask(scn.od_pair_origin)]
                    & d_act[..., mask(scn.od_pair_dest)])
        virt_recv = torch.where(scn.has_virtual & (o_act | d_act), 1e6, 0.0).to(
            ep.virt_recv.dtype)
    else:
        base_demand = ep.demand
        pair_act = None
        virt_recv = ep.virt_recv.expand(lead + ep.virt_recv.shape)

    # demand levels: rescale each origin's curve so its mean rate lands in
    # the reference's light-level band (env_loader.py:185-218)
    T = ep.demand.shape[-1]
    nom_mean = base_demand.sum(dim=-1) / T  # per-node mean rate
    target_mean = uniform(N, 4.0, 18.0)  # mid base..peak band
    dem_scale = torch.where(nom_mean > 0, target_mean / torch.clamp(nom_mean, min=1e-6), 1.0)
    demand = base_demand * dem_scale[..., None]

    # OD flow weights U(1, 10) per pair (env_loader.py:224-259); pairs
    # touching a closed OD node carry zero weight
    P = ep.od_table.shape[0]
    if P > 0:
        w = uniform(P, 1.0, 10.0)
        if pair_act is not None:
            w = w * pair_act
        od_table = w[..., None].expand(lead + ep.od_table.shape)
    else:
        od_table = ep.od_table.expand(lead + ep.od_table.shape)

    # derived constants follow the perturbed physics of each replica
    derived = derive_link_constants(ep.length, ffs, k_crit, k_jam, scn.unit_time)
    changed = dict(
        k_critical=k_crit.to(ep.k_critical.dtype),
        k_jam=k_jam.to(ep.k_jam.dtype),
        free_flow_speed=ffs.to(ep.free_flow_speed.dtype),
        demand=demand.to(ep.demand.dtype),
        od_table=od_table.to(ep.od_table.dtype),
        virt_recv=virt_recv,
        **{k: v.expand(lead + v.shape[-1:]) for k, v in derived.items()},
    )
    # every other leaf is the nominal one, broadcast (a view) over lead
    return EngineParams(**{
        name: changed[name] if name in changed else x.expand(lead + x.shape)
        for name, x in vars(ep).items()})


def randomize_engine_params_batched(scn, gen: torch.Generator, batch: int) -> EngineParams:
    """``batch`` independent randomized EngineParams: every leaf gains a
    leading replica axis, as the JAX package's vmapped draw has."""
    return _draw(scn, gen, (batch,))
