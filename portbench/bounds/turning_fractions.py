"""The routed turning fractions' least time (the function of
``routing.turning_fractions_step``), on the routing tables of the
scenario: per replica the density and receiving flow of each distinct
routed down link, its default capacity where the receiving flow is unset,
and the od flow of each distinct pair (once when shared); the tables once
(entry and (up, od) tables, the valid member ids, the node offsets, the
guard's fallback); the output.  Operations: the per-entry float work, one
add per valid member of each segment sum (the softmax groups twice), a
division per (up, od) entry, the guard's few per slot."""

import numpy as np

from portbench.peaks import least_seconds

OPS_PER_ENTRY = 31


def least_seconds_call(rt, max_deg: int, batch: int, unset: int, od_per_replica: bool) -> float:
    """One call for ``batch`` replicas, ``unset`` (replica, link) receiving
    flows still at their -1 sentinel."""
    def host(x):
        return np.asarray(x.detach().cpu())

    item = rt.dist_util.element_size()
    down = host(rt.te_down_link)
    links = np.unique(down[down >= 0]).size
    pairs = np.unique(host(rt.uo_od)).size
    K, U = int(rt.num_entries), int(rt.uo_od.numel())
    nnz = [int((host(m) >= 0).sum()) for m in (rt.group_members, rt.uo_group_members,
                                                rt.phi_c_members)]
    slots = int(rt.num_routed) * max_deg * max_deg
    moved = (batch * links * (4 + item) + unset * item
             + pairs * item * (batch if od_per_replica else 1)
             + K * (3 * 8 + item) + U * (2 * 8 + item) + 8 * sum(nnz)
             + int(rt.node_offsets.numel()) * 8 + slots * item + batch * slots * item)
    ops = batch * (OPS_PER_ENTRY * K + 2 * nnz[0] + nnz[1] + nnz[2] + U + 4 * slots)
    return least_seconds(moved, ops, item)
