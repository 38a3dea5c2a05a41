"""The node merge/diverge solve's least time (the function of the engine
step's node solve on the float32 fast path), on the scenario's topology
and routing tables: per replica the S and R rows read and the inflow and
outflow rows written (``B x E`` each), the two virtual vectors written
(``B x N`` each); the demand column and virtual receiving flow of the
virtual nodes once, or per replica where the traffic mix draws them per
replica (the env); ``phi_base``'s valid off-diagonal pairs of the
classic, unrouted nodes once; per replica the compact turning fractions that the routing
tables can make non-zero (a slot with a turn entry, or the guard's
fallback) at the classic routed nodes.  Operations: a division and four
multiplies, adds or min/floor per valid (node, in slot, out slot) of the
classic nodes.  Where a dense phi (exact parity) takes the place of
``phi_base`` and the compact rows, its valid off-diagonal pairs of every
classic node are read per replica instead."""

import numpy as np

from portbench.peaks import least_seconds

OPS_PER_PAIR = 5


def bytes_and_ops(scn, batch: int, per_replica_nodes: bool, item_bytes: int = 4,
                  dense_phi: bool = False):
    """``(bytes, operations)`` of one call for ``batch`` replicas of
    ``item_bytes``-byte flows, on a dense phi where ``dense_phi``."""
    topo = scn.topo
    E, N, M = scn.n_links, scn.n_nodes, scn.max_deg
    arity = np.asarray(topo.slot_valid, dtype=bool).sum(axis=1)
    classic = ~np.asarray(topo.is_otoo, dtype=bool)
    virtual = int(np.asarray(topo.has_virtual, dtype=bool).sum())
    routed = np.zeros(N, dtype=bool)
    phi_c_words = 0
    if scn.routing is not None:
        rt = scn.routing
        ids = np.asarray(rt.routed_ids.detach().cpu())
        routed[ids] = True
        members = np.asarray(rt.phi_c_members.detach().cpu()).reshape(ids.size, M, M, -1)
        live = (members >= 0).any(axis=-1) | (np.asarray(rt.offdiag_uniform.detach().cpu()) != 0)
        phi_c_words = int(live[classic[ids]].sum())
    base_pairs = int((arity * (arity - 1))[classic & ~routed].sum())
    if dense_phi:
        base_pairs, phi_c_words = 0, int((arity * (arity - 1))[classic].sum())
    words = (4 * batch * E + 2 * batch * N + 2 * virtual * (batch if per_replica_nodes else 1)
             + base_pairs + batch * phi_c_words)
    return item_bytes * words, OPS_PER_PAIR * batch * int((arity * arity)[classic].sum())


def least_seconds_call(scn, batch: int, per_replica_nodes: bool) -> float:
    """One call for ``batch`` replicas."""
    moved, ops = bytes_and_ops(scn, batch, per_replica_nodes)
    return least_seconds(moved, ops)
