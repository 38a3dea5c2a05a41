"""'optimal' node flow allocation: the LP merge/diverge mode.

Reference RegularNode.solve(type='optimal') (src/LTM/node.py:248-271):
maximize total node throughput subject to sending/receiving inequality
constraints and turning-fraction equality constraints relaxed with
penalty slack variables (weight w=1e-2, node.py:14), solved with scipy
linprog; flows are floored and aggregated through A_ub
(node.py:73-143,268-270).

A copy of ``pednstream_tpu/lp_solver.py`` (importing that package loads
JAX).  One golden fixture (optimal_diamond) uses this mode.  The engine
hands it each step's padded sending/receiving flows and turning fractions
as NumPy arrays and puts the result back on the device: one host round
trip per step, as the JAX engine's ``jax.pure_callback`` makes.
"""

from typing import List, Tuple

import numpy as np

from .topology import TopologySpec


class OptimalNodeSolver:
    """Host-side LP solve for all Regular nodes at one step."""

    def __init__(self, topo: TopologySpec, w_penalty: float = 1e-2):
        self.topo = topo
        self.w = w_penalty
        self.nodes: List[int] = [
            n for n in range(topo.n_nodes)
            if not topo.is_otoo[n] and topo.node_arity[n] >= 2
        ]
        # A_ub per node (node.py:73-108): rows = per-source sums then
        # per-dest sums over the edge_num flow variables; penalty columns 0.
        self._A_ub = {}
        for n in self.nodes:
            m = int(topo.node_arity[n])
            edge_num = m * (m - 1)
            A = np.zeros((2 * m, edge_num + 2 * edge_num))
            # enumerate edges row-major over (i, j != i)
            e = 0
            for i in range(m):
                for j in range(m):
                    if i == j:
                        continue
                    A[i, e] = 1.0  # source row i
                    A[m + j, e] = 1.0  # dest row j
                    e += 1
            self._A_ub[n] = A

    @staticmethod
    def _A_eq(phi_flat: np.ndarray, m: int) -> np.ndarray:
        """Turning-fraction equality rows (node.py:110-143)."""
        edge_num = m * (m - 1)
        A = np.zeros((edge_num, edge_num + 2 * edge_num))
        for i in range(edge_num):
            source_idx = i // (m - 1)
            start = source_idx * (m - 1)
            A[i, start : start + m - 1] = phi_flat[i]
            A[i, i] = phi_flat[i] - 1.0
            A[i, edge_num + 2 * i : edge_num + 2 * (i + 1)] = [1.0, -1.0]
        return A

    def __call__(self, s_pad: np.ndarray, r_pad: np.ndarray, phi: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """Solve each Regular node's LP; returns (q_in, q_out) [N, M]."""
        from scipy.optimize import linprog

        N, M = s_pad.shape
        q_in = np.zeros((N, M))
        q_out = np.zeros((N, M))
        for n in self.nodes:
            m = int(self.topo.node_arity[n])
            edge_num = m * (m - 1)
            s = np.asarray(s_pad[n, :m], dtype=np.float64)
            r = np.asarray(r_pad[n, :m], dtype=np.float64)
            # flatten phi row-major over off-diagonal slots
            phi_flat = np.array(
                [phi[n, i, j] for i in range(m) for j in range(m) if i != j]
            )
            c = np.concatenate([-np.ones(edge_num), self.w * np.ones(2 * edge_num)])
            b_ub = np.concatenate([s, r])
            A_ub = self._A_ub[n]
            A_eq = self._A_eq(phi_flat, m)
            res = linprog(c, A_ub=A_ub, A_eq=A_eq, b_ub=b_ub,
                          b_eq=np.zeros(edge_num))
            if res.success:
                flows = A_ub @ np.floor(res.x)
                q = np.maximum(0, flows)
                q_in[n, :m] = q[:m]
                q_out[n, :m] = q[m:]
        return q_in, q_out
