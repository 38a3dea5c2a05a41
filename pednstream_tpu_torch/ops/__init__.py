from .binom import binom_fast, binom_fast_plain
from .ncurve import (PER_REPLICA_T, fused_history_reads, fused_history_reads_plain,
                     fused_history_reads_ref, lookback)
from .node_solve import node_solve, node_solve_plain
from .routing import turning_fractions, turning_fractions_step_plain

__all__ = ["PER_REPLICA_T", "binom_fast", "binom_fast_plain", "fused_history_reads",
           "fused_history_reads_plain", "fused_history_reads_ref", "lookback",
           "node_solve", "node_solve_plain", "turning_fractions",
           "turning_fractions_step_plain"]
