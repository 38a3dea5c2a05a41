from .ncurve import (PER_REPLICA_T, fused_history_reads, fused_history_reads_plain,
                     fused_history_reads_ref, lookback)

__all__ = ["PER_REPLICA_T", "fused_history_reads", "fused_history_reads_plain",
           "fused_history_reads_ref", "lookback"]
