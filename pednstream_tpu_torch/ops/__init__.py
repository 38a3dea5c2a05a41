from .ncurve import (fused_history_reads, fused_history_reads_plain, fused_history_reads_ref,
                     lookback)

__all__ = ["fused_history_reads", "fused_history_reads_plain", "fused_history_reads_ref",
           "lookback"]
