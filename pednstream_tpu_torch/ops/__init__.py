from .ncurve import fused_history_reads, fused_history_reads_ref

__all__ = ["fused_history_reads", "fused_history_reads_ref"]
