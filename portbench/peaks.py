"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit): the yardstick of every roofline
share.  A result states the card's power limit beside the share."""

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12  # outside the tensor cores
FP64_OPS_PER_S = 34e12  # outside the tensor cores


def least_seconds(moved_bytes: float, ops: float, item_bytes: int = 4) -> float:
    """The least time for ``moved_bytes`` and ``ops`` floating-point
    operations of ``item_bytes``-byte floats: the larger of the two bounds."""
    rate = FP32_OPS_PER_S if item_bytes == 4 else FP64_OPS_PER_S
    return max(moved_bytes / HBM_BYTES_PER_S, ops / rate)
