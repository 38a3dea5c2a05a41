"""``trace_profile`` under the module path of
``pednstream_tpu/utils/profiling.py``; it lives in
:mod:`pednstream_tpu_torch.profiling`."""

from ..profiling import trace_profile

__all__ = ["trace_profile"]
