"""``StepTimer`` and ``trace_profile`` under the module path of
``pednstream_tpu/utils/profiling.py``; they live in
:mod:`pednstream_tpu_torch.profiling`."""

from ..profiling import StepTimer, trace_profile

__all__ = ["StepTimer", "trace_profile"]
