from ..profiling import StepTimer, trace_profile
from .checkpoint import load_engine_state, save_engine_state
from .logging_utils import setup_logger

__all__ = ["setup_logger", "StepTimer", "trace_profile",
           "save_engine_state", "load_engine_state"]
