"""Named spans inside the port, on the clock of ``torch.profiler``'s trace.

``span(name)`` marks a stretch of host code: the engine step and its
phases (``engine.step``, ``engine.history``, ``engine.sending``,
``engine.routing``, ``engine.receiving``, ``engine.node_solve``,
``engine.link_update``) and the env's RL step (``env.step``,
``env.actions``, ``env.rewards``, ``env.observations``).  While no
profiler records it costs one flag check and enters a shared no-op; while
one records it opens a host-only record function, which lands in the
trace as a plain ``cpu_op`` event (a ``record_function`` would land as a
user annotation, which the profiler mirrors onto the device timeline).
Every device operation that a step enqueues can then be put under the
innermost span around the host call that enqueued it.

``kept_span(name)`` marks one-time work (``scenario.build``,
``scenario.od_paths``): whether or not a profiler records, it appends
``(name, parent, start_ns, end_ns)`` to an in-memory list on
``time.time_ns()``, the clock of the profiler's host timestamps, which
``kept_spans()`` reads back; ``parent`` is the name of the kept span it
ran inside, or None.  Under a profiler it also goes to the trace, as a
``span``.  Only work done once per build is kept, so the list grows with
builds and never with steps.  It works as a decorator too.

There is no switch: the profiler being on is the switch.
"""

import contextlib
import threading
import time
from typing import List, Optional, Tuple

from torch._C._autograd import _profiler_enabled
from torch._C._profiler import _RecordFunctionFast

_OFF = contextlib.nullcontext()
_KEPT: List[Tuple[str, Optional[str], int, int]] = []
_OPEN = threading.local()  # the names of the kept spans open on this thread


def span(name: str):
    """A context manager that records ``name`` in a running profiler's
    trace, as a host event only, and does nothing otherwise."""
    if _profiler_enabled():
        return _RecordFunctionFast(name)
    return _OFF


@contextlib.contextmanager
def kept_span(name: str):
    """A :func:`span` whose interval is also kept (module docstring)."""
    stack = _OPEN.__dict__.setdefault("names", [])
    parent = stack[-1] if stack else None
    stack.append(name)
    start = time.time_ns()
    try:
        with span(name):
            yield
    finally:
        _KEPT.append((name, parent, start, time.time_ns()))
        stack.pop()


def kept_spans() -> List[Tuple[str, Optional[str], int, int]]:
    """The kept spans of this process so far, in the order they ended."""
    return list(_KEPT)
