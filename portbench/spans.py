"""The program's own spans (``pednstream_tpu_torch.tracing``) read from the
traced segment (``trace.Trace``) and from the program's kept spans.

Each device operation is paired with the host call that enqueued it: the
program issues on one stream, which runs its work in issue order, so the
k-th ``cudaLaunch*`` / ``cuLaunch*`` / ``cudaMemcpy*Async`` /
``cudaMemset*Async`` call enqueued the k-th operation on the device.  The
profiler can miss the device records of a segment's first operations (on
the H100, 0 to 9 of ~17,500, those that ran within microseconds of its
start), so the two lists are aligned at their ends: the last operation
with the last call.  The pairing must then give each operation a call of
its kind (a kernel a launch, a copy a copy, a set a set); where it does
not, or where the device holds more operations than there were calls,
every reading here is None, so a metric goes missing rather than wrong.
An operation belongs to the innermost program span open around its
enqueuing call.  A program without spans gives None too.
"""

from typing import Dict, List, Optional, Tuple

SPAN_PREFIXES = ("engine.", "env.", "scenario.")
BLOCKED = "Command Buffer Full"  # the host waits on a full launch queue


def is_enqueue(name: str) -> bool:
    """Whether the host call ``name`` puts work on the device."""
    return (name.startswith(("cudaLaunch", "cuLaunch"))
            or (name.startswith(("cudaMemcpy", "cudaMemset")) and name.endswith("Async")))


def program_spans(trace) -> List[Tuple[str, int, int]]:
    """The program's spans among the segment's host events, by start."""
    return sorted((h for h in trace.host if h[0].startswith(SPAN_PREFIXES)),
                  key=lambda h: (h[1], -h[2]))


def _kind(name: str, call: bool) -> str:
    """``copy``, ``set`` or ``kernel``: of a device operation's name, or of
    its enqueuing call's (``call``)."""
    copy, fill = ("cudaMemcpy", "cudaMemset") if call else ("Memcpy", "Memset")
    return "copy" if name.startswith(copy) else "set" if name.startswith(fill) else "kernel"


def device_ns_by_span(trace) -> Optional[Dict[Optional[str], int]]:
    """Device nanoseconds summed by the innermost program span around each
    operation's enqueuing call (key None: outside every span); None where
    the operations and the enqueuing calls do not pair up (module
    docstring)."""
    ops = sorted(trace.kernels, key=lambda k: k[1])
    calls = sorted((h for h in trace.host if is_enqueue(h[0])), key=lambda h: h[1])
    if len(ops) > len(calls):
        return None
    calls = calls[len(calls) - len(ops):]
    if any(_kind(o[0], False) != _kind(c[0], True) for o, c in zip(ops, calls)):
        return None
    spans = program_spans(trace)
    out: Dict[Optional[str], int] = {}
    stack: List[Tuple[str, int, int]] = []
    i = 0
    for (_, a, b), (_, at, _) in zip(ops, calls):
        while i < len(spans) and spans[i][1] <= at:
            while stack and stack[-1][2] < spans[i][1]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][2] < at:
            stack.pop()
        name = stack[-1][0] if stack else None
        out[name] = out.get(name, 0) + (b - a)
    return out


def device_ms_per_step(trace, names) -> Optional[float]:
    """Device milliseconds per batch step of the operations whose innermost
    span is one of ``names``; None where no such span is in the segment
    or the pairing fails."""
    seen = {s[0] for s in program_spans(trace)}
    if not seen & set(names):
        return None
    by_span = device_ns_by_span(trace)
    if by_span is None:
        return None
    return sum(by_span.get(n, 0) for n in names) / 1e6 / trace.steps


def host_issue_ms(trace) -> Optional[float]:
    """The mean host milliseconds of the outermost program spans (those
    inside no other), less the part of each that the host spent blocked on
    a full launch queue (``Command Buffer Full``)."""
    outer = []
    for s in program_spans(trace):
        if not outer or s[1] > outer[-1][2]:
            outer.append(s)
    if not outer:
        return None
    blocked = sorted((h[1], h[2]) for h in trace.host if h[0] == BLOCKED)
    total = 0
    for _, a, b in outer:
        total += b - a
        for x, y in blocked:
            total -= max(0, min(b, y) - max(a, x))
    return total / 1e6 / len(outer)


def kept_seconds(name: str) -> Optional[float]:
    """The program's kept spans ``name`` of this process, summed, in
    seconds; None where the program keeps none."""
    try:
        from pednstream_tpu_torch.tracing import kept_spans
    except ImportError:
        return None
    found = [end - start for n, _, start, end in kept_spans() if n == name]
    return sum(found) / 1e9 if found else None
