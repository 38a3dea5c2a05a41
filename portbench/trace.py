"""The reduction of a ``torch.profiler`` trace of the traced segment to what
the per-layer readers and the result line need: device intervals, launch
records, busy and idle time, and the breakdown."""

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

LAUNCH_PREFIXES = ("cudaLaunch", "cuLaunch")
NAME_CHARS = 120  # of an operation's name in the breakdown


@dataclass
class Trace:
    steps: int  # batch steps issued in the traced segment
    window_s: float  # host wall of the segment, issue to the closing synchronize
    kernels: List[Tuple[str, int, int]]  # (name, start ns, end ns) of each device operation
    launches: int  # cudaLaunch* / cuLaunch* records
    host: List[Tuple[str, int, int]] = field(default_factory=list)  # host events (name, start, end)
    counted: Dict[str, int] = field(default_factory=dict)  # the program's launch counters

    def busy_s(self) -> float:
        return sum(b - a for a, b in union(self.kernels)) / 1e9

    def device_seconds(self, names) -> Tuple[float, int]:
        """Summed device time of the operations whose name contains one of
        ``names``, and how many there were."""
        total, count = 0, 0
        for name, a, b in self.kernels:
            if any(n in name for n in names):
                total += b - a
                count += 1
        return total / 1e9, count


def union(intervals) -> List[Tuple[int, int]]:
    """The union of ``(name, start, end)`` intervals as sorted ``(start, end)``."""
    out: List[List[int]] = []
    for _, a, b in sorted(intervals, key=lambda x: x[1]):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def from_profiler(prof, steps: int, window_s: float) -> Trace:
    """A :class:`Trace` from a stopped ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    kernels, host, launches = [], [], 0
    for e in prof.profiler.kineto_results.events():
        start, dur = e.start_ns(), e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            kernels.append((e.name(), start, start + dur))
            continue
        name = e.name()
        if name.startswith(LAUNCH_PREFIXES):
            launches += 1
        host.append((name, start, start + dur))
    return Trace(steps=steps, window_s=window_s, kernels=kernels, launches=launches, host=host)


def breakdown(trace: Trace, top: int = 10) -> Dict[str, list]:
    """The device operations with the most time, and the idle gaps between
    device work summed by the innermost host event under each gap's middle
    (``python`` where none is)."""
    by_op: Dict[str, float] = {}
    for name, a, b in trace.kernels:
        by_op[name] = by_op.get(name, 0.0) + (b - a) / 1e9
    busy = union(trace.kernels)
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)
            if busy[i + 1][0] > busy[i][1]]
    host = sorted(trace.host, key=lambda x: x[1])
    starts = [h[1] for h in host]
    import bisect

    by_host: Dict[str, float] = {}
    for a, b in gaps:
        mid = (a + b) // 2
        name, best = "python", None
        # the latest-starting host event that covers the middle
        i = bisect.bisect_right(starts, mid)
        for h in reversed(host[max(0, i - 64):i]):
            if h[2] >= mid:
                if best is None or h[1] > best:
                    name, best = h[0], h[1]
        by_host[name] = by_host.get(name, 0.0) + (b - a) / 1e9

    def rank(d):
        return [[k[:NAME_CHARS], v]
                for k, v in sorted(d.items(), key=lambda kv: kv[1], reverse=True)[:top]]

    return {"device_ops": rank(by_op), "idle_gaps": rank(by_host)}
