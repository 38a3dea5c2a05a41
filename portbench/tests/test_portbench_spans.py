"""The reduction of the program's spans (``portbench/spans.py``) and the
readers over it, on synthetic traces: device operations paired with their
enqueuing calls in order and put under the innermost span, None where the
counts differ or the program has no spans, the host issue time less the
time blocked on a full launch queue, and a value from every new reader.

    python -m pytest --noconftest -p no:cacheprovider portbench/tests
"""

import json
import sys
from pathlib import Path
from types import SimpleNamespace as NS

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import spans, spec  # noqa: E402
from portbench.trace import Trace  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
MS = 1_000_000  # ns


def env_trace(steps: int = 2, blocked=()) -> Trace:
    """``steps`` RL steps 100 ms apart, each: an action draw outside any
    span (one launch), then ``env.step`` around ``env.actions`` (a copy),
    ``engine.step`` with its six phases (one launch each, the routing phase
    two) and ``env.rewards`` (one launch).  Device operation k runs
    ``k + 1`` µs; the copy's is named as the profiler names one."""
    host, enq = [], []
    for s in range(steps):
        t = s * 100 * MS
        enq.append(("cudaLaunchKernel", t + 1 * MS))  # the harness's action draw
        host.append(("env.step", t + 2 * MS, t + 90 * MS))
        host.append(("env.actions", t + 3 * MS, t + 5 * MS))
        enq.append(("cudaMemcpyAsync", t + 4 * MS))
        host.append(("engine.step", t + 10 * MS, t + 70 * MS))
        for i, ph in enumerate(("history", "sending", "routing", "receiving", "node_solve",
                                "link_update")):
            a = t + (11 + 9 * i) * MS
            host.append((f"engine.{ph}", a, a + 8 * MS))
            enq.append(("cuLaunchKernel" if ph == "history" else "cudaLaunchKernel", a + MS))
            if ph == "routing":
                enq.append(("cudaLaunchKernelExC", a + 2 * MS))
        host.append(("env.rewards", t + 75 * MS, t + 80 * MS))
        enq.append(("cudaLaunchKernel", t + 76 * MS))
    host += [(name, at, at + 1000) for name, at in enq]
    host += [("aten::add", 5, 10), ("cudaStreamSynchronize", 1, 2)]
    host += [("Command Buffer Full", a, b) for a, b in blocked]
    kernels = [("Memcpy DtoD (Device -> Device)" if name.startswith("cudaMemcpy") else f"k{k}",
                10**12 + k * 10**6, 10**12 + k * 10**6 + (k + 1) * 1000)
               for k, (name, _) in enumerate(enq)]
    return Trace(steps=steps, window_s=0.2, kernels=kernels[::-1], launches=len(enq),
                 host=host)


def test_operations_go_under_their_innermost_span():
    by = spans.device_ns_by_span(env_trace(steps=1))
    # operations 0..9 in issue order: draw, copy, six phases (routing two), rewards
    assert by == {None: 1000, "env.actions": 2000, "engine.history": 3000,
                  "engine.sending": 4000, "engine.routing": 5000 + 6000,
                  "engine.receiving": 7000, "engine.node_solve": 8000,
                  "engine.link_update": 9000, "env.rewards": 10000}


def test_first_operations_lost_at_the_start():
    """The device records of the segment's first operations missing: the
    rest pair from the end, the lost ones' calls left out."""
    tr = env_trace(steps=2)
    ops = sorted(tr.kernels, key=lambda k: k[1])
    tr.kernels = ops[3:]  # the draw, the copy and the first history read lost
    by = spans.device_ns_by_span(tr)
    assert by["engine.history"] == 13000 and by["engine.sending"] == 4000 + 14000
    assert by[None] == 11000 and by["env.actions"] == 12000


def test_per_step_and_missing_readings():
    tr = env_trace(steps=2)
    # the second step's history read is operation 12: 13 µs
    assert spans.device_ms_per_step(tr, ("engine.history",)) == pytest.approx((3 + 13) / 1e3 / 2)
    assert spans.device_ms_per_step(tr, ("engine.no_such",)) is None
    more = env_trace(steps=2)
    more.kernels = more.kernels + [("k", 10**13, 10**13 + 1)]  # more operations than calls
    assert spans.device_ns_by_span(more) is None
    assert spans.device_ms_per_step(more, ("engine.history",)) is None
    mid = env_trace(steps=2)
    ops = sorted(mid.kernels, key=lambda k: k[1])
    mid.kernels = ops[:2] + ops[3:]  # lost mid-segment: the copy pairs with no copy call
    assert spans.device_ns_by_span(mid) is None
    bare = env_trace()
    bare.host = [h for h in bare.host if not h[0].startswith(spans.SPAN_PREFIXES)]
    assert spans.device_ms_per_step(bare, ("engine.history",)) is None
    assert spans.host_issue_ms(bare) is None


def test_host_issue_leaves_out_the_blocked_time():
    assert spans.host_issue_ms(env_trace()) == pytest.approx(88.0)  # env.step, outermost
    # blocked 10 ms inside the first step, 5 ms across the second's end
    tr = env_trace(blocked=[(20 * MS, 30 * MS), (185 * MS, 195 * MS)])
    assert spans.host_issue_ms(tr) == pytest.approx((88 - 10 + 88 - 5) / 2)
    rollout = env_trace()
    rollout.host = [h for h in rollout.host if not h[0].startswith("env.")]
    assert spans.host_issue_ms(rollout) == pytest.approx(60.0)  # engine.step


def test_kept_seconds(monkeypatch):
    from pednstream_tpu_torch import tracing

    monkeypatch.setattr(tracing, "_KEPT", [("scenario.od_paths", "scenario.build", 0, 2 * 10**9),
                                           ("scenario.build", None, 0, 3 * 10**9),
                                           ("scenario.build", None, 0, 10**9)])
    assert spans.kept_seconds("scenario.build") == pytest.approx(4.0)
    assert spans.kept_seconds("scenario.od_paths") == pytest.approx(2.0)
    assert spans.kept_seconds("scenario.nothing") is None


NEW = [m for m in BENCH["per_layer"]
       if m["name"].split(".")[0] in ("history_ms_per_step", "sending_ms_per_step",
                                      "routing_ms_per_step", "receiving_ms_per_step",
                                      "node_solve_ms_per_step", "link_update_ms_per_step",
                                      "env_ms_per_step", "host_issue_ms_per_step",
                                      "scenario_build_s", "od_paths_s")]


def test_nineteen_new_metrics():
    assert len(NEW) == 19
    assert all(len(m["workloads"]) == 1 for m in NEW)


@pytest.mark.parametrize("name", [m["name"] for m in NEW])
def test_each_new_reader_reads_a_synthetic_run(name, monkeypatch):
    from pednstream_tpu_torch import tracing

    monkeypatch.setattr(tracing, "_KEPT", [("scenario.od_paths", "scenario.build", 0, 10**9),
                                           ("scenario.build", None, 0, 2 * 10**9)])
    value = spec.metric_reader(name)(NS(trace=env_trace()))
    assert value is not None and value > 0
