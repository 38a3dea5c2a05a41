"""The benchmark's harness on the CPU at tiny sizes: its data found by name,
``BENCHMARK.json`` within the contract's characters, the command's
arguments and its last line, the bytes-and-operations functions on
hand-counted shapes, and the import rules (nothing under ``portbench/``
imports JAX or the JAX package; the reference imports nothing of the
program), top-level module names compared whole.

    python -m pytest --noconftest -p no:cacheprovider portbench/tests
"""

import ast
import io
import json
import re
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import run, spec  # noqa: E402
from portbench.bounds import binom_fast, turning_fractions  # noqa: E402
from portbench.peaks import FP32_OPS_PER_S, HBM_BYTES_PER_S  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")


def tiny(workload: str, batch: int = 4, steps: int = 10):
    """The cell with a tiny batch and short episodes; every replica is
    compared (on the CPU the exact binomial's draws depend on the whole
    batch's counts, so a sample of rows cannot replay them)."""
    cell = spec.load_cell(workload)
    cell.traffic = dict(cell.traffic, batch=batch, episode_steps=steps, warm_steps=10,
                        check_rows=batch, trace={"start": 4, "steps": 3})
    return cell


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append(entry["name"])
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert LINE.match(w["why"]) and w["chips"] in (1, 4)
    for c in BENCH["configs"]:
        assert LINE.match(c["why"]) and LINE.match(c["source"])
        assert all(NAME.match(k) for k in c["reduced"])
    for m in BENCH["per_layer"]:
        assert LINE.match(m["layer"])
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_end_to_end_bounds():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(workload):
    cell = spec.load_cell(workload)
    module = spec.traffic_module(cell.traffic["driver"])
    assert callable(module.Driver) and callable(module.Reference)
    assert set(module.Reference.faults) >= {"unchanged", "half_batch", "altered"}
    assert set(cell.limits) == {"group_mismatch", "count_gap"}
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.metric_reader(m["name"]))
    for m in cell.per_layer:
        assert m["moves"] in reported


def test_unknown_driver_and_metric_are_refused():
    with pytest.raises(FileNotFoundError):
        spec.traffic_module("no_such_driver")
    with pytest.raises(ValueError):
        spec.traffic_module("../run")
    with pytest.raises(FileNotFoundError):
        spec.metric_reader("no_such_metric.rollout")


def test_end_to_end_metric_without_a_value_stops_the_run(monkeypatch):
    entries = [{"name": "setup_s", "unit": "s"}, {"name": "tail_ms.served", "unit": "ms"}]
    ctx = run.Context(tiny("melbourne.rollout"), None, None, 9.5, None, 1.0)
    monkeypatch.setattr(spec, "metric_reader",
                        lambda name: (lambda c: c.setup_s) if name == "setup_s" else (lambda c: None))
    with pytest.raises(run.MissingMetric):
        run.read_metrics(entries, ctx, True)
    # a per-layer reader that finds nothing leaves its metric out
    assert run.read_metrics(entries, ctx, False) == {"setup_s": {"value": 9.5, "unit": "s"}}


def test_end_to_end_values_come_from_their_readers():
    from types import SimpleNamespace as NS

    cell = tiny("melbourne.rollout")
    ctx = run.Context(cell, None, None, 12.25, NS(timed_steps=10), 2.0)
    got = run.read_metrics(cell.end_to_end, ctx, True)
    assert got["setup_s"]["value"] == 12.25
    assert got["env_steps_per_s.rollout"]["value"] == 10 * 4 / 2.0


def test_each_group_is_judged_on_its_own():
    from portbench import check as ck

    tally = ck.Tally()
    big = torch.arange(100000, dtype=torch.float32)
    tally.add("step.cum_in_ring", big, big)
    tally.add("step.rewards.gate", torch.ones(16) * 2.0, torch.ones(16))
    numbers = tally.numbers()
    assert numbers["group_mismatch"] == 1.0
    assert numbers["count_gap"] == 0.0


def test_configs_hold_their_files():
    for c in BENCH["configs"]:
        path = ROOT / c["file"]
        assert path.is_relative_to(ROOT / "portbench")
        cfg = json.loads(path.read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]


def test_unknown_workload_raises():
    with pytest.raises(KeyError):
        spec.load_cell("no.such.cell")


def test_command_without_a_card_prints_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", BENCH["workloads"][0]["name"], "--seed", str(2 ** 33 + 7),
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err


def test_command_needs_its_arguments():
    with pytest.raises(SystemExit):
        run.main(["--workload", "melbourne.rollout"])


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_last_line_on_the_cpu(workload):
    report = io.StringIO()
    out = run.run_cell(tiny(workload), 2 ** 31 + 99, 2.0, True, torch.device("cpu"),
                       report=report)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    # a CPU rehearsal names no device metric
    assert out["metrics"] == {} and out["device"]["platform"] == "cpu"
    assert set(out["checks"]) == {"group_mismatch", "count_gap"}
    for number, limit in out["checks"].values():
        assert number <= limit
    lines = report.getvalue().strip().splitlines()
    assert lines[-1].startswith("check ") and "limit" in lines[-1]
    json.dumps(out)


def test_jax_loaded_after_the_window_prints_no_result(capsys, monkeypatch):
    """JAX brought in by the check, after the look that follows the window,
    is still found before the result line: the run prints nothing."""
    import types

    from portbench import check as ck

    assert not run.forbidden_modules()
    cell = tiny("melbourne.rollout")
    real_run_cell, real_run_checks = run.run_cell, ck.run_checks

    def run_checks(*args, **kwargs):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return real_run_checks(*args, **kwargs)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(spec, "load_cell", lambda name: cell)
    monkeypatch.setattr(ck, "run_checks", run_checks)
    monkeypatch.setattr(run, "run_cell", lambda cell, seed, seconds, trace, device: real_run_cell(
        cell, seed, seconds, trace, torch.device("cpu"), report=io.StringIO()))
    rc = run.main(["--workload", "melbourne.rollout", "--seed", "7", "--seconds", "0.5",
                   "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "jax" in out.err


def test_window_inputs_come_from_the_seed():
    cell = tiny("melbourne.rollout")
    a = run.run_cell(cell, 5, 0.5, False, torch.device("cpu"), report=io.StringIO())
    assert a["correct"]
    from portbench import drivers

    d = drivers.make_driver(cell.config, cell.traffic, torch.device("cpu"))
    finals = []
    for _ in range(2):
        d.begin(2 ** 31 + 5)
        d.reset()
        for _ in range(5):
            d.step()
        finals.append(d.states.cum_in.clone())
    assert torch.equal(finals[0], finals[1])


def test_binom_bound_hand_counted():
    # n elements: the count, the sample and one random input move once, p once
    n, p = 1000, 10
    moved = 4 * (3 * n + p)
    assert binom_fast.least_seconds_call(n, p, 0) == pytest.approx(
        max(moved / HBM_BYTES_PER_S, 8 * n / FP32_OPS_PER_S))
    assert binom_fast.least_seconds_call(n, p, n) == pytest.approx(
        max(moved / HBM_BYTES_PER_S, 100 * n / FP32_OPS_PER_S))
    # a step: release (p per element), reverse (one p), activity (p per link)
    B, E = 8, 5
    want = sum(binom_fast.least_seconds_call(B * E, q, B * E) for q in (B * E, 1, E))
    assert binom_fast.least_seconds_step(B, E, True) == pytest.approx(want)
    assert binom_fast.least_seconds_step(B, E, False) < want


def test_routing_bound_hand_counted():
    from types import SimpleNamespace as NS

    t = torch.tensor
    rt = NS(dist_util=t([0.0, 0.0, 0.0], dtype=torch.float32),
            te_down_link=t([3, 3, 5]), uo_od=t([0, 1]), num_entries=3,
            group_members=t([[[0, 1]], [[2, -1]]]), uo_group_members=t([[[0, 1]]]),
            phi_c_members=t([[[0, -1]], [[1, 2]]]), num_routed=1,
            node_offsets=t([[0, 0], [1, 1]]))
    B, M = 2, 2
    links, pairs, K, U, nnz, slots = 2, 2, 3, 2, (3, 2, 3), 4
    moved = (B * links * 8 + 0 + pairs * 4 * B + K * (24 + 4) + U * (16 + 4)
             + 8 * sum(nnz) + 4 * 8 + slots * 4 + B * slots * 4)
    ops = B * (31 * K + 2 * nnz[0] + nnz[1] + nnz[2] + U + 4 * slots)
    got = turning_fractions.least_seconds_call(rt, M, B, 0, True)
    assert got == pytest.approx(max(moved / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S))


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".", 1)[0]


def test_nothing_imports_jax_or_the_jax_package():
    forbidden = {"jax", "jaxlib", "flax", "pednstream_tpu"}
    for path in (ROOT / "portbench").rglob("*.py"):
        assert not set(_imports(path)) & forbidden, path


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "portbench" / "reference").rglob("*.py"):
        assert "pednstream_tpu_torch" not in set(_imports(path)), path
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.level == 2:
                raise AssertionError(f"{path} imports from outside the reference")
