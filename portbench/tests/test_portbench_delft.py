"""Delft as published, the rollout cell with a shared OD column and
full-horizon rings, on the CPU at B=2: the reference's scenario build against
the program's and six steps bit for bit (state, turning fractions, binomial
samples); the routing bound with the OD column counted once for the batch;
each span stem read once in the cell.

    python -m pytest --noconftest -p no:cacheprovider portbench/tests
"""

import dataclasses
import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import drivers, spec  # noqa: E402
from portbench.bounds import turning_fractions  # noqa: E402
from portbench.peaks import FP32_OPS_PER_S, HBM_BYTES_PER_S  # noqa: E402

CPU = torch.device("cpu")
CELL = "delft.rollout_full"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SPAN_STEMS = ("history_ms_per_step", "sending_ms_per_step", "routing_ms_per_step",
              "receiving_ms_per_step", "node_solve_ms_per_step", "link_update_ms_per_step",
              "host_issue_ms_per_step", "scenario_build_s", "od_paths_s")


def leaves(x):
    return {f.name: getattr(x, f.name) for f in dataclasses.fields(x)
            if isinstance(getattr(x, f.name), torch.Tensor)}


def assert_same(a, b):
    la, lb = leaves(a), leaves(b)
    assert la.keys() == lb.keys()
    for k in la:
        assert torch.equal(la[k], lb[k]), k


def test_delft_reference_scenario_matches_the_program():
    cell = spec.load_cell(CELL)
    prog = drivers.make_driver(cell.config, cell.traffic, CPU).scn
    ref = drivers.make_reference(cell.config, cell.traffic, CPU).scn
    assert (prog.n_links, prog.n_nodes, prog.max_deg, prog.H) == (
        ref.n_links, ref.n_nodes, ref.max_deg, ref.H)
    shape = cell.config["shape"]
    assert (prog.n_links, prog.n_nodes, prog.H) == (
        shape["links"], shape["nodes"], shape["ring_rows"])
    assert_same(prog.engine_params, ref.engine_params)
    for name in ("in_safe", "out_safe", "end_flat", "start_flat", "reverse_idx"):
        assert torch.equal(getattr(prog, name), getattr(ref, name)), name


def test_delft_rollout_steps_agree_bitwise():
    cell = spec.load_cell(CELL)
    cell.traffic = dict(cell.traffic, batch=2)
    d = drivers.make_driver(cell.config, cell.traffic, CPU)
    reference = drivers.make_reference(cell.config, cell.traffic, CPU)
    d.begin(2 ** 32 + 1)
    d.reset()
    rows = torch.arange(2)
    for _ in range(6):
        pre = d.snapshot(rows)
        post = d.captured_step(rows)
        want = reference.step(pre, rows)
        assert_same(post["state"], want["state"])
        for key in ("phi", "binom"):
            assert len(post[key]) == len(want[key])
            for a, b in zip(post[key], want[key]):
                assert torch.equal(a, b), key


@pytest.mark.parametrize("od_per_replica", [True, False])
def test_routing_bound_od_column_counted_per_column(od_per_replica):
    """The OD column's bytes count once a replica where each replica has its
    own pairs (the env), once for the batch where the column is shared (the
    rollouts, delft's 140 pairs among them)."""
    from types import SimpleNamespace as NS

    t = torch.tensor
    rt = NS(dist_util=t([0.0, 0.0, 0.0], dtype=torch.float32),
            te_down_link=t([3, 3, 5]), uo_od=t([0, 1]), num_entries=3,
            group_members=t([[[0, 1]], [[2, -1]]]), uo_group_members=t([[[0, 1]]]),
            phi_c_members=t([[[0, -1]], [[1, 2]]]), num_routed=1,
            node_offsets=t([[0, 0], [1, 1]]))
    B, M = 2, 2
    links, pairs, K, U, nnz, slots = 2, 2, 3, 2, (3, 2, 3), 4
    od_columns = B if od_per_replica else 1
    moved = (B * links * 8 + 0 + pairs * 4 * od_columns + K * (24 + 4) + U * (16 + 4)
             + 8 * sum(nnz) + 4 * 8 + slots * 4 + B * slots * 4)
    ops = B * (31 * K + 2 * nnz[0] + nnz[1] + nnz[2] + U + 4 * slots)
    got = turning_fractions.least_seconds_call(rt, M, B, 0, od_per_replica)
    assert got == pytest.approx(max(moved / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S))


def test_delft_reads_each_span_stem_once():
    names = [m["name"] for m in BENCH["per_layer"] if CELL in m.get("workloads", [])]
    stems = [n.split(".")[0] for n in names]
    assert len(stems) == len(set(stems))
    assert set(SPAN_STEMS) <= set(stems)
    assert {"kernel_ms_per_step", "launches_per_step", "idle_share",
            "turning_fractions_roofline", "binom_fast_roofline"} <= set(stems)
