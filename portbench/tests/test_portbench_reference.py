"""The plain reference against the program's CPU path, a few steps from the
same start with the same generator streams: melbourne at B=2 and the
randomized env at B=2, every state leaf, the routed turning fractions, the
binomial samples, the observations and the rewards bit for bit; the
reference's own scenario build against the program's.

    python -m pytest --noconftest -p no:cacheprovider portbench/tests
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import drivers, spec  # noqa: E402

CPU = torch.device("cpu")


def leaves(x):
    return {f.name: getattr(x, f.name) for f in dataclasses.fields(x)
            if isinstance(getattr(x, f.name), torch.Tensor)}


def assert_same(a, b):
    la, lb = leaves(a), leaves(b)
    assert la.keys() == lb.keys()
    for k in la:
        assert torch.equal(la[k], lb[k]), k


def test_reference_scenario_matches_the_program():
    cell = spec.load_cell("melbourne.rollout")
    prog = drivers.make_driver(cell.config, cell.traffic, CPU).scn
    ref = drivers.make_reference(cell.config, cell.traffic, CPU).scn
    assert (prog.n_links, prog.n_nodes, prog.max_deg, prog.H) == (
        ref.n_links, ref.n_nodes, ref.max_deg, ref.H)
    assert_same(prog.engine_params, ref.engine_params)
    for name in ("in_safe", "out_safe", "end_flat", "start_flat", "reverse_idx"):
        assert torch.equal(getattr(prog, name), getattr(ref, name)), name


def test_rollout_steps_agree_bitwise():
    cell = spec.load_cell("melbourne.rollout")
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


def test_env_steps_agree_bitwise():
    cell = spec.load_cell("45_intersections.env")
    cell.traffic = dict(cell.traffic, batch=2)
    d = drivers.make_driver(cell.config, cell.traffic, CPU)
    reference = drivers.make_reference(cell.config, cell.traffic, CPU)
    d.begin(17)
    d.reset()
    rows = torch.arange(2)
    start = d.start_record(rows)
    eps = reference.engine_params(start["world_gen"], rows)
    assert_same(start["eps"], eps)
    assert_same(start["state"], reference.scn.init_state(2))
    for _ in range(6):
        pre = d.snapshot(rows)
        post = d.captured_step(rows)
        want = reference.step(pre, rows, eps, binom_in=post["binom_in"])
        assert_same(post["state"], want["state"])
        for key in ("obs", "rewards"):
            for agent in post[key]:
                assert torch.equal(post[key][agent], want[key][agent]), (key, agent)
        for a, b in zip(post["phi"], want["phi"]):
            assert torch.equal(a, b)
    assert np.isfinite(float(d.states.num_peds.sum()))
