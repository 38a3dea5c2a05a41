"""A run with the timed path broken underneath comes out not correct, once
for each fault a cell can have: a step that returns its state unchanged,
half of the batch left unstepped, one link's inflow altered where the
step produces it, every speed computed wrongly, and in the env every
reward, or every observation, computed wrongly (one chip: no exchange
between chips to leave out).  The harness runs on the CPU at a tiny size
with the committed limits, the look for a card skipped; the sound run
beside them comes out correct.

    python -m pytest --noconftest -p no:cacheprovider portbench/tests
"""

import io
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import pednstream_tpu_torch.engine as engine  # noqa: E402
import pednstream_tpu_torch.env.core as env_core  # noqa: E402
from portbench import run, spec  # noqa: E402
from portbench.check import ALTERED_PERSONS, skew  # noqa: E402

WORKLOADS = ["melbourne.rollout", "45_intersections.env"]


def broken_step(fault, real):
    def step(scn, ep, st, *args, **kwargs):
        new, out = real(scn, ep, st, *args, **kwargs)
        if fault == "unchanged":
            return st.replace(t=new.t), out
        if fault == "half_batch":
            half = st.batch // 2
            return new.replace(**{
                k: torch.cat([getattr(new, k)[:half], getattr(st, k)[half:]])
                for k in ("cum_in", "cum_out", "inflow", "outflow", "num_peds", "density",
                          "speed", "travel_time", "avg_tt", "tt_run_sum")}), out
        if fault == "speed":
            return new.replace(speed=skew(new.speed)), out
        inflow = new.inflow.clone()
        inflow[:, inflow.shape[1] // 2] += ALTERED_PERSONS
        return new.replace(inflow=inflow), out
    return step


def broken_output(real):
    def produce(self, *args, **kwargs):
        return {a: skew(x) for a, x in real(self, *args, **kwargs).items()}
    return produce


def tiny(workload):
    cell = spec.load_cell(workload)
    cell.traffic = dict(cell.traffic, batch=4, episode_steps=10, warm_steps=10, check_rows=4)
    return cell


FAULTS = [(w, f) for w in WORKLOADS for f in ("unchanged", "half_batch", "altered", "speed")]
FAULTS += [("45_intersections.env", "reward"), ("45_intersections.env", "obs")]


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_fault_is_not_correct(workload, fault, monkeypatch):
    if fault in ("reward", "obs"):
        name = {"reward": "_rewards", "obs": "_observations"}[fault]
        cls = env_core.PedNetEnvCore
        monkeypatch.setattr(cls, name, broken_output(getattr(cls, name)))
    else:
        real = engine.step_fn
        monkeypatch.setattr(engine, "step_fn", broken_step(fault, real))
        monkeypatch.setattr(env_core, "step_fn", broken_step(fault, real))
    out = run.run_cell(tiny(workload), 2 ** 31 + 3, 2.5, False, torch.device("cpu"),
                       report=io.StringIO())
    assert out["correct"] is False
    assert any(n > lim for n, lim in out["checks"].values())


@pytest.mark.parametrize("workload", WORKLOADS)
def test_sound_run_is_correct(workload):
    out = run.run_cell(tiny(workload), 2 ** 31 + 3, 2.5, False, torch.device("cpu"),
                       report=io.StringIO())
    assert out["correct"] is True
