"""The port's remaining drivers on the CPU against the JAX package's:
``reset_determinism_report``, ``retrain_r3``, ``ablate_global_reward``,
the dashboard (``network_dashboard``) and ``entry()``; nothing is written
under ``artifacts/``."""

import importlib.util
import json
import os
import shutil
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

import pednstream_tpu.rl.evaluate as jax_evaluate
from pednstream_tpu_torch import engine
from pednstream_tpu_torch.entry import entry
from pednstream_tpu_torch.generator import NetworkEnvGenerator
from pednstream_tpu_torch.io import OutputHandler
from pednstream_tpu_torch.rl import evaluate as port_evaluate
from pednstream_tpu_torch.scripts import (ablate_global_reward, network_dashboard,
                                          reset_determinism_report, retrain_r3)
from pednstream_tpu_torch.scripts import train_zoo as tz

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import train_zoo as jtz  # noqa: E402  (the JAX script)

torch.set_num_threads(1)


def jax_module(path, name):
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def artifacts_listing() -> dict:
    return {str(p.relative_to(ROOT)): (p.stat().st_size, p.stat().st_mtime_ns)
            for p in sorted((ROOT / "artifacts").rglob("*")) if p.is_file()}


BEFORE = artifacts_listing()


@pytest.fixture(autouse=True)
def float32_jax():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


# -- reset_determinism_report ---------------------------------------------------

def test_pca_2d_matches_jax():
    jmod = jax_module("scripts/reset_determinism_report.py", "jax_reset_report")
    x = np.random.default_rng(0).normal(size=(40, 12)).astype(np.float32)
    np.testing.assert_array_equal(reset_determinism_report.pca_2d(x), jmod.pca_2d(x))


def test_reset_report_files_match_jax(tmp_path, monkeypatch, capsys):
    """Same-seed no-action episodes through both envs: the files the JAX
    script writes, with the same keys and shapes, both deterministic."""
    jmod = jax_module("scripts/reset_determinism_report.py", "jax_reset_report")
    argv = ["--episodes", "2", "--steps", "3"]
    monkeypatch.setattr(sys, "argv", ["x", *argv, "--out", str(tmp_path / "jax")])
    jmod.main()
    reset_determinism_report.main([*argv, "--out", str(tmp_path / "port"), "--device", "cpu"])
    assert "max cross-episode deviation: 0.0 (DETERMINISTIC)" in capsys.readouterr().out
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax")) == [
        "episode_states.json", "pca_episodes.png", "statistics.json"]
    for name in ("statistics.json", "episode_states.json"):
        got = json.loads((tmp_path / "port" / name).read_text())
        want = json.loads((tmp_path / "jax" / name).read_text())
        assert got.keys() == want.keys()
        for k in want:
            if isinstance(want[k], dict):
                assert got[k].keys() == want[k].keys()
                for kk in want[k]:
                    assert np.shape(got[k][kk]) == np.shape(want[k][kk])
            else:
                assert np.shape(got[k]) == np.shape(want[k])
    stats = json.loads((tmp_path / "port" / "statistics.json").read_text())
    assert stats["deterministic"] is True and stats["max_cross_episode_deviation"] == 0.0


# -- retrain_r3 ---------------------------------------------------------------

def record_calls(monkeypatch, owner, names, calls):
    def make(name):
        def rec(*args, **kw):
            for k in ("out", "device", "num_runs"):
                kw.pop(k, None)
            calls.append((name, tuple(os.path.realpath(a) if isinstance(a, str) and
                                      os.sep in a else a for a in args), kw))
            if name == "evaluate_agents":
                os.makedirs(kw["output_dir"], exist_ok=True)
                return {"ppo": [{"total_reward": -1.0}]}
            return "summary" if name == "summarize" else "ckpt"
        return rec
    for name in names:
        monkeypatch.setattr(owner, name, make(name))


@pytest.mark.parametrize("phase", ["ppo", "sac", "eval", "lstm"])
def test_retrain_phases_call_as_jax(phase, tmp_path, monkeypatch, capsys):
    """Each phase calls the zoo's training and evaluation functions as the
    JAX driver does (the same datasets, iteration counts, seeds,
    checkpoints and protocol), with ``out`` and ``device`` added; the eval
    phase also scores the lstm_ppo variant."""
    jmod = jax_module("scripts/retrain_r3.py", "jax_retrain_r3")
    jax_calls, port_calls = [], []
    record_calls(monkeypatch, jtz, ["train_ppo", "train_sac", "evaluate_zoo"], jax_calls)
    record_calls(monkeypatch, jax_evaluate, ["evaluate_agents", "summarize"], jax_calls)
    record_calls(monkeypatch, tz, ["train_ppo", "train_sac", "evaluate_zoo"], port_calls)
    record_calls(monkeypatch, port_evaluate, ["evaluate_agents", "summarize"], port_calls)
    monkeypatch.chdir(tmp_path)
    argv = ["--phase", phase, "--datasets", "butterfly_scC", "45_intersections"]
    monkeypatch.setattr(sys, "argv", ["x", *argv])
    jmod.main()
    retrain_r3.main([*argv, "--out", str(tmp_path / "port"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "FAILED" not in out
    for calls in (jax_calls, port_calls):  # the output directory differs by design
        for _, _, kw in calls:
            kw.pop("output_dir", None)
    assert port_calls == jax_calls
    assert len(port_calls) == {"ppo": 2, "sac": 2, "eval": 4, "lstm": 1}[phase]
    assert artifacts_listing() == BEFORE


@pytest.mark.slow
def test_retrain_phases_run_under_out(tmp_path, monkeypatch, capsys):
    """The ppo, sac and eval phases for real at a tiny size (butterfly_scC,
    one PPO iteration of 4 replicas per seed, one SAC episode, one paired
    run; the eval phase also scores the shipped lstm_ppo variant): every
    checkpoint and result lands under ``--out``, none under
    ``artifacts/``."""
    monkeypatch.setattr(tz, "DATASETS", {"butterfly_scC": (15, 1, 1),
                                         "45_intersections": (15, 1, 1)})
    real = tz.train_ppo
    monkeypatch.setattr(tz, "train_ppo", lambda *a, **kw: real(
        *a, **{**kw, "num_envs": 4, "rollout_len": 2}))
    out = tmp_path / "out"
    for phase in ("ppo", "sac", "eval"):
        retrain_r3.main(["--phase", phase, "--datasets", "butterfly_scC", "--num-runs", "1",
                         "--out", str(out), "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "FAILED" not in printed and "=== phase eval done" in printed
    assert (out / "eval" / "butterfly_scC" / "results.json").exists()
    assert (out / "eval_butterfly_scC" / "table.txt").exists()
    assert (out / "zoo" / "sac_agents_butterfly_scC").is_dir()
    assert (out / "eval_45_intersections_lstm" / "results.json").exists()
    assert artifacts_listing() == BEFORE


# -- ablate_global_reward -------------------------------------------------------

def test_ablation_matches_jax_and_loads_in_jax(tmp_path, monkeypatch):
    """One candidate at one iteration (4 replicas) and one evaluation run:
    its export is scored by the JAX ablation's own ``eval_candidate``
    (the JAX package loads it), and ``ablation.json`` has the JAX rows'
    keys."""
    real_train = ablate_global_reward.train_candidate
    monkeypatch.setattr(ablate_global_reward, "train_candidate",
                        lambda *a, **kw: real_train(*a, **kw, num_envs=4))
    port_rows = ablate_global_reward.main([
        "--dataset", "butterfly_scC", "--coefs", "0.1", "--iters", "1", "--num-runs", "1",
        "--out", str(tmp_path / "port"), "--device", "cpu"])
    base = tmp_path / "port" / "ablate_butterfly_scC"
    ckpt = base / "coef0.1_T16"
    cfg = json.loads((ckpt / "config.json").read_text())
    assert cfg["global_reward_coef"] == 0.1 and cfg["iterations"] == 1
    curve = json.loads((ckpt / "curve.json").read_text())

    jmod = jax_module("scripts/ablate_global_reward.py", "jax_ablate")

    def train(dataset, action_gap, iterations, coef, rollout_len, out, seed=0):
        shutil.copytree(ckpt, out)  # the port's export, where the JAX script looks
        return curve

    real_eval = jax_evaluate.evaluate_agents
    monkeypatch.setattr(jmod, "train_candidate", train)
    monkeypatch.setattr(jax_evaluate, "evaluate_agents",
                        lambda *a, **kw: real_eval(*a, **{**kw, "num_runs": 1}))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", ["x", "--dataset", "butterfly_scC", "--coefs", "0.1",
                                      "--iters", "1"])
    jmod.main()
    jax_rows = json.loads((tmp_path / "outputs" / "ablate_butterfly_scC" /
                           "ablation.json").read_text())
    got = json.loads((base / "ablation.json").read_text())
    assert got == json.loads(json.dumps(port_rows))
    assert [list(r) for r in got] == [list(r) for r in jax_rows]
    for g, w in zip(got, jax_rows):
        assert len(g["reward_per_run"]) == len(w["reward_per_run"]) == 1
        assert w["reward_mean"] < 0 and g["reward_mean"] < 0
        assert {k: g[k] for k in ("dataset", "coef", "rollout_len", "iters")} == \
            {k: w[k] for k in ("dataset", "coef", "rollout_len", "iters")}
    assert artifacts_listing() == BEFORE


# -- network_dashboard ---------------------------------------------------------

@pytest.fixture(scope="module")
def saved_run(tmp_path_factory):
    """A deterministic butterfly_scC run of the port, saved by its handler."""
    args = NetworkEnvGenerator(device="cpu").scenario_args("butterfly_scC")
    args["params"]["seed"] = 3
    from pednstream_tpu_torch.scenario import build_scenario

    scn = build_scenario(**args, device="cpu")
    _, outs = engine.simulate(scn, scn.engine_params, scn.init_state(), 60)
    handler = OutputHandler(base_dir=str(tmp_path_factory.mktemp("dash")), simulation_dir="run")
    handler.save_scenario_state(scn, outs)
    return str(handler.simulation_dir)


def test_dashboard_html_matches_jax(saved_run, tmp_path, monkeypatch, capsys):
    jmod = jax_module("network_dashboard.py", "jax_dashboard")
    monkeypatch.setattr(sys, "argv", ["x", "--sim-dir", saved_run,
                                      "--html", str(tmp_path / "jax.html")])
    jmod.main()
    network_dashboard.main(["--sim-dir", saved_run, "--html", str(tmp_path / "port.html")])
    assert f"wrote {tmp_path / 'port.html'}" in capsys.readouterr().out
    html = (tmp_path / "port.html").read_text()
    assert html == (tmp_path / "jax.html").read_text()
    assert "<svg" in html and '"density"' in html


class StreamlitStub(types.ModuleType):
    """A ``streamlit`` that records each call (figures by type)."""

    def __init__(self, calls):
        super().__init__("streamlit")
        self._calls = calls

    def _rec(self, name, args, kw):
        self._calls.append((name, tuple(type(a).__name__ if hasattr(a, "savefig") else a
                                        for a in args), kw))

    def set_page_config(self, *a, **kw):
        self._rec("set_page_config", a, kw)

    def title(self, *a, **kw):
        self._rec("title", a, kw)

    def columns(self, *a, **kw):
        self._rec("columns", a, kw)
        return [Column() for _ in a[0]]

    def selectbox(self, *a, **kw):
        self._rec("selectbox", a, kw)
        return a[1][0]

    def slider(self, *a, **kw):
        self._rec("slider", a, kw)
        return 5

    def multiselect(self, *a, **kw):
        self._rec("multiselect", a, kw)
        return a[1][:2]

    def pyplot(self, *a, **kw):
        self._rec("pyplot", a, kw)


class Column:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_dashboard_streamlit_calls_match_jax(saved_run, monkeypatch):
    """The streamlit app makes the JAX dashboard's calls (a stub
    ``streamlit`` records them); without streamlit both exit 1."""
    jmod = jax_module("network_dashboard.py", "jax_dashboard")
    got, want = [], []
    monkeypatch.setitem(sys.modules, "streamlit", StreamlitStub(want))
    jmod.run_dashboard(saved_run)
    monkeypatch.setitem(sys.modules, "streamlit", StreamlitStub(got))
    network_dashboard.run_dashboard(saved_run)
    assert got == want
    assert [c[0] for c in got].count("pyplot") == 2
    monkeypatch.setitem(sys.modules, "streamlit", None)
    for run in (jmod.run_dashboard, network_dashboard.run_dashboard):
        with pytest.raises(SystemExit) as e:
            run(saved_run)
        assert e.value.code == 1


# -- entry() ---------------------------------------------------------------------

def test_entry_step_equals_make_step():
    """``entry()``'s step is ``make_step``'s stochastic step of melbourne
    with a generator of the same seed, bit for bit."""
    fn, (state,) = entry("cpu", seed=5)
    got = fn(state)
    scn = NetworkEnvGenerator(device="cpu").create_network("melbourne")
    step = engine.make_step(scn, stochastic=True, gen=torch.Generator().manual_seed(5))
    want, _ = step(scn.engine_params, scn.init_state())
    assert got.t == want.t == 2
    for f in ("num_peds", "density", "cum_in", "cum_out", "inflow", "outflow",
              "virt_arr_cum", "cum_in_ring", "avg_tt"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert float(got.cum_in.sum()) > 0


def test_entry_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        entry()
