"""The port's throughput sweeps and window quantification
(``pednstream_tpu_torch.scripts.{sweep_melbourne,sweep_grid,
quantify_window}``) on the CPU against the JAX scripts: the same rows, the
same scenario arguments, the same printed lines (a failed row included),
``simulate_batched`` called as the JAX ``measure`` calls it, and the
deterministic window rollouts equal to the JAX ones at a cut horizon."""

import copy
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

import pednstream_tpu.engine as jax_engine
import pednstream_tpu.generator as jax_generator
import pednstream_tpu.scenario as jax_scenario
from pednstream_tpu_torch import generator
from pednstream_tpu_torch.scenario import build_scenario
from pednstream_tpu_torch.scripts import quantify_window, sweep_grid, sweep_melbourne

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_scenario import assert_builds_match  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def jax_script(name):
    """``scripts/<name>.py`` as a module of its own."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def float32_jax():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


class Stub:
    """What a recorded ``build_scenario`` returns: carries its H."""

    def __init__(self, H):
        self.H = H


def record_sweep(monkeypatch, capsys, run, build_owner, measure_owner, failing_B):
    """Run a sweep's ``main`` with ``build_scenario`` and ``measure``
    recorded (``measure`` raises for ``failing_B``, else returns a rate
    from B); returns ``(printed lines, build calls, measure calls)``."""
    builds, measures = [], []

    def build(*args, **kw):
        kw.pop("device", None)
        builds.append((args, kw))
        return Stub(kw["history_window"])

    def measure(scn, batch, steps, *args, **kw):
        measures.append((scn.H, batch, steps))
        if batch == failing_B:
            raise MemoryError("out of memory at this batch")
        return 1000.0 * batch + 0.25

    monkeypatch.setattr(build_owner, "build_scenario", build)
    monkeypatch.setattr(measure_owner, "measure", measure)
    capsys.readouterr()
    run()
    return capsys.readouterr().out.splitlines(), builds, measures


@pytest.mark.parametrize("name,port,failing_B", [
    ("sweep_melbourne", sweep_melbourne, 1280),
    ("sweep_grid", sweep_grid, 512),
])
def test_sweep_rows_and_lines_match_jax(monkeypatch, capsys, name, port, failing_B):
    """Every (H, B) row in the JAX script's order, each scenario built
    with the JAX script's arguments (``history_window=H,
    binomial_mode="fast"``) and measured over 500 steps, and the printed
    lines the JAX script's, a failed row's ``FAILED`` line included."""
    jmod = jax_script(name)
    want = record_sweep(monkeypatch, capsys, jmod.main, jax_scenario, jmod, failing_B)
    got = record_sweep(monkeypatch, capsys, lambda: port.main(["--device", "cpu"]),
                       sweep_melbourne, sweep_melbourne, failing_B)
    assert got[0] == want[0]
    assert sum("FAILED" in ln for ln in got[0]) == 2
    assert got[2] == want[2] and len(got[2]) == 6
    for (ga, gk), (wa, wk) in zip(got[1], want[1]):
        assert gk == wk
        np.testing.assert_array_equal(ga[0], wa[0])
        assert ga[1:] == wa[1:]


def test_measure_runs_simulate_batched_as_jax(monkeypatch):
    """Both ``measure``s at a tiny size: ``simulate_batched`` stochastic over
    the given steps, from ``batch`` fresh replicas of the scenario's
    parameters; the port's rate is positive and its check sees each run's
    final state (one warm run, then ``reps``)."""
    args = generator.NetworkEnvGenerator(device="cpu").scenario_args("butterfly_scC")
    args["params"]["seed"] = 3
    js = jax_scenario.build_scenario(**copy.deepcopy(args), history_window=16,
                                     binomial_mode="fast")
    ts = build_scenario(**copy.deepcopy(args), history_window=16, binomial_mode="fast",
                        device="cpu")
    assert_builds_match(js, ts)
    seen = {}

    def recorder(key, real):
        def call(scn, ep, st, steps, *rest, **kw):
            seen.setdefault(key, []).append((scn, ep, st.density.shape[0], steps, rest, kw))
            return real(scn, ep, st, steps, *rest, **kw)
        return call

    monkeypatch.setattr(jax_engine, "simulate_batched",
                        recorder("jax", jax_engine.simulate_batched))
    monkeypatch.setattr(sweep_melbourne, "simulate_batched",
                        recorder("port", sweep_melbourne.simulate_batched))
    finals = []
    assert jax_script("sweep_melbourne").measure(js, 2, 3, reps=1) > 0
    assert sweep_melbourne.measure(ts, 2, 3, reps=2, check=finals.append) > 0
    (jscn, jep, jB, jsteps, jrest, jkw), = seen["jax"]  # traced once by jit
    assert jscn is js and jep is js.engine_params and (jB, jsteps, jrest) == (2, 3, ())
    assert len(seen["port"]) == 3 and len(finals) == 3
    for scn, ep, B, steps, rest, kw in seen["port"]:
        assert scn is ts and ep is ts.engine_params and (B, steps) == (2, 3)
        assert isinstance(rest[0], torch.Generator)
        assert kw == jkw == {"stochastic": True}
    assert all(f.t == 4 and f.density.shape == (2, ts.n_links) for f in finals)


def small_world(real, monkeypatch, owner):
    """``load_network_data`` of ``owner`` loading butterfly_scC (seeded, 80
    steps) whatever the name: the scripts' loops at a CPU size."""
    def load(self, name):
        data = real(self, "butterfly_scC")
        self.config["params"]["simulation_steps"] = 80
        self.config["params"]["seed"] = 3
        return data
    monkeypatch.setattr(owner, "load_network_data", load)


def test_quantify_window_matches_jax(monkeypatch, capsys):
    """quantify_window's loops on a small seeded world (butterfly_scC, 80
    steps, for both dataset names): every printed error line equals the
    JAX script's, and the rollouts' density and num_peds equal, bit for
    bit, JAX's deterministic ``simulate`` of the same scenario and demand
    (the full ring and H = 16 at 8x demand), jitted with its parameters as
    an argument.  (The script's own ``run`` closes over them: XLA then
    folds the parameter arithmetic and single pedestrians move from step
    18 on at 8x demand, ROADMAP.md §3; its printed lines are equal all
    the same.)"""
    jmod = jax_script("quantify_window")
    small_world(jax_generator.NetworkEnvGenerator.load_network_data, monkeypatch,
                jax_generator.NetworkEnvGenerator)
    small_world(generator.NetworkEnvGenerator.load_network_data, monkeypatch,
                generator.NetworkEnvGenerator)
    capsys.readouterr()
    jmod.main()
    want = capsys.readouterr().out.splitlines()
    rollouts = []
    real_run = quantify_window.run

    def run(scn, steps, mult):
        d, n = real_run(scn, steps, mult)
        rollouts.append((scn, d, n))
        return d, n

    monkeypatch.setattr(quantify_window, "run", run)
    errors = quantify_window.main(["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert got == want and len(got) == 12
    assert len(errors) == 12 and len(rollouts) == 16
    assert all(n.sum() > 0 for _, _, n in rollouts)
    gen = jax_generator.NetworkEnvGenerator()
    data = gen.load_network_data("melbourne")
    cfg = gen.config
    for k, H in ((4, None), (7, 16)):  # 8x demand: exact ring, then H = 16
        scn, d, n = rollouts[k]
        kw = {} if H is None else {"history_window": H}
        js = jax_scenario.build_scenario(data["adjacency_matrix"], cfg["params"],
                                         cfg["origin_nodes"], cfg["destination_nodes"], **kw)
        assert scn.H == js.H
        ep = js.engine_params.replace(demand=jax.numpy.asarray(js.engine_params.demand) * 8.0)
        run = jax.jit(lambda ep, st, js=js: jax_engine.simulate(
            js, ep, st, 79, stochastic=False, record=True)[1])
        outs = run(ep, js.init_state(jax.random.PRNGKey(0)))
        np.testing.assert_array_equal(d, np.asarray(outs.density))
        np.testing.assert_array_equal(n, np.asarray(outs.num_peds))
