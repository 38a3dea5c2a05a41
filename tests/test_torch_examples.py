"""The port's examples (``pednstream_tpu_torch.examples``) on the CPU
against the JAX package's ``examples/``.

For each example: the scenario its ``build`` makes equals, array for array,
the one the JAX example's own ``build_scenario`` / ``create_network`` call
makes (the call is captured by running the JAX example's ``__main__`` with
that function replaced, so the JAX example's own literals drive it); the
scenario run deterministically through both engines agrees within rtol
1e-6 at a horizon cut for the CPU; and the port's example runs end to end
and writes (or prints) what the JAX one does.  ``link_sharded_scale`` at a
small grid over two gloo ranks is bitwise equal to the unsharded port."""

import json
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

import pednstream_tpu
import pednstream_tpu.generator as jax_generator
import pednstream_tpu.scenario as jax_scenario
from pednstream_tpu.engine import simulate as jax_simulate
from pednstream_tpu.io import OutputHandler as JaxOutputHandler
from pednstream_tpu_torch import simulate, simulate_batched
from pednstream_tpu_torch.examples import (big_network, delft_exp, forky_queues, grid_scale,
                                           link_sharded_scale, long_corridor, melbourne,
                                           metered_corridor, nine_node, six_node, spike)

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_scenario import assert_builds_match  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def float32_jax():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


class Captured(Exception):
    pass


def jax_example_scenario(monkeypatch, name, where, argv=()):
    """Run ``examples/<name>.py`` as ``__main__`` with ``where`` (a module or
    class and an attribute) replaced by a recorder that stops the script at
    its first call, then make that call for real: the JAX example's own
    scenario."""
    owner, attr = where
    real = getattr(owner, attr)

    def record(*args, **kwargs):
        raise Captured(args, kwargs)

    monkeypatch.setattr(owner, attr, record)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    with pytest.raises(Captured) as got:
        runpy.run_path(str(ROOT / "examples" / f"{name}.py"), run_name="__main__")
    monkeypatch.setattr(owner, attr, real)
    args, kwargs = got.value.args
    kwargs.pop("use_pallas", None)  # the port has one history read (grid_scale.py:39)
    return real(*args, **kwargs)


GENERATOR = (jax_generator.NetworkEnvGenerator, "create_network")
BUILD = (pednstream_tpu, "build_scenario")
SCENARIO = (jax_scenario, "build_scenario")

# example -> (the JAX call replaced, its argv, the port's build, the CPU horizon).
# The JAX calls: melbourne.py:52, long_corridor.py:44, six_node.py:31,
# spike.py:37-38, forky_queues.py:30, nine_node.py:45-47, delft_exp.py:18,
# big_network.py:77-78 (both variants), grid_scale.py:35-40
CASES = {
    "melbourne": (GENERATOR, (), lambda: melbourne.build("cpu"), 12),
    "long_corridor": (BUILD, (), lambda: long_corridor.build("cpu"), 40),
    "six_node": (BUILD, (), lambda: six_node.build("cpu"), 40),
    "spike": (BUILD, (), lambda: spike.build("cpu"), 120),
    "forky_queues": (BUILD, (), lambda: forky_queues.build("cpu"), 40),
    "nine_node": (BUILD, (), lambda: nine_node.build("cpu"), 40),
    "delft_exp": (GENERATOR, (), lambda: delft_exp.build("cpu"), 12),
    "big_network": (SCENARIO, (), lambda: big_network.build(False, "cpu"), 12),
    "big_network --directions": (SCENARIO, ("--directions",),
                                 lambda: big_network.build(True, "cpu"), 12),
    "grid_scale": (SCENARIO, (), lambda: grid_scale.build("cpu"), 3),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_scenario_and_deterministic_run_match_jax(monkeypatch, case):
    """The example's scenario, array for array, then a deterministic
    rollout of it through both engines (the JAX step jitted with its
    parameters as an argument) at rtol 1e-6."""
    where, argv, build, steps = CASES[case]
    js = jax_example_scenario(monkeypatch, case.split()[0], where, argv)
    ts = build()
    assert_builds_match(js, ts)
    run = jax.jit(lambda ep, st: jax_simulate(js, ep, st, steps, stochastic=False,
                                              record=False)[0])
    want = run(js.engine_params, js.init_state(jax.random.PRNGKey(0)))
    got, _ = simulate(ts, ts.engine_params, ts.init_state(), steps, record=False)
    assert got.t == int(want.t) == steps + 1
    for f in ("num_peds", "density", "cum_in", "cum_out", "inflow", "outflow",
              "virt_arr_cum"):
        np.testing.assert_allclose(getattr(got, f)[0].numpy(), np.asarray(getattr(want, f)),
                                   rtol=1e-6, atol=1e-6, err_msg=f)
    assert float(got.cum_in.sum()) > 0


def test_metered_corridor_world_matches_jax():
    """metered_corridor.py:72-73 builds its env from the dataset: the same
    scenario as the JAX example's env."""
    from pednstream_tpu.env import PedNetParallelEnv as JaxEnv
    from pednstream_tpu_torch.env import PedNetParallelEnv

    kw = dict(obs_mode="option2", seed=0, action_gap=5)
    assert_builds_match(JaxEnv("metered_corridor", **kw).scn,
                        PedNetParallelEnv("metered_corridor", device="cpu", **kw).scn)


def saved_layout(sim_dir: Path) -> dict:
    """``{file: top-level JSON keys}`` of a saved run."""
    out = {}
    for p in sorted(sim_dir.iterdir()):
        data = json.loads(p.read_text()) if p.suffix == ".json" else None
        out[p.name] = sorted(data) if isinstance(data, dict) else type(data).__name__
    return out


def jax_saved_layout(tmp_path, js, steps, name) -> dict:
    _, traj = jax_simulate(js, js.engine_params, js.init_state(jax.random.PRNGKey(0)), steps,
                           stochastic=False, record=True)
    handler = JaxOutputHandler(base_dir=str(tmp_path / "jax"), simulation_dir=name)
    handler.save_scenario_state(js, traj)
    return saved_layout(Path(handler.simulation_dir))


@pytest.mark.parametrize("case", ["melbourne", "long_corridor", "nine_node", "big_network"])
def test_saving_examples_write_what_jax_writes(tmp_path, monkeypatch, case):
    """Run end to end on the CPU at a cut horizon (stochastic, recorded):
    the files saved and their JSON keys are those the JAX output handler
    writes for the same scenario; the state is finite and non-negative,
    mass is conserved."""
    where, argv, _, steps = CASES[case]
    js = jax_example_scenario(monkeypatch, case, where, argv)
    out = tmp_path / "port"
    if case == "big_network":
        r = big_network.run(False, "cpu", steps=steps, out=str(out), html=str(tmp_path / "m.html"))
        assert (tmp_path / "m.html").stat().st_size > 0
    else:
        r = getattr(sys.modules[f"pednstream_tpu_torch.examples.{case}"], "run")(
            "cpu", steps=steps, out=str(out))
    name = Path(r["saved"]).name
    assert saved_layout(Path(r["saved"])) == jax_saved_layout(tmp_path, js, steps, name)
    final = r["final"]
    assert final.t == steps + 1
    for f, x in vars(final).items():
        if isinstance(x, torch.Tensor):
            assert bool(torch.isfinite(x).all()) and not bool((x < 0).any()), f
    assert (final.cum_in - final.cum_out - final.num_peds).abs().max() <= 1e-3
    if case == "nine_node":
        assert set(r["metrics"]) >= {"throughput", "delay", "congestion"}


def test_long_corridor_renders(tmp_path):
    """The rendering half (matplotlib) on a cut run: the two PNGs of the
    JAX example (long_corridor.py:60-64)."""
    r = long_corridor.run("cpu", steps=40, out=str(tmp_path))
    paths = long_corridor.render(r["saved"], time_step=30)
    assert [Path(p).name for p in paths] == ["density_t30.png", "link_evolution.png"]
    assert all(Path(p).stat().st_size > 0 for p in paths)


@pytest.mark.parametrize("case,phrases", [
    # the JAX examples' prints: six_node.py:45-48, spike.py:41, forky_queues.py:36-38,
    # delft_exp.py:24, grid_scale.py:71-75
    ("six_node", ["upstream density while gate closed:", "after reopening, upstream density"]),
    ("spike", ["peak density after spike:"]),
    ("forky_queues", ["wide branch peak density", "narrow branch peak density"]),
    ("delft_exp", ["delft: 298 nodes, 818 directed links", "Simulation time:"]),
    ("grid_scale", ["grid_50x50: 2500 nodes, 9800 directed links, H=64", "env-steps/s"]),
])
def test_printing_examples_run_end_to_end(capsys, case, phrases):
    """The examples that print instead of saving: the full horizon for the
    small networks, cut for delft and grid_50x50; the JAX example's lines,
    and what the print reports matches the run."""
    mod = sys.modules[f"pednstream_tpu_torch.examples.{case}"]
    kw = {"delft_exp": dict(steps=6), "grid_scale": dict(batch=2, steps=2)}.get(case, {})
    r = mod.run("cpu", **kw)
    out = capsys.readouterr().out
    for phrase in phrases:
        assert phrase in out, (phrase, out)
    if case == "six_node":
        assert r["steps"] == 299 and r["closed_inflow"] == 0.0
        assert r["closed_upstream_density"] > r["reopened_upstream_density"]
    if case == "spike":
        assert r["peak_step"] >= spike.PARAMS["simulation_steps"] // 3 - 1
    if case == "forky_queues":
        assert r["wide_peak"] > 0 and r["narrow_peak"] > 0


@pytest.mark.slow
def test_metered_corridor_runs_end_to_end(tmp_path, capsys):
    """The four policies on the nominal world and the no-control run saved
    and exported (metered_corridor.py:85-112): a fixed meter beats no
    control, as tests/test_metered_corridor.py pins for the JAX package."""
    r = metered_corridor.run("cpu", html=str(tmp_path / "m.html"), out=str(tmp_path))
    rows = {name: (total, arrived) for name, total, arrived in r["rows"]}
    assert set(rows) == {"no_control", "rule_based", "fixed meter 0.6", "trained PPO (zoo)"}
    assert rows["fixed meter 0.6"][0] > rows["no_control"][0]
    assert (tmp_path / "metered_corridor_demo" / "link_data.json").exists()
    assert (tmp_path / "m.html").stat().st_size > 0


def test_link_sharded_scale_is_bitwise_the_unsharded_port():
    """An 8 x 8 grid (224 links) of 4 replicas, stochastic, 6 steps over 2
    gloo ranks (blocks of 112 links, H = 8: the horizon is 7 steps): every
    state field bitwise equal to
    the unsharded port from the same seed, one launch of the read per step
    per rank on the CPU's plain version (none counted)."""
    ranks = link_sharded_scale.run(n=8, steps=6, window=16, batch=4, ranks=2, device="cpu",
                                   seed=3)
    assert [r["block"] for r in ranks] == [(4, 8, 112)] * 2
    scn = link_sharded_scale.build(8, 6, 16, device="cpu")
    gen = torch.Generator().manual_seed(3)
    want = simulate_batched(scn, scn.engine_params, scn.init_state(4), 6, gen, stochastic=True)
    got = ranks[0]["final"]
    for f, x in vars(want).items():
        if isinstance(x, torch.Tensor):
            assert torch.equal(getattr(got, f), x), f
        else:
            assert getattr(got, f) == x, f
    assert float(want.virt_dep_cum.sum()) > 0


def test_link_sharded_scale_refuses_one_rank():
    with pytest.raises(ValueError, match="at least 2"):
        link_sharded_scale.run(n=4, steps=1, ranks=1, device="cpu")


@pytest.mark.parametrize("name", ["melbourne", "long_corridor", "six_node", "spike",
                                  "forky_queues", "nine_node", "delft_exp", "big_network",
                                  "grid_scale", "metered_corridor", "link_sharded_scale"])
def test_examples_run_on_the_card_unless_asked(name, monkeypatch, tmp_path):
    """With no ``device`` every example asks for the card: where torch sees
    none it raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        sys.modules[f"pednstream_tpu_torch.examples.{name}"].run()
