"""The port's visualizer and HTML export on the CPU, held to the JAX
package's on the same saved run and on the same live trajectory: the
arrays a ``NetworkVisualizer`` serves, the exported HTML, the matplotlib
entry points (snapshot, animation, OD paths, link evolution) and the env's
``render``."""

import copy
import importlib.util
from functools import partial

import matplotlib

matplotlib.use("Agg")

import numpy as np
import pytest
import torch

import jax

from pednstream_tpu.engine import simulate as jax_simulate
from pednstream_tpu.io import OutputHandler as JaxOutputHandler
from pednstream_tpu.scenario import build_scenario as jax_build
from pednstream_tpu.viz import NetworkVisualizer as JaxVisualizer
from pednstream_tpu.viz import export_interactive_html as jax_export
from pednstream_tpu_torch import env as port_env, generator
from pednstream_tpu_torch.interop import numpy_leaves
from pednstream_tpu_torch.scenario import build_scenario
from pednstream_tpu_torch.state import StepOutputs
from pednstream_tpu_torch.viz import (NetworkVisualizer, export_interactive_html,
                                      progress_callback)

NetworkEnvGenerator = partial(generator.NetworkEnvGenerator, device="cpu")
PedNetParallelEnv = partial(port_env.PedNetParallelEnv, device="cpu")
torch_build = partial(build_scenario, device="cpu")

torch.set_num_threads(1)

PROPS = ("density", "link_flow", "speed", "num_pedestrians", "travel_time", "inflow")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A deterministic butterfly_scC JAX rollout, saved by the JAX handler,
    with both scenarios and the trajectory in both packages' forms."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    args = NetworkEnvGenerator().scenario_args("butterfly_scC")
    args["params"]["seed"] = 3
    js = jax_build(**copy.deepcopy(args))
    ts = torch_build(**copy.deepcopy(args))
    _, outs = jax_simulate(js, js.engine_params, js.init_state(jax.random.PRNGKey(0)),
                           120, stochastic=False, record=True)
    jax.config.update("jax_enable_x64", prev)
    base = tmp_path_factory.mktemp("viz")
    handler = JaxOutputHandler(base_dir=str(base), simulation_dir="run")
    handler.save_scenario_state(js, outs)
    port_outs = StepOutputs(**{k: torch.from_numpy(np.array(v)).unsqueeze(1)
                               for k, v in numpy_leaves(outs, skip=()).items()})
    return {"dir": str(handler.simulation_dir), "js": js, "ts": ts, "jax_outs": outs,
            "port_outs": port_outs, "base": base}


def assert_same_view(a, b):
    assert a.edges == b.edges and a.simulation_steps == b.simulation_steps
    assert a.network_params == b.network_params and a.node_data == b.node_data
    assert a.link_data.keys() == b.link_data.keys()
    for key in a.link_data:
        for prop in PROPS:
            np.testing.assert_array_equal(a._series(key, prop), b._series(key, prop))
    assert a.pos.keys() == b.pos.keys()
    for n in a.pos:
        np.testing.assert_array_equal(np.asarray(a.pos[n]), np.asarray(b.pos[n]))


def test_visualizer_from_a_saved_run_equals_jax(run):
    assert_same_view(NetworkVisualizer(simulation_dir=run["dir"]),
                     JaxVisualizer(simulation_dir=run["dir"]))


def test_visualizer_from_a_live_run_equals_jax(run):
    """``scenario=`` + ``history=``: the port moves its tensors to the host
    through its output handler and serves the arrays JAX's serves; with no
    history both give the topology-only view."""
    live = NetworkVisualizer(scenario=run["ts"], history=run["port_outs"],
                             state=run["ts"].init_state(1))
    assert_same_view(live, JaxVisualizer(scenario=run["js"], history=run["jax_outs"]))
    assert_same_view(live, NetworkVisualizer(simulation_dir=run["dir"], pos=live.pos))
    bare = NetworkVisualizer(network=run["ts"])
    assert_same_view(bare, JaxVisualizer(network=run["js"]))
    assert bare.link_data[next(iter(bare.link_data))] == {"density": [0.0]}
    with pytest.raises(ValueError):
        NetworkVisualizer()


@pytest.mark.parametrize("source", ["saved run", "live run"])
def test_interactive_html_equals_jax(run, source):
    """The zero-dependency HTML map: the same bytes as the JAX package's
    export (the file carries no timestamp)."""
    if source == "saved run":
        kw_port = kw_jax = dict(simulation_dir=run["dir"], max_frames=50)
    else:
        kw_port = dict(scenario=run["ts"], history=run["port_outs"], title="live")
        kw_jax = dict(scenario=run["js"], history=run["jax_outs"], title="live")
    a = export_interactive_html(out_path=str(run["base"] / f"port_{source}.html"), **kw_port)
    b = jax_export(out_path=str(run["base"] / f"jax_{source}.html"), **kw_jax)
    html = open(a).read()
    assert html == open(b).read()
    assert "<svg" in html and '"density"' in html and len(html) > 10_000


def test_matplotlib_entry_points(run, tmp_path, capsys):
    import matplotlib.pyplot as plt

    viz = NetworkVisualizer(simulation_dir=run["dir"])
    snap = tmp_path / "snap.png"
    viz.visualize_network_state(60, edge_property="flow", save_path=str(snap))
    assert snap.stat().st_size > 0
    ani = viz.animate_network(start_time=0, end_time=3, vis_actions=True)
    ani._func(2)
    od = tmp_path / "od.png"
    viz.plot_od_paths(save_path=str(od))
    evo = tmp_path / "evo.png"
    viz.plot_link_evolution(list(viz.link_data)[:2], save_path=str(evo))
    assert od.stat().st_size > 0 and evo.stat().st_size > 0
    plt.close("all")
    progress_callback(10, 100)
    assert "10/100" in capsys.readouterr().out
    if importlib.util.find_spec("folium") is None:
        with pytest.raises(ImportError, match="folium"):
            viz.visualize_network_folium(10)
    else:
        assert viz.visualize_network_folium(10) is not None


def test_env_render(run, tmp_path):
    """``render`` draws the current state (``human``) or returns an
    animation (``animate``), from the live env or from a saved directory."""
    import matplotlib.pyplot as plt
    from matplotlib.animation import FuncAnimation

    env = PedNetParallelEnv("butterfly_scC", seed=1, render_mode="human", action_gap=5,
                            stochastic=False)
    env.reset()
    env.step({})
    assert env.render() is None and isinstance(env.visualizer, NetworkVisualizer)
    assert env.render(simulation_dir=run["dir"], variable="speed") is None
    first = next(iter(env.visualizer.link_data.values()))
    assert len(first["speed"]) == env.simulation_steps + 1
    env.render_mode = "animate"
    assert isinstance(env.render(simulation_dir=run["dir"]), FuncAnimation)
    plt.close("all")
