"""The port's object-style ``Network`` facade on the CPU against the JAX
package's, on the four-node corridor of tests/test_components.py's
``test_network_facade`` and on a corridor with a separator: per-link
series, the gate and separator setters' coupling, fixed turning fractions,
node info, saving and drawing."""

import copy
from functools import partial

import matplotlib

matplotlib.use("Agg")

import numpy as np
import pytest
import torch

import jax

from pednstream_tpu import Network as JaxNetwork
from pednstream_tpu.scenario import build_scenario as jax_build
from pednstream_tpu_torch import generator, network, simulate
from pednstream_tpu_torch.io import OutputHandler
from pednstream_tpu_torch.scenario import build_scenario

Network = partial(network.Network, device="cpu")
NetworkEnvGenerator = partial(generator.NetworkEnvGenerator, device="cpu")
torch_build = partial(build_scenario, device="cpu")

torch.set_num_threads(1)

RTOL = 1e-6
SERIES = ("density", "speed", "travel_time", "inflow", "outflow", "num_pedestrians",
          "cumulative_inflow", "cumulative_outflow", "link_flow", "sending_flow",
          "receiving_flow")


@pytest.fixture(autouse=True)
def float32_jax():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def corridor():
    adj = np.zeros((4, 4), dtype=int)
    for a, b in [(0, 1), (1, 2), (2, 3)]:
        adj[a, b] = adj[b, a] = 1
    params = {
        "unit_time": 10, "simulation_steps": 40, "seed": 1,
        "default_link": {"length": 100, "width": 2, "free_flow_speed": 1.1,
                         "k_critical": 2, "k_jam": 6},
        "demand": {"origin_0": {"peak_lambda": 15, "base_lambda": 5}},
    }
    return adj, params


def both_networks(steps, control=None):
    """The corridor driven ``steps`` steps through both facades,
    deterministic; ``control(net, t)`` runs before each step.  The JAX
    scenario reads history through its Pallas kernel in interpret mode,
    the read the port has."""
    adj, params = corridor()
    js = jax_build(adj, copy.deepcopy(params), [0], [3], use_pallas=True,
                   pallas_interpret=True)
    nets = (JaxNetwork(adj, params, origin_nodes=[0], stochastic=False, scenario=js),
            Network(adj, copy.deepcopy(params), origin_nodes=[0], destination_nodes=[3],
                    stochastic=False))
    for net in nets:
        for t in range(1, steps + 1):
            if control is not None:
                control(net, t)
            net.network_loading(t)
    return nets


def assert_same_series(jnet, tnet):
    assert tnet.links.keys() == jnet.links.keys()
    for key, link in tnet.links.items():
        for name in SERIES:
            np.testing.assert_allclose(getattr(link, name), getattr(jnet.links[key], name),
                                       rtol=RTOL, atol=0, err_msg=f"{key} {name}")


def test_network_facade_matches_jax():
    """The reference-style loop over the whole horizon: every series of
    every link within rtol 1e-6 of the JAX facade's, and equal to the
    port's functional ``simulate``."""
    jnet, tnet = both_networks(39)
    assert_same_series(jnet, tnet)
    link = tnet.links[(0, 1)]
    assert link.density.shape == (41,) and link.density[1:40].sum() > 0
    assert link.sending_flow[39] == -1 and link.link_id == "0_1" and not link.is_separator
    assert (link.length, link.width, link.k_jam) == (100.0, 2.0, 6.0)
    scn = tnet.scenario
    _, traj = simulate(scn, scn.engine_params, scn.init_state(1), 39, record=True)
    e = scn.topo.link_id_to_idx[(0, 1)]
    np.testing.assert_array_equal(link.density[1:40], traj.density[:, 0, e].numpy())
    with pytest.raises(ValueError, match="out of order"):
        tnet.network_loading(7)
    with pytest.raises(AttributeError):
        link.no_such_series


def test_gate_setters_match_jax():
    """Closing a back gate mid-run, then a front gate (the reverse link's
    back gate): the same widths read back and the same flows after."""
    def control(net, t):
        if t == 10:
            net.links[(1, 2)].back_gate_width = 0.5
        if t == 20:
            net.links[(1, 2)].front_gate_width = 0.25

    jnet, tnet = both_networks(30, control)
    assert tnet.links[(1, 2)].back_gate_width == 0.5
    assert tnet.links[(2, 1)].back_gate_width == tnet.links[(1, 2)].front_gate_width == 0.25
    assert_same_series(jnet, tnet)
    open_run = both_networks(30)[1]
    assert not np.allclose(open_run.links[(1, 2)].inflow, tnet.links[(1, 2)].inflow)


def test_separator_setter_couples_the_reverse_direction():
    """``separator_width`` on long_corridor's separator reallocates the
    reverse direction and both back gates (link.py:462-478), as in the JAX
    facade, and the flows that follow agree."""
    args = NetworkEnvGenerator().scenario_args("long_corridor")
    if args["params"].get("seed") is None:
        args["params"]["seed"] = 3  # an unseeded dataset: the same demand both sides
    js = jax_build(**copy.deepcopy(args), use_pallas=True, pallas_interpret=True)
    ts = torch_build(**copy.deepcopy(args))
    jnet = JaxNetwork(None, None, None, scenario=js, stochastic=False)
    tnet = Network(None, None, None, scenario=ts, stochastic=False)
    total = float(ts.topo.link_params.width[ts.topo.link_id_to_idx[(2, 3)]])
    for net in (jnet, tnet):
        for t in range(1, 25):
            if t == 8:
                net.links[(2, 3)].separator_width = total - 1.5
            net.network_loading(t)
    assert tnet.links[(2, 3)].is_separator
    assert abs(tnet.links[(2, 3)].separator_width - (total - 1.5)) < 1e-6
    assert abs(tnet.links[(3, 2)].separator_width - 1.5) < 1e-6
    assert abs(tnet.links[(3, 2)].back_gate_width - 1.5) < 1e-6
    assert_same_series(jnet, tnet)


def test_fixed_turning_fractions_match_jax():
    """``update_turning_fractions_per_node`` installs the reference's flat
    off-diagonal layout into ``phi_base`` as the JAX facade does."""
    adj, params = corridor()
    jnet = JaxNetwork(adj, copy.deepcopy(params), origin_nodes=[0], stochastic=False)
    tnet = Network(adj, copy.deepcopy(params), origin_nodes=[0], stochastic=False)
    m = int(tnet.scenario.topo.node_arity[1])
    flat = np.random.default_rng(0).uniform(size=(1, m * (m - 1)))
    for net in (jnet, tnet):
        net.update_turning_fractions_per_node([1], flat)
    got = tnet.scenario.engine_params.phi_base
    want = np.asarray(jnet.scenario.engine_params.phi_base)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.array_equal(want, np.asarray(
        JaxNetwork(adj, copy.deepcopy(params), origin_nodes=[0]).scenario.engine_params.phi_base))
    for net in (jnet, tnet):
        for t in range(1, 20):
            net.network_loading(t)
    assert_same_series(jnet, tnet)


def test_nodes_save_and_visualize(tmp_path):
    jnet, tnet = both_networks(12)
    assert tnet.nodes.keys() == jnet.nodes.keys()
    for nid, info in tnet.nodes.items():
        want = jnet.nodes[nid]
        assert {k: info[k] for k in ("node_id", "is_origin", "is_destination")} == \
            {k: want[k] for k in ("node_id", "is_origin", "is_destination")}
        if want["demand"] is None:
            assert info["demand"] is None
        else:
            np.testing.assert_array_equal(info["demand"], np.asarray(want["demand"]))
    run = tnet.save(base_dir=str(tmp_path), simulation_dir="port")
    jrun = jnet.save(base_dir=str(tmp_path), simulation_dir="jax")
    data, jdata = (OutputHandler.load_simulation(str(d)) for d in (run, jrun))
    assert data["node_data"] == jdata["node_data"]
    assert data["network_params"] == jdata["network_params"]
    for key, entry in data["link_data"].items():
        np.testing.assert_allclose(entry["density"], jdata["link_data"][key]["density"],
                                   rtol=RTOL, atol=0)
        np.testing.assert_array_equal(entry["density"], tnet.links[
            tuple(map(int, key.split("-")))].density)
    ax = tnet.visualize(save_path=str(tmp_path / "net.png"))
    assert ax is not None and (tmp_path / "net.png").stat().st_size > 0


def test_stochastic_network_is_seeded():
    adj, params = corridor()
    runs = []
    for seed in (4, 4, 5):
        net = Network(adj, copy.deepcopy(params), origin_nodes=[0], destination_nodes=[3],
                      seed=seed)
        for t in range(1, 30):
            net.network_loading(t)
        runs.append(net.links[(1, 2)].cumulative_inflow)
    np.testing.assert_array_equal(runs[0], runs[1])
    assert not np.array_equal(runs[0], runs[2]) and runs[0].sum() > 0
