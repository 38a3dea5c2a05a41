"""The port's output handler, checkpoints and small utilities on the CPU:
one JAX trajectory saved by both packages' handlers gives the same four
files byte for byte (from ``simulate``'s stacked outputs, and from an
env's per-RL-step list with an ``action_gap`` that overshoots the
horizon); ``load_simulation`` reads them back; engine-state checkpoints
round-trip exactly with an int and with a per-replica ``t``."""

import copy
import dataclasses
import logging
from functools import partial

import numpy as np
import pytest
import torch

import jax

from pednstream_tpu.engine import simulate as jax_simulate
from pednstream_tpu.io import OutputHandler as JaxOutputHandler
from pednstream_tpu.scenario import build_scenario as jax_build
from pednstream_tpu_torch import concat_states, generator, simulate
from pednstream_tpu_torch.interop import numpy_leaves
from pednstream_tpu_torch.io import OutputHandler
from pednstream_tpu_torch.scenario import build_scenario
from pednstream_tpu_torch.state import StepOutputs
from pednstream_tpu_torch.utils import (load_engine_state, save_engine_state, setup_logger,
                                        trace_profile)

NetworkEnvGenerator = partial(generator.NetworkEnvGenerator, device="cpu")
torch_build = partial(build_scenario, device="cpu")

torch.set_num_threads(1)

FILES = ("link_data.json", "node_data.json", "network_params.json")


@pytest.fixture(autouse=True)
def float32_jax():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def scenario_args(name, seed=3):
    args = NetworkEnvGenerator().scenario_args(name)
    if args["params"].get("seed") is None:
        args["params"]["seed"] = seed
    return args


def port_outputs(jax_outs, split=None):
    """A JAX ``StepOutputs`` ``[T, ...]`` as the port's: tensors ``[T, 1,
    ...]`` in the JAX leaves' dtypes, or, with ``split``, the env's list of
    ``[split, 1, ...]`` entries."""
    leaves = {k: torch.from_numpy(np.array(v)).unsqueeze(1)
              for k, v in numpy_leaves(jax_outs, skip=()).items()}
    if split is None:
        return StepOutputs(**leaves)
    T = leaves["density"].shape[0]
    return [StepOutputs(**{k: v[i:i + split] for k, v in leaves.items()})
            for i in range(0, T, split)]


@pytest.fixture(scope="module", params=["long_corridor", "butterfly_scC"])
def trajectory(request):
    """A deterministic JAX rollout over the whole horizon of long_corridor
    (a separator) and of butterfly_scC (a gater, routed turning fractions),
    so every optional series is written, and both packages' scenarios."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    args = scenario_args(request.param)
    js = jax_build(**copy.deepcopy(args))
    ts = torch_build(**copy.deepcopy(args))
    _, outs = jax_simulate(js, js.engine_params, js.init_state(jax.random.PRNGKey(0)),
                           js.simulation_steps - 1, stochastic=False, record=True)
    jax.config.update("jax_enable_x64", prev)
    return js, ts, outs


def assert_same_files(a, b, names):
    for name in names:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


def test_saved_files_equal_the_jax_handlers(trajectory, tmp_path):
    """``simulate``'s stacked record, with the CSV: four files, byte for
    byte."""
    js, ts, outs = trajectory
    jh = JaxOutputHandler(base_dir=str(tmp_path), simulation_dir="jax")
    jh.save_scenario_state(js, outs, save_time_series=True)
    th = OutputHandler(base_dir=str(tmp_path), simulation_dir="port")
    th.save_scenario_state(ts, port_outputs(outs), save_time_series=True)
    assert_same_files(jh.simulation_dir, th.simulation_dir, FILES + ("time_series.csv",))
    link_data = OutputHandler.load_simulation(str(th.simulation_dir))["link_data"]
    optional = "separator_width" if ts.topo.link_params.is_separator.any() else "back_gate_width"
    assert any(optional in v for v in link_data.values())


def test_env_history_with_overshoot_equals_the_jax_handlers(trajectory, tmp_path):
    """An env's list of ``[action_gap, 1, ...]`` entries whose total runs
    past the horizon (the reference layout holds T + 1 columns; the
    overshoot is dropped), against the JAX handler on the same list."""
    js, ts, outs = trajectory
    T = js.simulation_steps
    gap = 7
    assert (T - 1) % gap and T % gap  # the last entry overshoots
    # pad the T-1 recorded steps to a multiple of the gap by repeating the last
    n = -(-T // gap) * gap
    idx = np.minimum(np.arange(n), T - 2)
    padded = jax.tree_util.tree_map(lambda x: x[idx], outs)
    jax_list = [jax.tree_util.tree_map(lambda x: x[i:i + gap], padded) for i in range(0, n, gap)]
    jh = JaxOutputHandler(base_dir=str(tmp_path), simulation_dir="jax")
    jh.save_scenario_state(js, jax_list)
    th = OutputHandler(base_dir=str(tmp_path), simulation_dir="port")
    th.save_scenario_state(ts, port_outputs(padded, split=gap))
    assert_same_files(jh.simulation_dir, th.simulation_dir, FILES)
    data = OutputHandler.load_simulation(str(th.simulation_dir))
    assert all(len(v["density"]) == T + 1 for v in data["link_data"].values())
    assert data["network_params"]["simulation_steps"] == T


def test_single_step_list_equals_the_stacked_record(trajectory, tmp_path):
    """A list of single steps (``[1, ...]`` entries, as the Network facade
    records) saves what the stacked record saves."""
    _, ts, outs = trajectory
    stacked = port_outputs(outs)
    steps = [StepOutputs(**{k: getattr(stacked, k)[i] for k in StepOutputs.__dataclass_fields__})
             for i in range(stacked.density.shape[0])]
    a = OutputHandler(base_dir=str(tmp_path), simulation_dir="stacked")
    a.save_scenario_state(ts, stacked)
    b = OutputHandler(base_dir=str(tmp_path), simulation_dir="steps")
    b.save_scenario_state(ts, steps)
    assert_same_files(a.simulation_dir, b.simulation_dir, FILES)


def test_port_rollout_saves_and_loads_back(tmp_path):
    """The port's own ``simulate`` record through the handler: what
    ``load_simulation`` reads back equals the recorded tensors, column
    t = step t's value, column 0 the initial one."""
    scn = torch_build(**scenario_args("butterfly_scC"))
    steps = 30
    _, outs = simulate(scn, scn.engine_params, scn.init_state(1), steps, record=True)
    h = OutputHandler(base_dir=str(tmp_path), simulation_dir="run")
    h.save_scenario_state(scn, outs)
    data = OutputHandler.load_simulation(str(h.simulation_dir))
    assert set(data) == {"link_data", "node_data", "network_params"}
    T = scn.simulation_steps
    for e, (u, v) in enumerate(scn.topo.link_nodes):
        entry = data["link_data"][f"{int(u)}-{int(v)}"]
        for key, field in (("density", "density"), ("cumulative_inflow", "cum_in"),
                           ("num_pedestrians", "num_peds")):
            series = np.asarray(entry[key])
            assert series.shape == (T + 1,) and series[0] == 0
            np.testing.assert_array_equal(
                series[1:steps + 1], getattr(outs, field)[:, 0, e].numpy().astype(np.float64))
            assert not series[steps + 1:].any()
        assert entry["travel_time"][0] == float(scn.travel_time0[e])
        assert entry["sending_flow"][steps] == -1.0


def test_handler_refuses_a_batch_of_replicas(tmp_path):
    scn = torch_build(**scenario_args("butterfly_scC"))
    _, outs = simulate(scn, scn.engine_params, scn.init_state(2), 3, record=True)
    with pytest.raises(ValueError, match="one replica"):
        OutputHandler(base_dir=str(tmp_path), simulation_dir="run").save_scenario_state(scn, outs)


@pytest.mark.parametrize("form", ["int", "per replica"])
def test_engine_state_checkpoint_round_trip(tmp_path, form):
    """Every leaf comes back bit for bit, ``t`` in the form it was saved
    in, and the restored state steps on as the original does."""
    scn = torch_build(**scenario_args("butterfly_scC"), history_window=16)
    ep = scn.engine_params
    if form == "int":
        st = simulate(scn, ep, scn.init_state(2), 25, record=False)[0]
    else:
        st = concat_states([simulate(scn, ep, scn.init_state(1), n, record=False)[0]
                            for n in (3, 25)])
    path = str(tmp_path / "state.npz")
    save_engine_state(st, path)
    back = load_engine_state(path, scn.init_state(2), device="cpu")
    if form == "int":
        assert back.t == st.t == 26
    else:
        assert back.t.dtype == torch.int32 and back.t.tolist() == [4, 26]
    for f in dataclasses.fields(st):
        a, b = getattr(st, f.name), getattr(back, f.name)
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), f.name
    nxt_a = simulate(scn, ep, st, 5, record=False)[0]
    nxt_b = simulate(scn, ep, back, 5, record=False)[0]
    assert torch.equal(nxt_a.density, nxt_b.density) and torch.equal(nxt_a.cum_in, nxt_b.cum_in)


def test_checkpoint_refuses_another_scenario(tmp_path):
    scn = torch_build(**scenario_args("butterfly_scC"), history_window=16)
    path = str(tmp_path / "state.npz")
    save_engine_state(scn.init_state(2), path)
    with pytest.raises(ValueError, match="shape"):
        load_engine_state(path, scn.init_state(3), device="cpu")
    np.savez(path, t=np.asarray(1))
    with pytest.raises(ValueError, match="snapshot holds"):
        load_engine_state(path, scn.init_state(2), device="cpu")


def test_trace_profile_and_logger(tmp_path):
    with trace_profile(str(tmp_path / "prof")) as log_dir:
        torch.ones(8).sum()
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0 and log_dir.endswith("prof")
    logger = setup_logger(log_dir=str(tmp_path / "logs"), name="pednstream_tpu_torch.test")
    logger.info("hello")
    for handler in logger.handlers:
        handler.flush()
    assert "hello" in (tmp_path / "logs" / "network.log").read_text()
    for handler in list(logger.handlers):
        handler.close()
        logger.removeHandler(handler)
    assert logger.level == logging.INFO
