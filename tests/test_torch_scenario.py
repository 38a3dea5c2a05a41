"""The PyTorch port's host-side scenario compiler against the JAX package:
the same datasets give exactly the same static arrays, engine parameters,
routing tables and initial state.  The port never imports JAX."""

import copy
import dataclasses
import inspect
from functools import partial
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pednstream_tpu import config as jax_config
from pednstream_tpu.env.core import PedNetEnvCore as JaxEnvCore
from pednstream_tpu.generator import NetworkEnvGenerator as JaxGenerator
from pednstream_tpu.scenario import build_scenario as jax_build
from pednstream_tpu_torch import config as torch_config
from pednstream_tpu_torch import generator, scenario
from pednstream_tpu_torch.env.core import PedNetEnvCore

torch.set_num_threads(1)

# the port runs on the card unless asked: every CPU test asks
NetworkEnvGenerator = partial(generator.NetworkEnvGenerator, device="cpu")
torch_build = partial(scenario.build_scenario, device="cpu")

ROOT = Path(__file__).resolve().parent.parent
DATASETS = sorted(p.parent.name for p in (ROOT / "data").glob("*/sim_params.yaml"))
STATIC = ("reverse_idx", "in_link_idx", "out_link_idx", "slot_valid", "has_virtual",
          "is_otoo", "node_arity", "end_node", "end_slot", "start_node", "start_slot",
          "is_separator", "fd_type", "travel_time0", "tau_shockwave")
ROUTING = ("te_dist", "te_group", "te_uo_idx", "te_down_link", "te_phi_idx",
           "group_dist_sum", "uo_od", "uo_group", "uo_group_count", "routed_mask",
           "temp", "alpha", "beta", "omega", "routed_ids", "num_groups",
           "num_uo_groups", "num_entries", "num_routed")


def scenario_args(name, seed=3):
    """Both packages' build_scenario arguments for a dataset; unseeded
    datasets get ``seed`` so the two builds draw the same demand."""
    args = NetworkEnvGenerator().scenario_args(name)
    if args["params"].get("seed") is None:
        args["params"]["seed"] = seed
    return args


def both(name, ftype=None, **kwargs):
    """The JAX and the port's build of a dataset; ``ftype`` is a dtype
    name ("float64"), given to each package as its own dtype."""
    args = scenario_args(name)
    jkw, tkw = dict(kwargs), dict(kwargs)
    if ftype is not None:
        jkw["ftype"], tkw["ftype"] = getattr(jnp, ftype), getattr(torch, ftype)
    return (jax_build(**copy.deepcopy(args), **jkw),
            torch_build(**copy.deepcopy(args), **tkw))


def as_np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_port_never_imports_jax():
    """Every module of the port imports in a fresh interpreter without
    loading jax, flax or optax."""
    code = (
        "import pkgutil, importlib, sys\n"
        "import pednstream_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in ('jax', 'flax', 'optax', 'pednstream_tpu') if m in sys.modules]\n"
        "assert not bad, bad\n"
        "assert sum(n.startswith('pednstream_tpu_torch.rl') for n in names) == 14, names\n"
        "print(len(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    # config ... env.pz_env, randomize, profiling, golden, network, io/, utils/,
    # viz/, and rl/ with its thirteen modules
    assert int(out.stdout.strip()) >= 45


@pytest.mark.parametrize("name", DATASETS)
def test_load_config_matches_jax(name):
    """The port's YAML loader gives the JAX loader's dict, exactly."""
    path = str(ROOT / "data" / name / "sim_params.yaml")
    want, got = jax_config.load_config(path), torch_config.load_config(path)
    assert got.keys() == want.keys()
    for key in want:
        if key == "adjacency_matrix":
            np.testing.assert_array_equal(got[key], want[key])
        elif key == "od_flows":
            assert got[key].keys() == want[key].keys()
            for od in want[key]:
                np.testing.assert_array_equal(np.asarray(got[key][od]),
                                              np.asarray(want[key][od]))
        else:
            assert got[key] == want[key], key


@pytest.mark.parametrize("name,window", [
    ("butterfly_scC", 64), ("melbourne", 16), ("small_network", None),
    ("nine_intersections", 32), ("metered_corridor", None), ("od_flow_example", 16),
])
def test_host_build_matches_jax(name, window):
    """Exact equality of every static index/per-link array, every
    EngineParams leaf (values and dtype), every non-one-hot RoutingTables
    field and the initial state, leaf for leaf."""
    assert_builds_match(*both(name, history_window=window))


def assert_builds_match(js, ts):
    """Every static array, EngineParams leaf (values and dtype), routing
    field and initial-state leaf of the port's build equals the JAX one's."""
    for attr in ("n_nodes", "n_links", "max_deg", "H", "avg_tt_window",
                 "simulation_steps", "unit_time"):
        assert getattr(ts, attr) == getattr(js, attr), attr
    for attr in STATIC:
        np.testing.assert_array_equal(as_np(getattr(ts, attr)),
                                      np.asarray(getattr(js, attr)), err_msg=attr)

    for f in dataclasses.fields(js.engine_params):
        want = np.asarray(getattr(js.engine_params, f.name))
        got = as_np(getattr(ts.engine_params, f.name))
        assert got.dtype == want.dtype, f.name
        np.testing.assert_array_equal(got, want, err_msg=f.name)

    assert (ts.routing is None) == (js.routing is None)
    if js.routing is not None:
        for attr in ROUTING:
            np.testing.assert_array_equal(as_np(getattr(ts.routing, attr)),
                                          np.asarray(getattr(js.routing, attr)),
                                          err_msg=attr)

    jst = js.init_state(jax.random.PRNGKey(0))
    tst = ts.init_state(batch=2)
    assert tst.t == int(jst.t) == 1
    for f in dataclasses.fields(jst):
        if f.name in ("t", "key"):
            continue
        want = np.asarray(getattr(jst, f.name))
        got = as_np(getattr(tst, f.name))
        assert got.shape == (2,) + want.shape, f.name
        assert got.dtype == want.dtype, f.name
        np.testing.assert_array_equal(got[0], want, err_msg=f.name)
        np.testing.assert_array_equal(got[1], want, err_msg=f.name)


@pytest.mark.parametrize("name", ["butterfly_scC", "melbourne", "nine_intersections"])
def test_padded_segment_tables(name):
    """Each padded member table lists exactly the entries of its segment,
    in ascending order, then -1 padding."""
    rt = torch_build(**scenario_args(name)).routing
    M = rt.offdiag_uniform.shape[-1]
    for members, seg, num in [
        (rt.group_members, rt.te_group, rt.num_groups),
        (rt.uo_group_members, rt.uo_group, rt.num_uo_groups),
        (rt.phi_c_members, rt.te_phi_c, rt.num_routed * M * M),
    ]:
        members, seg = members.numpy(), seg.numpy()
        assert members.shape[0] == num
        for s in range(num):
            want = np.flatnonzero(seg == s)
            row = members[s]
            np.testing.assert_array_equal(row[: len(want)], want)
            assert (row[len(want):] == -1).all()


@pytest.fixture
def x64_on():
    """float64 JAX arrays for one test, restored afterwards (the session
    ``x64`` fixture would leave them on for every later test file in the
    worker)."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", prev)


OD_META = ("nominal_origin_mask", "nominal_dest_mask", "candidate_origin_mask",
           "candidate_dest_mask", "demand_full", "od_pair_origin", "od_pair_dest",
           "od_table_full")


@pytest.mark.parametrize("option", ["exact_parity", "binomial_exact", "od_candidates",
                                    "optimal_solve"])
def test_later_slice_options_build_like_jax(option, x64_on):
    """The options the first slice rejected now build, exactly as the JAX
    host build does: the float64 exact-parity anchor, the exact binomial,
    the od_candidates superset (with its randomization metadata) and the
    "optimal" LP solve."""
    kwargs = {
        "exact_parity": {"ftype": "float64", "exact_parity": True},
        "binomial_exact": {"binomial_mode": "exact"},
        "od_candidates": {"od_candidates": ([1, 4], [2, 5])},
        "optimal_solve": {},
    }[option]
    name = "small_network" if option != "od_candidates" else "butterfly_scC"
    if option == "optimal_solve":
        args = scenario_args(name)
        args["params"]["assign_flows_type"] = "optimal"
        js = jax_build(**copy.deepcopy(args))
        ts = torch_build(**copy.deepcopy(args))
        assert ts.optimal_solver.nodes == js.optimal_solver.nodes
        for n in js.optimal_solver.nodes:
            np.testing.assert_array_equal(ts.optimal_solver._A_ub[n],
                                          js.optimal_solver._A_ub[n])
    else:
        js, ts = both(name, **kwargs)
    assert_builds_match(js, ts)
    for attr in ("exact_parity", "binomial_mode", "assign_flows_type", "od_randomizable"):
        assert getattr(ts, attr) == getattr(js, attr), attr
    assert str(ts.ftype).removeprefix("torch.") == np.dtype(js.ftype).name
    if js.od_randomizable:
        assert js.candidate_origin_mask.any() and js.candidate_dest_mask.any()
        for attr in OD_META:
            np.testing.assert_array_equal(getattr(ts, attr), getattr(js, attr), err_msg=attr)


def _defaults(fn, skip):
    """``[(name, default)]`` of a callable's parameters, dtypes by name."""
    out = []
    for name, par in inspect.signature(fn).parameters.items():
        if name in skip:
            continue
        d = par.default
        if isinstance(d, torch.dtype):
            d = str(d).removeprefix("torch.")
        elif d is not inspect.Parameter.empty and d is not None and not isinstance(
                d, (bool, int, float, str, tuple)):
            d = np.dtype(d).name
        out.append((name, d))
    return out


@pytest.mark.parametrize("which", ["build_scenario", "NetworkEnvGenerator.__init__",
                                   "NetworkEnvGenerator.create_network",
                                   "PedNetEnvCore.__init__", "PPOAgent.__init__",
                                   "SACAgent.__init__", "build_agents",
                                   "BatchedPPOTrainer.__init__",
                                   "BatchedSACTrainer.__init__"])
def test_public_defaults_match_jax(which):
    """The port's public signatures take the JAX package's parameters with
    the same defaults (dtypes compared by name), less the port's
    ``device`` and the JAX Pallas switches."""
    from pednstream_tpu import rl as jrl
    from pednstream_tpu.rl.train import build_agents as jax_build_agents
    from pednstream_tpu_torch import rl as trl
    from pednstream_tpu_torch.rl.train import build_agents

    jax_fn, torch_fn = {
        "build_scenario": (jax_build, scenario.build_scenario),
        "NetworkEnvGenerator.__init__": (JaxGenerator.__init__,
                                         generator.NetworkEnvGenerator.__init__),
        "NetworkEnvGenerator.create_network": (JaxGenerator.create_network,
                                               generator.NetworkEnvGenerator.create_network),
        "PedNetEnvCore.__init__": (JaxEnvCore.__init__, PedNetEnvCore.__init__),
        "PPOAgent.__init__": (jrl.PPOAgent.__init__, trl.PPOAgent.__init__),
        "SACAgent.__init__": (jrl.SACAgent.__init__, trl.SACAgent.__init__),
        "build_agents": (jax_build_agents, build_agents),
        "BatchedPPOTrainer.__init__": (jrl.BatchedPPOTrainer.__init__,
                                       trl.BatchedPPOTrainer.__init__),
        "BatchedSACTrainer.__init__": (jrl.BatchedSACTrainer.__init__,
                                       trl.BatchedSACTrainer.__init__),
    }[which]
    want = _defaults(jax_fn, skip=("use_pallas", "pallas_interpret"))
    got = _defaults(torch_fn, skip=("device",))
    assert got == want


def test_state_to_another_device():
    """Moving a built state to another device keeps shapes and t."""
    ts = torch_build(**scenario_args("butterfly_scC"), history_window=32)
    st = ts.init_state(batch=3)
    moved = st.to("meta")
    assert moved.t == st.t == 1
    assert moved.cum_in_ring.shape == (3, 32, ts.n_links)
    assert moved.cum_in_ring.device.type == "meta"
    assert st.cum_in_ring.device.type == "cpu"


def _entry_point_calls():
    """Each entry point of the port called with no ``device``."""
    from pednstream_tpu_torch import interop
    from pednstream_tpu_torch.env import PedNetParallelEnv
    from pednstream_tpu_torch.golden import golden_errors
    from pednstream_tpu_torch.rl import PPOAgent, SACAgent
    from pednstream_tpu_torch.rl.train import main as train_main
    from pednstream_tpu_torch.routing import build_routing_tables

    leaves = {"x": np.zeros(3, np.float32)}
    return {
        "build_scenario": lambda: scenario.build_scenario(**scenario_args("butterfly_scC")),
        "NetworkEnvGenerator": lambda: generator.NetworkEnvGenerator(),
        "PedNetParallelEnv": lambda: PedNetParallelEnv("butterfly_scC"),
        "PPOAgent": lambda: PPOAgent(obs_dim=16, act_dim=4, features_per_link=4),
        "SACAgent": lambda: SACAgent(16, 4),
        "golden_errors": lambda: golden_errors(ROOT / "tests" / "golden" / "butterfly.npz"),
        "build_routing_tables": lambda: build_routing_tables(None, None, []),
        "tensors_from_jax": lambda: interop.tensors_from_jax(leaves),
        "engine_params_from_jax": lambda: interop.engine_params_from_jax(leaves),
        "network_state_from_jax": lambda: interop.network_state_from_jax(
            {"cum_in": np.zeros(3), "t": np.array(1)}),
        "rl.train CLI": lambda: train_main(["--dataset", "butterfly_scC", "--episodes", "1"]),
    }


@pytest.mark.parametrize("entry", sorted(_entry_point_calls()))
def test_entry_points_run_on_the_card_unless_asked(entry, monkeypatch):
    """With no ``device`` every entry point asks for the card: where torch
    sees none, each raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        _entry_point_calls()[entry]()
