"""The PyTorch port's host-side scenario compiler against the JAX package:
the same datasets give exactly the same static arrays, engine parameters,
routing tables and initial state.  The port never imports JAX."""

import copy
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from pednstream_tpu import config as jax_config
from pednstream_tpu.scenario import build_scenario as jax_build
from pednstream_tpu_torch import config as torch_config
from pednstream_tpu_torch.generator import NetworkEnvGenerator
from pednstream_tpu_torch.scenario import build_scenario as torch_build

torch.set_num_threads(1)

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


def both(name, **kwargs):
    args = scenario_args(name)
    return (jax_build(**copy.deepcopy(args), **kwargs),
            torch_build(**copy.deepcopy(args), **kwargs))


def as_np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_port_never_imports_jax():
    """Every module of the port imports in a fresh interpreter without
    loading jax or flax."""
    code = (
        "import pkgutil, importlib, sys\n"
        "import pednstream_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in ('jax', 'flax', 'pednstream_tpu') if m in sys.modules]\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 12  # config ... ops._build, interop


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
    js, ts = both(name, history_window=window)
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


@pytest.mark.parametrize("kwargs", [
    {"exact_parity": True},
    {"binomial_mode": "exact"},
    {"od_candidates": ([1], [2])},
])
def test_later_slices_raise(kwargs):
    args = scenario_args("small_network")
    with pytest.raises(NotImplementedError):
        torch_build(**args, **kwargs)


def test_optimal_solve_raises():
    args = scenario_args("small_network")
    args["params"]["assign_flows_type"] = "optimal"
    with pytest.raises(NotImplementedError):
        torch_build(**args)


def test_state_to_another_device():
    """Moving a built state to another device keeps shapes and t."""
    ts = torch_build(**scenario_args("butterfly_scC"), history_window=32)
    st = ts.init_state(batch=3)
    moved = st.to("meta")
    assert moved.t == st.t == 1
    assert moved.cum_in_ring.shape == (3, 32, ts.n_links)
    assert moved.cum_in_ring.device.type == "meta"
    assert st.cum_in_ring.device.type == "cpu"
