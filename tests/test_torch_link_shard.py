"""Link-axis sharding of the port (pednstream_tpu_torch.parallel.link_shard)
on gloo groups of CPU ranks: the counterpart of tests/test_link_shard.py,
case by case.

Each group of ranks is spawned once per module (a file:// store, one CPU
thread per rank), runs every case of its size and reports; the test
functions compare the reports with the unsharded port run in this
process, BITWISE, and one of them with the JAX package's own link-sharded
run on its 8-device virtual CPU mesh (rtol 1e-6, float32, EngineParams
passed as an argument).  JAX is imported inside the tests that use it, so
the spawned ranks, which import this module, never load it.
"""

import copy
import dataclasses
from functools import partial

import numpy as np
import pytest
import torch

from pednstream_tpu_torch import generator, parallel as par
from pednstream_tpu_torch.engine import simulate, simulate_batched, step_fn
from pednstream_tpu_torch.scenario import build_scenario

torch.set_num_threads(1)
torch_build = partial(build_scenario, device="cpu")
NetworkEnvGenerator = partial(generator.NetworkEnvGenerator, device="cpu")

TINY_ADJ = np.array([
    [0, 0, 1, 0, 0],
    [0, 0, 1, 0, 0],
    [1, 1, 0, 1, 1],
    [0, 0, 1, 0, 0],
    [0, 0, 1, 0, 0],
])
TINY_PARAMS = {
    "simulation_steps": 40,
    "unit_time": 10,
    "seed": 0,
    "default_link": {
        "length": 50, "width": 4, "free_flow_speed": 1.1,
        "k_critical": 2, "k_jam": 6, "fd_type": "yperman", "bi_factor": 1,
    },
    "controllers": {"enabled": True, "nodes": [2]},
    "demand": {"origin_0": {"pattern": "constant", "base_lambda": 5}},
}
TINY_OD = ([0, 1], [3, 4])

# (name, stochastic, build keywords) of the tiny runs; E = 8 links
TINY_CASES = {
    "deterministic": (False, {}),
    "stochastic_fast": (True, {"binomial_mode": "fast"}),
    "stochastic_exact": (True, {"binomial_mode": "exact"}),
    "float64_exact_parity": (False, {"ftype": torch.float64, "exact_parity": True}),
}
TINY_STEPS = 30
SEED = 11


def tiny_scenario(**kw):
    return torch_build(TINY_ADJ, copy.deepcopy(TINY_PARAMS), *TINY_OD, **kw)


def two_coordinators():
    args = NetworkEnvGenerator().scenario_args("two_coordinators")
    if args["params"].get("seed") is None:
        args["params"]["seed"] = 3
    return torch_build(**args, binomial_mode="fast")


def gen(seed=SEED):
    return torch.Generator().manual_seed(seed)


def halve_gates_run(step, st):
    """Six steps with every gate half closed before the fourth (the
    control path: the state's gate surface replaced between steps)."""
    for i in range(6):
        if i == 3:
            st = st.replace(back_gate=st.back_gate * 0.5)
        st = step(st)
    return st


# -- what the spawned ranks run ------------------------------------------------

def tiny_rank(rank, world, device):
    """One link per rank (E = 8 over 8 ranks): every reverse pair straddles
    two ranks."""
    mesh = par.make_mesh(world, axis="link", device=device)
    out = {"coords": mesh.coords, "shape": mesh.shape}
    for name, (stochastic, kw) in TINY_CASES.items():
        scn = tiny_scenario(**kw)
        before = copy.deepcopy(mesh.collectives)
        st = par.shard_link_state(scn.init_state(1), mesh)
        run = par.make_link_sharded_simulate(scn, mesh, TINY_STEPS, stochastic=stochastic)
        final = run(par.shard_link_params(scn.engine_params, mesh), st, gen())
        if name == "deterministic":
            out["block_shapes"] = {f.name: tuple(getattr(final, f.name).shape)
                                   for f in dataclasses.fields(final) if f.name != "t"}
            out["record"] = copy.deepcopy(mesh.collectives)
            out["guard"] = par.assert_no_full_ring_collectives(
                mesh, scn.H * scn.n_links * 4)
        out[name] = par.unshard_state(final, mesh)
        out[name + "/collectives"] = (
            mesh.collectives["link_exchange"][0] - before.get("link_exchange", [0])[0])

    scn = tiny_scenario()
    # ten deterministic float32 steps, for the comparison with the JAX run
    ep = par.shard_link_params(scn.engine_params, mesh)
    run = par.make_link_sharded_simulate(scn, mesh, 10)
    out["ten_steps"] = par.unshard_state(
        run(ep, par.shard_link_state(scn.init_state(1), mesh)), mesh)

    step = par.make_link_sharded_step(scn, mesh)
    st = halve_gates_run(lambda s: step(ep, s), par.shard_link_state(scn.init_state(1), mesh))
    # whole parameters are refused: they are placed once, by the caller
    try:
        step(scn.engine_params, st)
        out["whole_ep"] = ""
    except ValueError as e:
        out["whole_ep"] = str(e)
    out["control_block"] = tuple(st.cum_in_ring.shape)
    out["control"] = par.unshard_state(st, mesh)

    out["placements"] = (par.link_state_shardings(mesh), par.link_params_shardings(mesh))
    out["ep_block"] = {f.name: tuple(getattr(ep, f.name).shape)
                       for f in dataclasses.fields(ep)}

    # the guard trips on a ring sent through the step's exchange
    ring_mesh = par.make_mesh(world, axis="link", device=device)
    ring = torch.zeros(1, scn.H, 1)
    par.all_gather(ring, ring_mesh, "link", name="link_exchange")
    try:
        par.assert_no_full_ring_collectives(ring_mesh.collectives, scn.H * scn.n_links * 4)
        out["tripped"] = ""
    except AssertionError as e:
        out["tripped"] = str(e)
    return out


def four_rank(rank, world, device):
    out = {}
    scn = two_coordinators()
    mesh = par.make_mesh(world, axis="link", device=device)
    run = par.make_link_sharded_simulate(scn, mesh, 15, stochastic=True)
    final = run(par.shard_link_params(scn.engine_params, mesh),
                par.shard_link_state(scn.init_state(2), mesh), gen())
    out["two_coordinators"] = par.unshard_state(final, mesh)
    out["two_coordinators/guard"] = par.assert_no_full_ring_collectives(
        mesh, 2 * scn.H * scn.n_links * 4)

    scn = tiny_scenario(binomial_mode="fast")
    mesh2d = par.make_mesh_2d(2, 2, device=device)
    out["hybrid/coords"] = mesh2d.coords
    out["hybrid/placements"] = par.hybrid_state_shardings(mesh2d)
    for stochastic in (False, True):
        run = par.make_hybrid_sharded_simulate(scn, mesh2d, 25, stochastic=stochastic)
        final = run(par.shard_link_params(scn.engine_params, mesh2d),
                    par.shard_hybrid_state(scn.init_state(4), mesh2d), gen())
        out[f"hybrid/{stochastic}/block"] = tuple(final.cum_in_ring.shape)
        out[f"hybrid/{stochastic}"] = par.unshard_state(final, mesh2d, "link", "env")
    return out


def grid_scenario(n=165):
    from pednstream_tpu_torch.config import grid_adjacency

    N = n * n
    params = {
        "simulation_steps": 60, "unit_time": 10, "seed": 0,
        "default_link": {"length": 80, "width": 3, "free_flow_speed": 1.2,
                         "k_critical": 2, "k_jam": 6, "fd_type": "yperman", "bi_factor": 1},
        "demand": {"origin_0": {"pattern": "constant", "base_lambda": 8},
                   f"origin_{N - 1}": {"pattern": "constant", "base_lambda": 8}},
    }
    return torch_build(grid_adjacency(n, n), params, [0, N - 1], [n - 1, N - n],
                       history_window=16)


def tensor_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in vars(tree).values()
               if isinstance(x, torch.Tensor))


def grid_rank(rank, world, device):
    scn = grid_scenario()
    mesh = par.make_mesh(world, axis="link", device=device)
    whole = scn.init_state(1)
    st = par.shard_link_state(whole, mesh)
    out = {"whole_bytes": tensor_bytes(whole), "block_bytes": tensor_bytes(st),
           "node_bytes": sum(getattr(st, f).numel() * getattr(st, f).element_size()
                             for f in ("virt_dep", "virt_arr", "virt_dep_cum", "virt_arr_cum")),
           "ring_block": tuple(st.cum_in_ring.shape)}
    del whole
    final = par.make_link_sharded_simulate(scn, mesh, 3)(
        par.shard_link_params(scn.engine_params, mesh), st)
    out["guard"] = par.assert_no_full_ring_collectives(mesh, scn.H * scn.n_links * 4)
    out["record"] = dict(mesh.collectives)
    out["final"] = par.unshard_state(final, mesh) if rank == 0 else None
    if rank != 0:  # every rank takes part in the gather
        par.unshard_state(final, mesh)
    return out


@pytest.fixture(scope="module")
def tiny8():
    return par.spawn_ranks(tiny_rank, 8, device="cpu", threads=1)


@pytest.fixture(scope="module")
def four():
    return par.spawn_ranks(four_rank, 4, device="cpu", threads=1)


def assert_states_bitequal(ref, out):
    for f in dataclasses.fields(ref):
        a, b = getattr(ref, f.name), getattr(out, f.name)
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), f"leaf {f.name} diverged"
        else:
            assert a == b, f"leaf {f.name} diverged"


# -- the tests -----------------------------------------------------------------

@pytest.mark.parametrize("case", list(TINY_CASES))
def test_link_sharded_bitexact_tiny(tiny8, case):
    """E = 8 directed links over 8 ranks, one link per rank: sharded must
    equal unsharded BITWISE on every rank, deterministic, stochastic with
    either sampler, and on the float64 exact-parity path."""
    stochastic, kw = TINY_CASES[case]
    scn = tiny_scenario(**kw)
    ref, _ = simulate(scn, scn.engine_params, scn.init_state(1), TINY_STEPS, gen(),
                      stochastic, record=False)
    assert float(ref.num_peds.sum()) > 0
    for r in tiny8:
        assert_states_bitequal(ref, r[case])


def test_link_sharded_layout(tiny8):
    scn = tiny_scenario()
    H, W, N = scn.H, scn.avg_tt_window, scn.n_nodes
    for rank, r in enumerate(tiny8):
        assert r["coords"] == {"link": rank} and r["shape"] == (8,)
        shapes = r["block_shapes"]
        assert shapes["cum_in_ring"] == (1, H, 1) and shapes["tt_ring"] == (1, W, 1)
        assert shapes["density"] == (1, 1) and shapes["back_gate"] == (1, 1)
        assert shapes["virt_arr_cum"] == (1, N)  # node leaves replicated
        assert r["ep_block"]["length"] == (1,) and r["ep_block"]["tau_shockwave"] == (1,)
        assert r["ep_block"]["demand"] == tuple(scn.engine_params.demand.shape)
        assert r["ep_block"]["phi_base"] == tuple(scn.engine_params.phi_base.shape)


def test_link_shardings_name_the_placements(tiny8):
    st_sh, ep_sh = tiny8[0]["placements"]
    assert st_sh.cum_in_ring == st_sh.tt_ring == (None, None, "link")
    assert st_sh.density == st_sh.back_gate == st_sh.recv_prev == (None, "link")
    assert st_sh.virt_dep == (None, None) and st_sh.t == (None,)
    assert ep_sh.length == ep_sh.gamma == ep_sh.tau_shockwave == ("link",)
    assert ep_sh.demand is ep_sh.od_table is ep_sh.phi_base is ep_sh.virt_recv is None


def test_link_sharded_step_interactive_control(tiny8):
    """make_link_sharded_step with the gates halved mid-run (as a
    controller would): blocks stay blocks and match the unsharded engine."""
    scn = tiny_scenario()
    ref = halve_gates_run(
        lambda s: step_fn(scn, scn.engine_params, s, record=False)[0], scn.init_state(1))
    for r in tiny8:
        assert "shard_link_params" in r["whole_ep"]
        assert r["control_block"] == (1, scn.H, 1)
        assert_states_bitequal(ref, r["control"])


def test_ring_collective_guard_counts_and_trips(tiny8):
    """The memory claim: a run's collectives are counted (4 per float32
    step: counts and gates; sending flows; receiving flows; density), none
    reaches a ring's size, and a ring sent through the exchange trips the
    guard."""
    scn = tiny_scenario()
    for r in tiny8:
        n_coll, n_bad = r["guard"]
        assert (n_coll, n_bad) == (4 * TINY_STEPS, 0)
        calls, largest, _ = r["record"]["link_exchange"]
        assert calls == 4 * TINY_STEPS
        assert 0 < largest < scn.H * scn.n_links * 4
        assert r["deterministic/collectives"] == 4 * TINY_STEPS
        # float64 flows and float32 counts travel apart
        assert r["float64_exact_parity/collectives"] > 4 * TINY_STEPS
        assert "materialize a full ring" in r["tripped"]
    with pytest.raises(AssertionError):
        par.assert_no_full_ring_collectives({"link_exchange": [1, 4096, 4096]}, 4096)
    assert par.assert_no_full_ring_collectives(
        {"link_exchange": [7, 4095, 9000], "unshard": [1, 10 ** 9, 10 ** 9]}, 4096) == (7, 0)


def test_link_sharded_bitexact_real_dataset_with_routing(four):
    """two_coordinators (168 directed links, routed turning fractions,
    separator controllers), B = 2, 15 stochastic steps over 4 ranks: the
    whole pipeline under link sharding, bitwise equal to one process."""
    scn = two_coordinators()
    assert scn.routing is not None and scn.n_links % 4 == 0
    ref, _ = simulate(scn, scn.engine_params, scn.init_state(2), 15, gen(), True, record=False)
    assert float(ref.num_peds.sum()) > 0
    for r in four:
        assert_states_bitequal(ref, r["two_coordinators"])
        n_coll, n_bad = r["two_coordinators/guard"]
        assert n_coll == 4 * 15 and n_bad == 0


@pytest.mark.parametrize("stochastic", [False, True])
def test_hybrid_env_x_link_sharding_bitexact(four, stochastic):
    """2-D mesh (env = 2 x link = 2), B = 4, 25 steps: replicas block over
    the first axis, each replica's links over the second; bitwise equal to
    the unsharded batched engine."""
    scn = tiny_scenario(binomial_mode="fast")
    ref = simulate_batched(scn, scn.engine_params, scn.init_state(4), 25, gen(), stochastic)
    for rank, r in enumerate(four):
        assert r["hybrid/coords"] == {"env": rank // 2, "link": rank % 2}
        assert r[f"hybrid/{stochastic}/block"] == (2, scn.H, scn.n_links // 2)
        assert_states_bitequal(ref, r[f"hybrid/{stochastic}"])
    sh = four[0]["hybrid/placements"]
    assert sh.cum_in_ring == ("env", None, "link") and sh.density == ("env", "link")
    assert sh.virt_dep == ("env", None) and sh.t == ("env",)


def test_link_sharded_matches_jax_link_sharded(tiny8):
    """Ten deterministic float32 steps of the link-sharded port (8 gloo
    ranks) against the JAX package's link-sharded run on its 8-device
    virtual CPU mesh: every leaf within rtol 1e-6."""
    import jax

    from pednstream_tpu.parallel import make_link_sharded_simulate, make_mesh, shard_link_state
    from pednstream_tpu.scenario import build_scenario as jax_build
    from pednstream_tpu_torch.interop import numpy_leaves

    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        js = jax_build(TINY_ADJ, copy.deepcopy(TINY_PARAMS), *TINY_OD)
        mesh = make_mesh(8, axis="link")
        run = make_link_sharded_simulate(js, mesh, 10, stochastic=False)
        ref = numpy_leaves(run(js.engine_params,
                               shard_link_state(js.init_state(jax.random.PRNGKey(0)), mesh)))
    finally:
        jax.config.update("jax_enable_x64", prev)
    out = tiny8[0]["ten_steps"]
    assert int(ref.pop("t")) == out.t
    assert float(out.num_peds.sum()) > 0
    for name, a in ref.items():
        b = getattr(out, name)[0].numpy()  # the port's leading replica axis
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=0, err_msg=name)


@pytest.mark.slow
def test_link_sharded_100k_link_grid():
    """A 165 x 165 grid, 108,240 directed links, over 4 ranks for 3 steps:
    the rings are blockwise, no collective reaches a ring, mass moves,
    sharded equals unsharded bitwise, and a rank holds a quarter of the
    link state plus the replicated node leaves."""
    results = par.spawn_ranks(grid_rank, 4, device="cpu", threads=1)
    scn = grid_scenario()
    E = scn.n_links
    assert E == 2 * 2 * 165 * 164
    ref, _ = simulate(scn, scn.engine_params, scn.init_state(1), 3, record=False)
    for r in results:
        assert r["ring_block"] == (1, scn.H, E // 4)
        assert r["guard"][0] > 0 and r["guard"][1] == 0
        assert r["block_bytes"] <= r["whole_bytes"] / 4 + r["node_bytes"]
    final = results[0]["final"]
    assert float(final.num_peds.sum()) > 0
    assert_states_bitequal(ref, final)
