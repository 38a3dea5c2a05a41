"""The port's per-replica domain randomization (pednstream_tpu_torch.randomize)
and its od_candidates superset build: the counterparts of
tests/test_randomize_od.py, the port's draws against JAX's in
distribution, and the port's step under JAX-drawn per-replica
EngineParams carried across by interop."""

import numpy as np
import pytest
import torch

import jax

from pednstream_tpu import engine as jax_engine
from pednstream_tpu.generator import NetworkEnvGenerator as JaxGenerator
from pednstream_tpu.randomize import randomize_engine_params_batched as jax_draws
from pednstream_tpu_torch.engine import simulate, simulate_batched, step_fn
from pednstream_tpu_torch.generator import NetworkEnvGenerator
from pednstream_tpu_torch.interop import (engine_params_from_jax, network_state_from_jax,
                                          numpy_leaves)
from pednstream_tpu_torch.randomize import (randomize_engine_params,
                                            randomize_engine_params_batched)

torch.set_num_threads(1)

DATASET = "butterfly_scC"


@pytest.fixture(autouse=True)
def float32_jax():
    """Another test file in the same worker may have switched JAX to
    float64 for the session; these comparisons are float32."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


@pytest.fixture(scope="module")
def scn():
    return NetworkEnvGenerator().build_od_randomizable(DATASET)


def gen(seed):
    return torch.Generator().manual_seed(seed)


def test_superset_build_nominal_inert(scn):
    """Candidate OD nodes exist in the topology but start closed: zero
    demand rows, zero virtual receiving, zero od_table rows."""
    assert scn.od_randomizable
    assert scn.candidate_origin_mask.sum() > 0
    assert scn.candidate_dest_mask.sum() > 0
    ep = scn.engine_params
    cand = scn.candidate_origin_mask | scn.candidate_dest_mask
    nom = scn.nominal_origin_mask | scn.nominal_dest_mask
    cand_only = cand & ~nom
    assert ep.demand.numpy()[scn.candidate_origin_mask & ~scn.nominal_origin_mask].sum() == 0
    assert ep.virt_recv.numpy()[cand_only].sum() == 0
    assert ep.virt_recv.numpy()[nom].min() > 0
    assert scn.demand_full[scn.candidate_origin_mask].sum() > 0
    pair_cand = (scn.candidate_origin_mask[scn.od_pair_origin]
                 | scn.candidate_dest_mask[scn.od_pair_dest])
    assert ep.od_table.numpy()[pair_cand].sum() == 0


def test_randomized_draws_open_candidates(scn):
    """Across draws, candidate nodes sometimes open, nominal nodes
    sometimes close, and no draw empties either side."""
    opened = dropped = 0
    g = gen(0)
    cand_only = ((scn.candidate_origin_mask | scn.candidate_dest_mask)
                 & ~(scn.nominal_origin_mask | scn.nominal_dest_mask))
    for _ in range(16):
        ep = randomize_engine_params(scn, g)
        vr = ep.virt_recv.numpy() > 0
        opened += int(vr[cand_only].any())
        dem_nodes = ep.demand.numpy().sum(axis=1) > 0
        assert dem_nodes.sum() > 0  # never empty
        assert (dem_nodes <= vr).all()  # injecting nodes are active
        dropped += int((~dem_nodes & scn.nominal_origin_mask).any())
    assert opened > 0
    assert dropped > 0


def test_closed_destination_absorbs_nothing(scn):
    """Zeroing a destination's virt_recv stops all exits there."""
    ep = scn.engine_params
    dest = int(np.where(scn.nominal_dest_mask)[0][0])
    vr = ep.virt_recv.clone()
    vr[dest] = 0.0
    fin_open, _ = simulate(scn, ep, scn.init_state(1), 80, record=False)
    fin_closed, _ = simulate(scn, ep.replace(virt_recv=vr), scn.init_state(1), 80,
                             record=False)
    assert fin_open.virt_arr_cum[0, dest] > 0
    assert fin_closed.virt_arr_cum[0, dest] == 0


@pytest.mark.slow
def test_batched_od_randomized_rollout(scn):
    B = 8
    eps = randomize_engine_params_batched(scn, gen(3), B)
    vr = eps.virt_recv.numpy()
    assert len({tuple(row) for row in (vr > 0).astype(int)}) > 1, (
        "replicas should draw different OD activations")
    fin = simulate_batched(scn, eps, scn.init_state(B), 60, gen=gen(4), stochastic=True)
    npd = fin.num_peds
    assert bool(torch.isfinite(npd).all())
    err = (fin.cum_in - fin.cum_out - npd).abs().max().item()
    assert err < 1e-2  # float32 mass conservation (fractional demand)


@pytest.mark.slow
def test_od_set_size_distribution_vs_reference_moves(scn):
    """The origin-set-size marginal of the per-node activations against
    the reference's sequential add/remove edit moves (env_loader.py:
    261-359) re-simulated in NumPy, at the band of
    tests/test_randomize_od.py (means within 0.35)."""
    rng = np.random.default_rng(0)
    adj = np.asarray(NetworkEnvGenerator().load_network_data(DATASET)["adjacency_matrix"])
    origins = sorted(np.where(scn.nominal_origin_mask)[0].tolist())
    controllers = {2}  # butterfly controller hub

    def khop2(nodes):
        nb = set()
        for n in nodes:
            nb.update(np.where(adj[n] == 1)[0].tolist())
        nb.update({m for n in list(nb) for m in np.where(adj[n] == 1)[0].tolist()})
        return nb

    ref_sizes = []
    for _ in range(4000):
        new_o = list(origins)
        if rng.random() < 0.5:  # ADD one
            cands = [n for n in khop2(new_o) if n not in new_o and n not in controllers]
            if cands:
                new_o.append(int(rng.choice(cands)))
        if len(new_o) > 1 and rng.random() < 0.5:  # REMOVE one
            new_o.pop(int(rng.integers(len(new_o))))
        ref_sizes.append(len(new_o))  # SWAP is size-preserving
    ours = (randomize_engine_params_batched(scn, gen(7), 512).demand.numpy().sum(axis=2)
            > 0).sum(axis=1)
    assert abs(float(ours.mean()) - float(np.mean(ref_sizes))) <= 0.35
    assert ours.min() >= 1  # empty-side fallback engaged


def _marginals(eps, nominal):
    """Summary draws of a batched EngineParams: the share of links with a
    capacity or speed change, the factors where changed, per-origin mean
    demand rate, OD weights, the active origin count and the mean
    shockwave lookback per replica."""
    kc = np.asarray(eps["k_critical"]) / nominal["k_critical"]
    ffs = np.asarray(eps["free_flow_speed"]) / nominal["free_flow_speed"]
    demand = np.asarray(eps["demand"])
    rate = demand.sum(axis=2) / demand.shape[2]
    od = np.asarray(eps["od_table"])[:, :, 0]
    return {
        "capacity changed": (kc != 1.0).mean(axis=1),
        "capacity factor": kc[kc != 1.0],
        "speed changed": (ffs != 1.0).mean(axis=1),
        "speed factor": ffs[ffs != 1.0],
        "demand rate": rate[rate > 0],
        "od weight": od[od > 0],
        "active origins": (rate > 0).sum(axis=1).astype(float),
        "tau_shockwave": np.asarray(eps["tau_shockwave"]).astype(float).mean(axis=1),
    }


def test_draw_marginals_match_jax(scn):
    """512 draws of each package on the same superset scenario.  Bands,
    per summary: means within 5 standard errors of their difference
    (pooled), and the 10/50/90% quantiles within 10% of the JAX sample's
    10-90% spread plus one step of the summary's grid (1/E for the
    per-replica shares and means over links, 1 for origin counts, 0 for
    the continuous draws)."""
    B = 512
    js = JaxGenerator().build_od_randomizable(DATASET)
    nominal = numpy_leaves(js.engine_params)
    want = _marginals(numpy_leaves(jax_draws(js, jax.random.PRNGKey(1), B)), nominal)
    got = _marginals(numpy_leaves(randomize_engine_params_batched(scn, gen(1), B)), nominal)
    per_link = 1.0 / scn.n_links
    grid = {"capacity changed": per_link, "speed changed": per_link,
            "active origins": 1.0, "tau_shockwave": per_link}
    for name in want:
        a, b = got[name], want[name]
        assert a.size > 20 and b.size > 20, name
        se = np.sqrt(a.var() / a.size + b.var() / b.size) + 1e-12
        assert abs(a.mean() - b.mean()) < 5 * se, (name, a.mean(), b.mean())
        qa, qb = np.quantile(a, [0.1, 0.5, 0.9]), np.quantile(b, [0.1, 0.5, 0.9])
        spread = qb[2] - qb[0]
        assert np.all(np.abs(qa - qb) <= 0.1 * spread + grid.get(name, 0.0) + 1e-9), (
            name, qa, qb)


def test_step_under_jax_drawn_params_matches_jax():
    """Four replicas with JAX-drawn per-replica EngineParams (carried
    across by interop): 30 deterministic JAX steps (fused Pallas read in
    interpret mode), then one step of each engine from that state, at
    rtol 1e-6 (the single-step tolerance of tests/test_torch_engine.py)."""
    js = JaxGenerator().build_od_randomizable(DATASET, use_pallas=True,
                                              pallas_interpret=True)
    ts = NetworkEnvGenerator().build_od_randomizable(DATASET)
    B = 4
    eps = jax_draws(js, jax.random.PRNGKey(5), B)
    step = jax.jit(jax.vmap(lambda st, ep: jax_engine.step_fn(js, ep, st, stochastic=False)))
    st = jax.vmap(js.init_state)(jax.random.split(jax.random.PRNGKey(0), B))
    for _ in range(30):
        st, _ = step(st, eps)
    want_st, want = step(st, eps)
    tep = engine_params_from_jax(numpy_leaves(eps))
    assert tep.demand.shape == (B,) + tuple(np.asarray(js.engine_params.demand).shape)
    got_st, got = step_fn(ts, tep, network_state_from_jax(numpy_leaves(st)))
    assert got_st.t == 32
    assert float(np.asarray(want.inflow).sum()) > 0
    for name, b in numpy_leaves(want).items():
        np.testing.assert_allclose(getattr(got, name).numpy(), b, rtol=1e-6, atol=0,
                                   err_msg=name)
    for name, b in numpy_leaves(want_st, skip=("key", "t")).items():
        np.testing.assert_allclose(getattr(got_st, name).numpy(), b, rtol=1e-6, atol=0,
                                   err_msg=name)


@pytest.mark.parametrize("dataset", ["butterfly_scC", "45_intersections"])
def test_host_randomize_network_matches_jax(dataset):
    """The host-side episode randomization (env_loader.py:160-424: OD-node
    edits, link incidents, OD weights, demand patterns) draws the same
    global np.random sequence as the JAX package: the same seed gives the
    same OD sets and exactly the same EngineParams."""
    js = JaxGenerator().randomize_network(dataset, seed=11)
    ts = NetworkEnvGenerator().randomize_network(dataset, seed=11)
    assert ts.origin_nodes == js.origin_nodes
    assert ts.destination_nodes == js.destination_nodes
    nominal = numpy_leaves(NetworkEnvGenerator().create_network(dataset).engine_params)
    changed = 0
    for name, want in numpy_leaves(js.engine_params).items():
        got = getattr(ts.engine_params, name).numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
        changed += got.shape != nominal[name].shape or not np.array_equal(got, nominal[name])
    assert changed > 0
