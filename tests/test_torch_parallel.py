"""Replica data parallelism of the port (pednstream_tpu_torch.parallel.mesh,
the trainers' ``mesh=``, rl.train.make_dp_train_step, the multi-device dry
run) on gloo groups of CPU ranks: the counterpart of tests/test_parallel.py,
case by case.

One group of 4 ranks is spawned for the module (a file:// store, one CPU
thread per rank), runs every case and reports; the test functions compare
the reports with the unsharded port run in this process.  The minimal
policy-gradient step's gradient is held to the JAX package's on the same
parameters, observations and noise (rtol 1e-5).  JAX is imported inside
the tests that use it, so the spawned ranks, which import this module,
never load it.
"""

import copy
import dataclasses
from functools import partial

import numpy as np
import pytest
import torch

from pednstream_tpu_torch import parallel as par
from pednstream_tpu_torch.env import PedNetEnvCore, build_agent_spec
from pednstream_tpu_torch.rl.batched_ppo import BatchedPPOTrainer
from pednstream_tpu_torch.rl.batched_sac import BatchedSACTrainer
from pednstream_tpu_torch.rl.train import init_train_state, make_dp_train_step
from pednstream_tpu_torch.scenario import build_scenario

torch.set_num_threads(1)
torch_build = partial(build_scenario, device="cpu")

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
WORLD = 4
B = 16
# (stochastic, binomial_mode) of the env-step cases
STEP_CASES = {"deterministic": (False, "exact"), "stochastic_fast": (True, "fast"),
              "stochastic_exact": (True, "exact")}
PPO = dict(num_envs=B, rollout_len=4, epochs=2, minibatches=2)
PPO_CASES = {"mlp": dict(net_type="mlp"),
             "attention_randomized": dict(net_type="attention", randomize=True)}
SAC = dict(num_envs=B, collect_steps=3, updates_per_iter=4, batch_size=32,
           buffer_capacity=256, warmup_transitions=16)
# the policy-gradient step's case: whole-batch noise from numpy
PG_B, PG_SEED = 8, 21


def make_core(stochastic=True, binomial_mode="exact", **kw):
    scn = torch_build(TINY_ADJ, copy.deepcopy(TINY_PARAMS), *TINY_OD,
                      binomial_mode=binomial_mode, **kw)
    return PedNetEnvCore(scn, build_agent_spec(scn), obs_mode="option2", stochastic=stochastic)


def gen(seed):
    return torch.Generator().manual_seed(seed)


def open_gates(core, batch):
    widths = torch.as_tensor(np.asarray(core.spec.gate_link_widths[0], np.float32))
    return {core.spec.gate_ids[0]: widths.expand(batch, -1).clone()}


def flat(modules):
    return torch.cat([p.detach().reshape(-1) for m in modules for p in m.parameters()])


def ppo_iteration(mesh, case):
    trainer = BatchedPPOTrainer(make_core(), mesh=mesh, **PPO, **PPO_CASES[case])
    ts = trainer.init(seed=4)
    block = tuple(ts.env_states.density.shape)
    ts, metrics = trainer.train_iteration(ts)
    params = flat(list(ts.params.values()) + list(ts.value_params.values()))
    return {"block": block, "metrics": metrics, "params": params, "state": ts.env_states}


def sac_iteration(mesh):
    trainer = BatchedSACTrainer(make_core(), mesh=mesh, randomize=True, **SAC)
    ts = trainer.init(seed=5)
    block = tuple(ts.env_states.density.shape)
    ring = tuple(ts.buffers["gate_2"]["s"].shape)
    ts, metrics = trainer.train_iteration(ts)
    params = flat([ts.params[a][k] for a in ts.params for k in ("actor", "critic")])
    return {"block": block, "ring": ring, "metrics": metrics, "params": params,
            "state": ts.env_states, "ring_sum": float(ts.buffers["gate_2"]["s"].sum()),
            "size": ts.size}


def pg_noise(act_dim):
    return np.random.default_rng(PG_SEED).normal(size=(PG_B, act_dim)).astype(np.float32)


def warm_actions(widths, k):
    """Step k's gate widths of the warm-up, one row per replica."""
    frac = np.random.default_rng(PG_SEED + 1 + k).uniform(0.2, 1.0, (PG_B, len(widths)))
    return (frac * np.asarray(widths)).astype(np.float32)


WARM_STEPS = 12


def warm_up(core):
    """PG_B replicas driven apart by per-replica gate actions, so that the
    policy-gradient step sees rewards that differ (from a fresh batch they
    are equal and the advantage is zero)."""
    states, obs = core.batch_reset(PG_B)
    gid, widths = core.spec.gate_ids[0], core.spec.gate_link_widths[0]
    for k in range(WARM_STEPS):
        states, obs, _, _ = core.batch_step(
            states, {gid: torch.from_numpy(warm_actions(widths, k))})
    return states, obs


def parallel_rank(rank, world, device):
    mesh = par.make_mesh(world, device=device)
    out = {"coords": mesh.coords, "shape": mesh.shape}

    core = make_core()
    states, obs = core.batch_reset(B)
    sharded = par.shard_batch(states, mesh)
    out["shard_shapes"] = {f.name: tuple(getattr(sharded, f.name).shape)
                           for f in dataclasses.fields(sharded) if f.name != "t"}
    out["t"] = sharded.t
    per_replica_t = par.shard_batch(torch.arange(B, dtype=torch.int32), mesh)
    out["t_block"] = per_replica_t.tolist()
    out["obs_block"] = {k: tuple(v.shape) for k, v in par.shard_batch(obs, mesh).items()}
    out["scalar"] = float(par.shard_batch(torch.tensor(3.0), mesh))

    for name, (stochastic, mode) in STEP_CASES.items():
        core = make_core(stochastic, mode)
        states, _ = core.batch_reset(B)
        step = par.data_parallel_env_step(core, mesh)
        st, o, rew, done = par.shard_batch(states, mesh), None, None, None
        actions = par.shard_batch(open_gates(core, B), mesh)
        for _ in range(3):
            st, o, rew, done = step(st, actions, gen(7) if stochastic else None)
        out["step/" + name] = par.unshard_batch((st, o, rew, done), mesh)
    out["step/collectives"] = {k: v[0] for k, v in mesh.collectives.items() if k != "unshard"}

    # the minimal policy-gradient step: replicated parameters, and the
    # gradient for the comparison with JAX (deterministic env, numpy noise)
    core = make_core(stochastic=False)
    states, obs = warm_up(core)
    train_state = init_train_state(core, 3, device=device)
    noise = torch.from_numpy(pg_noise(train_state["act_dim"]))
    _, new_obs, train_state, metrics = make_dp_train_step(core, mesh)(
        par.shard_batch(states, mesh), par.shard_batch(obs, mesh), train_state, gen(0),
        noise=par.shard_batch(noise, mesh))
    out["pg"] = {"loss": float(metrics["loss"]), "grads": [g.clone() for g in metrics["grads"]],
                 "params": flat([train_state["policy"]]),
                 "obs_block": tuple(new_obs[core.spec.gate_ids[0]].shape)}

    for case in PPO_CASES:
        r = ppo_iteration(mesh, case)
        r["state"] = par.unshard_batch(r["state"], mesh)
        out["ppo/" + case] = r
    r = sac_iteration(mesh)
    r["state"] = par.unshard_batch(r["state"], mesh)
    out["sac"] = r
    out["collectives"] = dict(mesh.collectives)
    return out


@pytest.fixture(scope="module")
def ranks():
    return par.spawn_ranks(parallel_rank, WORLD, device="cpu", threads=1)


def assert_trees_equal(a, b, what=""):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), what
    elif isinstance(a, dict):
        for k in a:
            assert_trees_equal(a[k], b[k], f"{what}/{k}")
    elif isinstance(a, (tuple, list)):
        for i, (x, y) in enumerate(zip(a, b)):
            assert_trees_equal(x, y, f"{what}/{i}")
    elif dataclasses.is_dataclass(a):
        assert_trees_equal(vars(a), vars(b), what)
    else:
        assert a == b, what


# -- the tests -----------------------------------------------------------------

def test_make_mesh_and_shard_batch(ranks):
    """A 1-D env mesh over 4 ranks: every leaf with a leading axis keeps
    its block of 4 replicas, a shared int t and scalars stay whole."""
    core = make_core()
    scn = core.scn
    for rank, r in enumerate(ranks):
        assert r["coords"] == {"env": rank} and r["shape"] == (WORLD,)
        shapes = r["shard_shapes"]
        assert shapes["density"] == (B // WORLD, scn.n_links)
        assert shapes["cum_in_ring"] == (B // WORLD, scn.H, scn.n_links)
        assert shapes["virt_dep"] == (B // WORLD, scn.n_nodes)
        assert r["t"] == 1 and r["scalar"] == 3.0
        assert r["t_block"] == list(range(rank * 4, rank * 4 + 4))
        assert all(s[0] == B // WORLD for s in r["obs_block"].values())


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_sharded_env_step_matches_unsharded(ranks, case):
    """Three RL steps of the 4-way sharded batch against core.batch_step on
    the whole batch: states, observations, rewards and done BITWISE, with
    either sampler (the draws are the unsharded batch's)."""
    stochastic, mode = STEP_CASES[case]
    core = make_core(stochastic, mode)
    st, _ = core.batch_reset(B)
    actions = open_gates(core, B)
    for _ in range(3):
        st, obs, rew, done = core.batch_step(st, actions, gen(7) if stochastic else None)
    assert float(st.num_peds.sum()) > 0
    for r in ranks:
        assert_trees_equal((st, obs, rew, done), r["step/" + case], case)
    # a pure rollout communicates only to draw the exact binomial
    assert set(ranks[0]["step/collectives"]) == {"binomial_operands"}


def test_dp_train_step_replicates_params(ranks):
    for r in ranks:
        assert np.isfinite(r["pg"]["loss"])
        assert torch.equal(r["pg"]["params"], ranks[0]["pg"]["params"])
        assert r["pg"]["obs_block"][0] == PG_B // WORLD  # the env state stayed sharded
    fresh = flat([init_train_state(make_core(), 3, device="cpu")["policy"]])
    assert not torch.equal(fresh, ranks[0]["pg"]["params"])


def test_dp_train_step_gradient_matches_jax(ranks):
    """The port's all-reduced gradient against the JAX step's, on the same
    parameters (through params_from_flax), observations and noise, with a
    deterministic env.  The port's is the score-function gradient at the
    detached action; the JAX step as written keeps the action attached and
    differentiates through the env instead, so the JAX gradient is computed
    both ways (as written, and with stop_gradient on the action and the
    rewards) and the port held to the second (rtol 1e-5)."""
    import jax
    import jax.numpy as jnp

    from pednstream_tpu.env import PedNetEnvCore as JaxCore, build_agent_spec as jax_spec
    from pednstream_tpu.rl.ppo import _gaussian_logprob
    from pednstream_tpu.rl.train import init_train_state as jax_init
    from pednstream_tpu.scenario import build_scenario as jax_build
    from pednstream_tpu_torch.interop import (
        network_state_from_jax, numpy_leaves, params_from_flax, tensors_from_jax)

    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        js = jax_build(TINY_ADJ, copy.deepcopy(TINY_PARAMS), *TINY_OD)
        jcore = JaxCore(js, jax_spec(js), obs_mode="option2", stochastic=False)
        jts = jax_init(jcore, jax.random.PRNGKey(3))
        policy, agent_id = jts["policy"], jts["agent_id"]
        states, obs = jcore.batch_reset(jax.random.split(jax.random.PRNGKey(2), PG_B))
        for k in range(WARM_STEPS):
            states, obs, _, _ = jcore.batch_step(
                states, {agent_id: jnp.asarray(warm_actions(jcore.spec.gate_link_widths[0], k))})
        noise = jnp.asarray(pg_noise(jts["act_dim"]))

        def loss_fn(p, detach):
            mu, log_std, _ = jax.vmap(lambda o: policy.apply(p, o))(obs[agent_id])
            act = mu + jnp.exp(log_std) * noise
            if detach:
                act = jax.lax.stop_gradient(act)
            _, _, rewards, _, _ = jax.vmap(jcore._step_impl)(states, {agent_id: act})
            r = rewards[agent_id]
            if detach:
                r = jax.lax.stop_gradient(r)
            logp = jax.vmap(_gaussian_logprob)(mu, log_std, act)
            return -(logp * (r - r.mean())).mean()

        loss_d, grads_d = jax.value_and_grad(lambda p: loss_fn(p, True))(jts["params"])
        _, grads_w = jax.value_and_grad(lambda p: loss_fn(p, False))(jts["params"])
        warm = (network_state_from_jax(numpy_leaves(states), device="cpu"),
                tensors_from_jax({k: np.asarray(v) for k, v in obs.items()}, device="cpu"))
    finally:
        jax.config.update("jax_enable_x64", prev)

    # the same parameters in the port: init_train_state(seed 3) must agree
    # with flax's PRNGKey(3) only in shape, so load the JAX tree
    core = make_core(stochastic=False)
    ts = init_train_state(core, 3, device="cpu")
    ts["policy"].load_state_dict(params_from_flax(ts["policy"], jts["params"]))
    mesh_free = _single_rank_gradient(core, ts, *warm)
    names = [n for n, _ in ts["policy"].named_parameters()]
    want_d = params_from_flax(ts["policy"], grads_d)
    want_w = params_from_flax(ts["policy"], grads_w)
    scale = max(float(np.abs(np.asarray(v)).max()) for v in want_d.values())
    assert scale > 0
    for name, g in zip(names, mesh_free["grads"]):
        np.testing.assert_allclose(g.numpy(), np.asarray(want_d[name]), rtol=1e-5,
                                   atol=1e-6 * scale, err_msg=name)
    np.testing.assert_allclose(mesh_free["loss"], float(loss_d), rtol=1e-5)
    # the gradient as the JAX step is written is another estimator: only
    # the path through the env's rewards (its logp term has a zero gradient)
    written = max(float(np.abs(np.asarray(v)).max()) for v in want_w.values())
    apart = max(float(np.abs(np.asarray(want_w[n]) - np.asarray(want_d[n])).max())
                for n in names)
    print(f"JAX gradient as written: largest component {written:.3e}; score-function "
          f"gradient: {scale:.3e}; largest difference {apart:.3e}")
    assert apart > 1e-3 * scale


def _single_rank_gradient(core, train_state, states, obs):
    """make_dp_train_step on a mesh of one rank in this process."""
    import os
    import tempfile

    import torch.distributed as dist

    with tempfile.TemporaryDirectory() as tmp:
        par.init_rank(0, 1, os.path.join(tmp, "store"), device="cpu")
        try:
            mesh = par.make_mesh(1, device="cpu")
            noise = torch.from_numpy(pg_noise(train_state["act_dim"]))
            _, _, _, metrics = make_dp_train_step(core, mesh)(
                states, obs, train_state, gen(0), noise=noise)
            return {"loss": float(metrics["loss"]), "grads": metrics["grads"]}
        finally:
            dist.destroy_process_group()


def test_dp_train_step_sharded_gradient_matches_single_rank(ranks):
    """Four ranks' all-reduced gradient equals the whole batch's on one
    rank (the same seed-3 parameters and noise), up to the order of sums."""
    core = make_core(stochastic=False)
    one = _single_rank_gradient(core, init_train_state(core, 3, device="cpu"), *warm_up(core))
    assert abs(one["loss"]) > 0
    for r in ranks:
        np.testing.assert_allclose(r["pg"]["loss"], one["loss"], rtol=1e-5, atol=1e-7)
        for g, want in zip(r["pg"]["grads"], one["grads"]):
            torch.testing.assert_close(g, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("case", list(PPO_CASES))
def test_mesh_sharded_batched_ppo_matches_unsharded(ranks, case):
    """One BatchedPPOTrainer iteration over 4 ranks against the unsharded
    trainer from the same seed: init keeps the rank's replicas, the
    rollout's env state is BITWISE the unsharded one, metrics agree at rtol
    1e-4, atol 1e-6 and updated parameters at rtol 1e-4, atol 1e-5, and the
    parameters are equal on every rank."""
    plain = ppo_iteration(None, case)
    for r in (x["ppo/" + case] for x in ranks):
        assert r["block"][0] == B // WORLD
        assert_trees_equal(plain["state"], r["state"], "env state")
        for k, v in plain["metrics"].items():
            assert np.isfinite(r["metrics"][k])
            np.testing.assert_allclose(r["metrics"][k], v, rtol=1e-4, atol=1e-6, err_msg=k)
        # Adam's normalised step turns an ulp of a near-zero gradient (the
        # sums run in another order) into a fraction of lr = 3e-4: atol lr/30
        np.testing.assert_allclose(r["params"].numpy(), plain["params"].numpy(),
                                   rtol=1e-4, atol=1e-5)
        assert torch.equal(r["params"], ranks[0]["ppo/" + case]["params"])
    assert ranks[0]["collectives"]["gradients"][0] > 0


def test_mesh_sharded_batched_sac_matches_unsharded(ranks):
    """One BatchedSACTrainer iteration over 4 ranks: sharded collection
    into the replay ring that every rank holds whole, then replicated
    updates; against the unsharded trainer at rtol 1e-4."""
    plain = sac_iteration(None)
    for r in (x["sac"] for x in ranks):
        assert r["block"][0] == B // WORLD
        assert r["ring"] == plain["ring"] and r["size"] == plain["size"]  # the ring is whole
        # the actor's forward pass on 4 rows rounds otherwise than on 16, so
        # the actions, and with them the env state, agree to a few ulps only
        for f in dataclasses.fields(plain["state"]):
            if f.name != "t":
                torch.testing.assert_close(getattr(r["state"], f.name),
                                           getattr(plain["state"], f.name),
                                           rtol=1e-4, atol=1e-4, msg=f.name)
        assert r["state"].t == plain["state"].t
        np.testing.assert_allclose(r["ring_sum"], plain["ring_sum"], rtol=1e-4)
        for k, v in plain["metrics"].items():
            assert np.isfinite(r["metrics"][k])
            np.testing.assert_allclose(r["metrics"][k], v, rtol=1e-4, atol=1e-4, err_msg=k)
        np.testing.assert_allclose(r["params"].numpy(), plain["params"].numpy(),
                                   rtol=1e-4, atol=1e-4)
        assert torch.equal(r["params"], ranks[0]["sac"]["params"])
    assert ranks[0]["collectives"]["replicas"][0] > 0


def test_dryrun_five_stages_two_ranks(capsys):
    import dryrun_multichip_torch

    report = dryrun_multichip_torch.dryrun_multichip(2, device="cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("dryrun_multichip ok: 2 devices, batch 4, pg-loss ")
    assert "link-sharded mass" in line and "hybrid 2x1" in line
    assert report["link_n"] == 2 and report["hybrid"] and report["t"] == 2
    assert all(np.isfinite(report[k]) for k in ("pg_loss", "ppo_loss", "sac_loss", "link_mass"))
