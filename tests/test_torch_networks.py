"""The port's network families (pednstream_tpu_torch.rl.networks) against
flax on the CPU: every family at hidden 16 and at the zoo's 64, three
replicas, five recurrent steps from a random carry, on flax ``init``
parameters carried over by ``interop.params_from_flax``.  Outputs and
carries match flax ``apply`` at rtol 1e-5 / atol 1e-6, gradients of a
scalar loss match ``jax.grad`` at rtol 1e-4 / atol 1e-6, and the
flax <-> torch converters round-trip exactly."""

import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pednstream_tpu.rl import networks as jnets
from pednstream_tpu_torch.interop import params_from_flax, params_to_flax
from pednstream_tpu_torch.rl import networks as tnets

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)
B, T, L, FPL, K = 3, 5, 4, 4, 4  # replicas, steps, links, features per link, stack
D, A = L * FPL, L  # flat obs and action widths


@pytest.fixture(autouse=True)
def float32_jax():
    """Another test file in the same worker may have switched JAX to
    float64 for the session; these comparisons are float32."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


# name: (kind, flax module, torch module, obs shape per replica, carry shape)
def families(h):
    return {
        "AttentionPolicy": ("policy", jnets.AttentionPolicy(L, h),
                            tnets.AttentionPolicy(L, FPL, h), (L, FPL), (L, h)),
        "AttentionValue": ("value", jnets.AttentionValue(L, h),
                           tnets.AttentionValue(L, FPL, h), (L, FPL), (L, h)),
        "LSTMPolicy": ("policy", jnets.LSTMPolicy(A, h), tnets.LSTMPolicy(D, A, h),
                       (D,), (h,)),
        "LSTMValue": ("value", jnets.LSTMValue(h), tnets.LSTMValue(D, h), (D,), (h,)),
        "StackedPolicy": ("policy", jnets.StackedPolicy(A, h),
                          tnets.StackedPolicy(D, A, K, h), (K, D), None),
        "StackedValue": ("value", jnets.StackedValue(h), tnets.StackedValue(D, K, h),
                         (K, D), None),
        "MLPPolicy": ("policy", jnets.MLPPolicy(A, (h, h)), tnets.MLPPolicy(D, A, (h, h)),
                      (D,), None),
        "MLPValue": ("value", jnets.MLPValue((h, h)), tnets.MLPValue(D, (h, h)), (D,), None),
        "UDLSTMPolicy": ("policy", jnets.UDLSTMPolicy(L, h), tnets.UDLSTMPolicy(L, FPL, h),
                         (L, FPL), (L, h)),
        "UDLSTMValue": ("value", jnets.UDLSTMValue(L, h), tnets.UDLSTMValue(L, FPL, h),
                        (L, FPL), (L, h)),
        "GATLSTMPolicy": ("policy", jnets.GATLSTMPolicy(L, h), tnets.GATLSTMPolicy(L, FPL, h),
                          (L, FPL), (L, h)),
        "GATLSTMValue": ("value", jnets.GATLSTMValue(L, h), tnets.GATLSTMValue(L, FPL, h),
                         (L, FPL), (L, h)),
        "SACActor": ("actor", jnets.SACActor(A, h), tnets.SACActor(D, A, K, h), (K, D), None),
        "SACCritic": ("critic", jnets.SACCritic(h), tnets.SACCritic(D, A, K, h), (K, D), None),
    }


ADJ = np.array([[1, 1, 0, 0], [1, 1, 1, 0], [0, 1, 1, 1], [0, 0, 1, 1]], np.float32)


def inputs(name, obs_shape, carry_shape, seed):
    """``obs [T, B, ...]`` (plus ``act [T, B, A]`` for the critic), the
    initial carry ``(c, h)`` (or None) and the loss weights, from numpy."""
    rng = np.random.default_rng(seed)
    obs = rng.normal(0, 1, (T, B) + obs_shape).astype(np.float32)
    act = rng.uniform(-1, 1, (T, B, A)).astype(np.float32)
    carry = None if carry_shape is None else tuple(
        rng.normal(0, 0.5, (B,) + carry_shape).astype(np.float32) for _ in range(2))
    return obs, act, carry, rng


def jax_step(kind, mod, params, o, a, c, extra):
    """One replica's outputs tuple and new carry."""
    if kind == "policy":
        mu, ls, c = mod.apply(params, o, c, *extra)
        return (mu, ls), c
    if kind == "value":
        v, c = mod.apply(params, o, c, *extra)
        return (v,), c
    if kind == "actor":
        return mod.apply(params, o), c
    return mod.apply(params, o, a), c


def torch_step(kind, mod, o, a, c, extra):
    if kind == "policy":
        mu, ls, c = mod(o, c, *extra)
        return (mu, ls), c
    if kind == "value":
        v, c = mod(o, c, *extra)
        return (v,), c
    if kind == "actor":
        return mod(o), c
    return mod(o, a), c


def run_both(name, h, seed=0):
    kind, jmod, tmod, obs_shape, carry_shape = families(h)[name]
    obs, act, carry, rng = inputs(name, obs_shape, carry_shape, seed)
    gat = name.startswith("GAT")
    jextra = (jnp.asarray(ADJ),) if gat else ()
    textra = (torch.from_numpy(ADJ),) if gat else ()
    c0 = None if carry is None else tuple(jnp.asarray(x[0]) for x in carry)
    if kind == "critic":
        params = jmod.init(jax.random.PRNGKey(seed), obs[0, 0], act[0, 0])
    elif kind == "actor":
        params = jmod.init(jax.random.PRNGKey(seed), obs[0, 0])
    else:
        params = jmod.init(jax.random.PRNGKey(seed), obs[0, 0], c0, *jextra)
    params = jax.device_get(params)

    # loss weights per step and output, drawn once
    probe = jax.vmap(lambda o, a, c: jax_step(kind, jmod, params, o, a, c, jextra)[0])(
        obs[0], act[0], None if carry is None else tuple(map(jnp.asarray, carry)))
    weights = [[rng.normal(0, 1, np.shape(x)).astype(np.float32) for x in probe]
               for _ in range(T)]

    def jloss(p):
        c = None if carry is None else tuple(map(jnp.asarray, carry))
        outs, carries, total = [], [], 0.0
        for t in range(T):
            out, c = jax.vmap(lambda o, a, cc: jax_step(kind, jmod, p, o, a, cc, jextra))(
                obs[t], act[t], c)
            total = total + sum((x * w).sum() for x, w in zip(out, weights[t]))
            outs.append(out)
            carries.append(c)
        return total, (outs, carries)

    (_, (jouts, jcarries)), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)

    tmod.load_state_dict(params_from_flax(tmod, params))
    c = None if carry is None else tuple(torch.from_numpy(x) for x in carry)
    touts, tcarries, total = [], [], 0.0
    for t in range(T):
        out, c = torch_step(kind, tmod, torch.from_numpy(obs[t]), torch.from_numpy(act[t]),
                            c, textra)
        total = total + sum((x * torch.from_numpy(w)).sum() for x, w in zip(out, weights[t]))
        touts.append(out)
        tcarries.append(c)
    names = [n for n, _ in tmod.named_parameters()]
    tgrad = dict(zip(names, torch.autograd.grad(total, list(tmod.parameters()))))
    return tmod, params, (jouts, jcarries, jgrad), (touts, tcarries, tgrad)


NAMES = list(families(16))


@pytest.mark.parametrize("h", [16, 64])
@pytest.mark.parametrize("name", NAMES)
def test_family_matches_flax(name, h):
    """Outputs and carries over five steps (rtol 1e-5) and the gradient
    of a weighted sum of every output (rtol 1e-4)."""
    tmod, params, (jouts, jcarries, jgrad), (touts, tcarries, tgrad) = run_both(name, h)
    for t in range(T):
        for j, tt in zip(jouts[t], touts[t]):
            np.testing.assert_allclose(tt.detach().numpy(), np.asarray(j), **FWD,
                                       err_msg=f"{name} step {t}")
        if jcarries[t] is not None:
            for j, tt in zip(jcarries[t], tcarries[t]):
                np.testing.assert_allclose(tt.detach().numpy(), np.asarray(j), **FWD,
                                           err_msg=f"{name} carry step {t}")
    want = params_from_flax(tmod, jax.device_get(jgrad))
    assert want.keys() == tgrad.keys()
    for k, g in tgrad.items():
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), **GRAD, err_msg=f"{name} {k}")


@pytest.mark.parametrize("name", NAMES)
def test_flax_round_trip_is_exact(name):
    """params_to_flax(params_from_flax(t)) == t: names, shapes, dtypes and
    values, for flax-initialized trees and for trees after a torch step."""
    kind, jmod, tmod, obs_shape, carry_shape = families(64)[name]
    obs, act, carry, _ = inputs(name, obs_shape, carry_shape, 1)
    extra = (jnp.asarray(ADJ),) if name.startswith("GAT") else ()
    args = {"critic": (obs[0, 0], act[0, 0]), "actor": (obs[0, 0],)}.get(
        kind, (obs[0, 0], None if carry is None else tuple(x[0] for x in carry), *extra))
    tree = jax.device_get(jmod.init(jax.random.PRNGKey(3), *args))
    back = params_to_flax(params_from_flax(tmod, tree))
    flat_t = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_t] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_t, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    # the module's own state_dict survives the reverse trip unchanged
    tnets.init_flax_(tmod, torch.Generator().manual_seed(0))
    sd = tmod.state_dict()
    again = params_from_flax(tmod, params_to_flax(tmod))
    assert all(torch.equal(sd[k], again[k]) for k in sd)


def test_layouts_pinned():
    """The traps of the flax -> torch mapping, pinned one by one."""
    # SACCritic names its Dense layers in construction order: Dense_0 is
    # q1's head, Dense_1 its hidden layer; the shipped checkpoint agrees
    ckpt = pickle.load(open(ROOT / "artifacts/zoo/sac_agents_45_intersections/gate_24.pkl",
                            "rb"))
    critic = ckpt["critic"]["params"]
    assert critic["Dense_0"]["kernel"].shape == (64, 1)
    assert critic["Dense_1"]["kernel"].shape == (68, 64)
    tcritic = tnets.SACCritic(16, 4, 4, 64)
    tcritic.load_state_dict(params_from_flax(tcritic, ckpt["critic"]))
    assert tcritic.Dense_0.weight.shape == (1, 64) and tcritic.Dense_1.weight.shape == (64, 68)
    # StackedEncoder flattens time-major [K, 32]: the shipped Dense_0 is
    # (4 * 32, 64), and moving one frame moves 32 contiguous inputs
    assert critic["StackedEncoder_0"]["Dense_0"]["kernel"].shape == (128, 64)
    enc = tnets.init_flax_(tnets.StackedEncoder(2, 4, 8), torch.Generator().manual_seed(2))
    x = torch.randn(3, 4, 2, generator=torch.Generator().manual_seed(3))
    conv = torch.nn.functional.conv1d(x.transpose(1, 2), enc.Conv_0.weight, enc.Conv_0.bias,
                                      padding=1)  # [B, 32, K]
    np.testing.assert_allclose(tnets._conv_same(x, enc.Conv_0).detach().numpy(),
                               conv.transpose(1, 2).detach().numpy(), **FWD)
    # LayerNorm: epsilon 1e-6 (torch's default is 1e-5) and the fast
    # variance, against flax on rows whose variance is near epsilon
    rng = np.random.default_rng(0)
    rows = (1e-3 * rng.normal(size=(5, 64))).astype(np.float32)
    flax_ln = jax.device_get(jnets.nn.LayerNorm().apply(
        {"params": {"scale": np.ones(64, np.float32), "bias": np.zeros(64, np.float32)}},
        rows))
    ln = tnets.LayerNorm(64)
    assert ln.epsilon == 1e-6
    np.testing.assert_allclose(ln(torch.from_numpy(rows)).detach().numpy(), flax_ln, **FWD)
    # the LSTM carry is flax's (c, h): its second member is the output
    cell = tnets.init_flax_(tnets.OptimizedLSTMCell(3, 5), torch.Generator().manual_seed(1))
    (c, h), out = cell(tnets.zero_carry((2,), 5), torch.ones(2, 3))
    assert torch.equal(h, out) and not torch.equal(c, out)


def test_flax_initializer_statistics():
    """init_flax_ draws flax's distributions: truncated LeCun normal
    kernels of variance 1/fan_in, orthogonal recurrent blocks, zero
    biases, log_std at -0.5."""
    gen = torch.Generator().manual_seed(0)
    pol = tnets.init_flax_(tnets.AttentionPolicy(4, 4, 64), gen)
    lstm = pol.AttentionTorso_0.OptimizedLSTMCell_0
    for gate in range(4):
        w = lstm.weight_hh[gate * 64:(gate + 1) * 64]
        np.testing.assert_allclose((w @ w.T).detach().numpy(), np.eye(64), atol=1e-5)
    q = pol.AttentionTorso_0.MultiHeadDotProductAttention_0.query.kernel.detach()
    assert abs(float(q.var()) - 1 / 64) < 0.2 / 64
    assert float(q.abs().max()) <= 2 * (1 / 64) ** 0.5 / 0.87962566103423978 + 1e-6
    assert float(pol.Dense_0.bias.abs().max()) == 0.0
    assert torch.equal(pol.log_std.detach(), torch.full((4,), -0.5))
