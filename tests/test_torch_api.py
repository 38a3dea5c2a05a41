"""The port's public names that mirror ``pednstream_tpu``'s:
``make_step``, ``validate_config``, ``__version__``, the
``utils.profiling`` module path and ``rl.train.init_train_state``, each
against the JAX package on the same inputs."""

import copy
from functools import partial

import numpy as np
import pytest
import torch

import jax

import pednstream_tpu as jax_pkg
import pednstream_tpu_torch as port
from pednstream_tpu_torch import engine, generator, interop
from pednstream_tpu_torch.interop import numpy_leaves

NetworkEnvGenerator = partial(generator.NetworkEnvGenerator, device="cpu")
torch_build = partial(port.build_scenario, device="cpu")
engine_params_from_jax = partial(interop.engine_params_from_jax, device="cpu")
network_state_from_jax = partial(interop.network_state_from_jax, device="cpu")

torch.set_num_threads(1)

# one step of the same float32 operations in the same order (a few ulps
# for the sums whose order differs)
RTOL = 1e-6


@pytest.fixture(autouse=True)
def float32_jax():
    """Another test file in the same worker may have switched JAX to
    float64 for the session; these comparisons are float32."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def scenario_args(name="butterfly_scC", seed=3):
    args = NetworkEnvGenerator().scenario_args(name)
    args["params"]["seed"] = seed  # the dataset ships unseeded
    return args


def states_equal(a, b):
    assert a.t == b.t
    for name, x in vars(a).items():
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, getattr(b, name)), name


def test_exports():
    assert port.__version__ == jax_pkg.__version__
    for name in ("make_step", "validate_config", "__version__"):
        assert hasattr(port, name)
    assert {"make_step", "validate_config"} <= set(port.__all__)
    assert port.make_step is engine.make_step


def test_make_step_equals_simulate_bitwise():
    scn = torch_build(**scenario_args())
    ep = scn.engine_params
    step = port.make_step(scn, stochastic=False, record=True)
    st, outs = scn.init_state(1), []
    for _ in range(10):
        st, out = step(ep, st)
        outs.append(out)
    want_st, want = port.simulate(scn, ep, scn.init_state(1), 10)
    states_equal(st, want_st)
    for name in port.StepOutputs.__dataclass_fields__:
        assert torch.equal(torch.stack([getattr(o, name) for o in outs]),
                           getattr(want, name)), name
    # record=False (the default) returns no outputs
    _, none = port.make_step(scn)(ep, scn.init_state(1))
    assert none is None


def test_make_step_donate_changes_nothing():
    scn = torch_build(**scenario_args())
    ep = scn.engine_params
    ends = []
    for donate in (False, True):
        step = port.make_step(scn, record=True, donate=donate)
        st = scn.init_state(1)
        for _ in range(10):
            st, out = step(ep, st)
        ends.append((st, out))
    states_equal(ends[0][0], ends[1][0])
    assert torch.equal(ends[0][1].density, ends[1][1].density)


def test_make_step_matches_jax_make_step():
    """30 deterministic steps of the JAX ``make_step`` (EngineParams passed
    as its argument), then one step of each package's from that state."""
    args = scenario_args()
    js = jax_pkg.build_scenario(**copy.deepcopy(args))
    ts = torch_build(**copy.deepcopy(args))
    jstep = jax_pkg.make_step(js, stochastic=False, record=True)
    tstep = port.make_step(ts, stochastic=False, record=True)
    st = js.init_state(jax.random.PRNGKey(0))
    for _ in range(30):
        st, _ = jstep(js.engine_params, st)
    ep = engine_params_from_jax(numpy_leaves(js.engine_params))
    tst = network_state_from_jax(numpy_leaves(st))
    want_st, want = jstep(js.engine_params, st)
    got_st, got = tstep(ep, tst)
    assert got_st.t == int(want_st.t) == 32
    assert float(got.num_peds.sum()) > 0
    for name, b in numpy_leaves(want).items():
        np.testing.assert_allclose(getattr(got, name)[0].numpy(), b, rtol=RTOL, atol=0,
                                   err_msg=name)
    for name, b in numpy_leaves(want_st, skip=("key", "t")).items():
        np.testing.assert_allclose(getattr(got_st, name)[0].numpy(), b, rtol=RTOL, atol=0,
                                   err_msg=name)


def test_make_step_stochastic_needs_a_generator():
    scn = torch_build(**scenario_args())
    with pytest.raises(ValueError, match="torch.Generator"):
        port.make_step(scn, stochastic=True)(scn.engine_params, scn.init_state(1))
    # with one it steps, and two generators from one seed agree bit for bit
    ends = []
    for _ in range(2):
        step = port.make_step(scn, stochastic=True, gen=torch.Generator().manual_seed(5))
        st = scn.init_state(1)
        for _ in range(10):
            st, _ = step(scn.engine_params, st)
        ends.append(st)
    states_equal(*ends)


GOOD = {
    "network": {"origin_nodes": [0]},
    "simulation": {"simulation_steps": 10, "unit_time": 10},
    "default_link": {"length": 50, "width": 3, "free_flow_speed": 1.1,
                     "k_critical": 2, "k_jam": 6},
}


def _without(section, field=None):
    cfg = copy.deepcopy(GOOD)
    if field is None:
        del cfg[section]
    else:
        del cfg[section][field]
    return cfg


@pytest.mark.parametrize("cfg", [_without("simulation"), _without("network", "origin_nodes"),
                                 _without("default_link", "k_jam")],
                         ids=["no section", "no origin_nodes", "no k_jam"])
def test_validate_config_raises_the_jax_messages(cfg):
    with pytest.raises(ValueError) as want:
        jax_pkg.validate_config(cfg)
    with pytest.raises(ValueError) as got:
        port.validate_config(cfg)
    assert str(got.value) == str(want.value)


def test_validate_config_accepts_a_good_config():
    assert port.validate_config(GOOD) is None
    assert jax_pkg.validate_config(GOOD) is None


def test_utils_profiling_module_path():
    import pednstream_tpu_torch.utils.profiling as up
    from pednstream_tpu_torch import profiling

    assert up.trace_profile is profiling.trace_profile


def test_init_train_state_matches_jax():
    from pednstream_tpu.env import PedNetParallelEnv as JaxEnv
    from pednstream_tpu.rl.train import init_train_state as jax_init
    from pednstream_tpu_torch.env import PedNetParallelEnv
    from pednstream_tpu_torch.rl.optim import AdamState, adam_update
    from pednstream_tpu_torch.rl.train import init_train_state

    jenv = JaxEnv("butterfly_scC", obs_mode="option2", seed=0)
    tenv = PedNetParallelEnv("butterfly_scC", obs_mode="option2", seed=0, device="cpu")
    want = jax_init(jenv.core, jax.random.PRNGKey(1))
    got = init_train_state(tenv.core, seed=1, device="cpu")
    assert set(got) == set(want)
    assert got["act_dim"] == want["act_dim"]
    assert got["agent_id"] == want["agent_id"]
    want_shapes = jax.tree_util.tree_map(lambda x: (x.shape, str(x.dtype)), want["params"])
    got_shapes = jax.tree_util.tree_map(lambda x: (x.shape, str(x.dtype)),
                                        interop.params_to_flax(got["policy"]))
    assert got_shapes == dict(want_shapes)
    # the same seed gives the same weights, another seed others
    again = init_train_state(tenv.core, seed=1, device="cpu")
    other = init_train_state(tenv.core, seed=2, device="cpu")
    def flat(state):
        return torch.cat([p.detach().reshape(-1) for p in state["params"]])

    assert torch.equal(flat(got), flat(again))
    assert not torch.equal(flat(got), flat(other))
    # an Adam state at optax.adam(3e-4) that rl.optim steps
    assert isinstance(got["opt_state"], AdamState) and got["tx"]["lr"] == 3e-4
    before = got["params"][0].detach().clone()
    adam_update(got["params"], [torch.ones_like(p) for p in got["params"]],
                got["opt_state"], got["tx"]["lr"])
    np.testing.assert_allclose((before - got["params"][0].detach()).numpy(), 3e-4, rtol=1e-4)
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA"):
            init_train_state(tenv.core, seed=1)
