"""The port's float64 exact-parity anchor against the golden fixtures.

tests/golden/*.npz were made by running the original PedNStream code in
deterministic mode (tests/test_golden_parity.py holds the JAX package to
them).  The port builds each scenario with ``ftype=torch.float64,
exact_parity=True`` and must reproduce every recorded field within 1e-5
(the JAX package reaches them bit for bit, and so does the port on the
CPU).  The fixtures need no JAX; one test also holds a single mid-run exact
step to the JAX exact path, bit for bit.
"""

import copy
import os
from functools import partial

import numpy as np
import pytest
import torch

import jax

from pednstream_tpu import engine as jax_engine
from pednstream_tpu.scenario import build_scenario as jax_build
from pednstream_tpu_torch import golden, interop, scenario
from pednstream_tpu_torch.engine import step_fn
from pednstream_tpu_torch.golden import FIELDS, TOL, fixture_args
from pednstream_tpu_torch.interop import numpy_leaves

torch.set_num_threads(1)

# the port runs on the card unless asked: every CPU test asks
build_scenario = partial(scenario.build_scenario, device="cpu")
golden_errors = partial(golden.golden_errors, device="cpu")
engine_params_from_jax = partial(interop.engine_params_from_jax, device="cpu")
network_state_from_jax = partial(interop.network_state_from_jax, device="cpu")

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
REALWORLD = ("delft", "melbourne")
SMALL = sorted(f[:-4] for f in os.listdir(GOLDEN_DIR)
               if f.endswith(".npz") and f[:-4] not in REALWORLD)


def fixture(name):
    return os.path.join(GOLDEN_DIR, f"{name}.npz")


@pytest.fixture
def x64_on():
    """float64 JAX arrays for one test, restored afterwards (the session
    ``x64`` fixture would leave them on for every later test file in the
    worker)."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", prev)


@pytest.mark.parametrize("name", SMALL)
def test_golden_parity(name):
    errors, _, _ = golden_errors(fixture(name))
    assert len(errors) == len(FIELDS)
    bad = {k: v for k, v in errors.items() if not v <= TOL}
    assert not bad, f"{name}: max abs err per field {bad}"


@pytest.mark.slow
@pytest.mark.parametrize("name", REALWORLD)
def test_golden_parity_realworld(name):
    errors, _, _ = golden_errors(fixture(name))
    assert len(errors) == len(FIELDS)
    bad = {k: v for k, v in errors.items() if not v <= TOL}
    assert not bad, f"{name}: max abs err per field {bad}"


def test_exact_step_matches_jax(x64_on):
    """grid10 (routed turning fractions, two destinations): 60 exact JAX
    steps, then one step of each engine from that state, bit for bit.
    The JAX step takes EngineParams as a jit argument (closed over as
    constants, XLA reassociates the parameter arithmetic)."""
    args, _, _ = fixture_args(fixture("grid10"))
    js = jax_build(**copy.deepcopy(args), ftype=jax.numpy.float64, exact_parity=True)
    ts = build_scenario(**copy.deepcopy(args), ftype=torch.float64, exact_parity=True)
    step = jax.jit(lambda ep, st: jax_engine.step_fn(js, ep, st, stochastic=False))
    st = js.init_state(jax.random.PRNGKey(0))
    for _ in range(60):
        st, _ = step(js.engine_params, st)
    want_st, want = step(js.engine_params, st)
    got_st, got = step_fn(ts, engine_params_from_jax(numpy_leaves(js.engine_params)),
                          network_state_from_jax(numpy_leaves(st)))
    assert got_st.t == int(want_st.t) == 62
    assert float(np.asarray(want.inflow).sum()) > 0
    for name, b in numpy_leaves(want).items():
        a = getattr(got, name)[0].numpy()
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for name, b in numpy_leaves(want_st, skip=("key", "t")).items():
        np.testing.assert_array_equal(getattr(got_st, name)[0].numpy(), b, err_msg=name)
