"""Every shipped zoo checkpoint (artifacts/zoo/*_agents_*) in the port:
built from its pickle's config with no env, loaded, and acting
deterministically on three successive seeded observations (normalized
through the shipped norm_stats.json where there is one) exactly as the
JAX package's agent does, rtol 1e-5, with the recurrent carries and frame
stacks advancing.  One ``slow`` case per checkpoint mirrors
tests/test_zoo_artifacts.py through the port's build_agents and env."""

import json
import pickle
from functools import partial
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax

from pednstream_tpu.rl.ppo import PPOAgent as JaxPPOAgent
from pednstream_tpu.rl.rl_utils import RunningNormalizeWrapper as JaxWrapper
from pednstream_tpu.rl.sac import SACAgent as JaxSACAgent
from pednstream_tpu_torch.rl import ppo, sac
from pednstream_tpu_torch.rl.rl_utils import RunningNormalizeWrapper

# the port runs on the card unless asked: every CPU test asks
PPOAgent = partial(ppo.PPOAgent, device="cpu")
SACAgent = partial(sac.SACAgent, device="cpu")

torch.set_num_threads(1)

ZOO = Path(__file__).resolve().parents[1] / "artifacts" / "zoo"
DIRS = sorted(d.name for d in ZOO.iterdir() if "_agents_" in d.name
              and not d.name.endswith(".candidate")) if ZOO.is_dir() else []


@pytest.fixture(autouse=True)
def float32_jax():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def test_the_zoo_is_all_there():
    assert len(DIRS) == 19, DIRS


def _agents(path: Path, aid: str, cfg: dict):
    """A port agent and a JAX agent for one checkpoint, from its config,
    with made-up action bounds (the same for both)."""
    A = cfg["act_dim"]
    sep = aid.startswith("sep")
    bounds = dict(action_low=np.full(A, 1.5 if sep else 0.0, np.float32),
                  action_high=np.full(A, 3.5 if sep else 4.0, np.float32))
    if cfg.get("algo") == "sac":
        kw = dict(obs_dim=cfg["obs_dim"], act_dim=A, stack_size=cfg["stack_size"],
                  is_separator=sep, **bounds)
        port, ref = SACAgent(**kw, seed=1), JaxSACAgent(**kw, seed=2)
    else:
        kw = dict(obs_dim=cfg["obs_dim"], act_dim=A, features_per_link=cfg["features_per_link"],
                  net_type=cfg["net_type"], hidden_dim=cfg["hidden_dim"], **bounds)
        port, ref = PPOAgent(**kw, seed=1), JaxPPOAgent(**kw, seed=2)
    for agent in (port, ref):
        agent.load(str(path / f"{aid}.pkl"))
    return port, ref


@pytest.mark.parametrize("dirname", DIRS)
def test_zoo_checkpoint_acts_like_jax(dirname):
    path = ZOO / dirname
    stats = path / "norm_stats.json"
    wrappers = None
    if stats.exists():
        env = SimpleNamespace(obs_mode="option2")
        wrappers = (RunningNormalizeWrapper(env), JaxWrapper(env))
        for w in wrappers:
            w.load_stats(str(stats))
    for pkl in sorted(path.glob("*.pkl")):
        aid = pkl.stem
        cfg = pickle.load(open(pkl, "rb"))["config"]
        port, ref = _agents(path, aid, cfg)
        assert (port.max_delta, port.gate_anchor) == (ref.max_delta, ref.gate_anchor)
        rng = np.random.default_rng(sum(map(ord, dirname)))
        port.reset_hidden()
        ref.reset_hidden()
        acts = []
        for _ in range(3):
            raw = rng.uniform(0.0, 4.0, cfg["obs_dim"]).astype(np.float32)
            o_port = o_ref = raw
            if wrappers is not None:
                o_port = wrappers[0]._norm_obs({aid: raw})[aid]
                o_ref = wrappers[1]._norm_obs({aid: raw})[aid]
                np.testing.assert_array_equal(o_port, o_ref)
            got = port.absolute_action(o_port, port.take_action(o_port, explore=False))
            want = ref.absolute_action(o_ref, ref.take_action(o_ref, explore=False))
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                       err_msg=f"{dirname} {aid}")
            acts.append(got)
        assert all(np.isfinite(a).all() for a in acts)


@pytest.mark.slow
@pytest.mark.parametrize("dirname", DIRS)
def test_zoo_checkpoint_loads_and_acts_in_port_env(dirname):
    """tests/test_zoo_artifacts.py through the port: build_agents +
    load_all_agents on the port's env, finite in-bounds actions."""
    from pednstream_tpu_torch.env import PedNetParallelEnv
    from pednstream_tpu_torch.rl.rl_utils import load_all_agents
    from pednstream_tpu_torch.rl.train import build_agents

    prefix, dataset = dirname.split("_agents_", 1)
    algo = "sac" if prefix == "sac" else "ppo"
    path = ZOO / dirname
    cfg = json.load(open(path / "config.json"))
    assert cfg.get("agents") or cfg.get("net_type"), dirname
    env = PedNetParallelEnv(dataset, obs_mode="option2", action_gap=15, seed=0, device="cpu")
    wrapped = RunningNormalizeWrapper(env)
    agents = build_agents(wrapped, algo=algo, device="cpu")
    if cfg.get("agents"):
        assert set(agents) == set(cfg["agents"]), (dirname, set(agents))
    load_all_agents(agents, str(path), env=wrapped)
    obs, _ = wrapped.reset()
    for aid, agent in agents.items():
        agent.reset_hidden()
        act = agent.absolute_action(obs[aid], agent.take_action(obs[aid], explore=False))
        space = wrapped.action_space(aid)
        assert np.all(np.isfinite(act)), (dirname, aid)
        assert np.all(act >= space.low - 1e-5) and np.all(act <= space.high + 1e-5), (dirname, aid)
