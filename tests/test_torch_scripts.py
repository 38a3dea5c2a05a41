"""The port's command-line drivers (``pednstream_tpu_torch.scripts``) on the
CPU against the JAX scripts: the zoo pipeline's tables, its checkpoint
export (the same parameters exported by both give the same files and
pickle structure, and each package loads and acts on the other's), its
validation and evaluation against the JAX ones, the no-regress gate, a
``--mesh`` run over two gloo ranks, ``train_butterfly_demo`` and
``reeval_sac``; nothing is written under ``artifacts/``.

The JAX scripts are imported as tests/test_zoo_mesh.py imports them, with
their ``ART`` pointed at ``tmp_path`` where they would write."""

import json
import os
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

import pednstream_tpu.env as jax_env_pkg
import pednstream_tpu_torch.env as port_env_pkg
from pednstream_tpu.rl.rl_utils import load_all_agents as jax_load_all
from pednstream_tpu.rl.train import build_agents as jax_build_agents
from pednstream_tpu_torch.interop import params_from_flax
from pednstream_tpu_torch.rl.rl_utils import load_all_agents
from pednstream_tpu_torch.rl.train import build_agents
from pednstream_tpu_torch.scripts import reeval_sac, train_butterfly_demo
from pednstream_tpu_torch.scripts import train_zoo as tz

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import train_zoo as jtz  # noqa: E402  (the JAX script)

torch.set_num_threads(1)

DATASET, GAP = "butterfly_scC", 15
SHIPPED = ROOT / "artifacts" / "zoo" / "ppo_agents_butterfly_scC"


def artifacts_listing() -> dict:
    return {str(p.relative_to(ROOT)): (p.stat().st_size, p.stat().st_mtime_ns)
            for p in sorted((ROOT / "artifacts").rglob("*")) if p.is_file()}


# taken when the module is imported, compared by the module's last test
BEFORE = artifacts_listing()


@pytest.fixture(autouse=True)
def float32_jax():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def test_tables_match_jax():
    assert tz.DATASETS == jtz.DATASETS
    assert tz.OD_RANDOMIZE == jtz.OD_RANDOMIZE
    assert tz.ACTION_SCALE == jtz.ACTION_SCALE
    assert tz.GLOBAL_REWARD_COEF == jtz.GLOBAL_REWARD_COEF
    widths = [np.array([2.0, 3.5, 1.0]), np.array([4.25])]
    for name, gw in [(DATASET, widths), ("metered_corridor", widths[:1]), ("long_corridor", [])]:
        assert tz._max_delta(name, gw) == jtz._max_delta(name, gw)
    assert reeval_sac.AFFECTED == ["45_intersections", "butterfly_scB", "butterfly_scC",
                                   "one_intersection_v0", "small_network",
                                   "two_coordinators"]  # scripts/reeval_sac.py:31-32


def trainers(dataset):
    """The zoo's PPO trainer in both packages on the same seeded env
    (scripts/train_zoo.py:112-140 at tiny sizes), the port's parameters
    carried over from the JAX trainer's initial ones."""
    from pednstream_tpu.rl.batched_ppo import BatchedPPOTrainer as JaxTrainer
    from pednstream_tpu_torch.rl.batched_ppo import BatchedPPOTrainer

    kw = dict(obs_mode="option2", seed=0, action_gap=tz.DATASETS[dataset][0],
              history_window=64)
    jenv = jax_env_pkg.PedNetParallelEnv(dataset, **kw)
    tenv = port_env_pkg.PedNetParallelEnv(dataset, device="cpu", **kw)
    md = tz._max_delta(dataset, tenv.spec_agents.gate_link_widths)
    tkw = dict(num_envs=8, rollout_len=2, gate_anchor="open", max_delta=md,
               net_type="attention", randomize=True, lr=1e-4, epochs=4, minibatches=4,
               kl_target=0.02, reward_scale=1e-4)
    jtr, ttr = JaxTrainer(jenv.core, **tkw), BatchedPPOTrainer(tenv.core, **tkw)
    jts, tts = jtr.init(jax.random.PRNGKey(0)), ttr.init(0)
    for aid in ttr.agents:
        for mine, theirs in ((tts.params, jts.params), (tts.value_params, jts.value_params)):
            tree = jax.device_get(theirs[aid])
            mine[aid].load_state_dict(params_from_flax(mine[aid], tree))
    return (jenv, jtr, jts), (tenv, ttr, tts)


@pytest.fixture(scope="module", params=[DATASET, "long_corridor"])
def exports(request, tmp_path_factory):
    """The same parameters exported by both ``_export_ppo``s: butterfly_scC's
    gate, and long_corridor's one separator (the trainer's pseudo-agent,
    exported under its ``sep_u_v`` id, scripts/train_zoo.py:260-267)."""
    dataset = request.param
    (jenv, jtr, jts), (tenv, ttr, tts) = trainers(dataset)
    root = tmp_path_factory.mktemp("exports")
    curve = [{"iteration": 0, "reward": -1.0, "wall_s": 0.5}]
    extra = {"seeds_trained": 1, "selected_seed": 0, "selected_checkpoint": "final",
             "seed_validation": {}}
    args = ("attention", 3, dataset, 8, 2, tz.DATASETS[dataset][0], 12.3, curve)
    jtz._export_ppo(str(root / "jax"), jtr, jts, jenv, *args, extra=extra)
    tz._export_ppo(str(root / "port"), ttr, tts, tenv, *args, extra=extra)
    return root / "jax", root / "port", jenv, tenv


def structure(node):
    """Keys, shapes and dtypes of a pickled checkpoint, values dropped."""
    if isinstance(node, dict):
        return {k: structure(v) for k, v in node.items()}
    if isinstance(node, (np.ndarray, jax.Array)):
        return ("array", tuple(node.shape), str(node.dtype))
    return node


def test_export_matches_jax_layout(exports):
    jdir, tdir, _, tenv = exports
    shipped = ROOT / "artifacts" / "zoo" / f"ppo_agents_{tenv.dataset}"
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir)) == \
        sorted(os.listdir(shipped))  # config.json, curve.json, gate_2.pkl or sep_2_3.pkl
    for name in os.listdir(jdir):
        if name.endswith(".pkl"):
            want = pickle.load(open(jdir / name, "rb"))
            got = pickle.load(open(tdir / name, "rb"))
            assert structure(got) == structure(want)
            assert got["config"] == want["config"]
            for a, b in zip(jax.tree_util.tree_leaves(got["actor"]),
                            jax.tree_util.tree_leaves(want["actor"])):
                np.testing.assert_array_equal(a, np.asarray(b))
        else:
            assert json.loads((tdir / name).read_text()) == json.loads((jdir / name).read_text())


def greedy_actions(agents, obs_seq):
    out = []
    for a in agents.values():
        a.reset_hidden()
    for obs in obs_seq:
        out.append({aid: a.absolute_action(obs[aid], a.take_action(obs[aid], explore=False))
                    for aid, a in agents.items()})
    return out


@pytest.mark.parametrize("direction", ["port export in JAX", "JAX export in the port"])
def test_checkpoints_load_across_packages(exports, direction):
    """Each package's ``build_agents`` + ``load_all_agents`` on the other's
    export acts greedily as the exporting package's own load does, rtol
    1e-5, over three successive observations (the recurrent carry
    advancing)."""
    jdir, tdir, jenv, tenv = exports
    src = tdir if direction.startswith("port") else jdir
    rng = np.random.default_rng(4)
    aids = tenv.spec_agents.agent_ids
    obs_seq = [{aid: rng.uniform(0, 4, tenv.observation_space(aid).shape).astype(np.float32)
                for aid in aids} for _ in range(3)]
    jax_agents = jax_load_all(jax_build_agents(jenv, algo="ppo"), str(src))
    port_agents = load_all_agents(build_agents(tenv, algo="ppo", device="cpu"), str(src))
    for want, got in zip(greedy_actions(jax_agents, obs_seq),
                         greedy_actions(port_agents, obs_seq)):
        for aid in aids:
            np.testing.assert_allclose(got[aid], np.asarray(want[aid]), rtol=1e-5, atol=1e-6)


def deterministic(env_cls, **fixed):
    def make(*args, **kw):
        kw.update(stochastic=False, **fixed)
        return env_cls(*args, **kw)
    return make


def test_validate_ppo_dir_matches_jax(monkeypatch):
    """The shipped butterfly_scC policy through both ``_validate_ppo_dir``s
    on deterministic envs: the nominal and the randomized episode's totals
    within rtol 1e-7.  The windowed (H = 64) engine states agree bit for
    bit (ROADMAP.md §3; test_torch_evaluate.py holds a full-horizon
    episode's metrics to 1e-6): both totals measured equal."""
    monkeypatch.setattr(port_env_pkg, "PedNetParallelEnv",
                        deterministic(port_env_pkg.PedNetParallelEnv))
    monkeypatch.setattr(jax_env_pkg, "PedNetParallelEnv",
                        deterministic(jax_env_pkg.PedNetParallelEnv))
    got, got_parts = tz._validate_ppo_dir(DATASET, GAP, str(SHIPPED), device="cpu")
    want, want_parts = jtz._validate_ppo_dir(DATASET, GAP, str(SHIPPED))
    assert got_parts.keys() == want_parts.keys() == {"nominal", "randomized"}
    for k in want_parts:
        np.testing.assert_allclose(got_parts[k], want_parts[k], rtol=1e-7, err_msg=k)
    np.testing.assert_allclose(got, want, rtol=1e-7)


def test_evaluate_zoo_layout_matches_jax(tmp_path, monkeypatch):
    """``evaluate_zoo`` at one run: the same policies, row keys and files,
    and the results table laid out as the JAX one's (same header, same
    policy column)."""
    monkeypatch.setattr(jtz, "ART", str(tmp_path / "jax_art" / "zoo"))
    monkeypatch.chdir(tmp_path)  # the JAX script's runs go to ./outputs/eval_<dataset>
    want = jtz.evaluate_zoo(DATASET, GAP, str(SHIPPED), num_runs=1)
    got = tz.evaluate_zoo(DATASET, GAP, str(SHIPPED), num_runs=1, out=str(tmp_path / "port"),
                          device="cpu")
    assert list(got) == list(want) == ["ppo", "rule_based", "no_control"]
    for algo in want:
        assert [sorted(r) for r in got[algo]] == [sorted(r) for r in want[algo]]
    stored = json.loads((tmp_path / "port" / "eval" / DATASET / "results.json").read_text())
    assert list(stored) == list(want)
    jtable = (tmp_path / "outputs" / f"eval_{DATASET}" / "table.txt").read_text().splitlines()
    ttable = (tmp_path / "port" / f"eval_{DATASET}" / "table.txt").read_text().splitlines()
    assert ttable[0] == jtable[0]
    assert [ln[:16] for ln in ttable] == [ln[:16] for ln in jtable]
    assert sorted(os.listdir(tmp_path / "port" / f"eval_{DATASET}")) == \
        sorted(os.listdir(tmp_path / "outputs" / f"eval_{DATASET}"))


@pytest.mark.parametrize("candidate_wins", [False, True])
def test_no_regress_gate(tmp_path, monkeypatch, candidate_wins):
    """A one-iteration PPO run meets the shipped checkpoint at the gate
    (scores fixed here): a worse candidate is kept as ``.candidate`` under
    ``--out`` and the shipped directory is returned; a better one becomes
    the checkpoint under ``--out``.  The shipped zoo is only read."""
    def score(dataset, gap, ckpt_dir, **kw):
        mine = str(ckpt_dir) != str(SHIPPED)
        return (1.0 if mine == candidate_wins else -1.0), {}

    monkeypatch.setattr(tz, "_validate_ppo_dir", score)
    got = tz.train_ppo(DATASET, GAP, 1, num_envs=8, rollout_len=2, out=str(tmp_path),
                       device="cpu")
    mine = tmp_path / "zoo" / f"ppo_agents_{DATASET}"
    if candidate_wins:
        assert Path(got) == mine
        assert sorted(os.listdir(mine)) == sorted(os.listdir(SHIPPED))
        assert not (tmp_path / "zoo" / f"ppo_agents_{DATASET}.candidate").exists()
    else:
        assert Path(got) == SHIPPED and not mine.exists()
        keep = tmp_path / "zoo" / f"ppo_agents_{DATASET}.candidate"
        assert sorted(os.listdir(keep)) == sorted(os.listdir(SHIPPED))


def test_mesh_ppo_exports_a_loadable_checkpoint(tmp_path, capsys):
    """``train_ppo(use_mesh=True)`` over two gloo ranks: the ranks train
    together, rank 0 exports and gates, and what it leaves under ``--out``
    loads through ``build_agents`` + ``load_all_agents``."""
    out = tz.train_ppo(DATASET, GAP, 1, num_envs=8, rollout_len=2, use_mesh=True,
                       out=str(tmp_path), device="cpu")
    assert "training sharded over 2 devices" in capsys.readouterr().out
    left = [p for p in (tmp_path / "zoo").iterdir() if p.name.startswith("ppo_agents_")]
    assert len(left) == 1 and Path(out) in (left[0], SHIPPED)
    env = port_env_pkg.PedNetParallelEnv(DATASET, obs_mode="option2", seed=0, action_gap=GAP,
                                         device="cpu")
    agents = load_all_agents(build_agents(env, algo="ppo", device="cpu"), str(left[0]))
    obs, _ = env.reset()
    act = agents["gate_2"].take_action(obs["gate_2"], explore=False)
    assert np.isfinite(act).all()


def test_butterfly_demo_evaluate_matches_jax(monkeypatch):
    """``train_butterfly_demo.evaluate`` against the JAX script's on a
    deterministic env core (two replicas, three RL steps): gates wide open,
    and a trained-trainer policy carried over from JAX's initial MLP."""
    sys.path.insert(0, str(ROOT / "scripts"))
    import train_butterfly_demo as jdemo
    from pednstream_tpu.rl.batched_ppo import BatchedPPOTrainer as JaxTrainer
    from pednstream_tpu_torch.rl.batched_ppo import BatchedPPOTrainer

    kw = dict(obs_mode="option2", seed=0, action_gap=5, history_window=64, stochastic=False)
    jenv = jax_env_pkg.PedNetParallelEnv(DATASET, **kw)
    tenv = port_env_pkg.PedNetParallelEnv(DATASET, device="cpu", **kw)
    jtr = JaxTrainer(jenv.core, num_envs=8, rollout_len=2)
    jts = jtr.init(jax.random.PRNGKey(0))
    ttr = BatchedPPOTrainer(tenv.core, num_envs=8, rollout_len=2)
    policy = ttr.init(0).params["gate_2"]
    policy.load_state_dict(params_from_flax(policy, jax.device_get(jts.params["gate_2"])))
    small = dict(B=2, steps=3)
    np.testing.assert_allclose(
        train_butterfly_demo.evaluate(tenv.core, tenv.spec_agents, **small),
        jdemo.evaluate(jenv.core, jenv.spec_agents, **small), rtol=1e-6)
    np.testing.assert_allclose(
        train_butterfly_demo.evaluate(tenv.core, tenv.spec_agents, policy, **small),
        jdemo.evaluate(jenv.core, jenv.spec_agents, jtr._policy("gate_2"),
                       jts.params["gate_2"], **small), rtol=1e-6)


def test_butterfly_demo_writes_its_two_files(tmp_path, monkeypatch):
    """``main`` (trainer cut to 8 replicas x 2 RL steps, evaluation to 2 x
    3) writes butterfly_ppo.pkl and butterfly_ppo_training.json under
    ``--out`` with the JAX script's keys (scripts/train_butterfly_demo.py:
    63-88)."""
    from pednstream_tpu_torch.rl import batched_ppo

    real_trainer, real_eval = batched_ppo.BatchedPPOTrainer, train_butterfly_demo.evaluate
    monkeypatch.setattr(batched_ppo, "BatchedPPOTrainer",
                        lambda core, **kw: real_trainer(core, **{**kw, "num_envs": 8,
                                                                 "rollout_len": 2}))
    monkeypatch.setattr(train_butterfly_demo, "evaluate",
                        lambda *a, **kw: real_eval(*a, B=2, steps=3))
    train_butterfly_demo.main(2, out=str(tmp_path), device="cpu")
    assert sorted(os.listdir(tmp_path)) == ["butterfly_ppo.pkl", "butterfly_ppo_training.json"]
    saved = pickle.load(open(tmp_path / "butterfly_ppo.pkl", "rb"))
    assert sorted(saved) == ["config", "params", "value_params"]
    assert saved["config"]["iterations"] == 2
    summary = json.loads((tmp_path / "butterfly_ppo_training.json").read_text())
    assert sorted(summary) == ["curve", "summary"] and len(summary["curve"]) == 2
    assert sorted(summary["summary"]) == sorted([
        "iterations", "train_time_s", "engine_steps_per_s", "reward_curve_first5",
        "reward_curve_last5", "eval_mean_cum_reward_trained",
        "eval_mean_cum_reward_no_control"])


def test_reeval_sac_replaces_the_sac_rows(tmp_path):
    """``reeval`` re-runs the sac rows (three paired runs of the shipped
    checkpoint) into the stored results.json under ``--out`` and keeps the
    other rows."""
    res = tmp_path / f"eval_{DATASET}" / "results.json"
    res.parent.mkdir(parents=True)
    res.write_text(json.dumps({"ppo": [{"run": 0, "total_reward": -1.0}],
                               "sac": [{"run": 0, "total_reward": -2.0}]}))
    reeval_sac.reeval(DATASET, out=str(tmp_path), device="cpu")
    got = json.loads(res.read_text())
    assert got["ppo"] == [{"run": 0, "total_reward": -1.0}]
    assert [r["run"] for r in got["sac"]] == [0, 1, 2]
    assert all(np.isfinite(r["total_reward"]) and "delay.total_delay" in r for r in got["sac"])


def test_cli_accepts_every_jax_flag(tmp_path, monkeypatch):
    """Every flag of the JAX script's ``main`` (scripts/train_zoo.py:575-
    608) parses and reaches ``run``."""
    seen = {}
    monkeypatch.setattr(tz, "run", lambda name, **kw: seen.setdefault(name, kw))
    tz.main(["--dataset", "butterfly_scA", "--skip-sac", "--skip-ppo", "--skip-eval",
             "--with-mpc", "--ppo-iters", "3", "--sac-episodes", "4", "--sac-batched",
             "--sac-iters", "5", "--eval-only", "--mesh", "--out", str(tmp_path),
             "--device", "cpu"])
    assert seen == {"butterfly_scA": dict(
        skip_sac=True, skip_eval=True, with_mpc=True, ppo_iters=3, sac_eps=4, eval_only=True,
        use_mesh=True, sac_batched=True, sac_iters=5, skip_ppo=True, out=str(tmp_path),
        device="cpu")}
    seen.clear()
    tz.main(["--all"])
    assert list(seen) == list(jtz.DATASETS)


def test_artifacts_unchanged():
    """Nothing this module ran wrote under ``artifacts/`` (sizes and mtimes
    of every file as at import)."""
    assert artifacts_listing() == BEFORE


@pytest.mark.parametrize("entry", ["train_zoo", "train_butterfly_demo", "reeval_sac",
                                   "sweep_melbourne", "sweep_grid", "quantify_window",
                                   "reset_determinism_report", "retrain_r3",
                                   "ablate_global_reward"])
def test_scripts_run_on_the_card_unless_asked(entry, monkeypatch, tmp_path):
    """With no ``--device`` every driver asks for the card: where torch sees
    none it raises instead of running on the CPU."""
    from pednstream_tpu_torch.scripts import (ablate_global_reward, quantify_window,
                                              reset_determinism_report, retrain_r3,
                                              sweep_grid, sweep_melbourne)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = ["--out", str(tmp_path)]
    calls = {"train_zoo": lambda: tz.main(["--dataset", DATASET, "--out", str(tmp_path)]),
             "train_butterfly_demo": lambda: train_butterfly_demo.main(1, out=str(tmp_path)),
             "reeval_sac": lambda: reeval_sac.reeval(DATASET, out=str(tmp_path)),
             "sweep_melbourne": lambda: sweep_melbourne.main([]),
             "sweep_grid": lambda: sweep_grid.main([]),
             "quantify_window": lambda: quantify_window.main([]),
             "reset_determinism_report": lambda: reset_determinism_report.main(out),
             "retrain_r3": lambda: retrain_r3.main(["--phase", "eval", *out]),
             "ablate_global_reward": lambda: ablate_global_reward.main(out)}
    if entry == "reeval_sac":
        res = tmp_path / f"eval_{DATASET}" / "results.json"
        res.parent.mkdir(parents=True)
        res.write_text("{}")
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        calls[entry]()
