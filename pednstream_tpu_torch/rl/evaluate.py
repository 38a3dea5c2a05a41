"""Evaluation harness + CLI (the counterpart of
``pednstream_tpu/rl/evaluate.py``; reference rl/evaluate_and_visualize.py
and rl_utils.evaluate_agents :1513-1747).

``evaluate_agents`` rolls multiple policies (trained RL, rule-based,
MPC-optimization, no-control) over N randomized runs, saves each run in
the reference output format, and tabulates the offline metrics.  The env
and the learned policies run on ``device`` (the card unless asked
otherwise); a run's recorded history stays there until it is saved.

CLI:
    python -m pednstream_tpu_torch.rl.evaluate --dataset butterfly_scC \
        --run-test --algos rule_based no_control --num-runs 2
    python -m pednstream_tpu_torch.rl.evaluate --evaluate --output-dir outputs/eval
    python -m pednstream_tpu_torch.rl.evaluate --visualize outputs/eval/rule_based_run0
"""

import argparse
import json
import os
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from ..device import DEFAULT
from .metrics import evaluate_run
from .rl_utils import load_all_agents
from .train import build_agents


def rollout_and_save(env, agents: Dict, save_dir: str, randomize: bool = False,
                     deterministic: bool = True, bind_state: bool = False) -> float:
    """One full episode; returns total true reward and saves the run."""
    obs, _ = env.reset(options={"randomize": randomize})
    for a in agents.values():
        if hasattr(a, "reset_hidden"):
            a.reset_hidden()
    total = 0.0
    done = False
    while not done:
        actions = {}
        for aid, agent in agents.items():
            if bind_state and hasattr(agent, "bind_state"):
                agent.bind_state(env._state)
            delta = agent.take_action(obs[aid], explore=not deterministic)
            actions[aid] = agent.absolute_action(obs[aid], delta) \
                if hasattr(agent, "absolute_action") else delta
        obs, rewards, terms, truncs, infos = env.step(actions)
        total += sum(infos[a].get("true_reward", rewards.get(a, 0.0)) for a in rewards)
        done = any(terms.values()) or any(truncs.values())
    env.save(Path(save_dir).name, base_dir=str(Path(save_dir).parent))
    return total


def evaluate_agents(
    dataset: str,
    algos: List[str],
    num_runs: int = 3,
    output_dir: str = "outputs/eval",
    obs_mode: str = "option2",
    action_gap: int = 1,
    checkpoint_dirs: Optional[Dict[str, str]] = None,
    randomize: bool = True,
    seed: int = 0,
    device=DEFAULT,
) -> Dict[str, List[dict]]:
    """Multi-run, multi-policy comparison (rl_utils.py:1618-1747)."""
    from ..env import PedNetParallelEnv

    results: Dict[str, List[dict]] = {}
    for algo in algos:
        results[algo] = []
        for run in range(num_runs):
            env = PedNetParallelEnv(
                dataset, obs_mode=obs_mode, seed=seed + run,
                action_gap=action_gap, record_history=True, device=device,
            )
            if algo == "optimization":
                from .optimization_based import DecentralizedOptimizationAgent

                agents = {
                    aid: DecentralizedOptimizationAgent(env.scn, env.spec_agents, aid)
                    for aid in env.spec_agents.gate_ids
                }
                bind = True
            else:
                agents = build_agents(env, algo=algo if algo != "best_ppo" else "ppo",
                                      device=device)
                if checkpoint_dirs and algo in checkpoint_dirs:
                    ckpt = checkpoint_dirs[algo]
                    if os.path.exists(os.path.join(ckpt, "norm_stats.json")):
                        # the checkpoint was trained on NORMALIZED
                        # observations (RunningNormalizeWrapper) — evaluate
                        # it behind the same wrapper with the saved stats
                        # frozen, or the policy sees raw features orders of
                        # magnitude outside its training distribution
                        # (the round-2 SAC zoo collapse)
                        from .rl_utils import RunningNormalizeWrapper

                        env = RunningNormalizeWrapper(env)
                        env.freeze()
                        load_all_agents(agents, ckpt, env=env)
                    else:
                        load_all_agents(agents, ckpt)
                bind = False
            run_dir = os.path.join(output_dir, f"{algo}_run{run}")
            reward = rollout_and_save(env, agents, run_dir,
                                      randomize=randomize and run > 0,
                                      bind_state=bind)
            metrics = evaluate_run(run_dir)
            entry = {"run": run, "total_reward": reward, "save_dir": run_dir,
                     **{f"{k}.{kk}": vv for k, m in metrics.items()
                        for kk, vv in m.items() if isinstance(vv, (int, float))}}
            results[algo].append(entry)
    return results


def summarize(results: Dict[str, List[dict]]) -> str:
    lines = []
    keys = ["total_reward", "throughput.throughput", "delay.total_delay",
            "travel_time.avg_travel_time", "served_trips.served_trips_rate",
            "congestion.avg_congestion_density"]
    header = f"{'algo':<16}" + "".join(f"{k.split('.')[-1]:>22}" for k in keys)
    lines.append(header)
    for algo, runs in results.items():
        row = f"{algo:<16}"
        for k in keys:
            vals = [r.get(k) for r in runs if r.get(k) is not None]
            row += f"{np.mean(vals):>22.3f}" if vals else f"{'—':>22}"
        lines.append(row)
    return "\n".join(lines)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--dataset", default="butterfly_scC")
    parser.add_argument("--run-test", action="store_true")
    parser.add_argument("--evaluate", action="store_true")
    parser.add_argument("--visualize", default=None, metavar="RUN_DIR")
    parser.add_argument("--algos", nargs="+",
                        default=["rule_based", "no_control"])
    parser.add_argument("--num-runs", type=int, default=3)
    parser.add_argument("--output-dir", default="outputs/eval")
    parser.add_argument("--obs-mode", default="option2")
    parser.add_argument("--action-gap", type=int, default=1)
    parser.add_argument("--checkpoints", type=json.loads, default=None,
                        help='JSON dict {"ppo": "path"}')
    parser.add_argument("--device", default=DEFAULT,
                        help="where the env and the policies run (cuda or cpu)")
    args = parser.parse_args(argv)

    if args.run_test:
        results = evaluate_agents(
            args.dataset, args.algos, num_runs=args.num_runs,
            output_dir=args.output_dir, obs_mode=args.obs_mode,
            action_gap=args.action_gap, checkpoint_dirs=args.checkpoints,
            device=args.device,
        )
        with open(os.path.join(args.output_dir, "results.json"), "w") as f:
            json.dump(results, f, indent=2)
        print(summarize(results))
    elif args.evaluate:
        results = {}
        for d in sorted(Path(args.output_dir).iterdir()):
            if d.is_dir() and (d / "link_data.json").exists():
                algo = d.name.rsplit("_run", 1)[0]
                metrics = evaluate_run(str(d))
                results.setdefault(algo, []).append(
                    {f"{k}.{kk}": vv for k, m in metrics.items()
                     for kk, vv in m.items() if isinstance(vv, (int, float))}
                )
        print(summarize(results))
    elif args.visualize:
        import matplotlib

        matplotlib.use("Agg")
        from ..viz import NetworkVisualizer
        from matplotlib.animation import PillowWriter

        viz = NetworkVisualizer(simulation_dir=args.visualize)
        ani = viz.animate_network(edge_property="density")
        out = os.path.join(args.visualize, "animation.gif")
        ani.save(out, writer=PillowWriter(fps=10))
        print(f"wrote {out}")
    else:
        parser.print_help()


if __name__ == "__main__":
    main()
