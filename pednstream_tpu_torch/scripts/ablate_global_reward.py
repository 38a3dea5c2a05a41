"""Controlled ablation of the delay-aligned global reward term and the GAE
horizon (the counterpart of ``scripts/ablate_global_reward.py``).

Each candidate trains the batched-PPO configuration the zoo uses
(:func:`~pednstream_tpu_torch.scripts.train_zoo.train_ppo`) on the card
with ``-coef * total in-network count`` added to the TRAINING reward
(``PedNetParallelEnv(global_reward_coef=coef)``; evaluation rewards are
untouched) and the given rollout length, exports it to
``<out>/ablate_<dataset>/<tag>/`` in the JAX package's checkpoint layout,
and is scored under the paired evaluation protocol
(``rl.evaluate.evaluate_agents``) on the true reward and the offline
metrics.  Each candidate prints one ``ABLATE {...}`` line; all of them
go to ``ablation.json``.

Run:  python -m pednstream_tpu_torch.scripts.ablate_global_reward \\
          --dataset metered_corridor --coefs 0.0 0.1 0.3 [--device cpu]
"""

import argparse
import json
import os
import time

from ..device import DEFAULT, resolve
from .train_zoo import DATASETS, OD_RANDOMIZE, _export_ppo, _max_delta, _synchronize


def train_candidate(dataset: str, action_gap: int, iterations: int, coef: float,
                    rollout_len: int, out: str, seed: int = 0, num_envs: int = 256,
                    device=DEFAULT):
    from ..env import PedNetParallelEnv
    from ..rl.batched_ppo import BatchedPPOTrainer

    device = resolve(device)
    env = PedNetParallelEnv(dataset, obs_mode="option2", seed=seed, action_gap=action_gap,
                            history_window=64, od_randomize=dataset in OD_RANDOMIZE,
                            global_reward_coef=coef, device=device)
    md = _max_delta(dataset, env.spec_agents.gate_link_widths)
    tr = BatchedPPOTrainer(env.core, num_envs=num_envs, rollout_len=rollout_len,
                           gate_anchor="open", max_delta=md, net_type="attention",
                           randomize=True, randomize_fraction=1.0, lr=1e-4, epochs=4,
                           minibatches=4, kl_target=0.02, reward_scale=1e-4)
    ts = tr.init(seed)
    curve = []
    t0 = time.time()
    for i in range(iterations):
        t_it = time.time()
        ts, m = tr.train_iteration(ts)
        _synchronize(device)
        rew = float(sum(v for k, v in m.items() if k.endswith("/reward")))
        curve.append({"iteration": i, "reward": rew, "wall_s": round(time.time() - t_it, 3)})
        if i % 20 == 0 or i == iterations - 1:
            print(f"[{dataset} coef={coef} T={rollout_len}] iter {i}: reward {rew:.0f}",
                  flush=True)
    _export_ppo(out, tr, ts, env, "attention", iterations, dataset, num_envs, rollout_len,
                action_gap, time.time() - t0, curve, extra={"global_reward_coef": coef})
    return curve


def eval_candidate(dataset: str, action_gap: int, ckpt: str, out_dir: str,
                   num_runs: int = 3, device=DEFAULT):
    from ..rl.evaluate import evaluate_agents

    res = evaluate_agents(dataset, ["ppo"], num_runs=num_runs, output_dir=out_dir,
                          obs_mode="option2", action_gap=action_gap,
                          checkpoint_dirs={"ppo": ckpt}, device=device)
    runs = res["ppo"]

    def mean(k):
        vals = [r[k] for r in runs if k in r]
        return sum(vals) / len(vals) if vals else None

    return {
        "reward_mean": mean("total_reward"),
        "reward_per_run": [r["total_reward"] for r in runs],
        "total_delay_mean": mean("delay.total_delay"),
        "served_trips_mean": mean("served_trips.served_trips_rate"),
        "avg_tt_mean": mean("travel_time.avg_travel_time"),
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dataset", default="metered_corridor", choices=list(DATASETS))
    p.add_argument("--coefs", type=float, nargs="+", default=[0.0, 0.1, 0.3])
    p.add_argument("--rollout-lens", type=int, nargs="+", default=[16])
    p.add_argument("--iters", type=int, default=None)
    p.add_argument("--num-runs", type=int, default=3, help="paired evaluation runs")
    p.add_argument("--out", default="outputs",
                   help="candidates and results go to <out>/ablate_<dataset>")
    p.add_argument("--device", default=DEFAULT, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = resolve(args.device)

    action_gap, d_ppo, _ = DATASETS[args.dataset]
    iters = args.iters or d_ppo
    base = os.path.join(args.out, f"ablate_{args.dataset}")
    rows = []
    for T in args.rollout_lens:
        for coef in args.coefs:
            tag = f"coef{coef:g}_T{T}"
            ckpt = os.path.join(base, tag)
            curve = train_candidate(args.dataset, action_gap, iters, coef, T, ckpt,
                                    device=device)
            scores = eval_candidate(args.dataset, action_gap, ckpt,
                                    os.path.join(base, f"eval_{tag}"), args.num_runs,
                                    device)
            row = {"dataset": args.dataset, "coef": coef, "rollout_len": T, "iters": iters,
                   "train_reward_start": curve[0]["reward"],
                   "train_reward_last10": (sum(c["reward"] for c in curve[-10:])
                                           / len(curve[-10:])),
                   **scores}
            rows.append(row)
            print("ABLATE " + json.dumps(row), flush=True)
    with open(os.path.join(base, "ablation.json"), "w") as f:
        json.dump(rows, f, indent=2)
    print(f"wrote {os.path.join(base, 'ablation.json')}")
    return rows


if __name__ == "__main__":
    main()
