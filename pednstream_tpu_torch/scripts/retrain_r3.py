"""Zoo retrain driver, split by phase (the counterpart of
``scripts/retrain_r3.py``):

  --phase ppo   : batched PPO training, 3 seeds per dataset
  --phase sac   : SAC through the host episode loop
  --phase eval  : paired evaluations + MPC baselines (and the lstm_ppo
                  variant's, when it has been trained)
  --phase lstm  : the lstm_ppo family variant on 45_intersections

Every phase runs on the card unless given ``--device cpu``, through
:mod:`~pednstream_tpu_torch.scripts.train_zoo`, and writes under ``--out``
as it does; the shipped ``artifacts/zoo`` is only read (the evaluation
takes the checkpoint under ``--out`` where there is one).

Run:  python -m pednstream_tpu_torch.scripts.retrain_r3 --phase ppo
      python -m pednstream_tpu_torch.scripts.retrain_r3 --phase eval \\
          --datasets butterfly_scC --num-runs 1 [--device cpu] [--out DIR]
"""

import argparse
import json
import os
import time
import traceback

from ..device import DEFAULT, resolve
from . import train_zoo as tz


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--phase", required=True, choices=["ppo", "sac", "eval", "lstm"])
    ap.add_argument("--datasets", nargs="*", default=None)
    ap.add_argument("--num-runs", type=int, default=3,
                    help="paired evaluation runs per policy (phase eval)")
    ap.add_argument("--out", default=tz.OUT,
                    help="where checkpoints and results go (the shipped "
                         "artifacts/ are only read)")
    ap.add_argument("--device", default=DEFAULT, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    out, device = args.out, resolve(args.device)

    names = args.datasets or list(tz.DATASETS)
    t0 = time.time()
    for name in names:
        gap, ppo_iters, sac_eps = tz.DATASETS[name]
        try:
            if args.phase == "ppo":
                tz.train_ppo(name, gap, ppo_iters, seeds=3, out=out, device=device)
            elif args.phase == "sac":
                tz.train_sac(name, gap, sac_eps, out=out, device=device)
            elif args.phase == "eval":
                ppo_dir = tz._existing(out, f"ppo_agents_{name}")
                sac_dir = tz._existing(out, f"sac_agents_{name}")
                tz.evaluate_zoo(name, gap, ppo_dir, sac_dir, with_mpc=True,
                                num_runs=args.num_runs, out=out, device=device)
        except Exception:
            print(f"[{name}] FAILED:\n{traceback.format_exc()}", flush=True)
        print(f"--- elapsed {time.time() - t0:.0f}s", flush=True)

    if args.phase == "lstm":
        try:
            gap, ppo_iters, _ = tz.DATASETS["45_intersections"]
            lstm_dir = tz.train_ppo("45_intersections", gap, ppo_iters, net_type="lstm",
                                    prefix="lstm_ppo", seeds=2, out=out, device=device)
            print(f"lstm variant -> {lstm_dir}", flush=True)
        except Exception:
            print(f"[lstm_ppo] FAILED:\n{traceback.format_exc()}", flush=True)
    lstm_ckpt = tz._existing(out, "lstm_ppo_agents_45_intersections")
    if args.phase == "eval" and lstm_ckpt is not None:
        try:
            from ..rl.evaluate import evaluate_agents, summarize

            gap = tz.DATASETS["45_intersections"][0]
            res_dir = os.path.join(out, "eval_45_intersections_lstm")
            res = evaluate_agents("45_intersections", ["ppo"], num_runs=args.num_runs,
                                  output_dir=res_dir, obs_mode="option2", action_gap=gap,
                                  checkpoint_dirs={"ppo": lstm_ckpt}, device=device)
            res["lstm_ppo"] = res.pop("ppo")
            with open(os.path.join(res_dir, "results.json"), "w") as f:
                json.dump(res, f, indent=2, default=float)
            print(summarize(res), flush=True)
        except Exception:
            print(f"[lstm_ppo eval] FAILED:\n{traceback.format_exc()}", flush=True)
    print(f"=== phase {args.phase} done in {time.time() - t0:.0f}s ===", flush=True)


if __name__ == "__main__":
    main()
