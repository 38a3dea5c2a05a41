"""Regenerate the SAC rows of ``<out>/eval_<dataset>/results.json`` (the
counterpart of ``scripts/reeval_sac.py``).

Re-runs ONLY the sac rows with the same paired protocol (seed 0+run, run 0
nominal, runs 1+ randomized) and merges them into the stored results.json
in place.  The checkpoint is the one ``train_zoo`` left under ``--out``,
else the shipped ``artifacts/zoo/sac_agents_<dataset>`` (only read).

Run: python -m pednstream_tpu_torch.scripts.reeval_sac [dataset ...]
         [--out outputs/torch_zoo] [--device cpu]   (default: all affected)
"""

import argparse
import json
import os
import time

from ..device import DEFAULT
from .train_zoo import DATASETS, OUT, _existing

AFFECTED = ["45_intersections", "butterfly_scB", "butterfly_scC",
            "one_intersection_v0", "small_network", "two_coordinators"]


def reeval(dataset: str, out: str = OUT, device=DEFAULT):
    from ..rl.evaluate import evaluate_agents

    action_gap = DATASETS[dataset][0]
    out_dir = os.path.join(out, f"eval_{dataset}")
    res_path = os.path.join(out_dir, "results.json")
    with open(res_path) as f:
        results = json.load(f)
    t0 = time.time()
    new = evaluate_agents(
        dataset, ["sac"], num_runs=3, output_dir=out_dir,
        obs_mode="option2", action_gap=action_gap,
        checkpoint_dirs={"sac": _existing(out, f"sac_agents_{dataset}")},
        device=device,
    )
    old = {r["run"]: r["total_reward"] for r in results.get("sac", [])}
    results["sac"] = new["sac"]
    with open(res_path, "w") as f:
        json.dump(results, f, indent=2, default=float)
    for r in new["sac"]:
        print(f"[{dataset}] run{r['run']}: reward {r['total_reward']:.0f} "
              f"(was {old.get(r['run'], float('nan')):.0f}), "
              f"delay {r.get('delay.total_delay', float('nan')):.0f}",
              flush=True)
    print(f"[{dataset}] done in {time.time() - t0:.0f}s", flush=True)


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("datasets", nargs="*")
    p.add_argument("--out", default=OUT)
    p.add_argument("--device", default=DEFAULT)
    a = p.parse_args()
    for name in a.datasets or AFFECTED:
        reeval(name, a.out, a.device)
