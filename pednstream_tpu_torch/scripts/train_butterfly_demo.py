"""Train the butterfly_scC gating policy with the batched PPO trainer on the
card and save a checkpoint + training curve under ``--out`` (the
counterpart of ``scripts/train_butterfly_demo.py``, which writes the same
two files under ``artifacts/``).

Also evaluates the greedy trained policy against gates-wide-open
(no-control) on a fresh batch of envs.

Run:  python -m pednstream_tpu_torch.scripts.train_butterfly_demo [iterations]
          [--out outputs/torch_butterfly] [--device cpu]
"""

import argparse
import json
import os
import pickle
import time

import numpy as np
import torch

from ..device import DEFAULT, resolve

OUT = os.path.join("outputs", "torch_butterfly")


def evaluate(core, spec, policy=None, B=64, steps=120, key=0):
    """Mean cumulative reward over B fresh envs for `steps` steps: the
    greedy ``policy`` (a policy module of the trainer, its parameters
    inside) or, without one, gates wide open.  ``key`` seeds the engine's
    draws."""
    device = core.scn.device
    gen = torch.Generator(device=device).manual_seed(key)
    states, obs = core.batch_reset(B)
    gid = spec.gate_ids[0]
    widths = torch.as_tensor(np.asarray(spec.gate_link_widths[0], np.float32), device=device)
    total = torch.zeros(B, dtype=torch.float64, device=device)
    with torch.no_grad():
        for _ in range(steps):
            if policy is None:
                actions = {gid: widths[None].expand(B, -1)}
            else:
                o = obs[gid]
                mu, _, _ = policy(o)
                cur = o.reshape(B, len(widths), -1)[:, :, -1]
                target = cur + torch.clamp(mu, -2.5, 2.5)
                actions = {gid: torch.minimum(torch.clamp(target, min=0.0), widths)}
            states, obs, rew, done = core.batch_step(states, actions, gen)
            total += rew[gid].double()
    return float(total.mean())


def main(iterations=80, out=OUT, device=DEFAULT):
    from ..env import PedNetParallelEnv
    from ..interop import params_to_flax
    from ..rl.batched_ppo import BatchedPPOTrainer

    device = resolve(device)
    env = PedNetParallelEnv("butterfly_scC", obs_mode="option2", seed=0,
                            action_gap=5, history_window=64, device=device)
    tr = BatchedPPOTrainer(env.core, num_envs=256, rollout_len=16,
                           minibatches=4, epochs=4, lr=1e-3)
    ts = tr.init(0)

    curve = []
    t0 = time.time()
    for i in range(iterations):
        ts, m = tr.train_iteration(ts)
        curve.append(m["gate_2/reward"])
        if i % 10 == 0:
            print(f"iter {i}: reward {m['gate_2/reward']:.0f}", flush=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    train_time = time.time() - t0

    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "butterfly_ppo.pkl"), "wb") as f:
        pickle.dump({
            "params": {aid: params_to_flax(m) for aid, m in ts.params.items()},
            "value_params": {aid: params_to_flax(m) for aid, m in ts.value_params.items()},
            "config": {"dataset": "butterfly_scC", "obs_mode": "option2",
                       "action_gap": 5, "num_envs": 256, "rollout_len": 16,
                       "iterations": iterations},
        }, f)

    gid = "gate_2"
    r_trained = evaluate(env.core, env.spec_agents, ts.params[gid])
    r_nocontrol = evaluate(env.core, env.spec_agents)

    summary = {
        "iterations": iterations,
        "train_time_s": round(train_time, 1),
        "engine_steps_per_s": round(iterations * 256 * 16 * 5 / train_time),
        "reward_curve_first5": [round(r) for r in curve[:5]],
        "reward_curve_last5": [round(r) for r in curve[-5:]],
        "eval_mean_cum_reward_trained": round(r_trained, 1),
        "eval_mean_cum_reward_no_control": round(r_nocontrol, 1),
    }
    with open(os.path.join(out, "butterfly_ppo_training.json"), "w") as f:
        json.dump({"summary": summary, "curve": curve}, f, indent=2)
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("iterations", nargs="?", type=int, default=80)
    p.add_argument("--out", default=OUT)
    p.add_argument("--device", default=DEFAULT)
    a = p.parse_args()
    main(a.iterations, a.out, a.device)
