"""metered_corridor demo: the scenario where gating decisively matters
(the counterpart of ``examples/metered_corridor.py``).

Runs the nominal burst-demand world under the policies no-control,
rule-based, the best fixed meter and the shipped trained PPO gater (read
from ``artifacts/zoo``, if present), and prints the paired comparison.
Optionally exports the interactive HTML map of the no-control collapse,
its run saved under ``outputs/``.

The physics (jam-discharge collapse behind an ungated bottleneck) are
documented in data/metered_corridor/sim_params.yaml; the training
pipeline is ``pednstream_tpu_torch.scripts.train_zoo``.

Run:  python -m pednstream_tpu_torch.examples.metered_corridor [--html out.html] [--device cpu]
"""

import argparse
import os
from pathlib import Path

import numpy as np

from ..device import DEFAULT
from . import timed

ZOO = str(Path(__file__).resolve().parents[2] / "artifacts" / "zoo"
          / "ppo_agents_metered_corridor")


def episode(env, policy, record=False):
    obs, _ = env.reset()
    for a in policy.values():
        if hasattr(a, "reset_hidden"):
            a.reset_hidden()
    total, done = 0.0, False
    while not done:
        acts = {}
        for aid, ag in policy.items():
            d = ag.take_action(obs[aid], explore=False)
            acts[aid] = (ag.absolute_action(obs[aid], d)
                         if hasattr(ag, "absolute_action") else d)
        obs, rew, terms, truncs, infos = env.step(acts)
        total += sum(infos[a].get("true_reward", rew.get(a, 0.0))
                     for a in rew)
        done = any(terms.values()) or any(truncs.values())
    arrived = float(env._state.virt_arr_cum.sum())
    return total, arrived


class FixedMeter:
    """Hold the feeder entrance at a fixed width (the best static policy
    from the sweep in tests/test_metered_corridor.py)."""

    def __init__(self, spec, topo, width):
        idx = {v: k for k, v in topo.link_id_to_idx.items()}
        links = [idx[int(e)] for e in np.asarray(spec.gate_links[0])]
        self.w = np.asarray(spec.gate_link_widths[0], np.float32).copy()
        self.w[links.index((3, 4))] = width

    def reset_hidden(self):
        pass

    def take_action(self, obs, explore=False):
        return self.w

    def absolute_action(self, obs, a):
        return a


def run(device=DEFAULT, html=None, out="outputs"):
    """``{"rows": [(policy, total reward, arrived)], ...}`` on the nominal
    world, with the last episode's final state, the engine steps of all
    episodes and their seconds."""
    from ..env import PedNetParallelEnv
    from ..rl.train import build_agents

    env = PedNetParallelEnv("metered_corridor", obs_mode="option2", seed=0,
                            action_gap=5, record_history=bool(html), device=device)
    spec, topo = env.spec_agents, env.scn.topo
    aid = spec.gate_ids[0]

    rows = [("no_control", build_agents(env, algo="no_control")),
            ("rule_based", build_agents(env, algo="rule_based")),
            ("fixed meter 0.6", {aid: FixedMeter(spec, topo, 0.6)})]
    if os.path.isdir(ZOO):
        from ..rl.rl_utils import load_all_agents

        ppo = build_agents(env, algo="ppo", device=device)
        load_all_agents(ppo, ZOO)
        rows.append(("trained PPO (zoo)", ppo))

    results, seconds, steps = [], 0.0, 0
    print(f"{'policy':<20}{'total reward':>14}{'arrived':>9}")
    for name, policy in rows:
        (total, arrived), dt = timed(lambda: episode(env, policy), env.scn.device)
        results.append((name, total, arrived))
        seconds += dt
        steps += env._state.t - 1
        print(f"{name:<20}{total:>14.0f}{arrived:>9.0f}")
    final = env._state

    if html:
        # re-run no-control with history and export the interactive map
        env2 = PedNetParallelEnv("metered_corridor", obs_mode="option2",
                                 seed=0, action_gap=5, record_history=True, device=device)
        episode(env2, build_agents(env2, algo="no_control"))
        run_dir = os.path.join(out, "metered_corridor_demo")
        env2.save(os.path.basename(run_dir), base_dir=os.path.dirname(run_dir))
        from ..viz.html_export import export_interactive_html

        export_interactive_html(run_dir, html)
        print(f"wrote {html} (no-control collapse)")
    return {"rows": results, "final": final, "steps": steps, "batch": 1, "seconds": seconds}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--html", default=None, metavar="OUT.html")
    parser.add_argument("--device", default=DEFAULT)
    args = parser.parse_args(argv)
    return run(args.device, args.html)


if __name__ == "__main__":
    main()
