"""Reset-determinism statistical report (the counterpart of
``scripts/reset_determinism_report.py``; reference
rl/test_reset_determinism.py:29-120).

Runs N no-action episodes of the env on the card with a fixed seed,
collects every agent's observations, embeds the episodes with PCA, and
writes ``episode_states.json`` and ``statistics.json`` (:func:`report`,
the device work) and a scatter PNG (:func:`plot`, which needs matplotlib)
under ``--out``.

Run:  python -m pednstream_tpu_torch.scripts.reset_determinism_report \\
          --dataset butterfly_scC [--device cpu]
"""

import argparse
import json
import os

import numpy as np

from ..device import DEFAULT


def pca_2d(x: np.ndarray) -> np.ndarray:
    """2-component PCA via SVD (no sklearn dependency)."""
    xc = x - x.mean(axis=0, keepdims=True)
    _, _, vt = np.linalg.svd(xc, full_matrices=False)
    return xc @ vt[:2].T


def report(dataset="butterfly_scC", episodes=4, steps=30, seed=123,
           out="outputs/reset_determinism_test", device=DEFAULT):
    """Runs the episodes and writes the two JSON files; returns
    ``(episodes [N, steps, obs], PCA embedding, max cross-episode
    deviation)``."""
    from ..env import PedNetParallelEnv

    env = PedNetParallelEnv(dataset, obs_mode="option2", seed=seed, action_gap=5,
                            device=device)
    runs = []
    for _ in range(episodes):
        env.seed(seed)  # same seed every episode: distributions must match
        obs, _ = env.reset()
        rows = []
        for _ in range(steps):
            actions = {a: (env.action_space(a).low + env.action_space(a).high) / 2
                       for a in env.possible_agents}
            obs, *_ = env.step(actions)
            rows.append(np.concatenate([o.ravel() for o in obs.values()]))
        runs.append(np.stack(rows))

    emb = pca_2d(np.concatenate(runs))
    per_ep = {f"episode_{i}": {"mean": runs[i].mean(axis=0).tolist(),
                               "std": runs[i].std(axis=0).tolist()}
              for i in range(episodes)}
    max_dev = max(float(np.abs(runs[i] - runs[0]).max()) for i in range(1, episodes))

    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "episode_states.json"), "w") as f:
        json.dump({f"episode_{i}": e.tolist() for i, e in enumerate(runs)}, f)
    with open(os.path.join(out, "statistics.json"), "w") as f:
        json.dump({"per_episode": per_ep,
                   "max_cross_episode_deviation": max_dev,
                   "deterministic": max_dev == 0.0}, f, indent=2)
    return runs, emb, max_dev


def plot(emb, episodes, steps, max_dev, out):
    """``pca_episodes.png`` under ``out``."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 5))
    for i in range(episodes):
        ax.scatter(emb[i * steps:(i + 1) * steps, 0], emb[i * steps:(i + 1) * steps, 1],
                   s=12, alpha=0.6, label=f"episode {i}")
    ax.legend()
    ax.set_title(f"PCA of observations over {episodes} same-seed episodes\n"
                 f"max cross-episode deviation: {max_dev:g}")
    fig.savefig(os.path.join(out, "pca_episodes.png"), dpi=120, bbox_inches="tight")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--dataset", default="butterfly_scC")
    parser.add_argument("--episodes", type=int, default=4)
    parser.add_argument("--steps", type=int, default=30)
    parser.add_argument("--seed", type=int, default=123)
    parser.add_argument("--out", default="outputs/reset_determinism_test")
    parser.add_argument("--device", default=DEFAULT, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    _, emb, max_dev = report(args.dataset, args.episodes, args.steps, args.seed, args.out,
                             args.device)
    plot(emb, args.episodes, args.steps, max_dev, args.out)
    print(f"max cross-episode deviation: {max_dev} "
          f"({'DETERMINISTIC' if max_dev == 0 else 'NON-DETERMINISTIC'})")
    print(f"report written to {args.out}")


if __name__ == "__main__":
    main()
