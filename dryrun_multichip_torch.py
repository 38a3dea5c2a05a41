"""Multi-device dry run of the PyTorch port: five sharded stages on a tiny
scenario, over ``n`` ranks of one ``torch.distributed`` process group (the
counterpart of ``__graft_entry__.py``'s ``dryrun_multichip``).

    python3 dryrun_multichip_torch.py 4 --device cpu   # gloo ranks on the CPU
    python3 dryrun_multichip_torch.py 4                # on the card

Stages, each on the same 5-node butterfly with a gater agent:
  1. the minimal data-parallel policy-gradient step
     (``rl.train.make_dp_train_step``);
  2. one ``BatchedPPOTrainer(net_type="attention", randomize=True,
     mesh=...)`` iteration;
  3. one ``BatchedSACTrainer(randomize=True, mesh=...)`` iteration;
  4. a link-sharded 3-step stochastic run over the largest divisor of E
     that is at most ``n``;
  5. for an even ``n`` with E divisible by ``n / 2``, the 2 x n/2 hybrid
     (env x link) run.

Every stage must leave every rank with the same result; rank 0's line is
printed, and the report carries every rank's kernel launches and ring
blocks.  On the card the ranks share ``cuda:0`` over ``gloo`` unless there
is a card for each (``parallel.mesh``); with no card it raises.
"""

import argparse
import math

import numpy as np
import torch


def load_config_for_dryrun() -> dict:
    adj = np.array([
        [0, 0, 1, 0, 0],
        [0, 0, 1, 0, 0],
        [1, 1, 0, 1, 1],
        [0, 0, 1, 0, 0],
        [0, 0, 1, 0, 0],
    ])
    params = {
        "simulation_steps": 30,
        "unit_time": 10,
        "seed": 0,
        "default_link": {
            "length": 50, "width": 4, "free_flow_speed": 1.1,
            "k_critical": 2, "k_jam": 6, "fd_type": "yperman", "bi_factor": 1,
        },
        "controllers": {"enabled": True, "nodes": [2]},
        "demand": {"origin_0": {"pattern": "constant", "base_lambda": 5}},
    }
    return {"adjacency_matrix": adj, "params": params,
            "origin_nodes": [0, 1], "destination_nodes": [3, 4]}


def dryrun_rank(rank: int, world: int, device) -> dict:
    """The five stages on one rank; returns the numbers of the report."""
    from pednstream_tpu_torch.env import PedNetEnvCore, build_agent_spec
    from pednstream_tpu_torch.ops import fused_history_reads
    from pednstream_tpu_torch.parallel import (
        make_hybrid_sharded_simulate, make_link_sharded_simulate, make_mesh, make_mesh_2d,
        shard_batch, shard_hybrid_state, shard_link_params, shard_link_state, unshard_state)
    from pednstream_tpu_torch.rl.batched_ppo import BatchedPPOTrainer
    from pednstream_tpu_torch.rl.batched_sac import BatchedSACTrainer
    from pednstream_tpu_torch.rl.train import init_train_state, make_dp_train_step
    from pednstream_tpu_torch.scenario import build_scenario

    cfg = load_config_for_dryrun()
    # superset-topology OD candidates: the randomized trainers then open
    # and close origins and destinations per replica under sharding too
    scn = build_scenario(cfg["adjacency_matrix"], cfg["params"], cfg["origin_nodes"],
                         cfg["destination_nodes"], od_candidates=([4], [1]), device=device)
    core = PedNetEnvCore(scn, build_agent_spec(scn), obs_mode="option2", stochastic=True)

    def gen(seed):
        return torch.Generator(device=device).manual_seed(seed)

    mesh = make_mesh(world, device=device)
    B = 2 * world  # tiny batch, blocked over the env axis

    # 1) minimal sharded policy-gradient step
    states, obs = core.batch_reset(B)
    states, obs = shard_batch(states, mesh), shard_batch(obs, mesh)
    assert states.density.shape[0] == 2
    train_state = init_train_state(core, 1, device=device)
    new_states, _, train_state, metrics = make_dp_train_step(core, mesh)(
        states, obs, train_state, gen(0))
    pg_loss = float(metrics["loss"])
    blocks = {"replicas": tuple(new_states.cum_in_ring.shape)}

    # 2) the full training step: batched PPO, attention-LSTM policies,
    #    per-replica randomized worlds, replicas blocked over the mesh
    trainer = BatchedPPOTrainer(core, num_envs=B, rollout_len=3, epochs=1, minibatches=2,
                                net_type="attention", randomize=True, mesh=mesh)
    ts = trainer.init(seed=2)
    assert ts.env_states.density.shape[0] == B // world
    ts, ppo_metrics = trainer.train_iteration(ts)
    gate_loss = ppo_metrics[[k for k in ppo_metrics if k.endswith("/loss")][0]]

    # 3) off-policy: sharded collection into the replicated replay ring
    sac = BatchedSACTrainer(core, num_envs=B, collect_steps=2, updates_per_iter=2,
                            batch_size=16, buffer_capacity=64, warmup_transitions=4,
                            randomize=True, mesh=mesh)
    sts = sac.init(seed=3)
    assert sts.env_states.density.shape[0] == B // world
    sts, sac_metrics = sac.train_iteration(sts)
    sac_loss = sac_metrics[[k for k in sac_metrics if k.endswith("/critic_loss")][0]]

    # 4) link-axis state sharding: one replica's state blockwise over the
    #    largest divisor of E that the ranks allow
    E = scn.n_links
    link_n = max(d for d in range(1, world + 1) if E % d == 0)
    link_mesh = make_mesh(link_n, axis="link", device=device)
    link_mass = float("nan")
    if link_mesh is not None:
        run = make_link_sharded_simulate(scn, link_mesh, 3, stochastic=True)
        out = run(shard_link_params(scn.engine_params, link_mesh),
                  shard_link_state(scn.init_state(1), link_mesh), gen(4))
        assert out.cum_in_ring.shape == (1, scn.H, E // link_n)
        blocks["link"] = tuple(out.cum_in_ring.shape)
        link_mass = float(unshard_state(out, link_mesh).num_peds.sum())
        assert math.isfinite(link_mass)

    # 5) hybrid 2-D decomposition: replicas over 'env' x links over 'link'
    hybrid = world % 2 == 0 and E % (world // 2) == 0
    if hybrid:
        mesh2d = make_mesh_2d(2, world // 2, device=device)
        run = make_hybrid_sharded_simulate(scn, mesh2d, 2, stochastic=True)
        out = run(shard_link_params(scn.engine_params, mesh2d),
                  shard_hybrid_state(scn.init_state(4), mesh2d), gen(5))
        assert out.cum_in_ring.shape == (2, scn.H, E // (world // 2))
        blocks["hybrid"] = tuple(out.cum_in_ring.shape)

    return {"devices": world, "batch": B, "pg_loss": pg_loss, "ppo_loss": gate_loss,
            "sac_loss": sac_loss, "link_n": link_n, "link_mass": link_mass,
            "hybrid": hybrid, "t": int(new_states.t),
            "launches": dict(fused_history_reads.launches), "blocks": blocks,
            "backend": torch.distributed.get_backend(), "device": str(device),
            "host_trips": mesh.host_trips}


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Spawn ``n_devices`` ranks, run the five stages and print the report
    line; raises if a rank fails or the ranks disagree."""
    from pednstream_tpu_torch.device import resolve
    from pednstream_tpu_torch.parallel import spawn_ranks

    if resolve(device).type == "cuda":
        from pednstream_tpu_torch.ops import _build

        _build.build()  # once, before the ranks load it
    results = spawn_ranks(dryrun_rank, n_devices, device=device, threads=1)
    first = results[0]
    for r in results[1:]:
        for k in ("pg_loss", "ppo_loss", "sac_loss", "t"):
            if r[k] != first[k]:
                raise RuntimeError(f"ranks disagree on {k}: {first[k]} vs {r[k]}")
    masses = [r["link_mass"] for r in results if math.isfinite(r["link_mass"])]
    if len(set(masses)) != 1:
        raise RuntimeError(f"ranks disagree on the link-sharded mass: {masses}")
    first["link_mass"] = masses[0]
    first["launches_per_rank"] = [r["launches"] for r in results]
    first["blocks_per_rank"] = [r["blocks"] for r in results]
    print(f"dryrun_multichip ok: {n_devices} devices, batch {first['batch']}, "
          f"pg-loss {first['pg_loss']:.4f}, "
          f"ppo attention+randomized loss {first['ppo_loss']:.4f}, "
          f"sac critic loss {first['sac_loss']:.4f}, "
          f"link-sharded mass {first['link_mass']:.1f}, "
          f"t {first['t']} "
          f"[{first['backend']} on {first['device']}, link axis {first['link_n']}, "
          f"hybrid {'2x%d' % (n_devices // 2) if first['hybrid'] else 'skipped'}]")
    return first


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_devices", nargs="?", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dryrun_multichip(args.n_devices, args.device)
