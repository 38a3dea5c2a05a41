"""Gate control mid-run (reference examples/six_node.py; the counterpart of
``examples/six_node.py``): close a gate partway through the simulation and
watch the queue spill back.

Imperative control of the engine: the control state is changed between
``simulate`` calls on the same state.

Run:  python -m pednstream_tpu_torch.examples.six_node [--device cpu]
"""

import argparse

import numpy as np

from ..device import DEFAULT
from ..engine import simulate
from ..scenario import build_scenario
from . import timed

PARAMS = {
    "unit_time": 10, "simulation_steps": 300, "seed": 9,
    "default_link": {"length": 100, "width": 2, "free_flow_speed": 1.1,
                     "k_critical": 2, "k_jam": 6},
    "demand": {"origin_0": {"peak_lambda": 20, "base_lambda": 8}},
}
# free flow, gate closed, reopened: 120 + 60 + 119 = simulation_steps - 1
PHASES = (120, 60, 119)


def adjacency():
    adj = np.zeros((6, 6), dtype=int)
    for a, b in [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5)]:
        adj[a, b] = adj[b, a] = 1
    return adj


def build(device=DEFAULT):
    return build_scenario(adjacency(), PARAMS, origin_nodes=[0], destination_nodes=[5],
                          device=device)


def _set_gate(st, link, width):
    gate = st.back_gate.clone()
    gate[:, link] = width
    return st.replace(back_gate=gate)


def run(device=DEFAULT, phases=PHASES):
    scn = build(device)
    ep = scn.engine_params
    e34 = scn.topo.link_id_to_idx[(3, 4)]
    e23 = scn.topo.link_id_to_idx[(2, 3)]

    def go():
        st = scn.init_state()
        # phase 1: free flow
        st, traj1 = simulate(scn, ep, st, phases[0], record=True)
        # close the entry gate of link 3->4 (back_gate_width = 0, link.py:121-126)
        st = _set_gate(st, e34, 0.0)
        st, traj2 = simulate(scn, ep, st, phases[1], record=True)
        # reopen
        st = _set_gate(st, e34, 2.0)
        st, traj3 = simulate(scn, ep, st, phases[2], record=True)
        return st, (traj1, traj2, traj3)

    (final, trajs), dt = timed(go, scn.device)
    d2 = trajs[1].density[:, 0].cpu().numpy()
    inflow2 = trajs[1].inflow[:, 0].cpu().numpy()
    d3 = trajs[2].density[:, 0].cpu().numpy()
    print(f"upstream density while gate closed: {d2[:, e23].max():.2f} "
          f"(queue forms), downstream inflow: {inflow2[:, e34].max():.0f}")
    print(f"after reopening, upstream density recovers to {d3[-1, e23]:.2f}")
    return {"scn": scn, "final": final, "trajs": trajs, "steps": sum(phases), "batch": 1,
            "seconds": dt, "closed_upstream_density": float(d2[:, e23].max()),
            "closed_inflow": float(inflow2[:, e34].max()),
            "reopened_upstream_density": float(d3[-1, e23])}


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default=DEFAULT)
    run(p.parse_args().device)
