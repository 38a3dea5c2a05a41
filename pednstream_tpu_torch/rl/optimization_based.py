"""Model-predictive optimization baseline (the counterpart of
``pednstream_tpu/rl/optimization_based.py``; reference
rl/agents/optimization_based.py:409-867).

Each gater independently solves min_w Var(N_local(t+1; w)) over its gate
widths with scipy differential_evolution (maxiter 10, popsize 50,
best1bin, no polish — :722-785):
  - logit route choice with gate-width-dependent capacities (:437-546),
  - demand/supply transfer with receiving-gate scaling (:599-718),
  - external boundary flows from lagged inflow / current outflow
    (:630-650).

The predictive model runs host-side in NumPy (as in the reference — it
is an evaluation baseline, not a training hot path).  The search calls
its objective thousands of times per action, so the engine state's leaves
it reads (which live on the env's device and carry the replica axis) are
copied to the host once per ``bind_state`` or ``take_action``
(:class:`HostState`), never inside the objective.
"""

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from ..env.agents import AgentSpec
from ..scenario import Scenario
from ..state import NetworkState


@dataclass
class HostState:
    """What the predictive model reads of one replica's engine state, as
    numpy arrays without the replica axis."""

    t: int
    num_peds: np.ndarray  # [E]
    inflow_ring: np.ndarray  # [H, E]
    outflow: np.ndarray  # [E]
    back_gate: np.ndarray  # [E]

    @classmethod
    def of(cls, state: NetworkState) -> "HostState":
        """The first replica of ``state`` (the env steps one)."""
        t = state.t
        return cls(
            t=int(t[0]) if hasattr(t, "shape") else int(t),
            **{name: getattr(state, name)[0].cpu().numpy()
               for name in ("num_peds", "inflow_ring", "outflow", "back_gate")})


class DecentralizedOptimizationAgent:
    def __init__(self, scn: Scenario, spec: AgentSpec, agent_id: str,
                 verbose: bool = False, seed: int = 0):
        self.scn = scn
        self.spec = spec
        self.agent_id = agent_id
        self.verbose = verbose
        self.seed = seed
        pb = scn.path_builder
        self.temp = pb.temp if pb else 0.1
        self.alpha = pb.alpha if pb else 1.0
        self.beta_density = pb.beta if pb else 0.05
        self.beta_width = pb.omega if pb else 0.05

        topo = scn.topo
        gi = spec.gate_ids.index(agent_id)
        self.node_id = spec.gate_nodes[gi]
        self.out_links = list(spec.gate_links[gi])
        self.in_links = [
            int(topo.in_link_idx[self.node_id, k])
            for k in range(topo.max_deg)
            if int(topo.in_link_idx[self.node_id, k]) >= 0
        ]
        self.local_links = self.in_links + self.out_links
        self._turns = self._node_turn_structures()
        self._od_table = scn.engine_params.od_table.cpu().numpy()
        self._state: Optional[HostState] = None

    # -- host turn structures (mirrors calculate_turn_probabilities) ----------

    def _node_turn_structures(self):
        pb = self.scn.path_builder
        if pb is None:
            return None
        node_id = self.node_id
        turns_distances: Dict = {}
        up_od: Dict = {}
        for od_pair in pb.node_to_od_pairs.get(node_id, set()):
            origin, dest = od_pair
            dists: Dict = {}
            for path in pb.od_paths[od_pair]:
                if node_id not in path:
                    continue
                idx = path.index(node_id)
                if node_id == origin:
                    turn = (-1, path[idx + 1])
                elif node_id == dest:
                    turn = (path[idx - 1], -1)
                elif idx < len(path) - 1:
                    turn = (path[idx - 1], path[idx + 1])
                else:
                    continue
                remaining = pb.path_distance(path, start_idx=idx)
                if turn not in dists or remaining < dists[turn]:
                    dists[turn] = remaining
            for (up, down), d in dists.items():
                turns_distances.setdefault(od_pair, {}).setdefault(up, {})[down] = d
                up_od.setdefault(up, set()).add(od_pair)
        return {"turns_distances": turns_distances, "up_od": up_od}

    # -- predictive model ---------------------------------------------------------

    def _route_probs(self, w_vector, state, time_step):
        """p(down | up, od; w) with gate-width capacities (:437-546)."""
        if not self._turns:
            return {}
        topo = self.scn.topo
        lp = topo.link_params
        num_peds = state.num_peds
        rev = np.asarray(topo.reverse_idx)
        back_gate = state.back_gate
        route_probs = {}
        for od_pair, ups in self._turns["turns_distances"].items():
            route_probs[od_pair] = {}
            for up_node, downs in ups.items():
                turns, dists, dens, caps, kcs, kjs = [], [], [], [], [], []
                for down_node, dist in sorted(downs.items(), key=lambda kv: kv[0]):
                    turns.append((up_node, down_node))
                    dists.append(dist)
                    e = self.scn.topo.link_id_to_idx.get((self.node_id, down_node))
                    if e is None:
                        dens.append(0.0)
                        caps.append(100.0)
                        kcs.append(2.0)
                        kjs.append(10.0)
                        continue
                    area = lp.length[e] * lp.width[e]
                    dens.append((num_peds[e] + num_peds[rev[e]]) / area)
                    gate_width = back_gate[e]
                    for li, ce in enumerate(self.out_links):
                        if ce == e:
                            gate_width = w_vector[li]
                            break
                    caps.append(
                        gate_width * lp.free_flow_speed[e] * lp.k_critical[e]
                        * self.scn.unit_time
                    )
                    kcs.append(lp.k_critical[e])
                    kjs.append(lp.k_jam[e])
                dists, dens, caps = map(np.array, (dists, dens, caps))
                kcs, kjs = np.array(kcs), np.array(kjs)
                norm_d = dists / (dists.sum() + 1e-6)
                norm_k = np.maximum(dens - kcs, 0) / (kjs - kcs + 1e-6)
                norm_c = caps / (caps.sum() + 1e-6)
                util = self.alpha * norm_d + self.beta_density * norm_k - self.beta_width * norm_c
                z = np.exp(-self.temp * util)
                probs = z / (z.sum() + 1e-10)
                for turn, p in zip(turns, probs):
                    route_probs[od_pair][turn] = p
        return route_probs

    def _aggregated_probs(self, w_vector, state, time_step):
        """p(down | up; w) = sum_d p(d|up) p(down|up,d) (:560-597)."""
        route_probs = self._route_probs(w_vector, state, time_step)
        if not route_probs:
            return {}
        od_table = self._od_table
        od_pairs = list(self.scn.od_manager.od_flows.keys()) if self.scn.od_manager else []
        od_index = {p: i for i, p in enumerate(od_pairs)}
        agg = {}
        for up_node, ods in self._turns["up_od"].items():
            flows = {od: od_table[od_index[od], time_step] if od in od_index else 0.0
                     for od in ods}
            total = sum(flows.values())
            if total < 1e-10:
                flows = {od: 1.0 for od in ods}
                total = len(ods)
            downs = set()
            for od in ods:
                for (u, d) in route_probs.get(od, {}):
                    if u == up_node:
                        downs.add(d)
            for down in downs:
                agg[(up_node, down)] = sum(
                    (flows[od] / total) * route_probs.get(od, {}).get((up_node, down), 0.0)
                    for od in ods
                )
        return agg

    def _predict_next_state(self, w_vector, state, time_step):
        """N(t+1; w) with demand/supply transfer (:599-718)."""
        topo = self.scn.topo
        lp = topo.link_params
        num_peds = state.num_peds
        inflow_hist = state.inflow_ring  # [H, E]
        outflow = state.outflow
        local = self.local_links
        N_t = num_peds[local].astype(np.float64)
        N_next = N_t.copy()

        def gate_capacity(e, local_idx):
            w_idx = local_idx % len(w_vector)
            return (w_vector[w_idx] * lp.free_flow_speed[e] * lp.k_critical[e]
                    * self.scn.unit_time)

        idx_t = time_step
        H = inflow_hist.shape[0]
        for i, e in enumerate(local):
            travel_gap = int(np.floor(lp.length[e] / (lp.free_flow_speed[e] * self.scn.unit_time)))
            if travel_gap >= H and idx_t - travel_gap >= 0:
                # the ring no longer holds inflow[t - travel_gap]; a
                # silent mod-wrap would read a far-too-recent inflow
                raise ValueError(
                    f"link {e}: free-flow travel gap {travel_gap} steps "
                    f"exceeds history_window={H}; rebuild the scenario "
                    f"with history_window > {travel_gap} to use the MPC "
                    "agent")
            ext_in = (
                inflow_hist[(idx_t - travel_gap) % H, e]
                if idx_t - travel_gap >= 0 else 0.0
            )
            ext_out = outflow[e]
            if e in self.in_links:
                N_next[i] += ext_in
            else:
                N_next[i] -= ext_out

        agg = self._aggregated_probs(w_vector, state, time_step)
        requests = {e: 0.0 for e in self.out_links}
        transfers = []
        start_nodes = np.asarray(topo.start_node)
        for up_e in self.in_links:
            up_idx = local.index(up_e)
            sending_cap = gate_capacity(up_e, up_idx)
            potential = min(N_t[up_idx], sending_cap)
            for (u_id, d_id), prob in agg.items():
                if u_id == int(start_nodes[up_e]) and prob > 0:
                    down_e = topo.link_id_to_idx.get((self.node_id, d_id))
                    if down_e is not None and down_e in requests:
                        amount = potential * prob
                        requests[down_e] += amount
                        transfers.append(
                            {"up": up_idx, "down": local.index(down_e),
                             "amount": amount, "down_e": down_e}
                        )
        for down_e, total_req in requests.items():
            if total_req <= 1e-9:
                continue
            cap = gate_capacity(down_e, local.index(down_e))
            scale = cap / total_req if total_req > cap else 1.0
            for tr in transfers:
                if tr["down_e"] == down_e:
                    flow = tr["amount"] * scale
                    N_next[tr["up"]] -= flow
                    N_next[tr["down"]] += flow
        return np.maximum(N_next, 0)

    # -- interface -----------------------------------------------------------------

    def reset_hidden(self):
        pass

    def take_action(self, obs, state=None, time_step: Optional[int] = None,
                    explore: bool = False) -> np.ndarray:
        """Optimize gate widths by differential evolution (:722-785).
        Requires the engine state (pass via take_action(obs, state=..,
        time_step=..) or through bind_state): a ``NetworkState`` (its first
        replica is read) or a :class:`HostState`."""
        from scipy.optimize import differential_evolution

        if isinstance(state, NetworkState):
            state = HostState.of(state)
        if state is None:
            state = self._state
        if state is None:
            raise ValueError("optimization agent needs the engine state; call bind_state")
        if time_step is None:
            time_step = state.t - 1

        lp = self.scn.topo.link_params
        bounds = [(0.0, float(lp.width[e])) for e in self.out_links]

        def objective(w):
            n_next = self._predict_next_state(w, state, time_step)
            n_next = n_next.reshape(2, -1).sum(axis=0)
            return np.var(n_next)

        try:
            result = differential_evolution(
                objective, bounds, strategy="best1bin", maxiter=10, popsize=50,
                mutation=(0.5, 1), recombination=0.7, tol=0.01, polish=False,
                disp=False, seed=self.seed,
            )
            widths = result.x
        except Exception as e:  # fallback: hold current widths (:779-783)
            if self.verbose:
                print(f"Optimization failed for agent {self.agent_id}: {e}")
            widths = state.back_gate[self.out_links]
        return widths.astype(np.float32)

    def bind_state(self, state: NetworkState):
        self._state = HostState.of(state)

    def absolute_action(self, obs, action):
        return np.asarray(action, dtype=np.float32)

    def get_config(self):
        return {"algo": "optimization_based", "agent_id": self.agent_id}

    def save(self, path):
        pass

    def load(self, path):
        pass
