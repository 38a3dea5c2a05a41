"""Agent discovery and space construction (a host-side copy of
``pednstream_tpu/env/agents.py``; importing that package loads JAX).

Mirrors the reference AgentManager/SpaceBuilder (rl/discovery.py:20-178,
rl/spaces.py:20-137): separator agents come from ``controllers.links``
("u-v" corridors, agent id ``sep_u_v`` with u < v), gater agents from
``controllers.nodes`` (agent id ``gate_n``, controlling the node's real
non-separator outgoing links).  Compiled to static NumPy index arrays,
which the env core stages on the scenario's device once.
"""

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from .scenario import Scenario
from .topology import parse_controllers


@dataclass
class AgentSpec:
    agent_ids: List[str]
    agent_types: Dict[str, str]  # 'sep' | 'gate'

    # separators
    sep_ids: List[str]
    sep_fwd_link: np.ndarray  # [S] forward (min->max) directed link idx
    sep_total_width: np.ndarray  # [S]

    # gaters
    gate_ids: List[str]
    gate_nodes: List[int]
    gate_links: List[np.ndarray]  # per agent: controlled out-link indices
    gate_link_widths: List[np.ndarray]

    min_sep_width: float = 1.5  # pz_pednet_env.py:86
    max_delta_sep: float = 0.0  # set from 0.25 * unit_time (pz_pednet_env.py:84)
    max_delta_gate: float = 0.0

    @property
    def max_outdegree(self) -> int:
        return max((len(g) for g in self.gate_links), default=0)


def build_agent_spec(scn: Scenario, min_sep_width: float = 1.5) -> AgentSpec:
    enabled, _, gaters, controller_links = parse_controllers(scn.params)
    topo = scn.topo
    is_sep = topo.link_params.is_separator

    sep_ids, sep_fwd, sep_w = [], [], []
    for link in controller_links:
        a, b = sorted(map(int, link.split("-")))
        agent_id = f"sep_{a}_{b}"
        fwd = topo.link_id_to_idx.get((a, b))
        rev = topo.link_id_to_idx.get((b, a))
        if fwd is None or rev is None:
            raise ValueError(f"Missing bidirectional links for separator ({a},{b})")
        if not is_sep[fwd]:
            raise ValueError(
                f"Link {a}->{b} is not a Separator. Use Separator links for lane control."
            )
        sep_ids.append(agent_id)
        sep_fwd.append(fwd)
        sep_w.append(float(topo.link_params.width[fwd]))

    gate_ids, gate_nodes, gate_links, gate_widths = [], [], [], []
    for node_id in sorted(gaters):
        if node_id >= topo.n_nodes:
            raise ValueError(f"Gater node {node_id} not found in network")
        links = []
        for k in range(topo.max_deg):
            e = int(topo.out_link_idx[node_id, k])
            if e < 0 or is_sep[e]:
                continue
            links.append(e)
        if not links:
            raise ValueError(f"Gater node {node_id} has no real outgoing links to control")
        gate_ids.append(f"gate_{node_id}")
        gate_nodes.append(int(node_id))
        gate_links.append(np.array(links, dtype=np.int32))
        gate_widths.append(topo.link_params.width[np.array(links)])

    agent_ids = sep_ids + gate_ids
    agent_types = {a: "sep" for a in sep_ids}
    agent_types.update({a: "gate" for a in gate_ids})

    return AgentSpec(
        agent_ids=agent_ids,
        agent_types=agent_types,
        sep_ids=sep_ids,
        sep_fwd_link=np.array(sep_fwd, dtype=np.int32),
        sep_total_width=np.array(sep_w),
        gate_ids=gate_ids,
        gate_nodes=gate_nodes,
        gate_links=gate_links,
        gate_link_widths=gate_widths,
        min_sep_width=min_sep_width,
        max_delta_sep=0.25 * scn.unit_time,
        max_delta_gate=0.25 * scn.unit_time,
    )


def controlled_links_adjacency(scn: Scenario, links: np.ndarray) -> np.ndarray:
    """Adjacency over a gater's controlled links for the GAT policy
    family: links are adjacent when they share an endpoint node (for the
    out-links of one gater node this is fully connected — the same graph
    the reference's DenseGAT effectively sees), with self-loops."""
    nodes = scn.topo.link_nodes[np.asarray(links)]  # [L, 2] (u, v)
    L = len(links)
    adj = np.zeros((L, L), dtype=np.float32)
    for i in range(L):
        for j in range(L):
            adj[i, j] = float(bool(set(nodes[i]) & set(nodes[j])) or i == j)
    return adj


FEATURES_PER_LINK = {  # rl/builders.py:49-58
    "option1": 3,
    "option2": 4,
    "option3": 5,
    "option4": 2,
    "option5": 7,
}


@dataclass
class Box:
    """The bounds of a box space (``low``, ``high``, ``shape``, ``dtype``),
    used where gymnasium is not installed."""

    low: object
    high: object
    shape: Tuple[int, ...]
    dtype: object

    def __post_init__(self):
        self.low = np.full(self.shape, self.low, dtype=self.dtype)
        self.high = np.full(self.shape, self.high, dtype=self.dtype)


def build_spaces(spec: AgentSpec, obs_mode: str):
    """Gymnasium Box spaces (rl/spaces.py:43-104); :class:`Box` bounds
    where gymnasium is not installed."""
    try:
        from gymnasium import spaces as gspaces
    except ImportError:
        gspaces = None
    box = Box if gspaces is None else gspaces.Box

    fpl = FEATURES_PER_LINK[obs_mode]
    action_spaces, observation_spaces = {}, {}
    for i, agent_id in enumerate(spec.sep_ids):
        total = spec.sep_total_width[i]
        action_spaces[agent_id] = box(
            low=spec.min_sep_width, high=total - spec.min_sep_width,
            shape=(1,), dtype=np.float32,
        )
        observation_spaces[agent_id] = box(
            low=-np.inf, high=np.inf, shape=(4,), dtype=np.float32
        )
    for i, agent_id in enumerate(spec.gate_ids):
        widths = spec.gate_link_widths[i].astype(np.float32)
        action_spaces[agent_id] = box(
            low=np.zeros(len(widths), dtype=np.float32), high=widths,
            shape=(len(widths),), dtype=np.float32,
        )
        observation_spaces[agent_id] = box(
            low=-np.inf, high=np.inf, shape=(len(widths) * fpl,), dtype=np.float32
        )
    return action_spaces, observation_spaces
