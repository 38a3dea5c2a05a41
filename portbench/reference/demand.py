"""Origin demand generation and OD flow tables (host-side precompute).

A copy of ``pednstream_tpu/demand.py`` (which the port cannot import
without loading JAX).  The global ``np.random`` call order is part of the
contract: a change here changes every seeded demand table.

The reference generates per-origin Poisson demand lazily per node object
(src/LTM/od_manager.py:57-155) and stores OD flow splits as a dict of
arrays (od_manager.py:14-54).  Here both are compiled into dense device
arrays at scenario build time: ``demand[N, T+1]`` and
``od_table[num_pairs, T+1]`` — the per-step engine only gathers columns.

NumPy RNG call order is kept identical to the reference (per-origin
``np.random.seed(seed)`` re-seeding before ``poisson`` when a seed is
configured, generation in node-creation order) so that seeded runs
produce bit-identical demand curves for golden-trajectory tests.
"""

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np


@dataclass
class DemandConfig:
    """Per-origin demand configuration (reference od_manager.py:6-12)."""

    peak_lambda: float = 10.0
    base_lambda: float = 5.0
    seed: Optional[int] = None
    pattern: str = "gaussian_peaks"


class DemandGenerator:
    """Generates demand curves for origin nodes.

    Built-in patterns (reference od_manager.py:101-155):
      - gaussian_peaks: Poisson around two Gaussian peaks at T/4 and 3T/4
        with sigma = T/20; length T.
      - constant: flat base_lambda; length T+1.
      - sudden_demand: gaussian_peaks plus a random spike of 20-50 lasting
        10-20 steps at a random start.
    Custom patterns can be registered with :meth:`register_pattern`.
    """

    def __init__(self, simulation_steps: int, params: dict, logger=None):
        self.logger = logger
        self.simulation_steps = simulation_steps
        self.params = params
        self.time = np.arange(simulation_steps)
        self.seed = params.get("seed", None)
        self.demand_patterns: Dict[str, Callable] = {
            "gaussian_peaks": self.generate_gaussian_peaks,
            "constant": self.generate_constant,
            "sudden_demand": self.generate_sudden_demand,
        }

    def register_pattern(self, pattern_name: str, pattern_func: Callable) -> None:
        if not callable(pattern_func):
            raise ValueError("pattern_func must be callable")
        self.demand_patterns[pattern_name] = pattern_func

    def _get_demand_config(self, origin_id: int) -> DemandConfig:
        try:
            origin_config = self.params["demand"][f"origin_{origin_id}"]
            return DemandConfig(
                peak_lambda=origin_config.get("peak_lambda", 10.0),
                base_lambda=origin_config.get("base_lambda", 5.0),
                seed=self.seed,
                pattern=origin_config.get("pattern", "gaussian_peaks"),
            )
        except KeyError:
            return DemandConfig(seed=self.seed)

    def _base_gaussian(self, config: DemandConfig) -> np.ndarray:
        t = self.simulation_steps
        morning = config.peak_lambda * np.exp(-((self.time - t / 4) ** 2) / (2 * (t / 20) ** 2))
        evening = config.peak_lambda * np.exp(-((self.time - 3 * t / 4) ** 2) / (2 * (t / 20) ** 2))
        lambda_t = config.base_lambda + morning + evening
        if self.seed is not None:
            np.random.seed(self.seed)
        return np.random.poisson(lam=lambda_t)

    def generate_gaussian_peaks(self, origin_id: int, params=None) -> np.ndarray:
        return self._base_gaussian(self._get_demand_config(origin_id))

    def generate_constant(self, origin_id: int, params=None) -> np.ndarray:
        config = self._get_demand_config(origin_id)
        return np.full(self.simulation_steps + 1, config.base_lambda)

    def generate_sudden_demand(self, origin_id: int, params=None) -> np.ndarray:
        config = self._get_demand_config(origin_id)
        demand = self._base_gaussian(config)
        sudden_period = np.random.randint(10, 20)
        start_step = np.random.randint(0, max(1, self.simulation_steps - sudden_period))
        demand = demand.astype(np.int64, copy=True)
        demand[start_step : start_step + sudden_period] += np.random.randint(20, 50)
        return demand

    def generate_custom(self, origin_id: int, pattern: str) -> np.ndarray:
        if pattern not in self.demand_patterns:
            raise ValueError(
                f"Unknown demand pattern: {pattern}. "
                f"Available patterns: {list(self.demand_patterns.keys())}"
            )
        return self.demand_patterns[pattern](origin_id, params=self.params)


class ODManager:
    """Dense OD flow split table (reference od_manager.py:14-54).

    ``od_flows`` maps (origin, dest) -> array[T+1] of relative flow
    weights; scalars are expanded to constants; absent pairs read as 0.
    """

    def __init__(self, simulation_steps: int, logger=None):
        self.simulation_steps = simulation_steps
        self.od_flows: Dict[Tuple[int, int], np.ndarray] = {}

    def init_od_flows(self, origin_nodes: list, destination_nodes: list, od_flows: dict = None):
        if od_flows:
            for (o, d), flow in od_flows.items():
                if isinstance(flow, (int, float)):
                    self.od_flows[(o, d)] = np.full(self.simulation_steps + 1, float(flow))
                else:
                    flow = np.asarray(flow, dtype=np.float64)
                    if len(flow) != self.simulation_steps + 1:
                        raise ValueError(
                            f"Flow array length for OD pair ({o},{d}) must match simulation_steps"
                        )
                    self.od_flows[(o, d)] = flow
        else:
            for o in origin_nodes:
                for d in destination_nodes:
                    if o != d:
                        self.od_flows[(o, d)] = np.ones(self.simulation_steps + 1)

    def get_od_flow(self, origin: int, destination: int, time_step: int) -> float:
        arr = self.od_flows.get((origin, destination))
        return 0.0 if arr is None else float(arr[time_step])

    def dense_table(self) -> Tuple[List[Tuple[int, int]], np.ndarray]:
        """Return (ordered od pairs, table[num_pairs, T+1])."""
        pairs = list(self.od_flows.keys())
        if not pairs:
            return [], np.zeros((0, self.simulation_steps + 1))
        table = np.stack([self.od_flows[p] for p in pairs], axis=0)
        return pairs, table


def build_demand_table(
    simulation_steps: int,
    params: dict,
    origin_nodes: List[int],
    virtual_nodes_in_creation_order: List[int],
    custom_patterns: Optional[Dict[str, Callable]] = None,
) -> np.ndarray:
    """Compile per-node demand into a dense ``[N_virtual_order] -> [T+1]`` map.

    Demand is generated in node-creation order (the order the reference
    instantiates nodes in network.py:194-248) so the global NumPy RNG
    stream matches the reference when no per-origin seed is configured.
    Non-origin virtual nodes get zero demand (network.py:139).

    Returns dict {node_id: np.ndarray} of raw demand arrays (lengths vary
    by pattern, as in the reference; callers pad to T+1).
    """
    gen = DemandGenerator(simulation_steps, params)
    if custom_patterns:
        for name, func in custom_patterns.items():
            gen.register_pattern(name, func)

    demands: Dict[int, np.ndarray] = {}
    for node_id in virtual_nodes_in_creation_order:
        if node_id in origin_nodes:
            origin_config = params.get("demand", {}).get(f"origin_{node_id}", {})
            pattern = origin_config.get("pattern", "gaussian_peaks")
            demands[node_id] = np.asarray(gen.generate_custom(node_id, pattern), dtype=np.float64)
        else:
            demands[node_id] = np.zeros(simulation_steps)
    return demands
