"""Rule-based baseline controllers (a host-side NumPy copy of
``pednstream_tpu/rl/rule_based.py``, reference rl/agents/rule_based.py).

RuleBasedGaterAgent (:22-96): density-threshold gate rule — open wide
while average downstream density stays below a threshold, otherwise
nudge gate widths ±1 m around it.  Requires obs_mode option2 (density is
feature index 2 of each link block).

RuleBasedSeparatorAgent (:98-174): allocate corridor width proportionally
to smoothed directional inflows.
"""

import numpy as np


class RuleBasedGaterAgent:
    def __init__(self, act_dim: int, max_widths: np.ndarray,
                 density_threshold: float = 2.0, features_per_link: int = 4,
                 density_feature: int = 2, step: float = 1.0):
        self.act_dim = act_dim
        self.max_widths = np.asarray(max_widths, dtype=np.float32)
        self.density_threshold = density_threshold
        self.features_per_link = features_per_link
        self.density_feature = density_feature
        self.step = step

    def reset_hidden(self):
        pass

    def take_action(self, obs, explore: bool = False) -> np.ndarray:
        obs = np.asarray(obs, np.float32).reshape(self.act_dim, self.features_per_link)
        densities = obs[:, self.density_feature]
        widths = obs[:, -1]
        avg_density = densities.mean()
        if avg_density <= self.density_threshold:
            return self.max_widths.copy()  # open wide (rule_based.py:52-60)
        target = np.where(
            densities > self.density_threshold, widths - self.step, widths + self.step
        )
        return np.clip(target, 0.0, self.max_widths).astype(np.float32)

    def absolute_action(self, obs, action):
        return np.asarray(action, dtype=np.float32)

    def get_config(self):
        return {"algo": "rule_based_gater", "act_dim": self.act_dim,
                "density_threshold": self.density_threshold}

    def save(self, path):
        pass

    def load(self, path):
        pass


class RuleBasedSeparatorAgent:
    """Width ∝ smoothed directional inflow share (rule_based.py:98-174)."""

    def __init__(self, total_width: float, min_width: float = 1.5, ema: float = 0.3):
        self.total_width = total_width
        self.min_width = min_width
        self.ema = ema
        self._smoothed = np.array([1.0, 1.0])

    def reset_hidden(self):
        self._smoothed = np.array([1.0, 1.0])

    def take_action(self, obs, explore: bool = False) -> np.ndarray:
        obs = np.asarray(obs, np.float32)
        fwd_in, _, rev_in, _ = obs[:4]
        self._smoothed = (1 - self.ema) * self._smoothed + self.ema * np.array(
            [fwd_in, rev_in]
        )
        total = self._smoothed.sum()
        share = 0.5 if total <= 0 else self._smoothed[0] / total
        width = share * self.total_width
        width = np.clip(width, self.min_width, self.total_width - self.min_width)
        return np.array([width], dtype=np.float32)

    def absolute_action(self, obs, action):
        return np.asarray(action, dtype=np.float32)

    def get_config(self):
        return {"algo": "rule_based_separator", "total_width": self.total_width}

    def save(self, path):
        pass

    def load(self, path):
        pass


class NoControlAgent:
    """Holds gates fully open / separator centred (evaluation baseline)."""

    def __init__(self, default_action: np.ndarray):
        self.default_action = np.asarray(default_action, dtype=np.float32)

    def reset_hidden(self):
        pass

    def take_action(self, obs, explore: bool = False):
        return self.default_action.copy()

    def absolute_action(self, obs, action):
        return np.asarray(action, dtype=np.float32)

    def get_config(self):
        return {"algo": "no_control"}

    def save(self, path):
        pass

    def load(self, path):
        pass
