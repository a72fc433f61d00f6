"""Physics introspection for logging (mirror of
``controllable_agent_tpu/train/physics_stats.py``).

Named physics scalars with running min/max/mean/std aggregation, dumped into
the eval logs. The named scalars come from each environment's
``goal_features`` layout. The features are computed where the physics lives
(``features_fn`` maps a tensor to a tensor) and brought to the host once per
batch; the statistics are numpy on the host.
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch

_FEATURE_NAMES = {
    "walker": ("x", "z", "up", "vx", "vz", "am"),
    "cheetah": ("x", "z", "up", "vx", "vz", "am"),
    "hopper": ("x", "z", "up", "vx", "vz", "am"),
    "point_mass_maze": ("x", "y", "vx", "vy"),
    "grid": ("y", "x", "goal_y", "goal_x"),
    "quadruped": ("up", "_", "x", "y", "z", "vx", "vy", "vz"),
    "jaco": ("tcp_x", "tcp_y", "tcp_z"),
}


class FloatStats:
    """Running min/max/mean/std."""

    def __init__(self) -> None:
        self.min = np.inf
        self.max = -np.inf
        self.mean = 0.0
        self._m2 = 0.0
        self.count = 0

    def add(self, value: float) -> "FloatStats":
        self.count += 1
        self.min = min(self.min, value)
        self.max = max(self.max, value)
        delta = value - self.mean
        self.mean += delta / self.count
        self._m2 += delta * (value - self.mean)
        return self

    def add_array(self, values: np.ndarray) -> "FloatStats":
        """Vectorized bulk update (Chan et al. parallel merge): one call per
        eval instead of one host call per step."""
        values = np.asarray(values, np.float64).ravel()
        n = values.size
        if n == 0:
            return self
        self.min = min(self.min, float(values.min()))
        self.max = max(self.max, float(values.max()))
        mean = float(values.mean())
        delta = mean - self.mean
        total = self.count + n
        self._m2 += float(values.var()) * n + delta ** 2 * self.count * n / total
        self.mean += delta * n / total
        self.count = total
        return self

    @property
    def std(self) -> float:
        return float(np.sqrt(self._m2 / max(1, self.count)))

    def items(self) -> tp.Iterator[tp.Tuple[str, float]]:
        yield from (("min", self.min), ("max", self.max),
                    ("mean", self.mean), ("std", self.std))


class PhysicsAggregator:
    """Aggregates named physics scalars over rollouts."""

    def __init__(self, domain: str,
                 features_fn: tp.Optional[tp.Callable[[torch.Tensor], torch.Tensor]] = None
                 ) -> None:
        self.names = _FEATURE_NAMES.get(domain, ())
        self._features_fn = features_fn
        self.stats: tp.Dict[str, FloatStats] = {}

    def _features(self, physics: tp.Any) -> np.ndarray:
        physics = torch.as_tensor(physics)
        feats = physics if self._features_fn is None else self._features_fn(physics)
        return feats.detach().cpu().numpy()

    def add(self, physics: tp.Any) -> None:
        feats = self._features(physics)
        for i, name in enumerate(self.names):
            if i < feats.shape[-1]:
                self.stats.setdefault(name, FloatStats()).add(float(feats[..., i].mean()))

    def add_batch(self, physics_batch: tp.Any) -> None:
        """Aggregate a whole [N, physics_dim] batch: the features are computed
        once on the batch's device, copied to the host once, and the
        per-feature update is vectorized."""
        feats = self._features(physics_batch)
        for i, name in enumerate(self.names):
            if i < feats.shape[-1]:
                self.stats.setdefault(name, FloatStats()).add_array(feats[..., i])

    def dump(self) -> tp.Iterator[tp.Tuple[str, float]]:
        for name, stat in self.stats.items():
            for sname, val in stat.items():
                yield (f"phys_{name}_{sname}", float(val))
        self.stats.clear()
