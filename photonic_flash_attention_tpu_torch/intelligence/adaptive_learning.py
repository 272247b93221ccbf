"""Adaptive learning: workload pattern analysis + UCB1 kernel bandit.

The rebirth of reference intelligence/adaptive_learning.py:55-1024:

* ``WorkloadPatternAnalyzer`` (reference :55-450) — feature extraction
  over recent workloads and online k-means-style clustering into
  patterns, with per-pattern best-action statistics.
* ``AdaptiveDecisionEngine`` (reference :452-747) — combines pattern
  prediction, hard rules, and a **UCB1 multi-armed bandit** over kernel
  actions (:615-637), with the reward built from normalized latency /
  throughput terms (:669-697). The reference's arms were
  {gpu, photonic, hybrid, auto}; ours are the real kernel registry
  {fused, flash, flash_fp8}.

This sits *beside* the measured-latency router (core/router.py): the
router exploits direct measurements; this engine generalizes across
workload patterns when direct measurements are missing.

Port of ``photonic_flash_attention_tpu/intelligence/adaptive_learning.py``,
which imports no JAX: a copy over the port's ``core/router.py``
(``KernelKind``, ``WorkloadCharacteristics``, whose kind values are JAX's)
and ``config.py``. The arms are kind values; an engine built with the
router's eligible kinds for a workload (``AdaptiveDecisionEngine(actions=
[k.value for k in eligible])``) chooses among the kernels the port would
launch for it.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import get_config
from ..core.router import KernelKind, WorkloadCharacteristics
from ..utils.logging import get_logger

logger = get_logger("adaptive")


def workload_features(w: WorkloadCharacteristics) -> np.ndarray:
    """Feature vector (reference 14-dim extraction :55-150, trimmed to the
    dimensions that exist on TPU)."""
    return np.array(
        [
            math.log2(max(w.batch_size, 1)),
            math.log2(max(w.q_len, 1)),
            math.log2(max(w.kv_len, 1)),
            math.log2(max(w.num_heads, 1)),
            math.log2(max(w.head_dim, 1)),
            1.0 if w.causal else 0.0,
            1.0 if w.is_decode else 0.0,
            1.0 if w.has_mask else 0.0,
            math.log2(max(w.total_flops, 1.0)) / 50.0,
        ],
        dtype=np.float32,
    )


class WorkloadPatternAnalyzer:
    """Online k-means-ish clustering (reference :55-450)."""

    def __init__(self, max_patterns: int = 8, distance_threshold: float = 1.5) -> None:
        self.max_patterns = max_patterns
        self.distance_threshold = distance_threshold
        self.centroids: List[np.ndarray] = []
        self.counts: List[int] = []
        # per-pattern, per-action reward stats
        self.action_rewards: List[Dict[str, Tuple[float, int]]] = []
        self._lock = threading.RLock()

    def assign(self, features: np.ndarray) -> int:
        """Return the pattern id for a workload, creating one if novel."""
        with self._lock:
            if self.centroids:
                dists = [float(np.linalg.norm(features - c)) for c in self.centroids]
                best = int(np.argmin(dists))
                if dists[best] <= self.distance_threshold or (
                    len(self.centroids) >= self.max_patterns
                ):
                    # online centroid update
                    n = self.counts[best] + 1
                    self.centroids[best] += (features - self.centroids[best]) / n
                    self.counts[best] = n
                    return best
            self.centroids.append(features.copy())
            self.counts.append(1)
            self.action_rewards.append({})
            return len(self.centroids) - 1

    def record_reward(self, pattern: int, action: str, reward: float) -> None:
        with self._lock:
            total, n = self.action_rewards[pattern].get(action, (0.0, 0))
            self.action_rewards[pattern][action] = (total + reward, n + 1)

    def best_action(self, pattern: int) -> Optional[str]:
        with self._lock:
            stats = self.action_rewards[pattern]
            if not stats:
                return None
            return max(stats, key=lambda a: stats[a][0] / max(stats[a][1], 1))

    def summary(self) -> Dict:
        with self._lock:
            return {
                "patterns": len(self.centroids),
                "counts": list(self.counts),
                "best_actions": [self.best_action(i) for i in range(len(self.centroids))],
            }


@dataclasses.dataclass
class Outcome:
    action: str
    latency_ms: float
    tokens: int

    def reward(self, latency_scale_ms: float = 10.0) -> float:
        """Normalized reward (reference _calculate_reward :669-697):
        latency term + throughput term, both squashed to [0, 1]."""
        lat_term = 1.0 / (1.0 + self.latency_ms / latency_scale_ms)
        thr = self.tokens / max(self.latency_ms, 1e-3)  # tokens/ms
        thr_term = thr / (1.0 + thr)
        return 0.5 * lat_term + 0.5 * thr_term


class UCB1Bandit:
    """UCB1 over kernel actions (reference _select_bandit_action :615-637)."""

    def __init__(self, actions: Sequence[str], c: float = 1.4) -> None:
        self.actions = list(actions)
        self.c = c
        self.counts = {a: 0 for a in self.actions}
        self.total_reward = {a: 0.0 for a in self.actions}
        self._lock = threading.RLock()

    def select(self, eligible: Optional[Sequence[str]] = None) -> str:
        with self._lock:
            pool = [a for a in (eligible or self.actions) if a in self.counts]
            untried = [a for a in pool if self.counts[a] == 0]
            if untried:
                return untried[0]
            total = sum(self.counts[a] for a in pool)
            def ucb(a: str) -> float:
                mean = self.total_reward[a] / self.counts[a]
                return mean + self.c * math.sqrt(math.log(total) / self.counts[a])
            return max(pool, key=ucb)

    def update(self, action: str, reward: float) -> None:
        with self._lock:
            if action not in self.counts:
                self.counts[action] = 0
                self.total_reward[action] = 0.0
            self.counts[action] += 1
            self.total_reward[action] += reward

    def stats(self) -> Dict:
        with self._lock:
            return {
                a: {
                    "count": self.counts[a],
                    "mean_reward": (
                        self.total_reward[a] / self.counts[a] if self.counts[a] else None
                    ),
                }
                for a in self.counts
            }


class AdaptiveDecisionEngine:
    """Rules + patterns + bandit (reference AdaptiveDecisionEngine :452-747)."""

    def __init__(
        self,
        actions: Sequence[str] = ("fused", "flash", "flash_fp8"),
        exploration_rate: float = 0.1,
        seed: int = 0,
    ) -> None:
        self.analyzer = WorkloadPatternAnalyzer()
        self.bandit = UCB1Bandit(actions)
        self.exploration_rate = exploration_rate
        self._rng = np.random.default_rng(seed)
        self._decisions: Deque[Tuple[int, str]] = deque(maxlen=1000)
        self._lock = threading.RLock()

    def make_decision(self, w: WorkloadCharacteristics) -> Dict:
        """Returns {action, confidence, source} (reference :558-637)."""
        cfg = get_config()
        # Hard rules first (reference's 4 rules :558-613, re-grounded):
        if w.need_weights or w.has_mask:
            return {"action": "fused", "confidence": 1.0, "source": "rule"}
        if max(w.q_len, w.kv_len) < cfg.flash_threshold // 4:
            return {"action": "fused", "confidence": 0.8, "source": "rule"}

        feats = workload_features(w)
        pattern = self.analyzer.assign(feats)
        explore = self._rng.random() < self.exploration_rate
        if not explore:
            best = self.analyzer.best_action(pattern)
            if best is not None:
                self._remember(pattern, best)
                return {
                    "action": best,
                    "confidence": 0.7,
                    "source": f"pattern_{pattern}",
                }
        action = self.bandit.select()
        self._remember(pattern, action)
        return {"action": action, "confidence": 0.5, "source": "bandit"}

    def _remember(self, pattern: int, action: str) -> None:
        with self._lock:
            self._decisions.append((pattern, action))

    def record_outcome(self, w: WorkloadCharacteristics, outcome: Outcome) -> None:
        """Feed back a result (reference record_outcome :639-667)."""
        r = outcome.reward()
        feats = workload_features(w)
        pattern = self.analyzer.assign(feats)
        self.analyzer.record_reward(pattern, outcome.action, r)
        self.bandit.update(outcome.action, r)

    def get_stats(self) -> Dict:
        return {
            "bandit": self.bandit.stats(),
            "patterns": self.analyzer.summary(),
            "decisions": len(self._decisions),
        }
