"""Autoscaling decisions from serving metrics.

Rebirth of reference scaling/distributed_computing.py:805-1251
``AutoScalingOrchestrator``: scale decisions from utilization / queue
backlog / success-rate with trend-based load prediction (:934-1025),
cooldowns, scaling history and a cost report (:1220-1245). This emits
*decisions* (target replica counts) — executing them belongs to the
deployment layer; the reference "executed" them by appending to a list,
which is the same thing with less honesty.

The port's copy of ``photonic_flash_attention_tpu/scaling/autoscaler.py``, which imports no
JAX: the port may not import the JAX package, so it keeps its own.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional

from ..utils.logging import get_logger

logger = get_logger("autoscaler")

#: per-replica cost model, $/hour (public on-demand list prices, rounded)
REPLICA_COST_PER_HOUR = {"v5e-1": 1.2, "v5e-4": 4.8, "v5p-1": 4.2, "v6e-1": 2.7}
#: startup-time model, seconds (reference :835-839's startup-time analogue)
REPLICA_STARTUP_S = {"v5e-1": 120.0, "v5e-4": 180.0, "v5p-1": 240.0, "v6e-1": 150.0}


@dataclasses.dataclass
class MetricSample:
    utilization: float  # 0..1 across replicas
    queue_depth: int
    success_rate: float  # 0..1
    timestamp: float = dataclasses.field(default_factory=time.time)


@dataclasses.dataclass
class ScalingDecision:
    action: str  # "scale_up" | "scale_down" | "hold"
    current_replicas: int
    target_replicas: int
    reason: str
    predicted_utilization: float
    timestamp: float = dataclasses.field(default_factory=time.time)


class AutoScalingOrchestrator:
    """Decision engine with trend prediction + cooldowns (reference)."""

    def __init__(
        self,
        min_replicas: int = 1,
        max_replicas: int = 16,
        replica_type: str = "v5e-1",
        scale_up_threshold: float = 0.8,
        scale_down_threshold: float = 0.3,
        cooldown_s: float = 60.0,
        window: int = 20,
    ) -> None:
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.replica_type = replica_type
        self.scale_up_threshold = scale_up_threshold
        self.scale_down_threshold = scale_down_threshold
        self.cooldown_s = cooldown_s
        self.replicas = min_replicas
        self._metrics: Deque[MetricSample] = deque(maxlen=window)
        self._history: List[ScalingDecision] = []
        self._last_action_ts = 0.0
        self._lock = threading.RLock()

    # -- inputs -----------------------------------------------------------

    def record_metrics(
        self, utilization: float, queue_depth: int = 0, success_rate: float = 1.0
    ) -> None:
        with self._lock:
            self._metrics.append(MetricSample(utilization, queue_depth, success_rate))

    def _predict_utilization(self) -> float:
        """Linear trend over the window (reference _predict_future_load
        :1012-1025), extrapolated one cooldown ahead."""
        with self._lock:
            samples = list(self._metrics)
        if not samples:
            return 0.0
        if len(samples) < 3:
            return samples[-1].utilization
        t0 = samples[0].timestamp
        xs = [s.timestamp - t0 for s in samples]
        ys = [s.utilization for s in samples]
        n = len(xs)
        mx, my = sum(xs) / n, sum(ys) / n
        denom = sum((x - mx) ** 2 for x in xs) or 1e-9
        slope = sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / denom
        horizon = xs[-1] + self.cooldown_s
        return max(0.0, min(1.5, my + slope * (horizon - mx)))

    # -- decisions -----------------------------------------------------------

    def make_decision(self) -> ScalingDecision:
        """One tick of the reference's 30s loop (:934-1010)."""
        with self._lock:
            now = time.time()
            latest = self._metrics[-1] if self._metrics else None
            predicted = self._predict_utilization()
            cur = self.replicas

            def hold(reason: str) -> ScalingDecision:
                return ScalingDecision("hold", cur, cur, reason, predicted)

            if latest is None:
                decision = hold("no metrics")
            elif now - self._last_action_ts < self.cooldown_s:
                decision = hold("cooldown")
            elif (
                max(latest.utilization, predicted) >= self.scale_up_threshold
                or latest.queue_depth > 2 * cur
                or latest.success_rate < 0.95
            ) and cur < self.max_replicas:
                target = min(self.max_replicas, cur + max(1, cur // 2))
                decision = ScalingDecision(
                    "scale_up",
                    cur,
                    target,
                    f"util={latest.utilization:.2f} pred={predicted:.2f} "
                    f"queue={latest.queue_depth} ok={latest.success_rate:.2f}",
                    predicted,
                )
            elif (
                max(latest.utilization, predicted) <= self.scale_down_threshold
                and latest.queue_depth == 0
                and cur > self.min_replicas
            ):
                decision = ScalingDecision(
                    "scale_down",
                    cur,
                    max(self.min_replicas, cur - 1),
                    f"util={latest.utilization:.2f} pred={predicted:.2f}",
                    predicted,
                )
            else:
                decision = hold("within thresholds")

            if decision.action != "hold":
                self.replicas = decision.target_replicas
                self._last_action_ts = now
                logger.info(
                    "autoscale %s: %d -> %d (%s)",
                    decision.action,
                    decision.current_replicas,
                    decision.target_replicas,
                    decision.reason,
                )
            self._history.append(decision)
            if len(self._history) > 1000:
                del self._history[:500]
            return decision

    # -- reporting -----------------------------------------------------------

    def get_scaling_status(self) -> Dict:
        with self._lock:
            return {
                "replicas": self.replicas,
                "replica_type": self.replica_type,
                "bounds": [self.min_replicas, self.max_replicas],
                "predicted_utilization": self._predict_utilization(),
                "recent_decisions": [
                    dataclasses.asdict(d) for d in self._history[-5:]
                ],
            }

    def cost_report(self) -> Dict:
        """Scaling cost accounting (reference :1220-1245)."""
        rate = REPLICA_COST_PER_HOUR.get(self.replica_type, 2.0)
        with self._lock:
            events = [d for d in self._history if d.action != "hold"]
            return {
                "replica_type": self.replica_type,
                "current_replicas": self.replicas,
                "hourly_cost_usd": round(self.replicas * rate, 2),
                "scaling_events": len(events),
                "startup_time_s": REPLICA_STARTUP_S.get(self.replica_type, 180.0),
            }
