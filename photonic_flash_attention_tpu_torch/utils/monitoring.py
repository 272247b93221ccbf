"""Lightweight metric rings and device memory telemetry.

Port of ``photonic_flash_attention_tpu/utils/monitoring.py``: the same
``MetricRing``, ``MetricRegistry`` and process-wide ``get_metrics``, which
the attention engine records its per-call latency and energy into.
``device_memory_stats`` reads ``torch.cuda.memory_stats`` where the JAX one
reads ``jax.Device.memory_stats``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Deque, Dict, Optional, Tuple

import torch


class MetricRing:
    """Fixed-capacity rolling metric window."""

    def __init__(self, capacity: int = 256) -> None:
        self._values: Deque[Tuple[float, float]] = deque(maxlen=capacity)
        self._lock = threading.Lock()

    def record(self, value: float, timestamp: Optional[float] = None) -> None:
        with self._lock:
            self._values.append((timestamp or time.time(), float(value)))

    def __len__(self) -> int:
        return len(self._values)

    def summary(self) -> Dict[str, float]:
        with self._lock:
            vals = [v for _, v in self._values]
        if not vals:
            return {"count": 0}
        vals_sorted = sorted(vals)
        n = len(vals)
        return {
            "count": n,
            "mean": sum(vals) / n,
            "min": vals_sorted[0],
            "max": vals_sorted[-1],
            "p50": vals_sorted[n // 2],
            "p95": vals_sorted[min(n - 1, int(n * 0.95))],
            "last": vals[-1],
        }


class MetricRegistry:
    """Named metric rings with a single snapshot call."""

    def __init__(self) -> None:
        self._rings: Dict[str, MetricRing] = {}
        self._lock = threading.Lock()

    def ring(self, name: str) -> MetricRing:
        with self._lock:
            if name not in self._rings:
                self._rings[name] = MetricRing()
            return self._rings[name]

    def record(self, name: str, value: float) -> None:
        self.ring(name).record(value)

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            items = list(self._rings.items())
        return {name: ring.summary() for name, ring in items}


_registry: Optional[MetricRegistry] = None
_registry_lock = threading.Lock()


def get_metrics() -> MetricRegistry:
    """The process-wide metric registry."""
    global _registry
    if _registry is None:
        with _registry_lock:
            if _registry is None:
                _registry = MetricRegistry()
    return _registry


def device_memory_stats(device: Any = None) -> Dict[str, Any]:
    """Device memory in use, its limit and peak for one CUDA device (the
    current one by default); only the platform on a machine without CUDA."""
    if not torch.cuda.is_available():
        return {"platform": "cpu", "device": "cpu"}
    device = torch.device("cuda", torch.cuda.current_device()) if device is None else torch.device(device)
    stats = torch.cuda.memory_stats(device)
    limit = torch.cuda.get_device_properties(device).total_memory
    in_use = stats.get("allocated_bytes.all.current")
    return {
        "platform": "gpu",
        "device": torch.cuda.get_device_name(device),
        "bytes_in_use": in_use,
        "bytes_limit": limit,
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak"),
        "utilization": (in_use / limit) if (in_use and limit) else None,
    }
