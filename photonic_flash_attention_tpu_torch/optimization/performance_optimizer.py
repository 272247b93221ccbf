"""Workload profiling + adaptive operation wrapper.

The rebirth of reference optimization/performance_optimizer.py:40-524:
``WorkloadProfiler`` (start/end profiling records, rolling-window
workload classification into inference/training/batch/streaming,
:117-246) and ``AdaptiveOptimizer.optimize_operation`` (profile + cache
wrapper, :354-499), plus the ``@optimize_function`` decorator (:509+).

On TPU the honest additions are: wall-time measured with completion
forcing (see bench.py), and ``jax.profiler`` trace hooks for deep dives.

Port of ``photonic_flash_attention_tpu/optimization/performance_optimizer.py``:
a copy, except that ``optimize_operation`` waits for the output's CUDA
device (``torch.cuda.synchronize``) before the profile ends, where JAX
calls ``jax.block_until_ready``, so the profiled time is the device's
work and not only its launch. A cached hit returns the stored output and
launches nothing.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import uuid
from collections import deque
from typing import Any, Callable, Deque, Dict, Optional

import torch

from ..utils.logging import get_logger
from .caching import ResultCache, cache_key

logger = get_logger("perf_opt")


@dataclasses.dataclass
class ProfileRecord:
    profile_id: str
    operation: str
    started_at: float
    ended_at: Optional[float] = None
    metadata: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def duration_ms(self) -> Optional[float]:
        if self.ended_at is None:
            return None
        return (self.ended_at - self.started_at) * 1e3


class WorkloadProfiler:
    """Start/end profiling + workload classification (reference :117-246)."""

    WINDOW = 100

    def __init__(self) -> None:
        self._active: Dict[str, ProfileRecord] = {}
        self._completed: Deque[ProfileRecord] = deque(maxlen=self.WINDOW)
        self._lock = threading.RLock()

    def start_profiling(self, operation: str, **metadata: Any) -> str:
        pid = uuid.uuid4().hex[:12]
        with self._lock:
            self._active[pid] = ProfileRecord(pid, operation, time.perf_counter(), None, metadata)
        return pid

    def end_profiling(self, profile_id: str) -> Optional[ProfileRecord]:
        with self._lock:
            rec = self._active.pop(profile_id, None)
            if rec is None:
                return None
            rec.ended_at = time.perf_counter()
            self._completed.append(rec)
            return rec

    def classify_workload(self) -> str:
        """inference / training / batch / streaming (reference :200-246)."""
        with self._lock:
            recent = list(self._completed)[-20:]
        if not recent:
            return "unknown"
        batch_sizes = [r.metadata.get("batch_size", 1) for r in recent]
        has_grad = any(r.metadata.get("training") for r in recent)
        if has_grad:
            return "training"
        mean_batch = sum(batch_sizes) / len(batch_sizes)
        if mean_batch >= 8:
            return "batch"
        # streaming = steady arrival of small requests
        if len(recent) >= 10 and mean_batch <= 2:
            spans = [r.started_at for r in recent]
            gaps = [b - a for a, b in zip(spans, spans[1:])]
            if gaps and max(gaps) < 2 * (sum(gaps) / len(gaps) + 1e-9):
                return "streaming"
        return "inference"

    def summary(self) -> Dict:
        with self._lock:
            recs = list(self._completed)
        per_op: Dict[str, list] = {}
        for r in recs:
            per_op.setdefault(r.operation, []).append(r.duration_ms or 0.0)
        return {
            "workload_class": self.classify_workload(),
            "operations": {
                op: {
                    "count": len(ds),
                    "mean_ms": sum(ds) / len(ds),
                    "max_ms": max(ds),
                }
                for op, ds in per_op.items()
            },
        }


class AdaptiveOptimizer:
    """Profile + memoize wrapper (reference AdaptiveOptimizer :354-499)."""

    def __init__(self, cache: Optional[ResultCache] = None) -> None:
        self.profiler = WorkloadProfiler()
        self.cache = cache or ResultCache(capacity=128, ttl_s=600)

    def optimize_operation(
        self,
        fn: Callable,
        *args: Any,
        operation: Optional[str] = None,
        cacheable: bool = False,
        **kwargs: Any,
    ) -> Any:
        op = operation or getattr(fn, "__qualname__", "op")
        if cacheable:
            key = (op,) + cache_key(*args, **kwargs)
            sentinel = object()
            hit = self.cache.get(key, sentinel)
            if hit is not sentinel:
                return hit
        pid = self.profiler.start_profiling(
            op, batch_size=_batch_of(args), training=False
        )
        try:
            out = fn(*args, **kwargs)
            _block_until_ready(out)
        finally:
            self.profiler.end_profiling(pid)
        if cacheable:
            self.cache.put(key, out)
        return out

    def optimized(self, operation: Optional[str] = None, cacheable: bool = False):
        """``@optimize_function`` decorator (reference :509+)."""

        def deco(fn: Callable) -> Callable:
            def wrapper(*args: Any, **kwargs: Any) -> Any:
                op = operation or getattr(fn, "__qualname__", "op")
                if cacheable:
                    key = (op,) + cache_key(*args, **kwargs)
                    sentinel = object()
                    hit = self.cache.get(key, sentinel)
                    if hit is not sentinel:
                        return hit
                pid = self.profiler.start_profiling(op, batch_size=_batch_of(args))
                try:
                    out = fn(*args, **kwargs)
                finally:
                    self.profiler.end_profiling(pid)
                if cacheable:
                    self.cache.put(key, out)
                return out

            return wrapper

        return deco

    def get_stats(self) -> Dict:
        return {
            "profiler": self.profiler.summary(),
            "cache": self.cache.stats.as_dict(),
        }


def _block_until_ready(out: Any) -> None:
    """Wait for the device of every CUDA tensor in ``out`` (a tensor or a
    tuple, list or dict of them)."""
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
    elif isinstance(out, (tuple, list)):
        for o in out:
            _block_until_ready(o)
    elif isinstance(out, dict):
        for o in out.values():
            _block_until_ready(o)


def _batch_of(args: tuple) -> int:
    for a in args:
        if hasattr(a, "shape") and getattr(a, "ndim", 0) >= 1:
            return int(a.shape[0])
    return 1


_optimizer: Optional[AdaptiveOptimizer] = None
_opt_lock = threading.Lock()


def get_performance_optimizer() -> AdaptiveOptimizer:
    """Singleton (reference get_performance_optimizer)."""
    global _optimizer
    if _optimizer is None:
        with _opt_lock:
            if _optimizer is None:
                _optimizer = AdaptiveOptimizer()
    return _optimizer
