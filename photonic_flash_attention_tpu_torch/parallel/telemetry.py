"""Collective telemetry: per-axis communication accounting.

Port of ``photonic_flash_attention_tpu/parallel/telemetry.py``
(``collective_bytes`` :36, ``CollectiveTelemetry`` :67, ``get_telemetry``
:174): the same analytic byte counts per (mesh axis, collective), recorded
on the host by the callers (``parallel/ring.py``, ``parallel/ulysses.py``),
and the same busy-fraction estimate over a 10 s window with the congestion
threshold of 0.8. The link rate is the card's interconnect figure from
``hardware/detection.py`` (NVLink on the H100: 450 GB/s each way, NVIDIA's
data sheet), JAX's ``ici_gbps``; a process without a card takes the H100's
row, the card the port targets. The estimate counts bytes, it times
nothing: NCCL's own time is read on the card by CUDA events
(``chip_smoke.py``).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import defaultdict
from typing import Dict, Optional

import torch

from ..hardware.detection import _CAPABILITY_TABLE, known_capabilities
from ..utils.logging import get_logger

logger = get_logger("telemetry")

CONGESTION_THRESHOLD = 0.8


def collective_bytes(op: str, shard_bytes: int, axis_size: int) -> int:
    """Bytes a rank moves for one collective over an axis (ring algorithms)."""
    if axis_size <= 1:
        return 0
    if op == "ppermute":
        return shard_bytes
    if op == "all_gather":
        return shard_bytes * (axis_size - 1)
    if op == "psum":  # ring all-reduce = reduce-scatter + all-gather
        return 2 * shard_bytes * (axis_size - 1) // axis_size
    if op in ("reduce_scatter", "all_to_all"):
        return shard_bytes * (axis_size - 1) // axis_size
    return shard_bytes


def default_link_gbps() -> float:
    """The interconnect rate (GB/s each way) of this process's card; the
    H100's without one."""
    caps = known_capabilities()
    if caps is None or caps.ici_gbps <= 0.0:
        caps = _CAPABILITY_TABLE["h100"]
    return caps.ici_gbps


@dataclasses.dataclass
class AxisStats:
    bytes_total: int = 0
    ops: int = 0
    by_op: Dict[str, int] = dataclasses.field(default_factory=lambda: defaultdict(int))
    window_start: float = dataclasses.field(default_factory=time.time)
    window_bytes: int = 0
    #: Least seconds of link time the window's bytes need at the full rate.
    window_busy_s: float = 0.0


class CollectiveTelemetry:
    """Per-axis byte and utilization accounting."""

    WINDOW_S = 10.0

    def __init__(self, link_gbps: Optional[float] = None) -> None:
        self.link_gbps = max(link_gbps if link_gbps is not None else default_link_gbps(), 1e-3)
        self._axes: Dict[str, AxisStats] = defaultdict(AxisStats)
        self._lock = threading.RLock()
        self._congestion_events = 0
        self._last_congestion_log: Dict[str, float] = {}

    def record(self, axis: str, op: str, shard_bytes: int, axis_size: int) -> None:
        moved = collective_bytes(op, shard_bytes, axis_size)
        now = time.time()
        with self._lock:
            st = self._axes[axis]
            st.bytes_total += moved
            st.ops += 1
            st.by_op[op] += moved
            if now - st.window_start > self.WINDOW_S:
                st.window_start = now
                st.window_bytes = 0
                st.window_busy_s = 0.0
            st.window_bytes += moved
            st.window_busy_s += moved / (self.link_gbps * 1e9)
            if self.utilization(axis) >= CONGESTION_THRESHOLD:
                self._congestion_events += 1
                # One log line per window and axis.
                if now - self._last_congestion_log.get(axis, 0.0) > self.WINDOW_S:
                    self._last_congestion_log[axis] = now
                    level = logger.warning if torch.cuda.is_available() else logger.info
                    level("axis %s congested (analytic estimate: recorded traffic needs %.0f%% "
                          "of link time this window)", axis, 100 * self.utilization(axis))

    def utilization(self, axis: str) -> float:
        """Analytic busy fraction of the window, in [0, 1]: the least link
        time of its bytes over the window's wall clock (floored by that
        busy time). A lower bound on pressure; it times no transfer."""
        st = self._axes.get(axis)
        if st is None:
            return 0.0
        elapsed = max(time.time() - st.window_start, 1e-3)
        return st.window_busy_s / max(elapsed, st.window_busy_s)

    def record_array(self, axis: str, op: str, x: torch.Tensor, axis_size: int) -> None:
        self.record(axis, op, x.numel() * x.element_size(), axis_size)

    def get_stats(self) -> Dict:
        with self._lock:
            return {
                "link_gbps": self.link_gbps,
                "congestion_events": self._congestion_events,
                "utilization_note": (
                    "analytic lower-bound busy fraction (bytes / link bandwidth vs window "
                    "wall-clock), capped at 1.0"
                ),
                "axes": {
                    name: {
                        "bytes_total": st.bytes_total,
                        "ops": st.ops,
                        "by_op": dict(st.by_op),
                        "utilization": self.utilization(name),
                    }
                    for name, st in self._axes.items()
                },
            }

    def reset(self) -> None:
        with self._lock:
            self._axes.clear()
            self._congestion_events = 0


_telemetry: Optional[CollectiveTelemetry] = None
_tel_lock = threading.Lock()


def get_telemetry() -> CollectiveTelemetry:
    global _telemetry
    if _telemetry is None:
        with _tel_lock:
            if _telemetry is None:
                _telemetry = CollectiveTelemetry()
    return _telemetry
