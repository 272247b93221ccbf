"""Request scheduler of the serving engine.

Port of ``photonic_flash_attention_tpu/core/native_sched.py``: the
pure-Python ``PyRequestScheduler`` (priority admission queue, FIFO within a
priority, wait-time percentiles) and ``make_scheduler``. The C++ scheduler
the JAX package binds with ctypes comes in a later slice (ROADMAP A15), so
``make_scheduler`` returns the Python one.
"""

from __future__ import annotations

import bisect
import threading
import time
from typing import Dict, List, Optional


def _now_us() -> int:
    return int(time.monotonic() * 1e6)


class PyRequestScheduler:
    """Priority admission queue (same contract as the JAX package's)."""

    def __init__(self) -> None:
        self._entries: List = []  # sorted by (-priority, order)
        self._order = 0
        self._submit_us: Dict[int, int] = {}
        self._waits: List[int] = []
        self._admitted = 0
        self._cancelled = 0
        self._lock = threading.Lock()

    def submit(self, sid: int, priority: int = 0) -> None:
        with self._lock:
            bisect.insort(self._entries, (-priority, self._order, sid))
            self._order += 1
            self._submit_us[sid] = _now_us()

    def peek(self) -> Optional[int]:
        with self._lock:
            return self._entries[0][2] if self._entries else None

    def pop(self, sid: int) -> bool:
        """Admit ``sid``, wherever it sits in the queue, and record its wait.

        Best-fit admission takes requests from behind the head. The JAX
        package's schedulers pop only the head, so such a request stays
        queued and is admitted a second time later."""
        with self._lock:
            for i, (_, _, s) in enumerate(self._entries):
                if s == sid:
                    self._entries.pop(i)
                    t0 = self._submit_us.pop(sid, None)
                    if t0 is not None:
                        self._waits.append(_now_us() - t0)
                        self._waits = self._waits[-512:]
                    self._admitted += 1
                    return True
            return False

    def cancel(self, sid: int) -> bool:
        with self._lock:
            for i, (_, _, s) in enumerate(self._entries):
                if s == sid:
                    self._entries.pop(i)
                    self._submit_us.pop(sid, None)
                    self._cancelled += 1
                    return True
            return False

    def __len__(self) -> int:
        return len(self._entries)

    def waiting_ids(self, cap: int = 65536) -> List[int]:
        with self._lock:
            return [sid for (_, _, sid) in self._entries[:cap]]

    def stats(self) -> Dict[str, int]:
        with self._lock:
            waits = sorted(self._waits)

            def pct(p):
                return waits[int(p * (len(waits) - 1))] if waits else 0

            return {
                "waiting": len(self._entries),
                "admitted": self._admitted,
                "cancelled": self._cancelled,
                "wait_p50_us": pct(0.5),
                "wait_p95_us": pct(0.95),
                "wait_max_us": waits[-1] if waits else 0,
            }


def make_scheduler() -> PyRequestScheduler:
    """The engine's admission queue."""
    return PyRequestScheduler()
