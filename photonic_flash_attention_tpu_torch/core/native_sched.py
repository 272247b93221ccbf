"""Request scheduler of the serving engine: native (C++) and Python.

Port of ``photonic_flash_attention_tpu/core/native_sched.py``: the priority
admission queue (FIFO within a priority, higher priority first, wait-time
percentiles) as ``NativeRequestScheduler``, bound with ctypes to the port's
copy of ``native/request_scheduler.cpp`` (built with g++ at first use into
``_build/``, ``ops/_build.py::host_library``), and its pure-Python twin
``PyRequestScheduler``. ``make_scheduler`` prefers the native one and keeps
the Python one where the library cannot be built (a host without g++).

Both schedulers' ``pop`` admits a request wherever it sits in the queue.
The JAX package's pop only a queue's head, so best-fit admission admits a
request from behind the head twice there (ROADMAP, known faults).
"""

from __future__ import annotations

import bisect
import ctypes
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Union

from ..ops import _build
from ..utils.logging import get_logger

logger = get_logger("native_sched")

SOURCE = Path(__file__).resolve().parent.parent / "native" / "request_scheduler.cpp"


def library_path() -> Path:
    """The built library (built now if it is not there yet)."""
    return _build.host_library(SOURCE, "sched")


def load() -> ctypes.CDLL:
    """The loaded scheduler library, its C signatures set; raises if it
    cannot be built."""
    lib = _build.load_host_library(SOURCE, "sched")
    lib.pfa_sched_create.restype = ctypes.c_void_p
    lib.pfa_sched_destroy.argtypes = [ctypes.c_void_p]
    lib.pfa_sched_submit.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
                                     ctypes.c_int64]
    lib.pfa_sched_peek.argtypes = [ctypes.c_void_p]
    lib.pfa_sched_peek.restype = ctypes.c_int64
    lib.pfa_sched_pop.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]
    lib.pfa_sched_pop.restype = ctypes.c_int32
    lib.pfa_sched_cancel.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.pfa_sched_cancel.restype = ctypes.c_int32
    lib.pfa_sched_count.argtypes = [ctypes.c_void_p]
    lib.pfa_sched_count.restype = ctypes.c_int64
    lib.pfa_sched_waiting.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
                                      ctypes.c_int64]
    lib.pfa_sched_waiting.restype = ctypes.c_int64
    lib.pfa_sched_stats.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
    return lib


def native_available() -> bool:
    try:
        load()
        return True
    except Exception as e:  # noqa: BLE001 - reported, and the caller keeps Python
        logger.warning("native scheduler unavailable: %s", e)
        return False


def _now_us() -> int:
    return int(time.monotonic() * 1e6)


class NativeRequestScheduler:
    """Priority admission queue backed by the C++ library."""

    def __init__(self) -> None:
        self._lib = load()
        self._h = ctypes.c_void_p(self._lib.pfa_sched_create())

    def __del__(self) -> None:
        h = getattr(self, "_h", None)
        if h:
            self._lib.pfa_sched_destroy(h)
            self._h = None

    def submit(self, sid: int, priority: int = 0) -> None:
        self._lib.pfa_sched_submit(self._h, sid, priority, _now_us())

    def peek(self) -> Optional[int]:
        sid = self._lib.pfa_sched_peek(self._h)
        return None if sid < 0 else int(sid)

    def pop(self, sid: int) -> bool:
        """Admit ``sid``, wherever it sits in the queue, and record its wait."""
        return self._lib.pfa_sched_pop(self._h, sid, _now_us()) == 0

    def cancel(self, sid: int) -> bool:
        return self._lib.pfa_sched_cancel(self._h, sid) == 0

    def __len__(self) -> int:
        return int(self._lib.pfa_sched_count(self._h))

    def waiting_ids(self, cap: int = 65536) -> List[int]:
        buf = (ctypes.c_int64 * cap)()
        n = self._lib.pfa_sched_waiting(self._h, buf, cap)
        return [int(buf[i]) for i in range(n)]

    def stats(self) -> Dict[str, int]:
        out = (ctypes.c_int64 * 6)()
        self._lib.pfa_sched_stats(self._h, out)
        keys = ("waiting", "admitted", "cancelled", "wait_p50_us", "wait_p95_us", "wait_max_us")
        return dict(zip(keys, [int(v) for v in out]))


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
        """Admit ``sid``, wherever it sits in the queue, and record its wait
        (best-fit admission takes requests from behind the head)."""
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


def make_scheduler() -> Union[NativeRequestScheduler, PyRequestScheduler]:
    """The engine's admission queue: native when buildable, Python otherwise."""
    if native_available():
        return NativeRequestScheduler()
    return PyRequestScheduler()
