"""Request-level load balancing across serving replicas.

Rebirth of reference scaling/load_balancer.py:21-558: the same strategy
set — round-robin / least-connections / weighted-RR / performance-aware /
consistent-hash ring (150 virtual replicas, :287-385) — plus sticky
sessions with timeout (:146-201) and ``execute_request`` with retry and
fallback (:386). Nodes here are serving replicas (one ``ServingEngine``
per host/process); health flips come from the health monitor rather than
a probe thread.

The port's copy of ``photonic_flash_attention_tpu/scaling/load_balancer.py``, which imports no
JAX: the port may not import the JAX package, so it keeps its own.
"""

from __future__ import annotations

import bisect
import dataclasses
import hashlib
import itertools
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ..utils.exceptions import DistributionError
from ..utils.logging import get_logger

logger = get_logger("load_balancer")

VIRTUAL_REPLICAS = 150  # reference ConsistentHashRing default


@dataclasses.dataclass
class BackendNode:
    node_id: str
    weight: float = 1.0
    healthy: bool = True
    active_requests: int = 0
    total_requests: int = 0
    failures: int = 0
    ema_latency_ms: float = 0.0

    def record(self, latency_ms: float, ok: bool) -> None:
        self.total_requests += 1
        if not ok:
            self.failures += 1
        if self.ema_latency_ms == 0.0:
            self.ema_latency_ms = latency_ms
        else:
            self.ema_latency_ms = 0.8 * self.ema_latency_ms + 0.2 * latency_ms


class ConsistentHashRing:
    """Hash ring with virtual replicas (reference :287-385)."""

    def __init__(self, virtual_replicas: int = VIRTUAL_REPLICAS) -> None:
        self.virtual_replicas = virtual_replicas
        self._ring: List[int] = []
        self._owners: Dict[int, str] = {}

    @staticmethod
    def _hash(key: str) -> int:
        return int(hashlib.md5(key.encode()).hexdigest()[:16], 16)

    def add(self, node_id: str) -> None:
        for i in range(self.virtual_replicas):
            h = self._hash(f"{node_id}#{i}")
            if h not in self._owners:
                bisect.insort(self._ring, h)
                self._owners[h] = node_id

    def remove(self, node_id: str) -> None:
        doomed = [h for h, n in self._owners.items() if n == node_id]
        for h in doomed:
            del self._owners[h]
            idx = bisect.bisect_left(self._ring, h)
            if idx < len(self._ring) and self._ring[idx] == h:
                self._ring.pop(idx)

    def lookup(self, key: str) -> Optional[str]:
        if not self._ring:
            return None
        h = self._hash(key)
        idx = bisect.bisect_right(self._ring, h) % len(self._ring)
        return self._owners[self._ring[idx]]


class LoadBalancer:
    """Strategy-driven node selection (reference LoadBalancer :203)."""

    STRATEGIES = (
        "round_robin",
        "least_connections",
        "weighted_round_robin",
        "performance",
        "consistent_hash",
    )

    def __init__(
        self,
        strategy: str = "least_connections",
        session_timeout_s: float = 300.0,
    ) -> None:
        if strategy not in self.STRATEGIES:
            raise DistributionError(f"unknown strategy {strategy!r}")
        self.strategy = strategy
        self.session_timeout_s = session_timeout_s
        self._nodes: Dict[str, BackendNode] = {}
        self._ring = ConsistentHashRing()
        self._rr = itertools.count()
        self._sessions: Dict[str, tuple] = {}  # session -> (node_id, ts)
        self._lock = threading.RLock()

    # -- membership ---------------------------------------------------------

    def add_node(self, node_id: str, weight: float = 1.0) -> None:
        with self._lock:
            self._nodes[node_id] = BackendNode(node_id, weight)
            self._ring.add(node_id)

    def remove_node(self, node_id: str) -> None:
        with self._lock:
            self._nodes.pop(node_id, None)
            self._ring.remove(node_id)
            self._sessions = {
                s: (n, t) for s, (n, t) in self._sessions.items() if n != node_id
            }

    def set_health(self, node_id: str, healthy: bool) -> None:
        with self._lock:
            if node_id in self._nodes:
                self._nodes[node_id].healthy = healthy

    # -- selection ------------------------------------------------------------

    def _healthy(self) -> List[BackendNode]:
        return [n for n in self._nodes.values() if n.healthy]

    def select_node(self, session_id: Optional[str] = None) -> str:
        with self._lock:
            healthy = self._healthy()
            if not healthy:
                raise DistributionError("no healthy nodes")

            # sticky sessions (reference SessionManager :146-201)
            if session_id is not None:
                entry = self._sessions.get(session_id)
                if entry is not None:
                    node_id, ts = entry
                    node = self._nodes.get(node_id)
                    if (
                        node is not None
                        and node.healthy
                        and time.time() - ts < self.session_timeout_s
                    ):
                        self._sessions[session_id] = (node_id, time.time())
                        return node_id

            node_id = self._pick(healthy, session_id)
            if session_id is not None:
                self._sessions[session_id] = (node_id, time.time())
            return node_id

    def _pick(self, healthy: List[BackendNode], session_id: Optional[str]) -> str:
        if self.strategy == "round_robin":
            return healthy[next(self._rr) % len(healthy)].node_id
        if self.strategy == "least_connections":
            return min(healthy, key=lambda n: n.active_requests).node_id
        if self.strategy == "weighted_round_robin":
            expanded = [n for node in healthy for n in [node] * max(1, int(node.weight))]
            return expanded[next(self._rr) % len(expanded)].node_id
        if self.strategy == "performance":
            return min(
                healthy,
                key=lambda n: (n.ema_latency_ms or 1e-3) * (1 + n.active_requests),
            ).node_id
        # consistent_hash
        key = session_id or str(next(self._rr))
        node_id = self._ring.lookup(key)
        node = self._nodes.get(node_id) if node_id else None
        if node is None or not node.healthy:
            return min(healthy, key=lambda n: n.active_requests).node_id
        return node_id

    # -- execution -------------------------------------------------------------

    def execute_request(
        self,
        fn: Callable[[str], Any],
        session_id: Optional[str] = None,
        max_retries: int = 2,
    ) -> Any:
        """Run ``fn(node_id)`` with retry-on-other-node (reference :386)."""
        last_err: Optional[BaseException] = None
        tried: set = set()
        for _ in range(max_retries + 1):
            with self._lock:
                candidates = [n for n in self._healthy() if n.node_id not in tried]
            if not candidates:
                break
            node_id = self.select_node(session_id)
            if node_id in tried:
                node_id = candidates[0].node_id
            node = self._nodes[node_id]
            tried.add(node_id)
            with self._lock:
                node.active_requests += 1
            t0 = time.perf_counter()
            try:
                out = fn(node_id)
                node.record((time.perf_counter() - t0) * 1e3, ok=True)
                return out
            except Exception as e:  # noqa: BLE001 - retry on any node failure
                node.record((time.perf_counter() - t0) * 1e3, ok=False)
                last_err = e
                logger.warning("node %s failed: %s; retrying", node_id, e)
            finally:
                with self._lock:
                    node.active_requests -= 1
        raise DistributionError(f"all nodes failed: {last_err}")

    def get_stats(self) -> Dict:
        with self._lock:
            return {
                "strategy": self.strategy,
                "nodes": {
                    n.node_id: {
                        "healthy": n.healthy,
                        "active": n.active_requests,
                        "total": n.total_requests,
                        "failures": n.failures,
                        "ema_latency_ms": round(n.ema_latency_ms, 3),
                    }
                    for n in self._nodes.values()
                },
                "sessions": len(self._sessions),
            }
