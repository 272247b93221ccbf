"""Health + pressure monitoring mapped to real TPU signals.

The rebirth of the reference's monitors (reference
monitoring/health_monitor.py:20-606 pluggable checks + background loop +
alert callbacks; monitoring/thermal_monitor.py:17-785 5-state machine
with hysteresis). A TPU VM exposes no die temperature through JAX, so the
"thermal" state machine is re-grounded in the pressure signals that *do*
exist and matter for serving: HBM utilization, sustained kernel latency
inflation, and error rate. Same state ladder
(NORMAL/WARNING/THROTTLING/CRITICAL/EMERGENCY), same hysteresis
mechanics, honest inputs.

Port of ``photonic_flash_attention_tpu/monitoring/health.py``: a copy,
except the two device checks. ``device_reachable_check`` counts the CUDA
devices (``torch.cuda.device_count()``, where JAX counts
``jax.device_count()``); a process without CUDA has one device, the CPU,
as in ``hardware/detection.py`` and as JAX counts its CPU backend.
``hbm_utilization_check`` reads the port's
``utils/monitoring.py::device_memory_stats`` (the caching allocator's bytes
in use over the card's memory), UNKNOWN without a card.
"""

from __future__ import annotations

import dataclasses
import enum
import threading
import time
from typing import Callable, Dict, List, Optional

import torch

from ..utils.logging import get_logger
from ..utils.monitoring import MetricRing, device_memory_stats

logger = get_logger("health")


class HealthStatus(str, enum.Enum):
    HEALTHY = "healthy"
    DEGRADED = "degraded"
    CRITICAL = "critical"
    UNKNOWN = "unknown"


class PressureState(int, enum.Enum):
    """The thermal ladder reborn (reference ThermalThresholds :26-67)."""

    NORMAL = 0
    WARNING = 1
    THROTTLING = 2
    CRITICAL = 3
    EMERGENCY = 4


@dataclasses.dataclass
class HealthCheckResult:
    name: str
    status: HealthStatus
    message: str = ""
    value: Optional[float] = None
    timestamp: float = dataclasses.field(default_factory=time.time)


class HealthCheck:
    """Pluggable check (reference health_monitor.py:98-341)."""

    def __init__(self, name: str, fn: Callable[[], HealthCheckResult]) -> None:
        self.name = name
        self.fn = fn

    def run(self) -> HealthCheckResult:
        try:
            return self.fn()
        except Exception as e:  # noqa: BLE001 - a failing check is a result
            return HealthCheckResult(self.name, HealthStatus.CRITICAL, str(e)[:200])


def device_reachable_check() -> HealthCheckResult:
    """HEALTHY with the device count as its value: the CUDA devices, or the
    CPU alone without CUDA."""
    try:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 1
    except RuntimeError as e:
        return HealthCheckResult("device_reachable", HealthStatus.CRITICAL, str(e)[:200])
    return HealthCheckResult(
        "device_reachable", HealthStatus.HEALTHY, f"{n} device(s)", float(n)
    )


def hbm_utilization_check(warn: float = 0.85, crit: float = 0.95) -> HealthCheckResult:
    stats = device_memory_stats()
    util = stats.get("utilization")
    if util is None:
        return HealthCheckResult("hbm", HealthStatus.UNKNOWN, "no memory stats")
    status = (
        HealthStatus.CRITICAL
        if util >= crit
        else HealthStatus.DEGRADED if util >= warn else HealthStatus.HEALTHY
    )
    return HealthCheckResult("hbm", status, f"{util:.1%} in use", float(util))


class PressureMonitor:
    """Hysteresis state machine over a pressure metric in [0, 1].

    Thresholds mirror the reference's thermal ladder shape
    (65/75/85/95 -> here 0.65/0.75/0.85/0.95) with the same 5-unit
    (0.05) hysteresis on the way down (thermal_monitor.py:26-67).
    """

    THRESHOLDS = (0.65, 0.75, 0.85, 0.95)
    HYSTERESIS = 0.05

    def __init__(self) -> None:
        self.state = PressureState.NORMAL
        self._lock = threading.Lock()

    def update(self, pressure: float) -> PressureState:
        with self._lock:
            up = PressureState.NORMAL
            for i, th in enumerate(self.THRESHOLDS):
                if pressure >= th:
                    up = PressureState(i + 1)
            if up.value > self.state.value:
                self.state = up
            elif up.value < self.state.value:
                # require hysteresis margin below the current state's floor
                floor = self.THRESHOLDS[self.state.value - 1]
                if pressure < floor - self.HYSTERESIS:
                    self.state = up
            return self.state


class PressureTrend:
    """Trend + time-to-limit prediction over recent pressure samples
    (reference thermal_monitor.py:428-466's trend / time-to-limit)."""

    def __init__(self, window: int = 64) -> None:
        self.window = window
        self._samples: List[tuple] = []  # (t, pressure)
        self._lock = threading.Lock()

    def record(self, pressure: float, t: Optional[float] = None) -> None:
        with self._lock:
            self._samples.append((t if t is not None else time.time(), pressure))
            if len(self._samples) > self.window:
                self._samples.pop(0)

    def slope_per_s(self) -> Optional[float]:
        """Least-squares pressure slope; None with <3 samples."""
        with self._lock:
            pts = list(self._samples)
        if len(pts) < 3:
            return None
        t0 = pts[0][0]
        xs = [t - t0 for t, _ in pts]
        ys = [p for _, p in pts]
        n = len(xs)
        mx, my = sum(xs) / n, sum(ys) / n
        denom = sum((x - mx) ** 2 for x in xs)
        if denom == 0:
            return None
        return sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / denom

    def seconds_to(self, threshold: float) -> Optional[float]:
        """Projected seconds until pressure crosses ``threshold``;
        None when flat/declining or not enough data."""
        slope = self.slope_per_s()
        with self._lock:
            if not self._samples:
                return None
            current = self._samples[-1][1]
        if current >= threshold:
            return 0.0
        if slope is None or slope <= 1e-9:
            return None
        return (threshold - current) / slope


class PressureController:
    """State-transition -> action dispatch (reference per-state action
    lists, thermal_monitor.py:317-427). Actions are callbacks registered
    per state; the default wiring in :class:`ResilientAttentionWrapper`
    maps THROTTLING -> precision degradation and EMERGENCY -> load shed.
    """

    def __init__(self, monitor: Optional[PressureMonitor] = None) -> None:
        self.monitor = monitor or PressureMonitor()
        self.trend = PressureTrend()
        self._actions: Dict[PressureState, List[Callable[[PressureState], None]]] = {}
        self._lock = threading.Lock()
        self._transitions: List[tuple] = []

    def on_state(
        self, state: PressureState, action: Callable[[PressureState], None]
    ) -> None:
        with self._lock:
            self._actions.setdefault(state, []).append(action)

    def update(self, pressure: float) -> PressureState:
        prev = self.monitor.state
        state = self.monitor.update(pressure)
        self.trend.record(pressure)
        if state != prev:
            with self._lock:
                self._transitions.append((time.time(), prev.name, state.name))
                actions = list(self._actions.get(state, ()))
            logger.info("pressure %s -> %s (%.2f)", prev.name, state.name, pressure)
            for fn in actions:
                try:
                    fn(state)
                except Exception:  # noqa: BLE001 - actions must not kill updates
                    logger.exception("pressure action failed")
        return state

    def get_status(self) -> Dict:
        with self._lock:
            transitions = list(self._transitions[-10:])
        return {
            "state": self.monitor.state.name,
            "slope_per_s": self.trend.slope_per_s(),
            "seconds_to_critical": self.trend.seconds_to(
                PressureMonitor.THRESHOLDS[2]
            ),
            "recent_transitions": transitions,
        }


def pressure_protected(
    monitor_or_controller=None,
    max_state: PressureState = PressureState.CRITICAL,
    fallback: Optional[Callable] = None,
):
    """Gate a callable on the pressure state (reference
    ``@thermal_protected``, thermal_monitor.py:761+).

    At or above ``max_state`` the wrapped call is refused: the
    ``fallback`` runs instead when given, otherwise ``HardwareError``
    raises. Defaults to the global health monitor's pressure state.
    """
    import functools

    from ..utils.exceptions import HardwareError

    def state_of() -> PressureState:
        src = monitor_or_controller
        if src is None:
            return get_health_monitor().pressure.state
        if isinstance(src, PressureController):
            return src.monitor.state
        return src.state

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            state = state_of()
            if state.value >= max_state.value:
                if fallback is not None:
                    return fallback(*args, **kwargs)
                raise HardwareError(
                    f"call refused: pressure state {state.name} >= {max_state.name}"
                )
            return fn(*args, **kwargs)

        return wrapper

    return deco


class HealthMonitor:
    """Background health loop + alerts (reference health_monitor.py:343-608)."""

    def __init__(self, interval_s: float = 10.0) -> None:
        self.interval_s = interval_s
        self.checks: List[HealthCheck] = [
            HealthCheck("device_reachable", device_reachable_check),
            HealthCheck("hbm", hbm_utilization_check),
        ]
        self.pressure = PressureMonitor()
        self.latency_ring = MetricRing(256)
        self.error_ring = MetricRing(256)
        self._alert_callbacks: List[Callable[[HealthCheckResult], None]] = []
        self._results: Dict[str, HealthCheckResult] = {}
        self._lock = threading.RLock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def add_check(self, check: HealthCheck) -> None:
        with self._lock:
            self.checks.append(check)

    def add_alert_callback(self, cb: Callable[[HealthCheckResult], None]) -> None:
        self._alert_callbacks.append(cb)

    def record_latency_ms(self, v: float) -> None:
        self.latency_ring.record(v)

    def record_error(self) -> None:
        self.error_ring.record(1.0)

    def run_checks(self) -> Dict[str, HealthCheckResult]:
        results = {}
        for check in list(self.checks):
            res = check.run()
            results[res.name] = res
            if res.status in (HealthStatus.DEGRADED, HealthStatus.CRITICAL):
                for cb in self._alert_callbacks:
                    try:
                        cb(res)
                    except Exception:  # noqa: BLE001 - alerts must not kill the loop
                        logger.exception("alert callback failed")
        hbm = results.get("hbm")
        if hbm is not None and hbm.value is not None:
            self.pressure.update(hbm.value)
        with self._lock:
            self._results = results
        return results

    def overall_status(self) -> HealthStatus:
        with self._lock:
            results = list(self._results.values())
        if not results:
            return HealthStatus.UNKNOWN
        if any(r.status == HealthStatus.CRITICAL for r in results):
            return HealthStatus.CRITICAL
        if any(r.status == HealthStatus.DEGRADED for r in results):
            return HealthStatus.DEGRADED
        return HealthStatus.HEALTHY

    def get_status(self) -> Dict:
        with self._lock:
            results = {
                k: {"status": r.status.value, "message": r.message, "value": r.value}
                for k, r in self._results.items()
            }
        return {
            "overall": self.overall_status().value,
            "pressure_state": self.pressure.state.name,
            "checks": results,
            "latency_ms": self.latency_ring.summary(),
            "errors": self.error_ring.summary(),
        }

    # -- background loop ----------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop() -> None:
            while not self._stop.wait(self.interval_s):
                self.run_checks()

        self._thread = threading.Thread(target=loop, daemon=True, name="pfa-health")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


_monitor: Optional[HealthMonitor] = None
_monitor_lock = threading.Lock()


def get_health_monitor() -> HealthMonitor:
    global _monitor
    if _monitor is None:
        with _monitor_lock:
            if _monitor is None:
                _monitor = HealthMonitor()
    return _monitor
