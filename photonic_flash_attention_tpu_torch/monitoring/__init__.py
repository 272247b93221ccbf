"""Monitoring: health checks, pressure state machine + controller, metric
rings, HTTP metrics/dashboard endpoint."""

from .dashboard import MetricsServer, collect_metrics, render_prometheus
from .health import (
    HealthCheck,
    HealthCheckResult,
    HealthMonitor,
    HealthStatus,
    PressureController,
    PressureMonitor,
    PressureState,
    PressureTrend,
    get_health_monitor,
    pressure_protected,
)

__all__ = [
    "HealthCheck",
    "HealthCheckResult",
    "HealthMonitor",
    "HealthStatus",
    "MetricsServer",
    "PressureController",
    "PressureMonitor",
    "PressureState",
    "PressureTrend",
    "collect_metrics",
    "get_health_monitor",
    "pressure_protected",
    "render_prometheus",
]
