"""HTTP observability endpoint: Prometheus metrics + JSON health + dashboard.

The rebirth of the reference's ops surface (reference
monitoring/dashboard.py stdlib-HTTP dashboard — shipped with a recorded
syntax error at line 529 — and monitoring/prometheus.yml scraping
``:8080/metrics``). Same endpoints, working implementation:

* ``GET /metrics`` — Prometheus text exposition: engine/router stats,
  KV-cache pool, collective telemetry per axis, health checks, HBM.
* ``GET /health`` — JSON health summary (k8s liveness/readiness).
* ``GET /`` — minimal HTML dashboard rendering the same numbers.

Stdlib-only (``http.server`` on a daemon thread); zero dependencies, safe
to run beside the serving loop.

Port of ``photonic_flash_attention_tpu/monitoring/dashboard.py``, which
imports no JAX: a copy reading the port's singletons (the engine, the KV
cache, the health monitor, the collective telemetry) and the card's
memory through ``utils/monitoring.py::device_memory_stats``.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..utils.logging import get_logger

logger = get_logger("dashboard")


def _flatten(prefix: str, obj: Any, out: List[Tuple[str, float]]) -> None:
    """Flatten nested dicts of numbers into prometheus-style names."""
    if isinstance(obj, bool):
        out.append((prefix, 1.0 if obj else 0.0))
    elif isinstance(obj, (int, float)):
        out.append((prefix, float(obj)))
    elif isinstance(obj, dict):
        for k, v in obj.items():
            key = str(k).replace("-", "_").replace(" ", "_").replace(".", "_")
            _flatten(f"{prefix}_{key}" if prefix else key, v, out)
    # strings/lists are skipped: prometheus wants numbers


def collect_metrics() -> Dict[str, Any]:
    """Gather every subsystem's stats surface (best-effort per source)."""
    metrics: Dict[str, Any] = {}

    def grab(name: str, fn: Callable[[], Any]) -> None:
        try:
            metrics[name] = fn()
        except Exception as e:  # noqa: BLE001 - one bad source must not kill /metrics
            logger.debug("metrics source %s failed: %s", name, e)

    def engine_stats():
        from ..core import engine as engine_mod

        if engine_mod._engine is None:
            return None
        return engine_mod._engine.get_performance_stats()

    def kv_stats():
        from ..core import kv_cache as kv_mod

        if kv_mod._cache_singleton is None:
            return None
        return kv_mod._cache_singleton.get_memory_stats()

    def health_stats():
        from . import health as health_mod

        if health_mod._monitor is None:
            return None
        return health_mod._monitor.get_status()

    def telemetry_stats():
        from ..parallel import telemetry as tel_mod

        if tel_mod._telemetry is None:
            return None
        return tel_mod._telemetry.get_stats()

    def hbm_stats():
        from ..utils.monitoring import device_memory_stats

        return device_memory_stats()

    def rings_stats():
        from ..utils.monitoring import get_metrics

        return get_metrics().snapshot()

    grab("engine", engine_stats)
    grab("kv_cache", kv_stats)
    grab("health", health_stats)
    grab("collectives", telemetry_stats)
    grab("hbm", hbm_stats)
    grab("rings", rings_stats)
    return {k: v for k, v in metrics.items() if v is not None}


def render_prometheus(metrics: Optional[Dict[str, Any]] = None) -> str:
    """Render to the Prometheus text exposition format."""
    metrics = collect_metrics() if metrics is None else metrics
    flat: List[Tuple[str, float]] = []
    _flatten("pfa", metrics, flat)
    lines = []
    for name, value in flat:
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name} {value}")
    return "\n".join(lines) + "\n"


_DASH_HTML = """<!doctype html>
<html><head><title>photonic-flash-attention-tpu</title>
<style>
 body {{ font-family: monospace; margin: 2em; background: #111; color: #ddd; }}
 h1 {{ color: #7fd4ff; }} h2 {{ color: #9fe8a0; margin-top: 1.5em; }}
 pre {{ background: #1b1b1b; padding: 1em; border-radius: 6px; overflow-x: auto; }}
</style></head>
<body>
<h1>photonic-flash-attention-tpu</h1>
<p>endpoints: <a href="/metrics" style="color:#7fd4ff">/metrics</a>
 <a href="/health" style="color:#7fd4ff">/health</a></p>
{sections}
</body></html>
"""


def render_dashboard() -> str:
    metrics = collect_metrics()
    sections = "".join(
        f"<h2>{name}</h2><pre>{json.dumps(value, indent=2, default=str)}</pre>"
        for name, value in metrics.items()
    ) or "<p>no subsystems active yet</p>"
    return _DASH_HTML.format(sections=sections)


class _Handler(BaseHTTPRequestHandler):
    def do_GET(self) -> None:  # noqa: N802 - stdlib API
        try:
            if self.path.startswith("/metrics"):
                body = render_prometheus().encode()
                ctype = "text/plain; version=0.0.4"
                code = 200
            elif self.path.startswith("/health"):
                from .health import get_health_monitor

                mon = get_health_monitor()
                if not mon.get_status()["checks"]:
                    mon.run_checks()
                status = mon.get_status()
                body = json.dumps(status, default=str).encode()
                ctype = "application/json"
                code = 200 if status["overall"] in ("healthy", "degraded") else 503
            elif self.path == "/":
                body = render_dashboard().encode()
                ctype = "text/html"
                code = 200
            else:
                body = b"not found"
                ctype = "text/plain"
                code = 404
        except Exception as e:  # noqa: BLE001 - observability must not crash
            body = f"error: {e}".encode()
            ctype = "text/plain"
            code = 500
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt: str, *args: Any) -> None:  # silence stderr
        logger.debug("http: " + fmt, *args)


class MetricsServer:
    """Background metrics/dashboard HTTP server."""

    def __init__(self, port: int = 8080, host: str = "0.0.0.0") -> None:
        self.host = host
        self.port = port
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> int:
        """Start serving; returns the bound port (0 picks a free one)."""
        if self._server is not None:
            return self.port
        self._server = ThreadingHTTPServer((self.host, self.port), _Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True, name="pfa-metrics"
        )
        self._thread.start()
        logger.info("metrics server on %s:%d", self.host, self.port)
        return self.port

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
