"""Port parity: ``monitoring`` (health, pressure, dashboard).

The pressure ladder, trend, controller and ``pressure_protected`` are
copies: the cases of ``tests/unit/test_monitoring.py`` run on both packages
on the same pressure sequences and give the same states, slopes and
transitions. The device checks are the port's: ``device_reachable`` counts
the CUDA devices (here none, so the CPU alone, as JAX counts its CPU
backend: both report one device, HEALTHY) and ``hbm`` reads the port's
``device_memory_stats`` (UNKNOWN without a card, as JAX on the CPU). The
cases of ``tests/unit/test_dashboard.py`` run on the port: Prometheus text
of the same metrics dict equals JAX's, ``collect_metrics`` reads the
port's engine, and the server answers ``/metrics``, ``/health`` and ``/``
on 127.0.0.1. Background loops tick every 0.01 s.
"""

import json
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from photonic_flash_attention_tpu.monitoring import dashboard as jax_dash
from photonic_flash_attention_tpu.monitoring import health as jax_health
from photonic_flash_attention_tpu.utils import exceptions as jax_exc
from photonic_flash_attention_tpu_torch.monitoring import dashboard as port_dash
from photonic_flash_attention_tpu_torch.monitoring import health as port_health
from photonic_flash_attention_tpu_torch.utils import exceptions as port_exc

PORT = types.SimpleNamespace(h=port_health, d=port_dash, HardwareError=port_exc.HardwareError)
JAX = types.SimpleNamespace(h=jax_health, d=jax_dash, HardwareError=jax_exc.HardwareError)


@pytest.fixture(autouse=True)
def _fresh():
    from photonic_flash_attention_tpu_torch.config import reset_config
    from photonic_flash_attention_tpu_torch.core.engine import reset_engine

    reset_config()
    reset_engine()
    port_health._monitor = None
    yield
    reset_engine()
    port_health._monitor = None


def _both(scenario):
    port, ref = scenario(PORT), scenario(JAX)
    assert port == ref
    return port


PRESSURES = {
    "escalation": [0.5, 0.7, 0.8, 0.9, 0.99],
    "hysteresis_blocks_flapping": [0.8, 0.72, 0.69, 0.3],
    "jump_down_requires_margin": [0.99, 0.94, 0.89],
    "sawtooth": [0.1, 0.66, 0.62, 0.59, 0.76, 0.71, 0.69, 0.97, 0.91, 0.88, 0.0],
}


@pytest.mark.parametrize("case", list(PRESSURES))
def test_pressure_ladder_matches_jax(case):
    def run(m):
        pm = m.h.PressureMonitor()
        return [pm.update(p).name for p in PRESSURES[case]]

    states = _both(run)
    if case == "escalation":
        assert states == ["NORMAL", "WARNING", "THROTTLING", "CRITICAL", "EMERGENCY"]
    if case == "hysteresis_blocks_flapping":
        assert states == ["THROTTLING", "THROTTLING", "WARNING", "NORMAL"]


def _trend(m, samples, threshold):
    tr = m.h.PressureTrend()
    for t, p in samples:
        tr.record(p, t=t)
    slope = tr.slope_per_s()
    return (None if slope is None else round(slope, 12)), tr.seconds_to(threshold)


TRENDS = {
    "rising": ([(1000.0 + i, 0.5 + 0.01 * i) for i in range(10)], 0.85),
    "flat": ([(1000.0 + i, 0.5) for i in range(5)], 0.9),
    "already_over": ([(float(i), 0.9 + 0.01 * i) for i in range(3)], 0.85),
    "too_few": ([(0.0, 0.5), (1.0, 0.6)], 0.9),
    "window_of_64": ([(float(i), 0.001 * i) for i in range(100)], 0.5),
}


@pytest.mark.parametrize("case", list(TRENDS))
def test_pressure_trend_matches_jax(case):
    slope, eta = _both(lambda m: _trend(m, *TRENDS[case]))
    if case == "rising":
        assert abs(slope - 0.01) < 1e-6 and 25.0 < eta < 27.0
    if case == "flat":
        assert eta is None
    if case == "already_over":
        assert eta == 0.0


def _controller(m):
    pc = m.h.PressureController()
    fired = []
    pc.on_state(m.h.PressureState.THROTTLING, lambda s: fired.append(s.name))
    pc.on_state(m.h.PressureState.WARNING, lambda s: 1 / 0)  # must not break updates
    states = [pc.update(p).name for p in (0.5, 0.7, 0.80, 0.82, 0.6)]
    s = pc.get_status()
    return states, fired, s["state"], [t[1:] for t in s["recent_transitions"]]


def test_pressure_controller_matches_jax():
    states, fired, state, transitions = _both(_controller)
    assert fired == ["THROTTLING"] and states[1] == "WARNING"
    assert transitions[0] == ("NORMAL", "WARNING")


def _protected(m):
    mon = m.h.PressureMonitor()

    @m.h.pressure_protected(mon, max_state=m.h.PressureState.CRITICAL)
    def work(x):
        return x * 2

    @m.h.pressure_protected(mon, max_state=m.h.PressureState.CRITICAL, fallback=lambda x: -x)
    def soft(x):
        return x * 2

    out = [work(21), soft(21)]
    mon.update(0.96)  # -> EMERGENCY
    try:
        work(21)
        out.append("ran")
    except m.HardwareError:
        out.append("refused")
    out.append(soft(21))
    return out


def test_pressure_protected_matches_jax():
    assert _both(_protected) == [42, 42, "refused", -21]


def test_device_checks_on_the_cpu_match_jax():
    """No card here: both report HEALTHY; the port counts the CPU as one
    device (JAX counts the test session's 8 virtual CPU devices)."""
    port, ref = port_health.device_reachable_check(), jax_health.device_reachable_check()
    assert port.status.value == ref.status.value == "healthy"
    assert port.value == 1.0 and port.message == "1 device(s)"
    port, ref = port_health.hbm_utilization_check(), jax_health.hbm_utilization_check()
    assert port.status == ref.status == port_health.HealthStatus.UNKNOWN


@pytest.mark.parametrize("util, status", [(0.5, "healthy"), (0.9, "degraded"), (0.97, "critical"),
                                          (None, "unknown")])
def test_hbm_check_reads_device_memory_stats(monkeypatch, util, status):
    stats = {"platform": "gpu", "utilization": util}
    monkeypatch.setattr(port_health, "device_memory_stats", lambda: stats)
    monkeypatch.setattr(jax_health, "device_memory_stats", lambda: stats)
    port, ref = port_health.hbm_utilization_check(), jax_health.hbm_utilization_check()
    assert port.status.value == ref.status.value == status
    assert port.message == ref.message and port.value == ref.value


def _monitor(m):
    hm = m.h.HealthMonitor()
    fired = []
    hm.add_alert_callback(lambda r: fired.append(r.name))
    hm.record_latency_ms(5.0)
    hm.record_latency_ms(7.0)
    results = hm.run_checks()
    out = [sorted(results), results["device_reachable"].status.value, hm.overall_status().value]
    hm.add_check(m.h.HealthCheck(
        "always_bad", lambda: m.h.HealthCheckResult("always_bad", m.h.HealthStatus.CRITICAL, "x")))

    def boom():
        raise RuntimeError("sensor exploded")

    hm.add_check(m.h.HealthCheck("boom", boom))
    results = hm.run_checks()
    s = hm.get_status()
    out += [fired, hm.overall_status().value, "sensor exploded" in results["boom"].message,
            s["latency_ms"]["count"], s["pressure_state"]]
    return out


def test_health_monitor_matches_jax():
    out = _both(_monitor)
    assert out[1] == "healthy" and out[2] in ("healthy", "unknown")
    assert out[3] == ["always_bad", "boom"] and out[4] == "critical" and out[5]
    assert out[6] == 2


def test_background_loop_start_stop():
    hm = port_health.HealthMonitor(interval_s=0.01)
    hm.start()
    time.sleep(0.1)
    hm.stop()
    assert hm.get_status()["overall"] != "unknown"
    assert port_health.get_health_monitor() is port_health.get_health_monitor()


# -- the dashboard -------------------------------------------------------------------------

METRIC_DICTS = [
    {"engine": {"total_calls": 3, "router": {"hit_rate": 0.5}}},
    {"x": {"ok": True, "name": "flash", "items": [1, 2]}},
    {"kv-cache": {"pages in.use": 7, "nested": {"deep": {"deeper": -1.25}}}},
]


@pytest.mark.parametrize("metrics", METRIC_DICTS, ids=range(len(METRIC_DICTS)))
def test_render_prometheus_matches_jax(metrics):
    text = port_dash.render_prometheus(metrics)
    assert text == jax_dash.render_prometheus(metrics)


def test_prometheus_flattening():
    text = port_dash.render_prometheus(METRIC_DICTS[0])
    assert "pfa_engine_total_calls 3.0" in text and "pfa_engine_router_hit_rate 0.5" in text
    assert "# TYPE pfa_engine_total_calls gauge" in text
    text = port_dash.render_prometheus(METRIC_DICTS[1])
    assert "pfa_x_ok 1.0" in text and "flash" not in text


@pytest.fixture
def warm_engine(rng):
    from photonic_flash_attention_tpu_torch.core.engine import get_engine

    q = torch.from_numpy(rng.standard_normal((1, 128, 4, 64)).astype(np.float32))
    get_engine()(q, q, q)


def test_collects_live_engine(warm_engine):
    m = port_dash.collect_metrics()
    assert m["engine"]["total_calls"] >= 1 and "hbm" in m and "rings" in m
    assert "pfa_engine_total_calls" in port_dash.render_prometheus(m)


def test_metrics_server_endpoints(warm_engine):
    srv = port_dash.MetricsServer(port=0, host="127.0.0.1")
    port = srv.start()
    try:
        base = f"http://127.0.0.1:{port}"
        metrics = urllib.request.urlopen(f"{base}/metrics", timeout=10).read().decode()
        assert "pfa_engine_total_calls" in metrics
        health = json.loads(urllib.request.urlopen(f"{base}/health", timeout=10).read())
        assert health["overall"] == "healthy"
        assert health["checks"]["device_reachable"]["value"] == 1.0
        html = urllib.request.urlopen(f"{base}/", timeout=10).read().decode()
        assert "photonic-flash-attention-tpu" in html and "engine" in html
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"{base}/nope", timeout=10)
    finally:
        srv.stop()


def test_start_stop_idempotent():
    srv = port_dash.MetricsServer(port=0, host="127.0.0.1")
    p1 = srv.start()
    assert srv.start() == p1
    srv.stop()
    srv.stop()
