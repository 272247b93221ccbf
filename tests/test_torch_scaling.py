"""Port parity: ``scaling`` (load balancer, autoscaler, workload balancer).

Every case of ``tests/unit/test_scaling.py`` and
``tests/unit/test_workload_balancer.py`` runs on both packages: the same
scenario, the same inputs, and its observable result (picks, decisions,
placements, task states) must be equal, besides the JAX test's own
assertion on the port. The hash ring places 500 keys as JAX's does, and the
autoscaler takes the same decisions on one metric sequence with the
samples' timestamps set. The attention task runs the port's engine on the
CPU (plain versions) and is held against the JAX engine's output at
``rel_err_norm`` <= 1e-5 (fp32). Loops are waited on with ticks of 0.01 s.
"""

import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import photonic_flash_attention_tpu.scaling.autoscaler as jax_autoscaler
import photonic_flash_attention_tpu.scaling.load_balancer as jax_lb
import photonic_flash_attention_tpu.scaling.workload_balancer as jax_wb
import photonic_flash_attention_tpu.utils.exceptions as jax_exc
import photonic_flash_attention_tpu_torch.scaling.autoscaler as port_autoscaler
import photonic_flash_attention_tpu_torch.scaling.load_balancer as port_lb
import photonic_flash_attention_tpu_torch.scaling.workload_balancer as port_wb
import photonic_flash_attention_tpu_torch.utils.exceptions as port_exc
from .conftest import rel_err_norm


def _ns(lb, auto, wb, exc):
    return types.SimpleNamespace(
        ConsistentHashRing=lb.ConsistentHashRing, LoadBalancer=lb.LoadBalancer,
        AutoScalingOrchestrator=auto.AutoScalingOrchestrator, ComputeNode=wb.ComputeNode,
        DistributedTask=wb.DistributedTask, Balancer=wb.DistributedWorkloadBalancer,
        PlacementStrategy=wb.PlacementStrategy, TaskState=wb.TaskState,
        DistributionError=exc.DistributionError)


PORT = _ns(port_lb, port_autoscaler, port_wb, port_exc)
JAX = _ns(jax_lb, jax_autoscaler, jax_wb, jax_exc)


@pytest.fixture(autouse=True)
def _port_config():
    from photonic_flash_attention_tpu_torch.config import reset_config
    from photonic_flash_attention_tpu_torch.core.engine import reset_engine

    reset_config()
    reset_engine()
    yield
    reset_config()
    reset_engine()


def _both(scenario):
    """The scenario's result on the port, after checking it equals JAX's."""
    port, ref = scenario(PORT), scenario(JAX)
    assert port == ref
    return port


# -- the consistent-hash ring and the load balancer ---------------------------------


def test_hash_ring_places_keys_as_jax():
    def place(m):
        r = m.ConsistentHashRing()
        for n in ("a", "b", "c", "d"):
            r.add(n)
        before = [r.lookup(f"key-{i}") for i in range(500)]
        r.remove("b")
        return before, [r.lookup(f"key-{i}") for i in range(500)]

    before, after = _both(place)
    assert set(before) == {"a", "b", "c", "d"}
    assert all(x == y for x, y in zip(before, after) if x != "b")  # only b's keys move
    assert "b" not in after


def _round_robin_cycles(m):
    lb = m.LoadBalancer("round_robin")
    for n in ("a", "b"):
        lb.add_node(n)
    return [lb.select_node() for _ in range(4)]


def _least_connections(m):
    lb = m.LoadBalancer("least_connections")
    lb.add_node("a")
    lb.add_node("b")
    lb._nodes["a"].active_requests = 5
    return lb.select_node()


def _performance(m):
    lb = m.LoadBalancer("performance")
    lb.add_node("slow")
    lb.add_node("fast")
    lb._nodes["slow"].ema_latency_ms = 50.0
    lb._nodes["fast"].ema_latency_ms = 5.0
    return lb.select_node()


def _unhealthy_excluded(m):
    lb = m.LoadBalancer("round_robin")
    lb.add_node("a")
    lb.add_node("b")
    lb.set_health("a", False)
    return [lb.select_node() for _ in range(3)]


def _sticky(m):
    lb = m.LoadBalancer("round_robin")
    for n in ("a", "b", "c"):
        lb.add_node(n)
    return [lb.select_node(session_id="s1") for _ in range(6)]


def _consistent_hash(m):
    lb = m.LoadBalancer("consistent_hash")
    for n in ("a", "b", "c"):
        lb.add_node(n)
    return [lb.select_node(f"user-{i}") for i in range(20)]


def _weighted(m):
    lb = m.LoadBalancer("weighted_round_robin")
    lb.add_node("heavy", weight=3.0)
    lb.add_node("light", weight=1.0)
    return [lb.select_node() for _ in range(8)]


def _retries(m):
    lb = m.LoadBalancer("round_robin")
    lb.add_node("bad")
    lb.add_node("good")
    calls = []

    def fn(node_id):
        calls.append(node_id)
        if node_id == "bad":
            raise RuntimeError("down")
        return f"ok:{node_id}"

    return lb.execute_request(fn), calls, lb.get_stats()["nodes"]["bad"]["failures"]


LB_CASES = {
    "round_robin_cycles": (_round_robin_cycles, ["a", "b", "a", "b"]),
    "least_connections": (_least_connections, "b"),
    "performance_prefers_fast_node": (_performance, "fast"),
    "unhealthy_excluded": (_unhealthy_excluded, ["b", "b", "b"]),
    "sticky_sessions": (_sticky, None),
    "consistent_hash_strategy": (_consistent_hash, None),
    "weighted_round_robin": (_weighted, None),
    "execute_request_retries_on_failure": (_retries, None),
}


@pytest.mark.parametrize("case", list(LB_CASES))
def test_load_balancer_case_matches_jax(case):
    scenario, expected = LB_CASES[case]
    out = _both(scenario)
    if expected is not None:
        assert out == expected
    if case == "sticky_sessions":
        assert len(set(out)) == 1
    if case == "execute_request_retries_on_failure":
        assert out[0] == "ok:good" and out[2] == 1 and "bad" in out[1]


@pytest.mark.parametrize("case", ["no_healthy", "all_nodes_fail", "unknown_strategy"])
def test_load_balancer_errors_as_jax(case):
    for m in (PORT, JAX):
        with pytest.raises(m.DistributionError):
            if case == "unknown_strategy":
                m.LoadBalancer("chaos")
            lb = m.LoadBalancer()
            lb.add_node("a")
            if case == "no_healthy":
                lb.set_health("a", False)
                lb.select_node()
            else:
                lb.execute_request(lambda n: (_ for _ in ()).throw(RuntimeError("x")))


# -- the autoscaler -------------------------------------------------------------------

#: (utilization, queue depth, success rate) a tick: a rise, a plateau, a
#: failure burst, a fall and an idle stretch.
METRIC_SEQUENCE = (
    [(0.2 + 0.06 * i, i % 3, 1.0) for i in range(12)]
    + [(0.55, 2, 1.0)] * 4
    + [(0.5, 0, 0.9)] * 3
    + [(0.9 - 0.08 * i, 0, 1.0) for i in range(11)]
    + [(0.05, 0, 1.0)] * 30
)


def test_autoscaler_decisions_match_jax():
    def run(m):
        a = m.AutoScalingOrchestrator(min_replicas=1, max_replicas=8, cooldown_s=0)
        out = []
        for i, (util, queue, ok) in enumerate(METRIC_SEQUENCE):
            a.record_metrics(util, queue_depth=queue, success_rate=ok)
            a._metrics[-1].timestamp = 1000.0 + i  # one tick a second
            d = a.make_decision()
            out.append((d.action, d.current_replicas, d.target_replicas, d.reason,
                        round(d.predicted_utilization, 12)))
        return out, a.cost_report()["scaling_events"]

    decisions, events = _both(run)
    actions = {d[0] for d in decisions}
    assert {"scale_up", "scale_down"} <= actions and events > 0


def _scales_up(m):
    a = m.AutoScalingOrchestrator(min_replicas=1, max_replicas=8, cooldown_s=0)
    for _ in range(3):
        a.record_metrics(0.95, queue_depth=10)
    d = a.make_decision()
    return d.action, a.replicas


def _scales_down(m):
    a = m.AutoScalingOrchestrator(min_replicas=1, max_replicas=8, cooldown_s=0)
    a.replicas = 4
    for _ in range(5):
        a.record_metrics(0.05, queue_depth=0)
    d = a.make_decision()
    return d.action, d.target_replicas


def _cooldown(m):
    a = m.AutoScalingOrchestrator(cooldown_s=3600)
    a.record_metrics(0.99, queue_depth=50)
    first = a.make_decision().action
    a.record_metrics(0.99, queue_depth=50)
    return first, a.make_decision().action


def _bounds(m):
    a = m.AutoScalingOrchestrator(min_replicas=1, max_replicas=2, cooldown_s=0)
    for _ in range(5):
        a.record_metrics(0.99, queue_depth=100)
        a.make_decision()
    return a.replicas


def _trend(m):
    a = m.AutoScalingOrchestrator(cooldown_s=10)
    for i in range(10):
        a.record_metrics(0.3 + i * 0.05)
        a._metrics[-1].timestamp = 5000.0 + i
    return round(a._predict_utilization(), 12)


def _cost(m):
    a = m.AutoScalingOrchestrator(replica_type="v5e-1")
    r = a.cost_report()
    return r["hourly_cost_usd"], r["startup_time_s"]


def _status(m):
    a = m.AutoScalingOrchestrator()
    a.record_metrics(0.5)
    a.make_decision()
    s = a.get_scaling_status()
    return s["replicas"], len(s["recent_decisions"]), s["bounds"]


AUTOSCALER_CASES = {
    "scales_up_on_high_utilization": (_scales_up, lambda o: o[0] == "scale_up" and o[1] > 1),
    "scales_down_when_idle": (_scales_down, lambda o: o == ("scale_down", 3)),
    "cooldown_holds": (_cooldown, lambda o: o == ("scale_up", "hold")),
    "bounds_respected": (_bounds, lambda o: o <= 2),
    "trend_prediction_anticipates": (_trend, lambda o: o > 0.9),
    "cost_report": (_cost, lambda o: o[0] > 0 and o[1] > 0),
    "status_surface": (_status, lambda o: o[0] >= 1 and o[1] == 1),
}


@pytest.mark.parametrize("case", list(AUTOSCALER_CASES))
def test_autoscaler_case_matches_jax(case):
    scenario, check = AUTOSCALER_CASES[case]
    assert check(_both(scenario))


# -- the workload balancer ------------------------------------------------------------


def echo_executor(task):
    return task.payload.get("x", 0) * 2


def _round_robin_spreads(m):
    b = m.Balancer(strategy=m.PlacementStrategy.ROUND_ROBIN)
    for i in range(3):
        b.register_node(m.ComputeNode(f"n{i}", executor=echo_executor))
    for i in range(9):
        b.submit_task(m.DistributedTask(f"t{i}", payload={"x": i}))
    b.run_until_drained()
    return ([n["completed"] for n in b.get_cluster_status()["nodes"].values()],
            [(t.assigned_node, t.result) for t in b._tasks.values()])


def _accelerator_for_long_seq(m):
    b = m.Balancer(strategy=m.PlacementStrategy.PERFORMANCE_AWARE)
    b.register_node(m.ComputeNode("cpu0", device_type="cpu", executor=echo_executor))
    b.register_node(m.ComputeNode("tpu0", device_type="tpu", executor=echo_executor))
    b.submit_task(m.DistributedTask("long", seq_length=4096, payload={"x": 1}))
    b.run_until_drained()
    return b._tasks["long"].assigned_node


def _priority(m):
    order = []

    def rec(task):
        order.append(task.task_id)

    b = m.Balancer()
    b.register_node(m.ComputeNode("n0", capacity=1, executor=rec))
    for name, prio in (("low", 0), ("high", 10), ("mid", 5)):
        b.submit_task(m.DistributedTask(name, priority=prio))
    b.run_until_drained()
    return order


def _least_loaded(m):
    b = m.Balancer(strategy=m.PlacementStrategy.LEAST_LOADED)
    for i, cap in enumerate((1, 4, 2)):
        b.register_node(m.ComputeNode(f"n{i}", capacity=cap, executor=echo_executor))
    for i in range(7):
        b.submit_task(m.DistributedTask(f"t{i}", payload={"x": i}))
    b.run_until_drained()
    return sorted((t.task_id, t.assigned_node) for t in b._tasks.values())


def _heartbeat_requeues(m):
    b = m.Balancer(heartbeat_timeout_s=0.05)
    good = m.ComputeNode("good", executor=echo_executor)
    b.register_node(good)
    dead = m.ComputeNode("dead", executor=echo_executor)
    b.register_node(dead)
    t = m.DistributedTask("t0", payload={"x": 3})
    b.submit_task(t)
    t.state = m.TaskState.RUNNING
    t.assigned_node = "dead"
    dead.active_tasks = 1
    dead.last_heartbeat = time.time() - 1.0
    good.last_heartbeat = time.time() + 100  # keep alive
    failed = b.check_heartbeats()
    requeued = t.state.value
    b.run_until_drained()
    return failed, requeued, t.state.value, t.assigned_node, t.result


def _heartbeat_recovers(m):
    b = m.Balancer(heartbeat_timeout_s=0.01)
    n = m.ComputeNode("n0", executor=echo_executor)
    b.register_node(n)
    n.last_heartbeat = time.time() - 1.0
    b.check_heartbeats()
    was_failed = n.failed
    b.heartbeat("n0")
    return was_failed, n.failed


def _retries_then_fails(m):
    calls = []

    def flaky(task):
        calls.append(1)
        raise RuntimeError("boom")

    b = m.Balancer()
    b.register_node(m.ComputeNode("n0", executor=flaky))
    t = m.DistributedTask("t0")
    b.submit_task(t)
    b.run_until_drained()
    return t.state.value, len(calls), b.MAX_ATTEMPTS, "boom" in t.error


def _background_loop(m):
    b = m.Balancer()
    b.register_node(m.ComputeNode("n0", executor=echo_executor))
    b.start(tick_s=0.01)
    t = m.DistributedTask("t0", payload={"x": 21})
    b.submit_task(t)
    deadline = time.time() + 5
    while t.state != m.TaskState.DONE and time.time() < deadline:
        time.sleep(0.01)
    b.stop()
    return t.result


def _status_surface(m):
    b = m.Balancer()
    b.register_node(m.ComputeNode("n0", executor=echo_executor))
    b.submit_task(m.DistributedTask("t0", payload={"x": 1}))
    b.run_until_drained()
    s = b.get_cluster_status()
    return s["tasks"], s["nodes"]["n0"]["completed"], s["strategy"]


WB_CASES = {
    "round_robin_spreads": (_round_robin_spreads, lambda o: o[0] == [3, 3, 3]),
    "performance_aware_prefers_accelerator_for_long_seq": (
        _accelerator_for_long_seq, lambda o: o == "tpu0"),
    "priority_order": (_priority, lambda o: o == ["high", "mid", "low"]),
    "least_loaded": (_least_loaded, lambda o: len(o) == 7),
    "heartbeat_timeout_requeues": (
        _heartbeat_requeues, lambda o: o == (["dead"], "queued", "done", "good", 6)),
    "heartbeat_recovers_node": (_heartbeat_recovers, lambda o: o == (True, False)),
    "failing_task_retries_then_fails": (
        _retries_then_fails, lambda o: o[0] == "failed" and o[1] == o[2] and o[3]),
    "background_loop": (_background_loop, lambda o: o == 42),
    "status_surface": (_status_surface, lambda o: o[0] == {"done": 1} and o[1] == 1),
}


@pytest.mark.parametrize("case", list(WB_CASES))
def test_workload_balancer_case_matches_jax(case):
    scenario, check = WB_CASES[case]
    assert check(_both(scenario))


def test_gpu_nodes_are_accelerators():
    """The port's default node is a ``"gpu"``, scored as JAX scores a TPU."""
    b = PORT.Balancer()
    b.register_node(PORT.ComputeNode("cpu0", device_type="cpu", executor=echo_executor))
    b.register_node(PORT.ComputeNode("gpu0", executor=echo_executor))
    assert b._nodes["gpu0"].device_type == "gpu"
    b.submit_task(PORT.DistributedTask("long", seq_length=4096, payload={"x": 1}))
    b.run_until_drained()
    assert b._tasks["long"].assigned_node == "gpu0"


def test_duplicate_task_rejected():
    for m in (PORT, JAX):
        b = m.Balancer()
        b.register_node(m.ComputeNode("n0", executor=echo_executor))
        b.submit_task(m.DistributedTask("t0"))
        with pytest.raises(m.DistributionError):
            b.submit_task(m.DistributedTask("t0"))


@pytest.mark.parametrize("causal", [True, False])
def test_attention_task_through_engine_matches_jax(rng, causal):
    """The default executor runs each package's engine on the same input."""
    from photonic_flash_attention_tpu.core.engine import reset_engine as jax_reset_engine
    from photonic_flash_attention_tpu.ops.reference import attention_reference

    x = rng.standard_normal((1, 128, 4, 32)).astype(np.float32)
    outs = []
    for m, q in ((PORT, torch.from_numpy(x)), (JAX, jnp.asarray(x))):
        jax_reset_engine()
        b = m.Balancer()
        b.register_node(m.ComputeNode("local"))  # default local_engine_executor
        t = m.DistributedTask("attn", kind="attention", seq_length=128,
                              payload={"q": q, "k": q, "v": q, "causal": causal})
        b.submit_task(t)
        b.run_until_drained()
        assert t.state == m.TaskState.DONE
        outs.append(np.asarray(t.result, np.float32))
    jax_reset_engine()
    ref, _ = attention_reference(jnp.asarray(x), jnp.asarray(x), jnp.asarray(x), causal=causal)
    assert rel_err_norm(outs[0], outs[1]) <= 1e-5
    assert rel_err_norm(outs[0], np.asarray(ref)) <= 1e-5
