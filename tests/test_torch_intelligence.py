"""Port parity: ``intelligence/adaptive_learning.py``.

The port's module is a copy over the port's router and config. Given the
same workloads (a port ``WorkloadCharacteristics`` and a JAX one with the
same fields), ``workload_features`` agrees with JAX's at 1e-7, the pattern
analyzer assigns the same patterns, the UCB1 bandit (numpy-seeded rewards)
pulls the same arms and the decision engine decides alike. The
adaptive-learning cases of ``tests/unit/test_optimization.py`` run on both.
"""

import types

import numpy as np
import pytest

from photonic_flash_attention_tpu.core.router import KernelKind as JaxKind
from photonic_flash_attention_tpu.core.router import WorkloadCharacteristics as JaxWorkload
from photonic_flash_attention_tpu.intelligence import adaptive_learning as jax_al
from photonic_flash_attention_tpu_torch.core.router import AdaptiveRouter, KernelKind
from photonic_flash_attention_tpu_torch.core.router import WorkloadCharacteristics
from photonic_flash_attention_tpu_torch.intelligence import adaptive_learning as port_al

PORT = types.SimpleNamespace(al=port_al, W=WorkloadCharacteristics)
JAX = types.SimpleNamespace(al=jax_al, W=JaxWorkload)


def wc(m, **kw):
    for key, value in (("batch_size", 2), ("q_len", 1024), ("kv_len", 1024), ("num_heads", 8),
                       ("head_dim", 64)):
        kw.setdefault(key, value)
    return m.W(**kw)


WORKLOADS = [
    dict(),
    dict(q_len=1100),
    dict(q_len=65536, batch_size=64, kv_len=65536),
    dict(q_len=1, kv_len=4096, is_decode=True, batch_size=8),
    dict(causal=True, num_heads=16, head_dim=128),
    dict(mask_kind="key"),
    dict(need_weights=True, q_len=32, kv_len=32),
    dict(batch_size=0, q_len=0, kv_len=0),
]


@pytest.mark.parametrize("kw", WORKLOADS, ids=range(len(WORKLOADS)))
def test_workload_features_match_jax(kw):
    port = port_al.workload_features(wc(PORT, **kw))
    ref = jax_al.workload_features(wc(JAX, **kw))
    assert port.dtype == ref.dtype == np.float32 and port.shape == ref.shape == (9,)
    np.testing.assert_allclose(port, ref, rtol=1e-7, atol=1e-7)


def _clustering(m):
    a = m.al.WorkloadPatternAnalyzer(max_patterns=4)
    ids = [a.assign(m.al.workload_features(wc(m, **kw))) for kw in WORKLOADS * 2]
    return ids, a.summary(), [c.tolist() for c in a.centroids]


def test_pattern_assignment_matches_jax():
    port, ref = _clustering(PORT), _clustering(JAX)
    assert port[0] == ref[0] and port[1] == ref[1]
    np.testing.assert_allclose(port[2], ref[2], rtol=1e-6)
    assert port[0][0] == port[0][1] and port[0][2] != port[0][0]  # JAX's clustering case


def _bandit(m):
    b = m.al.UCB1Bandit(["a", "b", "c"], c=0.5)
    rng = np.random.default_rng(0)
    arms = []
    for _ in range(300):
        arm = b.select()
        arms.append(arm)
        b.update(arm, {"a": 0.2, "b": 0.9, "c": 0.4}[arm] + rng.normal(0, 0.05))
    return arms, b.stats()


def test_ucb1_matches_jax_and_converges():
    arms, stats = _bandit(PORT)
    assert (arms, stats) == _bandit(JAX)
    assert stats["b"]["count"] > stats["a"]["count"] and stats["b"]["count"] > stats["c"]["count"]


def _decisions(m, exploration_rate):
    eng = m.al.AdaptiveDecisionEngine(exploration_rate=exploration_rate, seed=1)
    out = [eng.make_decision(wc(m, need_weights=True)),
           eng.make_decision(wc(m, q_len=32, kv_len=32))]
    w = wc(m, q_len=4096)
    for i in range(10):
        eng.record_outcome(w, m.al.Outcome("flash", latency_ms=1.0 + 0.1 * i, tokens=4096))
        eng.record_outcome(w, m.al.Outcome("fused", latency_ms=50.0, tokens=4096))
    for kw in WORKLOADS[:6]:
        out.append(eng.make_decision(wc(m, **kw)))
    out.append(eng.make_decision(w))
    return out, eng.get_stats()


@pytest.mark.parametrize("exploration_rate", [0.0, 0.1, 0.5])
def test_decision_engine_matches_jax(exploration_rate):
    port = _decisions(PORT, exploration_rate)
    assert port == _decisions(JAX, exploration_rate)
    decisions = port[0]
    assert decisions[0] == {"action": "fused", "confidence": 1.0, "source": "rule"}
    assert decisions[1]["action"] == "fused"
    if exploration_rate == 0.0:
        assert decisions[-1]["action"] == "flash" and decisions[-1]["source"].startswith("pattern")


@pytest.mark.parametrize("latency_ms, tokens", [(1.0, 4096), (50.0, 1), (0.0, 10), (3.5, 0)])
def test_outcome_reward_matches_jax(latency_ms, tokens):
    port = port_al.Outcome("flash", latency_ms, tokens).reward()
    assert port == jax_al.Outcome("flash", latency_ms, tokens).reward()
    assert 0.0 <= port <= 1.0


def test_arms_are_the_routers_kinds():
    """The default arms are kinds of both routers; an engine built on the
    router's eligible kinds chooses among them."""
    for action in ("fused", "flash", "flash_fp8"):
        assert KernelKind(action).value == JaxKind(action).value == action
    w = wc(PORT, batch_size=4, q_len=2048, kv_len=2048, num_heads=12, causal=True)
    available = (KernelKind.FUSED, KernelKind.FLASH, KernelKind.FLASH_UNROLLED)
    eligible = [k.value for k in AdaptiveRouter().eligible_kernels(w, available)]
    eng = port_al.AdaptiveDecisionEngine(actions=eligible, exploration_rate=0.0)
    for kind, ms in zip(eligible, (3.0, 0.5, 0.7)):
        eng.record_outcome(w, port_al.Outcome(kind, ms, 4 * 2048))
    d = eng.make_decision(w)
    assert d["action"] in eligible and d["action"] == "flash"
