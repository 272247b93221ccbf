"""Port parity: ``resilience/fault_tolerance.py``.

The degradation ladder makes the same config transitions as JAX's for every
trigger (each package's config, set alike before): the same fields
rewritten, levels, history and reverts. The wrapper's cases of
``tests/unit/test_resilience.py`` run on both packages with the same
numpy-seeded q/k/v; the CPU wrapper's last resort (a uniform mean over V,
GQA repeated) is within 1e-6 of JAX's. The wrapper's contract for CUDA
tensors, checked here with the CPU tensors declared on the card
(``_on_card`` patched): a failure is counted by the breaker and raised, the
KERNEL_FAILURE rung is not applied, the last resort is never used, and a
transient error is retried on the same function. The engine reads
``quant_mode`` at each call, so QUANT_ACCURACY takes its int8 kinds away
at the next call and ``recover`` gives them back.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photonic_flash_attention_tpu import config as jax_config
from photonic_flash_attention_tpu.core import error_recovery as jax_recovery
from photonic_flash_attention_tpu.resilience import fault_tolerance as jax_ft
from photonic_flash_attention_tpu.utils import exceptions as jax_exc
from photonic_flash_attention_tpu_torch import config as port_config
from photonic_flash_attention_tpu_torch.core import error_recovery as port_recovery
from photonic_flash_attention_tpu_torch.resilience import fault_tolerance as port_ft
from photonic_flash_attention_tpu_torch.utils import exceptions as port_exc

PORT = types.SimpleNamespace(ft=port_ft, cfg=port_config, rec=port_recovery, exc=port_exc,
                             arr=torch.from_numpy)
JAX = types.SimpleNamespace(ft=jax_ft, cfg=jax_config, rec=jax_recovery, exc=jax_exc,
                            arr=jnp.asarray)


@pytest.fixture(autouse=True)
def _fresh():
    from photonic_flash_attention_tpu_torch.core.engine import reset_engine

    for m in (PORT, JAX):
        m.rec.reset_recovery_manager()
        m.cfg.reset_config()
    reset_engine()
    yield
    for m in (PORT, JAX):
        m.rec.reset_recovery_manager()
        m.cfg.reset_config()
    reset_engine()


def _both(scenario):
    port, ref = scenario(PORT), scenario(JAX)
    assert port == ref
    return port


FIELDS = ("quant_mode", "kv_cache_dtype", "max_batch_size", "auto_kernel_selection",
          "flash_threshold")
TRIGGER_SEQUENCES = {
    "quant_accuracy": ["QUANT_ACCURACY"],
    "memory_pressure": ["MEMORY_PRESSURE"],
    "latency_slo": ["LATENCY_SLO"],
    "kernel_failure": ["KERNEL_FAILURE"],
    "all_four": ["QUANT_ACCURACY", "MEMORY_PRESSURE", "LATENCY_SLO", "KERNEL_FAILURE"],
    "repeated": ["MEMORY_PRESSURE", "MEMORY_PRESSURE", "KERNEL_FAILURE", "QUANT_ACCURACY"],
}


@pytest.mark.parametrize("case", list(TRIGGER_SEQUENCES))
def test_degradation_ladder_matches_jax(case):
    def run(m):
        m.cfg.set_global_config(quant_mode="int8", kv_cache_dtype="int8", max_batch_size=64)
        mgr = m.ft.GracefulDegradationManager()
        snap = lambda: {f: getattr(m.cfg.get_config(), f) for f in FIELDS}  # noqa: E731
        out = [snap()]
        for name in TRIGGER_SEQUENCES[case]:
            action = mgr.degrade(m.ft.DegradationTrigger[name], reason="test")
            out.append((action.level.name, action.description, mgr.level.name, snap()))
        status = mgr.get_status()
        out.append((status["level"], status["active_triggers"], status["history_len"]))
        for name in dict.fromkeys(TRIGGER_SEQUENCES[case]):
            out.append((mgr.recover(m.ft.DegradationTrigger[name]), mgr.level.name, snap()))
        out.append(mgr.recover(m.ft.DegradationTrigger.KERNEL_FAILURE))
        return out

    out = _both(run)
    assert out[-2][2] == out[0]  # every rewrite reverted


def test_jax_degradation_cases_on_both():
    for m in (PORT, JAX):
        m.cfg.set_global_config(quant_mode="int8", kv_cache_dtype="int8")
        mgr = m.ft.GracefulDegradationManager()
        mgr.degrade(m.ft.DegradationTrigger.QUANT_ACCURACY)
        assert m.cfg.get_config().quant_mode == "bf16" and mgr.level.name == "REDUCED"
        mgr.recover(m.ft.DegradationTrigger.QUANT_ACCURACY)
        assert m.cfg.get_config().quant_mode == "int8" and mgr.level.name == "NORMAL"
        mgr.degrade(m.ft.DegradationTrigger.KERNEL_FAILURE)
        assert m.cfg.get_config().flash_threshold == 1 << 30 and mgr.level.name == "MINIMAL"
        mgr.recover_all()
        assert m.cfg.get_config().flash_threshold == 512
        a1 = mgr.degrade(m.ft.DegradationTrigger.MEMORY_PRESSURE)
        assert mgr.degrade(m.ft.DegradationTrigger.MEMORY_PRESSURE) is a1
        mgr.recover_all()


def _qkv(m, rng, hq=2, hkv=2):
    q = rng.standard_normal((1, 32, hq, 16)).astype(np.float32)
    v = rng.standard_normal((1, 32, hkv, 16)).astype(np.float32)
    return m.arr(q), m.arr(v.copy()), m.arr(v)


def _wrapper_case(m, case):
    rng = np.random.default_rng(7)
    q, k, v = _qkv(m, rng)
    calls = {"n": 0}

    def ok(q, k, v, mask=None):
        calls["n"] += 1
        return q * 2, None

    def nan(q, k, v, mask=None):
        raise m.exc.ComputationError("kernel nan")

    def fb(q, k, v, mask=None):
        return q + 1, None

    def invalid(q, k, v, mask=None):
        raise m.exc.ValidationError("unrecoverable")  # ABORT policy

    if case == "passthrough_on_success":
        w = m.ft.ResilientAttentionWrapper(ok)
        out, _ = w(q, k, v)
        return calls["n"], np.asarray(out).tolist() == (np.asarray(q) * 2).tolist()
    if case == "fallback_path":
        out, _ = m.ft.ResilientAttentionWrapper(nan, fallback_fn=fb)(q, k, v)
        return np.allclose(np.asarray(out), np.asarray(q) + 1)
    if case == "last_resort_is_finite_and_shaped":
        w = m.ft.ResilientAttentionWrapper(invalid)
        out, weights = w(q, k, v)
        return (tuple(out.shape) == tuple(q.shape), bool(np.isfinite(np.asarray(out)).all()),
                weights, w.get_status()["last_resort_uses"])
    if case == "repeated_failures_degrade":
        w = m.ft.ResilientAttentionWrapper(invalid, max_failures_before_degrade=2)
        w(q, k, v)
        w(q, k, v)
        level = w.degradation.level.name
        threshold = m.cfg.get_config().flash_threshold
        w.degradation.recover_all()
        return level, threshold, w.get_status()["consecutive_failures"]
    raise AssertionError(case)


WRAPPER_CASES = {
    "passthrough_on_success": (1, True),
    "fallback_path": True,
    "last_resort_is_finite_and_shaped": (True, True, None, 1),
    "repeated_failures_degrade": ("MINIMAL", 1 << 30, 2),
}


@pytest.mark.parametrize("case", list(WRAPPER_CASES))
def test_wrapper_case_matches_jax(case):
    assert _both(lambda m: _wrapper_case(m, case)) == WRAPPER_CASES[case]


@pytest.mark.parametrize("hq, hkv", [(2, 2), (4, 2), (8, 1)])
def test_last_resort_matches_jax(rng, hq, hkv):
    q = rng.standard_normal((2, 24, hq, 16)).astype(np.float32)
    v = rng.standard_normal((2, 40, hkv, 16)).astype(np.float32)
    port = port_ft.ResilientAttentionWrapper(lambda *a: None)._last_resort(
        torch.from_numpy(q), torch.from_numpy(v), torch.from_numpy(v))
    ref = jax_ft.ResilientAttentionWrapper(lambda *a: None)._last_resort(
        jnp.asarray(q), jnp.asarray(v), jnp.asarray(v))
    assert port.shape == q.shape and port.dtype == torch.float32
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=0, atol=1e-6)


# -- the contract for CUDA tensors ----------------------------------------------------------


@pytest.fixture
def on_card(monkeypatch):
    """The call's tensors count as lying on the card."""
    monkeypatch.setattr(port_ft, "_on_card", lambda *t: True)


def test_card_failure_raises_without_rung_or_last_resort(on_card, rng):
    q, k, v = _qkv(PORT, rng)
    calls = {"n": 0, "fallback": 0}

    def failing(q, k, v, mask=None):
        calls["n"] += 1
        raise port_exc.KernelLaunchError("pfa_flash_fwd failed: an illegal memory access")

    def fb(q, k, v, mask=None):
        calls["fallback"] += 1
        return q, None

    w = port_ft.ResilientAttentionWrapper(failing, fallback_fn=fb)
    for _ in range(3):
        with pytest.raises(port_exc.KernelLaunchError):
            w(q, k, v)
    status = w.get_status()
    assert status["last_resort_uses"] == 0 and status["consecutive_failures"] == 3
    assert status["degradation"]["level"] == "NORMAL"
    assert port_config.get_config().flash_threshold == 512
    assert calls == {"n": 3, "fallback": 0}  # ABORT: no retry, no fallback
    assert w.breaker._failures == 3
    out, _ = port_ft.ResilientAttentionWrapper(lambda q, k, v, mask=None: (q, None),
                                               breaker=w.breaker)(q, k, v)
    assert out is q  # the breaker is still closed: the next good call goes through


def test_card_transient_error_is_retried_on_the_same_function(on_card, rng):
    q, k, v = _qkv(PORT, rng)
    calls = {"n": 0}

    def flaky(q, k, v, mask=None):
        calls["n"] += 1
        if calls["n"] == 1:
            raise TimeoutError("timeout")
        return q * 3, None

    out, _ = port_ft.ResilientAttentionWrapper(flaky)(q, k, v)
    assert calls["n"] == 2 and torch.equal(out, q * 3)


def test_card_numeric_failure_is_not_sent_to_the_fallback(on_card, rng):
    q, k, v = _qkv(PORT, rng)

    def nan(q, k, v, mask=None):
        raise port_exc.ComputationError("kernel nan")

    w = port_ft.ResilientAttentionWrapper(nan, fallback_fn=lambda q, k, v, mask=None: (q, None),
                                          max_failures_before_degrade=1)
    with pytest.raises(port_exc.ComputationError):
        w(q, k, v)
    assert w.get_status()["last_resort_uses"] == 0 and w.degradation.level.name == "NORMAL"


def test_quant_accuracy_moves_the_engines_next_call(rng):
    """Under quant_mode int8 the engine offers its int8 kinds; the rung
    takes them away at the next call, and ``recover`` gives them back."""
    from photonic_flash_attention_tpu_torch.core.engine import get_engine
    from photonic_flash_attention_tpu_torch.core.router import KernelKind

    port_config.set_global_config(quant_mode="int8", auto_kernel_selection=False,
                                  flash_threshold=64)
    eng = get_engine()
    q = torch.from_numpy(rng.standard_normal((1, 64, 2, 64)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 128, 2, 64)).astype(np.float32))
    eng(q, k, k)
    assert eng.last_kernel_used == KernelKind.FLASH_INT8FULL.value
    mgr = port_ft.GracefulDegradationManager()
    mgr.degrade(port_ft.DegradationTrigger.QUANT_ACCURACY)
    assert not eng.enable_int8
    eng(q, k, k)
    assert eng.last_kernel_used == KernelKind.FLASH.value
    mgr.recover(port_ft.DegradationTrigger.QUANT_ACCURACY)
    eng(q, k, k)
    assert eng.enable_int8 and eng.last_kernel_used == KernelKind.FLASH_INT8FULL.value
