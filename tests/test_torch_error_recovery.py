"""The port's error recovery against the JAX package's.

The error-recovery classes of ``tests/unit/test_resilience.py``
(``TestCircuitBreaker``, ``TestRecoveryManager``) run on the port; the
default policy table picks JAX's strategy for the errors both packages
share; and the error the port's kernel calls raise on CUDA tensors
(``KernelLaunchError``: a failed launch or build) is raised, never sent to
a plain version, checked through the policy table since the CPU has no
CUDA tensor. RECOMPILE clears the port's plan caches.
"""

import threading
import time

import pytest

from photonic_flash_attention_tpu.core.error_recovery import (
    ErrorRecoveryManager as JaxManager,
)
from photonic_flash_attention_tpu.utils import exceptions as jax_exc
from photonic_flash_attention_tpu_torch.core.error_recovery import (
    DEFAULT_POLICIES,
    CircuitBreaker,
    CircuitState,
    ErrorRecoveryManager,
    RecoveryPolicy,
    RecoveryStrategy,
    clear_plan_caches,
    get_recovery_manager,
    reset_recovery_manager,
    with_circuit_breaker,
    with_error_recovery,
)
from photonic_flash_attention_tpu_torch.ops import _build, paged
from photonic_flash_attention_tpu_torch.utils.exceptions import (
    CompilationError,
    ComputationError,
    KernelLaunchError,
    PhotonicFlashAttentionError,
    TimeoutError_,
    ValidationError,
)


@pytest.fixture(autouse=True)
def _fresh():
    reset_recovery_manager()
    yield
    reset_recovery_manager()


# -- TestCircuitBreaker ---------------------------------------------------------


def test_opens_after_threshold():
    cb = CircuitBreaker("t", failure_threshold=3, recovery_timeout_s=60)
    for _ in range(3):
        with pytest.raises(RuntimeError):
            with cb:
                raise RuntimeError("boom")
    assert cb.state == CircuitState.OPEN
    with pytest.raises(PhotonicFlashAttentionError):
        with cb:
            pass


def test_half_open_recovery():
    cb = CircuitBreaker("t", failure_threshold=1, recovery_timeout_s=0.05)
    with pytest.raises(RuntimeError):
        with cb:
            raise RuntimeError("boom")
    assert cb.state == CircuitState.OPEN
    time.sleep(0.06)
    assert cb.state == CircuitState.HALF_OPEN
    with cb:
        pass  # success closes
    assert cb.state == CircuitState.CLOSED


def test_half_open_failure_reopens():
    cb = CircuitBreaker("t", failure_threshold=1, recovery_timeout_s=0.05)
    with pytest.raises(RuntimeError):
        with cb:
            raise RuntimeError("boom")
    time.sleep(0.06)
    with pytest.raises(RuntimeError):
        with cb:
            raise RuntimeError("again")
    assert cb.state == CircuitState.OPEN


def test_breaker_thread_safety():
    cb = CircuitBreaker("t", failure_threshold=50)
    errors = []

    def worker():
        for _ in range(20):
            try:
                with cb:
                    pass
            except Exception as e:  # noqa: BLE001
                errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert cb.state == CircuitState.CLOSED


# -- TestRecoveryManager ----------------------------------------------------------


def test_abort_on_validation_error():
    mgr = ErrorRecoveryManager()
    with pytest.raises(ValidationError):
        mgr.handle_error(ValidationError("bad shape"), operation=lambda: 1, fallback=lambda: 2)


def test_retry_transient():
    mgr = ErrorRecoveryManager()
    calls = {"n": 0}

    def op():
        calls["n"] += 1
        if calls["n"] < 2:
            raise TimeoutError("timeout")
        return "ok"

    assert mgr.handle_error(TimeoutError("timeout"), operation=op) == "ok"


def test_fallback_on_computation_error():
    mgr = ErrorRecoveryManager()
    out = mgr.handle_error(
        ComputationError("kernel NaN"), operation=lambda: 1 / 0, fallback=lambda: "fallback"
    )
    assert out == "fallback"


def test_custom_policy_precedence():
    mgr = ErrorRecoveryManager()
    mgr.add_policy(RecoveryPolicy("custom", RecoveryStrategy.FALLBACK,
                                  message_substrings=("weird",)))
    out = mgr.handle_error(RuntimeError("weird failure"), operation=lambda: 1,
                           fallback=lambda: "fb")
    assert out == "fb"


def test_stats():
    mgr = ErrorRecoveryManager()
    with pytest.raises(ValidationError):
        mgr.handle_error(ValidationError("x"), operation=lambda: 1)
    s = mgr.get_stats()
    assert s["total_errors"] == 1
    assert s["by_strategy"].get("abort") == 1


def test_decorators():
    @with_error_recovery(fallback=lambda: "fb")
    def flaky():
        raise ComputationError("kernel exploded")

    assert flaky() == "fb"

    @with_circuit_breaker("deco_test", failure_threshold=1)
    def bad():
        raise RuntimeError("x")

    with pytest.raises(RuntimeError):
        bad()
    with pytest.raises(PhotonicFlashAttentionError):
        bad()  # now open
    assert get_recovery_manager().get_stats()["breakers"]["deco_test"] == "open"


def test_concurrent_error_handling():
    mgr = ErrorRecoveryManager()
    results = []

    def worker():
        results.append(mgr.handle_error(ComputationError("kernel nan"), operation=lambda: 1,
                                        fallback=lambda: "fb"))

    threads = [threading.Thread(target=worker) for _ in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert results == ["fb"] * 16


# -- the policy table against JAX's --------------------------------------------------

#: (port error, JAX error) pairs the two tables must answer alike.
SHARED = [
    (ValidationError("bad shape"), jax_exc.ValidationError("bad shape")),
    (TimeoutError_("slow"), jax_exc.TimeoutError_("slow")),
    (TimeoutError("t"), TimeoutError("t")),
    (ConnectionError("peer"), ConnectionError("peer")),
    (RuntimeError("deadline exceeded"), RuntimeError("deadline exceeded")),
    (ComputationError("kernel NaN"), jax_exc.ComputationError("kernel NaN")),
    (ComputationError("bad partials"), jax_exc.ComputationError("bad partials")),
    (RuntimeError("output has inf"), RuntimeError("output has inf")),
    (CompilationError("variant failed"), jax_exc.CompilationError("variant failed")),
    (KeyError("x"), KeyError("x")),
]


@pytest.mark.parametrize("port_error, jax_error", SHARED, ids=lambda e: type(e).__name__)
def test_default_policies_match_jax(port_error, jax_error):
    want = JaxManager().select_policy(jax_error)
    got = ErrorRecoveryManager().select_policy(port_error)
    assert (got and got.strategy.value) == (want and want.strategy.value)


#: What the port's kernel calls raise on CUDA tensors: a failed launch
#: (``ops/_build.py::launch``) and a failed nvcc or g++ build.
CARD_FAILURES = [
    KernelLaunchError("pfa_paged_decode_fused: CUDA error 700 (an illegal memory access was "
                      "encountered)"),
    KernelLaunchError("pfa_flash_fwd: CUDA error 209 (no kernel image is available for "
                      "execution on the device)"),
    KernelLaunchError("nvcc failed (1): nvcc -c csrc/flash_fwd.cu\nerror: kernel NaN inf"),
    KernelLaunchError("nvcc not found: the port's CUDA kernels build only where the CUDA "
                      "toolkit is installed"),
    RuntimeError("CUDA error: device-side assert triggered (kernel nan check)"),
]


@pytest.mark.parametrize("error", CARD_FAILURES, ids=range(len(CARD_FAILURES)))
def test_a_kernel_failure_on_the_card_is_raised_not_sent_to_a_plain_version(error):
    mgr = ErrorRecoveryManager()
    policy = mgr.select_policy(error)
    assert policy.strategy == RecoveryStrategy.ABORT
    plain_calls = []

    @with_error_recovery(fallback=lambda: plain_calls.append(1), manager=mgr)
    def kernel_call():
        raise error

    with pytest.raises(type(error)):
        kernel_call()
    assert not plain_calls
    assert mgr.get_stats()["by_strategy"] == {"abort": 1}


def test_no_default_policy_routes_a_launch_error_elsewhere():
    err = KernelLaunchError("pfa_softmax: CUDA error 1 (invalid argument)")
    matching = [p for p in DEFAULT_POLICIES if p.matches(err)]
    assert matching and matching[0].strategy == RecoveryStrategy.ABORT
    assert isinstance(err, RuntimeError)  # the wrappers' callers catch RuntimeError


def test_launch_and_build_raise_kernel_launch_error(monkeypatch):
    class _Lib:
        def pfa_bad(self, *args):
            return 700

        def pfa_error_string(self, err):
            return b"an illegal memory access was encountered"

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(_build, "lib", lambda: _Lib())
    monkeypatch.setattr(_build.torch.cuda, "device", lambda d: _NullContext())
    monkeypatch.setattr(_build.torch.cuda, "current_stream", lambda d: _Stream())
    monkeypatch.setattr(_build.torch.cuda, "is_current_stream_capturing", lambda: False)
    with pytest.raises(KernelLaunchError, match="CUDA error 700"):
        _build.launch("pfa_bad", "cuda")
    assert "pfa_bad" not in _build.LAUNCHES
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    with pytest.raises(KernelLaunchError, match="nvcc not found"):
        _build._nvcc()


class _NullContext:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_recompile_clears_the_ports_plan_caches():
    paged.k3_plan(8, 16, 16, 64, 1, 128, 16)
    assert paged.k3_plan.cache_info().currsize > 0
    calls = []
    out = ErrorRecoveryManager().handle_error(
        CompilationError("variant failed"), operation=lambda: calls.append(1) or "again")
    assert out == "again" and calls == [1]
    assert paged.k3_plan.cache_info().currsize == 0
    assert clear_plan_caches() >= 1
