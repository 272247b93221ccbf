"""Policy-driven error recovery + circuit breakers.

Port of ``photonic_flash_attention_tpu/core/error_recovery.py``: the same
machinery (substring/type-matched recovery policies, strategy executors,
per-operation CLOSED/OPEN/HALF_OPEN circuit breakers,
``with_error_recovery``/``with_circuit_breaker`` decorators, the global
singleton), with these strategies:

* ABORT: validation errors (bad inputs do not deserve retries), and a
  kernel of the port that fails to build or launch on the card
  (``KernelLaunchError``, or any message naming a CUDA error or a failed
  ``nvcc``/``g++`` build);
* RETRY with exponential backoff: transient errors (timeouts, connection
  errors, an unavailable resource);
* RECOMPILE: ``CompilationError``; clears the port's plan caches
  (:func:`clear_plan_caches`) and runs the operation again;
* FALLBACK: a numerical failure (``ComputationError``, NaN/Inf) goes to the
  caller's alternate path;
* DEGRADE: the caller's higher-precision path.

Differences from JAX: the kernel-failure ABORT policy comes before every
other, so no default policy sends a failure of a kernel on CUDA tensors to
a plain version (the port's contract: a kernel failure raises for CUDA
tensors; the FUSED fallback is kept for CPU tensors only). RECOMPILE clears
the port's ``functools.lru_cache`` plans (K3's split plan, the experiments'
work plans, the T5 bucket ranges, the device record), where JAX clears its
jit caches; the JAX policy's TPU compiler substrings ("mosaic", "xla
compilation", "hlo") have no counterpart here.
"""

from __future__ import annotations

import dataclasses
import enum
import functools
import sys
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple, Type

from ..utils.exceptions import (
    CompilationError,
    ComputationError,
    KernelLaunchError,
    PhotonicFlashAttentionError,
    TimeoutError_,
    ValidationError,
)
from ..utils.logging import get_logger

logger = get_logger("recovery")


class RecoveryStrategy(str, enum.Enum):
    RETRY = "retry"
    FALLBACK = "fallback"
    DEGRADE = "degrade"
    RECOMPILE = "recompile"
    ABORT = "abort"


@dataclasses.dataclass
class RecoveryPolicy:
    """error pattern -> strategy."""

    name: str
    strategy: RecoveryStrategy
    error_types: Tuple[Type[BaseException], ...] = ()
    message_substrings: Tuple[str, ...] = ()
    max_attempts: int = 3
    backoff_s: float = 0.1
    backoff_multiplier: float = 2.0

    def matches(self, error: BaseException) -> bool:
        if self.error_types and isinstance(error, self.error_types):
            return True
        msg = str(error).lower()
        return any(s in msg for s in self.message_substrings)


DEFAULT_POLICIES: List[RecoveryPolicy] = [
    RecoveryPolicy(
        "raise_on_card_kernel_failure",
        RecoveryStrategy.ABORT,
        error_types=(KernelLaunchError,),
        message_substrings=("cuda error", "nvcc failed", "nvcc not found", "g++ failed"),
    ),
    RecoveryPolicy(
        "abort_on_bad_inputs",
        RecoveryStrategy.ABORT,
        error_types=(ValidationError,),
    ),
    RecoveryPolicy(
        "recompile_on_compiler_error",
        RecoveryStrategy.RECOMPILE,
        error_types=(CompilationError,),
        max_attempts=2,
    ),
    RecoveryPolicy(
        "retry_transient",
        RecoveryStrategy.RETRY,
        error_types=(TimeoutError_, TimeoutError, ConnectionError),
        message_substrings=("timeout", "deadline", "unavailable", "resource exhausted"),
        max_attempts=3,
    ),
    RecoveryPolicy(
        "fallback_on_kernel_failure",
        RecoveryStrategy.FALLBACK,
        error_types=(ComputationError,),
        message_substrings=("nan", "inf", "kernel"),
    ),
]


#: Bound methods called after every :func:`clear_plan_caches` while their
#: objects live (a serving engine drops its decode window's CUDA graphs,
#: which were captured against what the caches held).
_ON_CLEAR: List[weakref.WeakMethod] = []


def on_clear_plan_caches(method: Callable[[], None]) -> None:
    """Call the bound ``method`` after every :func:`clear_plan_caches`, for
    as long as its object lives (held weakly)."""
    _ON_CLEAR[:] = [ref for ref in _ON_CLEAR if ref() is not None]
    _ON_CLEAR.append(weakref.WeakMethod(method))


def clear_plan_caches() -> int:
    """Clear every ``functools.lru_cache`` of the port's loaded modules (the
    kernels' launch plans and the other memoised host work), then run the
    :func:`on_clear_plan_caches` hooks; returns how many caches were
    cleared."""
    package = __name__.split(".")[0]
    cleared = 0
    for name, module in list(sys.modules.items()):
        if module is None or (name != package and not name.startswith(package + ".")):
            continue
        for obj in list(vars(module).values()):
            if callable(getattr(obj, "cache_clear", None)) and hasattr(obj, "cache_info"):
                obj.cache_clear()
                cleared += 1
    for ref in list(_ON_CLEAR):
        method = ref()
        if method is None:
            _ON_CLEAR.remove(ref)
        else:
            method()
    return cleared


class CircuitState(str, enum.Enum):
    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"


class CircuitBreaker:
    """CLOSED/OPEN/HALF_OPEN breaker.

    Usable as a context manager or through :func:`with_circuit_breaker`.
    """

    def __init__(
        self,
        name: str,
        failure_threshold: int = 5,
        recovery_timeout_s: float = 30.0,
        half_open_max_calls: int = 1,
    ) -> None:
        self.name = name
        self.failure_threshold = failure_threshold
        self.recovery_timeout_s = recovery_timeout_s
        self.half_open_max_calls = half_open_max_calls
        self._state = CircuitState.CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._half_open_calls = 0
        self._lock = threading.RLock()

    @property
    def state(self) -> CircuitState:
        with self._lock:
            self._maybe_half_open()
            return self._state

    def _maybe_half_open(self) -> None:
        if (
            self._state == CircuitState.OPEN
            and time.time() - self._opened_at >= self.recovery_timeout_s
        ):
            self._state = CircuitState.HALF_OPEN
            self._half_open_calls = 0

    def __enter__(self) -> "CircuitBreaker":
        with self._lock:
            self._maybe_half_open()
            if self._state == CircuitState.OPEN:
                raise PhotonicFlashAttentionError(
                    f"circuit {self.name!r} is open", circuit=self.name
                )
            if self._state == CircuitState.HALF_OPEN:
                if self._half_open_calls >= self.half_open_max_calls:
                    raise PhotonicFlashAttentionError(
                        f"circuit {self.name!r} half-open at capacity",
                        circuit=self.name,
                    )
                self._half_open_calls += 1
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        with self._lock:
            if exc is None:
                if self._state == CircuitState.HALF_OPEN:
                    logger.info("circuit %s recovered", self.name)
                self._state = CircuitState.CLOSED
                self._failures = 0
            else:
                self._failures += 1
                if (
                    self._state == CircuitState.HALF_OPEN
                    or self._failures >= self.failure_threshold
                ):
                    self._state = CircuitState.OPEN
                    self._opened_at = time.time()
                    logger.warning(
                        "circuit %s opened after %d failures", self.name, self._failures
                    )
        return False  # propagate

    def reset(self) -> None:
        with self._lock:
            self._state = CircuitState.CLOSED
            self._failures = 0


class ErrorRecoveryManager:
    """Policy table + strategy executors."""

    def __init__(self, policies: Optional[List[RecoveryPolicy]] = None) -> None:
        self.policies = list(policies or DEFAULT_POLICIES)
        self._breakers: Dict[str, CircuitBreaker] = {}
        self._lock = threading.RLock()
        self._events: List[Dict] = []

    def add_policy(self, policy: RecoveryPolicy, front: bool = True) -> None:
        if front:
            self.policies.insert(0, policy)
        else:
            self.policies.append(policy)

    def breaker(self, name: str, **kwargs: Any) -> CircuitBreaker:
        with self._lock:
            if name not in self._breakers:
                self._breakers[name] = CircuitBreaker(name, **kwargs)
            return self._breakers[name]

    def select_policy(self, error: BaseException) -> Optional[RecoveryPolicy]:
        for policy in self.policies:
            if policy.matches(error):
                return policy
        return None

    def handle_error(
        self,
        error: BaseException,
        operation: Callable[[], Any],
        fallback: Optional[Callable[[], Any]] = None,
        degrade: Optional[Callable[[], Any]] = None,
    ) -> Any:
        """Resolve one failure.

        ``operation`` retries the original call; ``fallback``/``degrade``
        are the alternate paths a caller provides (e.g. the fused path /
        a higher-precision mode).
        """
        policy = self.select_policy(error)
        self._record(error, policy)
        if policy is None or policy.strategy == RecoveryStrategy.ABORT:
            raise error

        if policy.strategy == RecoveryStrategy.RETRY:
            delay = policy.backoff_s
            last = error
            for _ in range(policy.max_attempts):
                time.sleep(delay)
                delay *= policy.backoff_multiplier
                try:
                    return operation()
                except Exception as e:  # noqa: BLE001
                    last = e
            raise last

        if policy.strategy == RecoveryStrategy.RECOMPILE:
            logger.info("cleared %d plan caches for recompile recovery", clear_plan_caches())
            return operation()

        if policy.strategy == RecoveryStrategy.FALLBACK:
            if fallback is None:
                raise error
            return fallback()

        if policy.strategy == RecoveryStrategy.DEGRADE:
            target = degrade or fallback
            if target is None:
                raise error
            return target()

        raise error

    def _record(self, error: BaseException, policy: Optional[RecoveryPolicy]) -> None:
        with self._lock:
            self._events.append(
                {
                    "time": time.time(),
                    "error": type(error).__name__,
                    "message": str(error)[:200],
                    "policy": policy.name if policy else None,
                    "strategy": policy.strategy.value if policy else "unhandled",
                }
            )
            if len(self._events) > 1000:
                del self._events[:500]

    def get_stats(self) -> Dict:
        with self._lock:
            by_strategy: Dict[str, int] = {}
            for e in self._events:
                by_strategy[e["strategy"]] = by_strategy.get(e["strategy"], 0) + 1
            return {
                "total_errors": len(self._events),
                "by_strategy": by_strategy,
                "breakers": {name: b.state.value for name, b in self._breakers.items()},
            }


def with_error_recovery(
    fallback: Optional[Callable] = None,
    manager: Optional[ErrorRecoveryManager] = None,
):
    """Decorator: a failure of the call goes through the manager's policies."""

    def deco(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapper(*args: Any, **kwargs: Any) -> Any:
            mgr = manager or get_recovery_manager()
            try:
                return fn(*args, **kwargs)
            except Exception as e:  # noqa: BLE001
                return mgr.handle_error(
                    e,
                    operation=lambda: fn(*args, **kwargs),
                    fallback=(lambda: fallback(*args, **kwargs)) if fallback else None,
                )

        return wrapper

    return deco


def with_circuit_breaker(
    name: str,
    manager: Optional[ErrorRecoveryManager] = None,
    **breaker_kwargs: Any,
):
    """Decorator: the call runs inside the manager's breaker ``name``."""

    def deco(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapper(*args: Any, **kwargs: Any) -> Any:
            mgr = manager or get_recovery_manager()
            with mgr.breaker(name, **breaker_kwargs):
                return fn(*args, **kwargs)

        return wrapper

    return deco


_manager: Optional[ErrorRecoveryManager] = None
_manager_lock = threading.Lock()


def get_recovery_manager() -> ErrorRecoveryManager:
    """Global singleton."""
    global _manager
    if _manager is None:
        with _manager_lock:
            if _manager is None:
                _manager = ErrorRecoveryManager()
    return _manager


def reset_recovery_manager() -> None:
    global _manager
    with _manager_lock:
        _manager = None
