"""Fault tolerance: degradation ladder + resilient attention wrapper.

The rebirth of reference resilience/fault_tolerance.py:27-1113:

* ``GracefulDegradationManager`` (reference :201-328) — trigger ->
  config-rewrite table. The reference rewrote optical knobs
  (photonic-failure->gpu_only, thermal->reduce optical power); the TPU
  ladder rewrites real engine knobs: quantization accuracy failure ->
  raise precision (int8/fp8 -> bf16), memory pressure -> shrink batch /
  evict KV pages, latency SLO breach -> drop to the cheaper kernel,
  kernel failure -> pin the fused XLA path.
* ``ResilientAttentionWrapper`` (reference :939-1113) — composes circuit
  breaker + recovery policies + the degradation ladder around any
  attention callable, with a last-resort uniform-attention fallback
  (mean over values — finite, shape-correct, clearly flagged).

The reference's ``AutoRecoverySystem``'s named strategies (:331-608) are
covered by :mod:`..core.error_recovery`'s policy table.

Port of ``photonic_flash_attention_tpu/resilience/fault_tolerance.py``
under the port's contract (``core/error_recovery.py``): a kernel that
fails on CUDA tensors raises, and nothing answers in its place. The
ladder is JAX's, the same config rewrites; the engine reads
``quant_mode`` at each call, so QUANT_ACCURACY moves its next call from an
8-bit kind to a bf16 one (both kernels on the card). The wrapper differs
for a call on CUDA tensors:

* the failure is counted by the breaker and raised; the recovery manager
  is asked with no fallback, so it may retry a transient error but sends
  nothing to another path (its ABORT policy raises a kernel's failure);
* the KERNEL_FAILURE rung, which pins the plain FUSED path through
  ``flash_threshold``, is not applied;
* ``_last_resort`` (a uniform mean over V) is never used.

For CPU tensors the wrapper is JAX's: the rung after
``max_failures_before_degrade`` failures, the caller's fallback, and the
last resort.
"""

from __future__ import annotations

import dataclasses
import enum
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..config import get_config, set_global_config
from ..core.error_recovery import CircuitBreaker, get_recovery_manager
from ..utils.logging import get_logger

logger = get_logger("resilience")


class DegradationLevel(int, enum.Enum):
    NORMAL = 0
    REDUCED = 1  # precision raised / cheaper kernels preferred
    MINIMAL = 2  # fused XLA path only
    EMERGENCY = 3  # last-resort fallback answers


class DegradationTrigger(str, enum.Enum):
    QUANT_ACCURACY = "quant_accuracy"  # quantized output failed numeric gates
    MEMORY_PRESSURE = "memory_pressure"
    LATENCY_SLO = "latency_slo"
    KERNEL_FAILURE = "kernel_failure"


@dataclasses.dataclass
class DegradationAction:
    """One rung of the ladder: what config to rewrite and how to undo."""

    trigger: DegradationTrigger
    level: DegradationLevel
    description: str
    apply: Callable[[], None]
    revert: Callable[[], None]


class GracefulDegradationManager:
    """Trigger -> config-rewrite ladder (reference :201-328)."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._active: Dict[DegradationTrigger, DegradationAction] = {}
        self._history: List[Dict] = []
        self._saved: Dict[str, Any] = {}

    def _save(self, key: str) -> None:
        if key not in self._saved:
            self._saved[key] = getattr(get_config(), key)

    def _actions(self, trigger: DegradationTrigger) -> DegradationAction:
        cfg = get_config()
        if trigger == DegradationTrigger.QUANT_ACCURACY:
            self._save("quant_mode")
            self._save("kv_cache_dtype")
            return DegradationAction(
                trigger,
                DegradationLevel.REDUCED,
                "raise precision: quant_mode/kv_cache_dtype -> bf16",
                apply=lambda: set_global_config(quant_mode="bf16", kv_cache_dtype="bf16"),
                revert=lambda: set_global_config(
                    quant_mode=self._saved["quant_mode"],
                    kv_cache_dtype=self._saved["kv_cache_dtype"],
                ),
            )
        if trigger == DegradationTrigger.MEMORY_PRESSURE:
            self._save("max_batch_size")
            new_batch = max(1, cfg.max_batch_size // 2)
            return DegradationAction(
                trigger,
                DegradationLevel.REDUCED,
                f"halve max_batch_size -> {new_batch}",
                apply=lambda: set_global_config(max_batch_size=new_batch),
                revert=lambda: set_global_config(
                    max_batch_size=self._saved["max_batch_size"]
                ),
            )
        if trigger == DegradationTrigger.LATENCY_SLO:
            self._save("auto_kernel_selection")
            return DegradationAction(
                trigger,
                DegradationLevel.REDUCED,
                "freeze router exploration (static threshold dispatch)",
                apply=lambda: set_global_config(auto_kernel_selection=False),
                revert=lambda: set_global_config(
                    auto_kernel_selection=self._saved["auto_kernel_selection"]
                ),
            )
        # KERNEL_FAILURE
        self._save("flash_threshold")
        return DegradationAction(
            trigger,
            DegradationLevel.MINIMAL,
            "pin fused XLA path (flash_threshold -> inf)",
            apply=lambda: set_global_config(flash_threshold=1 << 30),
            revert=lambda: set_global_config(
                flash_threshold=self._saved["flash_threshold"]
            ),
        )

    def degrade(self, trigger: DegradationTrigger, reason: str = "") -> DegradationAction:
        with self._lock:
            if trigger in self._active:
                return self._active[trigger]
            action = self._actions(trigger)
            action.apply()
            self._active[trigger] = action
            self._history.append(
                {"time": time.time(), "event": "degrade", "trigger": trigger.value,
                 "action": action.description, "reason": reason}
            )
            logger.warning("degraded (%s): %s", trigger.value, action.description)
            return action

    def recover(self, trigger: DegradationTrigger) -> bool:
        with self._lock:
            action = self._active.pop(trigger, None)
            if action is None:
                return False
            action.revert()
            self._history.append(
                {"time": time.time(), "event": "recover", "trigger": trigger.value}
            )
            logger.info("recovered from %s", trigger.value)
            return True

    def recover_all(self) -> None:
        with self._lock:
            for trigger in list(self._active):
                self.recover(trigger)

    @property
    def level(self) -> DegradationLevel:
        with self._lock:
            if not self._active:
                return DegradationLevel.NORMAL
            return max(a.level for a in self._active.values())

    def get_status(self) -> Dict:
        with self._lock:
            return {
                "level": self.level.name,
                "active_triggers": [t.value for t in self._active],
                "history_len": len(self._history),
                "recent": self._history[-5:],
            }


def _on_card(*tensors: Any) -> bool:
    """Whether a call's tensors lie on a CUDA device."""
    return any(isinstance(t, torch.Tensor) and t.is_cuda for t in tensors)


class ResilientAttentionWrapper:
    """Compose breaker + recovery + degradation around an attention callable
    (reference fault_tolerance.py:939-1113).

    ``attention_fn(q, k, v, mask=None, **kw) -> (out, weights)``;
    the wrapper preserves that contract under failure.
    """

    def __init__(
        self,
        attention_fn: Callable,
        fallback_fn: Optional[Callable] = None,
        degradation: Optional[GracefulDegradationManager] = None,
        breaker: Optional[CircuitBreaker] = None,
        max_failures_before_degrade: int = 3,
    ) -> None:
        self.attention_fn = attention_fn
        self.fallback_fn = fallback_fn
        self.degradation = degradation or GracefulDegradationManager()
        self.breaker = breaker or CircuitBreaker("resilient_attention", 10, 15.0)
        self.max_failures_before_degrade = max_failures_before_degrade
        self._failures = 0
        self._successes = 0
        self._last_resort_uses = 0
        self._lock = threading.RLock()

    def __call__(self, q, k, v, mask=None, **kwargs) -> Tuple[Any, Any]:
        recovery = get_recovery_manager()
        try:
            with self.breaker:
                out = self.attention_fn(q, k, v, mask, **kwargs)
            with self._lock:
                self._successes += 1
                self._failures = 0
            return out
        except Exception as primary:  # noqa: BLE001
            on_card = _on_card(q, k, v)
            with self._lock:
                self._failures += 1
                if not on_card and self._failures >= self.max_failures_before_degrade:
                    self.degradation.degrade(
                        DegradationTrigger.KERNEL_FAILURE, str(primary)[:120]
                    )
            if on_card:
                # No plain path and no made-up output for CUDA tensors.
                return recovery.handle_error(
                    primary, operation=lambda: self.attention_fn(q, k, v, mask, **kwargs)
                )
            try:
                return recovery.handle_error(
                    primary,
                    operation=lambda: self.attention_fn(q, k, v, mask, **kwargs),
                    fallback=(
                        (lambda: self.fallback_fn(q, k, v, mask, **kwargs))
                        if self.fallback_fn
                        else None
                    ),
                )
            except Exception as secondary:  # noqa: BLE001
                logger.error(
                    "attention failed through all recovery paths: %s", secondary
                )
                return self._last_resort(q, k, v), None

    def _last_resort(self, q, k, v):
        """Finite, shape-correct emergency output: uniform attention
        (mean over values) — the reference's identity-ish fallback
        (fault_tolerance.py:1060-1113). CPU tensors only."""
        with self._lock:
            self._last_resort_uses += 1
        hq = q.shape[2]
        hkv = v.shape[2]
        vv = v.repeat_interleave(hq // hkv, dim=2) if hq != hkv else v
        out = vv.float().mean(dim=1, keepdim=True).expand(q.shape)
        return out.to(q.dtype)

    def get_status(self) -> Dict:
        with self._lock:
            return {
                "successes": self._successes,
                "consecutive_failures": self._failures,
                "last_resort_uses": self._last_resort_uses,
                "breaker_state": self.breaker.state.value,
                "degradation": self.degradation.get_status(),
            }
