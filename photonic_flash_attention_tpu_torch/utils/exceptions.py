"""Typed exception hierarchy (copied from the JAX package's utils/exceptions.py).

Mirrors the reference's hierarchy rooted at ``PhotonicFlashAttentionError``
(reference src/.../utils/exceptions.py:4-121), with hardware/thermal errors
re-expressed for TPU concerns (compilation, kernel, memory, distribution).
"""

from __future__ import annotations

from typing import Any, Optional


class PhotonicFlashAttentionError(Exception):
    """Base class for all engine errors."""

    def __init__(self, message: str, **context: Any) -> None:
        super().__init__(message)
        self.message = message
        self.context = context

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        if self.context:
            ctx = ", ".join(f"{k}={v!r}" for k, v in self.context.items())
            return f"{self.message} ({ctx})"
        return self.message


class ConfigurationError(PhotonicFlashAttentionError):
    """Invalid or inconsistent configuration."""


class ValidationError(PhotonicFlashAttentionError):
    """Invalid inputs (shapes, dtypes, ranges)."""


class HardwareError(PhotonicFlashAttentionError):
    """TPU device unavailable / failed (reference: PhotonicHardwareError)."""

    def __init__(self, message: str, device_id: Optional[str] = None, **context: Any) -> None:
        super().__init__(message, device_id=device_id, **context)
        self.device_id = device_id


class ComputationError(PhotonicFlashAttentionError):
    """Numerical failure in a kernel (NaN/Inf, mismatched partials)."""

    def __init__(self, message: str, operation: Optional[str] = None, **context: Any) -> None:
        super().__init__(message, operation=operation, **context)
        self.operation = operation


class CompilationError(PhotonicFlashAttentionError):
    """XLA/Mosaic compilation failure for a kernel variant."""


class KernelLaunchError(PhotonicFlashAttentionError, RuntimeError):
    """A CUDA kernel of the port failed to build or to launch on the card
    (the port's own; a ``RuntimeError`` as well). It is never answered by a
    plain version: see ``core/error_recovery.py``."""


class MemoryError_(PhotonicFlashAttentionError):
    """HBM / KV-cache exhaustion (reference: PhotonicMemoryError)."""

    def __init__(
        self,
        message: str,
        requested_bytes: Optional[int] = None,
        available_bytes: Optional[int] = None,
        **context: Any,
    ) -> None:
        super().__init__(
            message,
            requested_bytes=requested_bytes,
            available_bytes=available_bytes,
            **context,
        )
        self.requested_bytes = requested_bytes
        self.available_bytes = available_bytes


class KVCacheError(MemoryError_):
    """Paged KV-cache specific failure (no free pages, bad sequence id)."""


class DistributionError(PhotonicFlashAttentionError):
    """Mesh/sharding/collective failure."""


class TimeoutError_(PhotonicFlashAttentionError):
    """Operation exceeded its deadline (reference: PhotonicTimeoutError)."""


class SecurityError(PhotonicFlashAttentionError):
    """Rejected input or policy violation."""


class CalibrationError(PhotonicFlashAttentionError):
    """Quantization calibration failed its error budget."""


class CheckpointError(PhotonicFlashAttentionError):
    """Checkpoint save/restore failed or checkpoint is missing/incomplete."""
