"""Resilience: degradation ladder, resilient wrapper, circuit breaking."""

from .fault_tolerance import (
    DegradationLevel,
    DegradationTrigger,
    GracefulDegradationManager,
    ResilientAttentionWrapper,
)

__all__ = [
    "DegradationLevel",
    "DegradationTrigger",
    "GracefulDegradationManager",
    "ResilientAttentionWrapper",
]
