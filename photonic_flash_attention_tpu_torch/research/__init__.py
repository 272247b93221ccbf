"""Research: novel attention algorithms + benchmark harness."""

from .novel_algorithms import (
    AlgorithmResult,
    HierarchicalAttention,
    QuantumInspiredAttention,
    ResearchBenchmark,
    SpectralAttention,
)

__all__ = [
    "AlgorithmResult",
    "HierarchicalAttention",
    "QuantumInspiredAttention",
    "ResearchBenchmark",
    "SpectralAttention",
]
