"""Optimization: caching, profiling, adaptive operation wrapping."""

from .caching import (
    CacheStats,
    CompileCacheManager,
    MultiLevelCacheManager,
    ResultCache,
    cache_key,
    cached_computation,
)
from .performance_optimizer import (
    AdaptiveOptimizer,
    WorkloadProfiler,
    get_performance_optimizer,
)

__all__ = [
    "AdaptiveOptimizer",
    "CacheStats",
    "CompileCacheManager",
    "MultiLevelCacheManager",
    "ResultCache",
    "WorkloadProfiler",
    "cache_key",
    "cached_computation",
    "get_performance_optimizer",
]
