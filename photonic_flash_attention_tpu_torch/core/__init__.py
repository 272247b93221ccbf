"""Core runtime: engine, router, autotuner, serving, KV cache, checkpointing,
error recovery (the JAX package's ``core`` exports)."""

from .autotuner import Autotuner, TuneResult, candidate_blocks
from .checkpoint import (
    CheckpointManager,
    engine_state_dict,
    restore_engine_state,
    restore_kv_cache,
    save_kv_cache,
)
from .engine import AttentionEngine, get_engine, reset_engine
from .kv_cache import PagedKVCache, get_kv_cache, reset_kv_cache
from .router import AdaptiveRouter, KernelKind, WorkloadCharacteristics

__all__ = [
    "AdaptiveRouter",
    "AttentionEngine",
    "Autotuner",
    "CheckpointManager",
    "KernelKind",
    "PagedKVCache",
    "TuneResult",
    "WorkloadCharacteristics",
    "candidate_blocks",
    "engine_state_dict",
    "get_engine",
    "get_kv_cache",
    "reset_engine",
    "reset_kv_cache",
    "restore_engine_state",
    "restore_kv_cache",
    "save_kv_cache",
]
