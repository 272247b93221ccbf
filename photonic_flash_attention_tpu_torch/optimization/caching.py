"""Caching: result cache + persistent compile cache.

The rebirth of the reference's two cache stacks:

* ``ResultCache`` + ``cached_computation`` — reference
  scaling/cache_manager.py:32-631 (LRU/LFU/TTL eviction, computation
  results keyed on tensor shapes/dtypes + scalar args, hit/miss stats).
  On TPU the *useful* result cache is host-side memoization of pure
  computations on identical inputs (calibration sweeps, routing probes),
  not activation caching — kept deliberately small and explicit.
* ``CompileCacheManager`` — the reference's multi-level tensor cache
  (optimization/advanced_caching.py:27-879) has no TPU analogue worth
  faking, but its *purpose* (avoid recomputing expensive artifacts) maps
  exactly to XLA's persistent compilation cache: enabling it makes every
  kernel/model compile a disk artifact reusable across processes — the
  single highest-value cache on TPU.

Port of ``photonic_flash_attention_tpu/optimization/caching.py``. The
result caches (``ResultCache``, ``MultiLevelCacheManager``,
``cached_computation``) are copies. Two parts differ:

* ``_array_fingerprint`` takes the same ~256 strided elements as JAX's on
  the tensor's own device and copies only those to the host; on equal
  data the digest of a float32 or integer tensor equals JAX's, and a
  bfloat16 tensor hashes its raw 16-bit words (as JAX's ``tobytes`` of a
  bfloat16 array does). The dtype is named as JAX names it.
* ``CompileCacheManager`` manages the port's one compile cache, the kernel
  build directory (``ops/_build.py::BUILD_DIR``), where each library's
  file name carries a hash of its sources and flags, so an edited source
  builds a new one and an unchanged one is reused across processes. The
  port compiles nothing else (no ``torch.compile``). ``stats()`` counts the
  libraries there.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import os
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..utils.logging import get_logger

logger = get_logger("caching")


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    expirations: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def as_dict(self) -> Dict:
        return {**dataclasses.asdict(self), "hit_rate": self.hit_rate}


class ResultCache:
    """LRU/LFU/TTL result cache (reference cache_manager.py:177-262)."""

    def __init__(
        self,
        capacity: int = 256,
        policy: str = "lru",  # lru | lfu | fifo
        ttl_s: Optional[float] = None,
    ) -> None:
        if policy not in ("lru", "lfu", "fifo"):
            raise ValueError(f"unknown eviction policy {policy!r}")
        self.capacity = capacity
        self.policy = policy
        self.ttl_s = ttl_s
        self._data: "OrderedDict[Any, Tuple[Any, float]]" = OrderedDict()
        self._freq: Dict[Any, int] = {}
        self._lock = threading.RLock()
        self.stats = CacheStats()

    def get(self, key: Any, default: Any = None) -> Any:
        with self._lock:
            entry = self._data.get(key)
            if entry is None:
                self.stats.misses += 1
                return default
            value, ts = entry
            if self.ttl_s is not None and time.time() - ts > self.ttl_s:
                del self._data[key]
                self._freq.pop(key, None)
                self.stats.expirations += 1
                self.stats.misses += 1
                return default
            self.stats.hits += 1
            self._freq[key] = self._freq.get(key, 0) + 1
            if self.policy == "lru":
                self._data.move_to_end(key)
            return value

    def put(self, key: Any, value: Any) -> None:
        with self._lock:
            if key in self._data:
                self._data[key] = (value, time.time())
                if self.policy == "lru":
                    self._data.move_to_end(key)
                return
            while len(self._data) >= self.capacity:
                self._evict_one()
            self._data[key] = (value, time.time())
            self._freq[key] = 0

    def _evict_one(self) -> None:
        if not self._data:
            return
        if self.policy == "lfu":
            victim = min(self._data, key=lambda k: self._freq.get(k, 0))
        else:  # lru and fifo both evict the head (lru moves-to-end on hit)
            victim = next(iter(self._data))
        del self._data[victim]
        self._freq.pop(victim, None)
        self.stats.evictions += 1

    def clear(self) -> None:
        with self._lock:
            self._data.clear()
            self._freq.clear()

    def __len__(self) -> int:
        return len(self._data)


def _array_fingerprint(x: Any) -> Tuple:
    """Cheap content-aware key: shape + dtype + a sampled hash.

    The reference keys on shapes only (cache_manager.py:447-517), which
    silently aliases different data; sampling 1 KB of bytes keeps keys
    cheap while making collisions across different inputs unlikely.
    """
    if not isinstance(x, torch.Tensor):
        arr = np.asarray(x)
        sample = arr.reshape(-1)[:: max(1, arr.size // 256)].tobytes()
        digest = hashlib.blake2b(sample, digest_size=8).hexdigest()
        return ("arr", arr.shape, str(arr.dtype), digest)
    flat = x.detach().reshape(-1)
    picked = flat[:: max(1, flat.numel() // 256)]
    if picked.dtype == torch.bfloat16:
        picked = picked.view(torch.int16)  # numpy has no bfloat16: hash the raw words
    sample = picked.contiguous().cpu().numpy().tobytes()
    digest = hashlib.blake2b(sample, digest_size=8).hexdigest()
    return ("arr", tuple(x.shape), str(x.dtype).removeprefix("torch."), digest)


def cache_key(*args: Any, **kwargs: Any) -> Tuple:
    parts = []
    for a in list(args) + sorted(kwargs.items()):
        if isinstance(a, tuple) and len(a) == 2 and isinstance(a[0], str):
            name, val = a
            parts.append((name,) + cache_key(val))
        elif hasattr(a, "shape") and hasattr(a, "dtype"):
            parts.append(_array_fingerprint(a))
        elif isinstance(a, (int, float, str, bool, type(None))):
            parts.append(a)
        else:
            parts.append(repr(a)[:128])
    return tuple(parts)


def cached_computation(cache: Optional[ResultCache] = None):
    """Memoize a pure array computation (reference ``cached_computation``)."""
    local = cache or ResultCache(capacity=64)

    def deco(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapper(*args: Any, **kwargs: Any) -> Any:
            key = (fn.__qualname__,) + cache_key(*args, **kwargs)
            sentinel = object()
            hit = local.get(key, sentinel)
            if hit is not sentinel:
                return hit
            out = fn(*args, **kwargs)
            local.put(key, out)
            return out

        wrapper.cache = local  # type: ignore[attr-defined]
        return wrapper

    return deco


class CompileCacheManager:
    """The kernel build directory: the port's persistent compile cache.

    ``ops/_build.py`` writes every library it builds there (the CUDA
    kernels' ``libpfa_kernels_<hash>.so``, the host libraries'
    ``libpfa_<name>_<hash>.so``) and reuses one whose hash matches, so the
    cache is on whenever the directory exists. ``enable`` creates it.
    """

    def __init__(self, cache_dir: Optional[str] = None) -> None:
        if cache_dir is None:
            from ..ops._build import BUILD_DIR

            cache_dir = str(BUILD_DIR)
        self.cache_dir = cache_dir
        self.enabled = os.path.isdir(cache_dir)

    def enable(self) -> None:
        os.makedirs(self.cache_dir, exist_ok=True)
        self.enabled = True
        logger.info("kernel build cache at %s", self.cache_dir)

    def stats(self) -> Dict:
        """The built libraries (``lib*.so``) in the directory: count and bytes."""
        n, size = 0, 0
        if os.path.isdir(self.cache_dir):
            for f in os.listdir(self.cache_dir):
                if f.startswith("lib") and f.endswith(".so"):
                    n += 1
                    try:
                        size += os.path.getsize(os.path.join(self.cache_dir, f))
                    except OSError:
                        pass
        return {
            "enabled": self.enabled,
            "dir": self.cache_dir,
            "entries": n,
            "bytes": size,
        }


class MultiLevelCacheManager:
    """L1/L2/L3 cache hierarchy with promotion (reference
    optimization/advanced_caching.py:673-752).

    * L1: small, LRU — hot working set.
    * L2: medium, LRU — recently useful.
    * L3: large, LFU with transparent zlib compression of pickled
      values — long-tail artifacts (tuned profiles, calibration sweeps,
      rendered reports).

    Entries enter at L2; an entry promotes one level after
    ``promotion_threshold`` hits at its current level (the reference
    promotes after 3 accesses); L1/L2 evictions demote one level instead
    of dropping.
    """

    PROMOTION_THRESHOLD = 3

    def __init__(
        self,
        l1_capacity: int = 64,
        l2_capacity: int = 256,
        l3_capacity: int = 1024,
        compress_l3: bool = True,
    ) -> None:
        self.l1 = ResultCache(l1_capacity, policy="lru")
        self.l2 = ResultCache(l2_capacity, policy="lru")
        self.l3 = ResultCache(l3_capacity, policy="lfu")
        self.compress_l3 = compress_l3
        self._hits_at_level: Dict[Any, int] = {}
        self._lock = threading.RLock()
        self.stats = CacheStats()

    # -- L3 payload codec ---------------------------------------------------

    def _pack(self, value: Any) -> Any:
        if not self.compress_l3:
            return value
        import pickle
        import zlib

        try:
            return ("z", zlib.compress(pickle.dumps(value), level=1))
        except Exception:  # noqa: BLE001 - unpicklable values stay raw
            return value

    def _unpack(self, value: Any) -> Any:
        if (
            isinstance(value, tuple)
            and len(value) == 2
            and value[0] == "z"
            and isinstance(value[1], bytes)
        ):
            import pickle
            import zlib

            return pickle.loads(zlib.decompress(value[1]))
        return value

    # -- public surface -----------------------------------------------------

    def get(self, key: Any, default: Any = None) -> Any:
        sentinel = object()
        with self._lock:
            for level, cache in ((1, self.l1), (2, self.l2), (3, self.l3)):
                hit = cache.get(key, sentinel)
                if hit is sentinel:
                    continue
                self.stats.hits += 1
                value = self._unpack(hit) if level == 3 else hit
                n = self._hits_at_level.get(key, 0) + 1
                if n >= self.PROMOTION_THRESHOLD and level > 1:
                    self._move(key, value, level, level - 1)
                    self._hits_at_level[key] = 0
                else:
                    self._hits_at_level[key] = n
                return value
            self.stats.misses += 1
            return default

    def put(self, key: Any, value: Any) -> None:
        with self._lock:
            self._demote_overflow(self.l2, 2)
            self.l2.put(key, value)
            self._hits_at_level[key] = 0

    def _move(self, key: Any, value: Any, src_level: int, dst_level: int) -> None:
        src = (None, self.l1, self.l2, self.l3)[src_level]
        dst = (None, self.l1, self.l2, self.l3)[dst_level]
        with src._lock:
            src._data.pop(key, None)
            src._freq.pop(key, None)
        self._demote_overflow(dst, dst_level)
        dst.put(key, self._pack(value) if dst is self.l3 else value)

    def _demote_overflow(self, cache: ResultCache, level: int) -> None:
        """Before inserting into a full L1/L2, demote its victim downward
        instead of letting ResultCache drop it."""
        if cache is self.l3:
            return
        with cache._lock:
            if len(cache._data) < cache.capacity:
                return
            victim = next(iter(cache._data))
            value, _ = cache._data.pop(victim)
            cache._freq.pop(victim, None)
            cache.stats.evictions += 1
        self._move_down(victim, value, level)

    def _move_down(self, key: Any, value: Any, from_level: int) -> None:
        dst = self.l2 if from_level == 1 else self.l3
        self._demote_overflow(dst, from_level + 1)
        dst.put(key, self._pack(value) if dst is self.l3 else value)
        self._hits_at_level[key] = 0

    def clear(self) -> None:
        with self._lock:
            for c in (self.l1, self.l2, self.l3):
                c.clear()
            self._hits_at_level.clear()

    def get_stats(self) -> Dict:
        return {
            "overall": self.stats.as_dict(),
            "l1": {"entries": len(self.l1), **self.l1.stats.as_dict()},
            "l2": {"entries": len(self.l2), **self.l2.stats.as_dict()},
            "l3": {"entries": len(self.l3), **self.l3.stats.as_dict()},
        }
