"""Paged KV cache with host-side page tables (PyTorch).

Port of ``photonic_flash_attention_tpu/core/kv_cache.py``: one pool of K
pages and one of V pages, a host free list, per-sequence page tables and
the memory-manager surface (``allocate_sequence``/``free_sequence``/
``temporary_sequence``/``get_memory_stats``), with ``KVCacheError`` on an
exhausted pool or a sequence over ``max_pages_per_seq``.

Differences from JAX:

* the pools are **token-major**, ``(num_kv_heads, num_pages, page_size,
  head_dim)``, int8 scales ``(num_kv_heads, num_pages, page_size)``: the
  layout of the port's ``KVPages`` (``models/gpt2_serving.py``), so
  ``ops/paged.py::paged_attention`` (kernel K3 on the card) reads the
  cache's tensors without a copy. JAX's are token-minor
  ``(num_kv_heads, num_pages, head_dim, page_size)``;
* the pools live on ``device``, the card unless the caller passes
  ``device="cpu"``, and ``append`` writes them in place (one indexed
  scatter, plain PyTorch, where JAX scatters token runs with XLA
  ``.at[].set``). The int8 payload and scales are bit-equal to JAX's.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..ops.paged import _quant_token_write
from ..utils.exceptions import KVCacheError


@dataclasses.dataclass
class SequenceInfo:
    seq_id: int
    page_ids: List[int]
    length: int  # tokens currently stored


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"`` (JAX's ``str(jnp.dtype(...))``)."""
    return str(dtype).replace("torch.", "")


class PagedKVCache:
    """Paged KV storage for one attention layer (or shared trunk).

    Args:
      num_pages: total physical pages in the pool.
      page_size: tokens per page.
      num_kv_heads / head_dim: KV geometry.
      dtype: payload dtype: ``torch.bfloat16``, ``torch.float32`` or
        ``torch.int8`` (per-token scales maintained automatically).
      max_pages_per_seq: page-table width.
      device: where the pools live (the card by default).
    """

    def __init__(
        self,
        num_pages: int,
        page_size: int,
        num_kv_heads: int,
        head_dim: int,
        dtype: torch.dtype = torch.bfloat16,
        max_pages_per_seq: int = 128,
        device: Any = "cuda",
    ) -> None:
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("PagedKVCache lives on the card by default and CUDA is not "
                               "available; pass device='cpu' to keep it on the CPU")
        self.num_pages = num_pages
        self.page_size = page_size
        self.num_kv_heads = num_kv_heads
        self.head_dim = head_dim
        self.dtype = dtype
        self.quantized = dtype == torch.int8
        self.max_pages_per_seq = max_pages_per_seq

        shape = (num_kv_heads, num_pages, page_size, head_dim)
        self.k_pages = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v_pages = torch.zeros(shape, dtype=dtype, device=self.device)
        if self.quantized:
            self.k_scales = torch.ones(shape[:3], device=self.device)
            self.v_scales = torch.ones(shape[:3], device=self.device)
        else:
            self.k_scales = None
            self.v_scales = None

        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        self._sequences: Dict[int, SequenceInfo] = {}
        self._lock = threading.RLock()
        self._next_seq_id = 0
        self._alloc_count = 0
        self._free_count = 0
        self._oom_events = 0
        self._peak_pages_used = 0

    # -- allocation -------------------------------------------------------

    def allocate_sequence(self, num_tokens: int = 0, seq_id: Optional[int] = None) -> int:
        """Create a sequence, reserving pages for ``num_tokens``."""
        with self._lock:
            if seq_id is None:
                seq_id = self._next_seq_id
                self._next_seq_id += 1
            if seq_id in self._sequences:
                raise KVCacheError(f"sequence {seq_id} already allocated")
            info = SequenceInfo(seq_id, [], 0)
            self._sequences[seq_id] = info
            if num_tokens:
                self._reserve(info, num_tokens)
            return seq_id

    def _reserve(self, info: SequenceInfo, total_tokens: int) -> None:
        pages_needed = -(-total_tokens // self.page_size) - len(info.page_ids)
        if pages_needed <= 0:
            return
        if len(info.page_ids) + pages_needed > self.max_pages_per_seq:
            raise KVCacheError(
                f"sequence needs {len(info.page_ids) + pages_needed} pages "
                f"> max_pages_per_seq {self.max_pages_per_seq}"
            )
        if pages_needed > len(self._free):
            self._oom_events += 1
            raise KVCacheError(
                "KV cache out of pages",
                requested_bytes=pages_needed * self.page_bytes,
                available_bytes=len(self._free) * self.page_bytes,
            )
        for _ in range(pages_needed):
            info.page_ids.append(self._free.pop())
        self._alloc_count += pages_needed
        used = self.num_pages - len(self._free)
        self._peak_pages_used = max(self._peak_pages_used, used)

    def free_sequence(self, seq_id: int) -> None:
        """Release a sequence's pages (not zeroed: they are logically invalid)."""
        with self._lock:
            info = self._sequences.pop(seq_id, None)
            if info is None:
                raise KVCacheError(f"unknown sequence {seq_id}")
            self._free.extend(info.page_ids)
            self._free_count += len(info.page_ids)

    def temporary_sequence(self, num_tokens: int = 0):
        """Context manager: a sequence freed on exit."""
        cache = self

        class _Tmp:
            def __enter__(self) -> int:
                self.seq_id = cache.allocate_sequence(num_tokens)
                return self.seq_id

            def __exit__(self, *exc) -> None:
                cache.free_sequence(self.seq_id)

        return _Tmp()

    # -- writes -----------------------------------------------------------

    def append(self, seq_id: int, k: torch.Tensor, v: torch.Tensor) -> None:
        """Append ``(S_new, num_kv_heads, head_dim)`` K/V tokens."""
        with self._lock:
            info = self._sequences.get(seq_id)
            if info is None:
                raise KVCacheError(f"unknown sequence {seq_id}")
            s_new = k.shape[0]
            self._reserve(info, info.length + s_new)
            start = info.length
            info.length += s_new
            pages = list(info.page_ids)
        if s_new == 0:
            return
        tok = torch.arange(start, start + s_new)
        table = torch.tensor(pages)
        pids = table[tok // self.page_size].to(self.device)
        offs = (tok % self.page_size).to(self.device)
        k = k.to(self.device)
        v = v.to(self.device)
        if self.quantized:
            kq, ks = _quant_token_write(k)
            vq, vs = _quant_token_write(v)
            self.k_scales[:, pids, offs] = ks.transpose(0, 1)
            self.v_scales[:, pids, offs] = vs.transpose(0, 1)
        else:
            kq, vq = k.to(self.dtype), v.to(self.dtype)
        self.k_pages[:, pids, offs] = kq.transpose(0, 1)
        self.v_pages[:, pids, offs] = vq.transpose(0, 1)

    # -- reads ------------------------------------------------------------

    def sequence_length(self, seq_id: int) -> int:
        info = self._sequences.get(seq_id)
        if info is None:
            raise KVCacheError(f"unknown sequence {seq_id}")
        return info.length

    def page_table(self, seq_ids: List[int]) -> Tuple[torch.Tensor, torch.Tensor]:
        """(lengths (B,), page_indices (B, max_pages_per_seq)) int32 on the
        cache's device; unused entries are 0."""
        lengths = []
        tables = []
        with self._lock:
            for sid in seq_ids:
                info = self._sequences.get(sid)
                if info is None:
                    raise KVCacheError(f"unknown sequence {sid}")
                lengths.append(info.length)
                tables.append(info.page_ids + [0] * (self.max_pages_per_seq - len(info.page_ids)))
        return (
            torch.tensor(lengths, dtype=torch.int32, device=self.device),
            torch.tensor(tables, dtype=torch.int32, device=self.device).reshape(
                len(seq_ids), self.max_pages_per_seq),
        )

    def gather_kv(self, seq_id: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Densify one sequence's K/V to (S, H, D) fp32 (the oracle path)."""
        info = self._sequences.get(seq_id)
        if info is None:
            raise KVCacheError(f"unknown sequence {seq_id}")
        n_pages = -(-info.length // self.page_size)
        ids = torch.tensor(info.page_ids[:n_pages], dtype=torch.long, device=self.device)

        def dense(pages, scales):
            x = pages[:, ids].float()  # (H, n_pages, page, D)
            if scales is not None:
                x = x * scales[:, ids, :, None]
            return x.reshape(self.num_kv_heads, -1, self.head_dim)[:, : info.length].transpose(0, 1)

        return dense(self.k_pages, self.k_scales), dense(self.v_pages, self.v_scales)

    # -- stats ------------------------------------------------------------

    @property
    def page_bytes(self) -> int:
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        b = 2 * self.num_kv_heads * self.page_size * self.head_dim * itemsize
        if self.quantized:
            b += 2 * self.num_kv_heads * self.page_size * 4
        return b

    def get_memory_stats(self) -> Dict:
        """Pool stats (the JAX cache's keys)."""
        with self._lock:
            used = self.num_pages - len(self._free)
            return {
                "num_pages": self.num_pages,
                "pages_used": used,
                "pages_free": len(self._free),
                "utilization": used / self.num_pages,
                "peak_pages_used": self._peak_pages_used,
                "sequences": len(self._sequences),
                "alloc_count": self._alloc_count,
                "free_count": self._free_count,
                "oom_events": self._oom_events,
                "page_bytes": self.page_bytes,
                "pool_bytes": self.num_pages * self.page_bytes,
                "dtype": dtype_name(self.dtype),
            }


_cache_singleton: Optional[PagedKVCache] = None
_cache_lock = threading.Lock()


def get_kv_cache(**kwargs) -> PagedKVCache:
    """Module-level singleton (JAX's defaults: 1024 pages of 128 tokens,
    12 heads of 64)."""
    global _cache_singleton
    if _cache_singleton is None:
        with _cache_lock:
            if _cache_singleton is None:
                kwargs.setdefault("num_pages", 1024)
                kwargs.setdefault("page_size", 128)
                kwargs.setdefault("num_kv_heads", 12)
                kwargs.setdefault("head_dim", 64)
                _cache_singleton = PagedKVCache(**kwargs)
    return _cache_singleton


def reset_kv_cache() -> None:
    global _cache_singleton
    with _cache_lock:
        _cache_singleton = None
