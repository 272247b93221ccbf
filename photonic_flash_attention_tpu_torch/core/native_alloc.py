"""ctypes binding for the native (C++) page allocator.

Port of ``photonic_flash_attention_tpu/core/native_alloc.py``. The port
keeps its own copy of the source, ``native/page_allocator.cpp``, and builds
it with g++ at first use into the package's ``_build/``
(``ops/_build.py::host_library``; a library named by the hash of its source,
never beside the JAX sources). ``NativePageAllocator`` has the contract of
``core/serving.py::_PyPageAllocator``: page 0 reserved as the trash page,
the same page ids handed out in the same order, the same ``KVCacheError``
on an exhausted pool or a request over ``max_pages_per_seq``.

:func:`load` raises when the library cannot be built; :func:`native_available`
says whether it can, and the engine keeps the Python allocator where it
cannot (a host without g++).
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, List

from ..ops import _build
from ..utils.exceptions import KVCacheError
from ..utils.logging import get_logger

logger = get_logger("native_alloc")

SOURCE = Path(__file__).resolve().parent.parent / "native" / "page_allocator.cpp"


def library_path() -> Path:
    """The built library (built now if it is not there yet)."""
    return _build.host_library(SOURCE, "alloc")


def load() -> ctypes.CDLL:
    """The loaded allocator library, its C signatures set; raises if it
    cannot be built."""
    lib = _build.load_host_library(SOURCE, "alloc")
    lib.pfa_alloc_create.restype = ctypes.c_void_p
    lib.pfa_alloc_create.argtypes = [ctypes.c_int32] * 4
    lib.pfa_alloc_destroy.argtypes = [ctypes.c_void_p]
    lib.pfa_alloc_sequence.restype = ctypes.c_int64
    lib.pfa_alloc_sequence.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    for name in ("pfa_extend", "pfa_set_length"):
        getattr(lib, name).restype = ctypes.c_int32
        getattr(lib, name).argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32]
    for name in ("pfa_free_sequence", "pfa_length"):
        getattr(lib, name).restype = ctypes.c_int32
        getattr(lib, name).argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.pfa_get_pages.restype = ctypes.c_int32
    lib.pfa_get_pages.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
    ]
    lib.pfa_stats.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
    return lib


def native_available() -> bool:
    try:
        load()
        return True
    except Exception as e:  # noqa: BLE001 - reported, and the caller keeps Python
        logger.warning("native allocator unavailable: %s", e)
        return False


class NativePageAllocator:
    """C++-backed page allocator (see ``native/page_allocator.cpp``)."""

    def __init__(
        self,
        num_pages: int,
        page_size: int,
        max_pages_per_seq: int,
        reserve_trash_page: bool = True,
    ) -> None:
        lib = load()
        self._lib = lib
        self._handle = lib.pfa_alloc_create(
            num_pages, page_size, max_pages_per_seq, 1 if reserve_trash_page else 0
        )
        if not self._handle:
            raise KVCacheError("native allocator creation failed")
        self.num_pages = num_pages
        self.page_size = page_size
        self.max_pages_per_seq = max_pages_per_seq

    def __del__(self) -> None:
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.pfa_alloc_destroy(handle)
            self._handle = None

    def allocate_sequence(self, reserve_tokens: int = 0) -> int:
        sid = self._lib.pfa_alloc_sequence(self._handle, reserve_tokens)
        if sid == -1:
            raise KVCacheError("KV cache out of pages")
        if sid == -2:
            raise KVCacheError("request exceeds max_pages_per_seq")
        return int(sid)

    def extend(self, seq_id: int, new_total_tokens: int) -> None:
        rc = self._lib.pfa_extend(self._handle, seq_id, new_total_tokens)
        if rc == -1:
            raise KVCacheError("KV cache out of pages")
        if rc == -2:
            raise KVCacheError("request exceeds max_pages_per_seq")
        if rc == -3:
            raise KVCacheError(f"unknown sequence {seq_id}")

    def set_length(self, seq_id: int, tokens: int) -> None:
        if self._lib.pfa_set_length(self._handle, seq_id, tokens) != 0:
            raise KVCacheError(f"unknown sequence {seq_id}")

    def length(self, seq_id: int) -> int:
        n = self._lib.pfa_length(self._handle, seq_id)
        if n == -3:
            raise KVCacheError(f"unknown sequence {seq_id}")
        return int(n)

    def free_sequence(self, seq_id: int) -> None:
        if self._lib.pfa_free_sequence(self._handle, seq_id) != 0:
            raise KVCacheError(f"unknown sequence {seq_id}")

    def page_ids(self, seq_id: int) -> List[int]:
        buf = (ctypes.c_int32 * self.max_pages_per_seq)()
        n = self._lib.pfa_get_pages(self._handle, seq_id, buf, self.max_pages_per_seq)
        if n == -3:
            raise KVCacheError(f"unknown sequence {seq_id}")
        if n < 0:
            raise KVCacheError(f"page table read failed ({n})")
        return list(buf[:n])

    def stats(self) -> Dict[str, int]:
        out = (ctypes.c_int64 * 7)()
        self._lib.pfa_stats(self._handle, out)
        keys = ("pages_used", "pages_free", "alloc_count", "free_count", "oom_events",
                "peak_pages_used", "sequences")
        return dict(zip(keys, [int(v) for v in out]))
