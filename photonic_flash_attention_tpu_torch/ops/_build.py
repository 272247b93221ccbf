"""Build, load and launch the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for sm_90a into ONE shared
library with a plain C interface, loaded with ``ctypes``; no source
includes PyTorch's headers, which would make every build far slower. The
library lands in ``_build/`` (listed in ``.gitignore``) under a name that
carries the hash of the sources and flags, so an edited source rebuilds at
its next use.

Each C entry point takes pointers and the CUDA stream as ``c_void_p`` and
sizes as ``c_int``, launches on that stream and returns
``cudaGetLastError()``; :func:`launch` raises if that is not 0, and counts
the launch in :data:`LAUNCHES`.

Nothing here runs at import: the CPU tests import every module, and this
machine may have no ``nvcc``.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: argtypes of every C entry point, in the order of the C prototypes.
_SIGNATURES: Dict[str, List] = {
    # q, k, v, o, B, Sq, Skv, Hq, Hkv, D, sm_scale, causal, dtype, stream
    "pfa_flash_fwd": [_P] * 4 + [_I] * 6 + [_F, _I, _I, _P],
    # k_new, v_new, k_pool, v_pool, k_scales, v_scales, slots,
    # layer, B, Hkv, D, num_pages, page_size, in_dtype, pool_dtype, stream
    "pfa_paged_token_write": [_P] * 7 + [_I] * 8 + [_P],
    # q, k_pool, v_pool, k_scales, v_scales, lengths, tables, o,
    # layer, B, Hq, Hkv, D, num_pages, page_size, pages_per_seq,
    # sm_scale, pool_dtype, stream
    "pfa_paged_decode_attend": [_P] * 8 + [_I] * 8 + [_F, _I, _P],
}

#: dtype codes shared with the C side (csrc/common.cuh).
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

#: Kernel launches since the last :func:`reset_launches`, by kernel name.
#: Incremented only where a wrapper has launched its kernel.
LAUNCHES: collections.Counter = collections.Counter()

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def reset_launches() -> None:
    LAUNCHES.clear()


def _sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Path of the library built from the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libpfa_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels build only where the "
            "CUDA toolkit is installed"
        )
    return path


def build() -> Path:
    """Compile the kernels unless the library for these sources exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp)]
    cmd += [str(s) for s in _sources() if s.suffix == ".cu"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _lib
    with _lock:
        if _lib is None:
            loaded = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(loaded, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            loaded.pfa_error_string.argtypes = [ctypes.c_int]
            loaded.pfa_error_string.restype = ctypes.c_char_p
            _lib = loaded
        return _lib


def launch(name: str, device: torch.device, *args) -> None:
    """Call C entry point ``name`` on ``device``'s current stream; raise on
    a launch error; count the launch."""
    kernels = lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(kernels, name)(*args, stream)
    if err != 0:
        msg = kernels.pfa_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
    LAUNCHES[name] += 1
