"""Build, load and launch the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for sm_90a (one process per
source, all in parallel) and linked into ONE shared library with a plain
C interface, loaded with ``ctypes``; no source
includes PyTorch's headers, which would make every build far slower. The
library lands in ``_build/`` (listed in ``.gitignore``) under a name that
carries the hash of the sources and flags, so an edited source rebuilds at
its next use.

Each C entry point takes pointers and the CUDA stream as ``c_void_p`` and
sizes as ``c_int``, launches on that stream and returns
``cudaGetLastError()``; :func:`launch` raises if that is not 0, and counts
the launch in :data:`LAUNCHES`, under the entry point's name or under the
name of the kernel's mode (``count_as``). A call made while the stream is
being captured into a CUDA graph launches nothing: it is counted in
:data:`CAPTURED` instead, and the card runs it once per replay.

:func:`host_library` builds the host C++ sources under ``native/`` (the
page allocator and the request scheduler) with ``g++`` into the same
directory, named by the same kind of hash; they run on the CPU and build
wherever ``g++`` is installed.

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
from typing import Dict, List, Mapping, Optional, Tuple

import torch

from ..utils.exceptions import KernelLaunchError

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
_L = ctypes.c_longlong
#: The window and dropout arguments of K1, K4 and K5: win_lo, win_hi,
#: seed, keep threshold, 1 / (1 - rate).
_STREAMS = [_I, _I, _U, _U, _F]
#: argtypes of every C entry point, in the order of the C prototypes.
_SIGNATURES: Dict[str, List] = {
    # q, k, v, o, lse (or None), lens (or None), kbias (or None), B, Sq, Skv,
    # Hq, Hkv, D, sm_scale, causal, win_lo, win_hi, seed, thresh, inv_keep,
    # dtype, stream
    "pfa_flash_fwd": [_P] * 7 + [_I] * 6 + [_F, _I] + _STREAMS + [_I, _P],
    # q, k, v, o, lse (or None), relvec (or None), qkbias (or None), B, Sq,
    # Skv, Hq, Hkv, D, Hb, sm_scale, causal, dtype, stream
    "pfa_flash_fwd_bias": [_P] * 7 + [_I] * 7 + [_F, _I, _I, _P],
    # q, k, v, do, lse, di, dk, dv, ws (or None), counters (or None), B, Sq,
    # Skv, Hq, Hkv, D, slices, sm_scale, causal, win_lo, win_hi, seed,
    # thresh, inv_keep, dtype, stream
    "pfa_flash_bwd_dkv": [_P] * 10 + [_I] * 7 + [_F, _I] + _STREAMS + [_I, _P],
    # q, k, v, o, do, lse, dq, di (written), B, Sq, Skv, Hq, Hkv, D,
    # sm_scale, causal, win_lo, win_hi, seed, thresh, inv_keep, dtype, stream
    "pfa_flash_bwd_dq": [_P] * 8 + [_I] * 6 + [_F, _I] + _STREAMS + [_I, _P],
    # k_new, v_new, k_pool, v_pool, k_scales, v_scales, slots,
    # layer, B, Hkv, D, num_pages, page_size, in_dtype, pool_dtype, stream
    "pfa_paged_token_write": [_P] * 7 + [_I] * 8 + [_P],
    # q (or None), q8 (or None), score_scale (or None), k_pool, v_pool,
    # k_scales, v_scales, lengths, tables, token_bias, k_new, v_new, slots
    # (the last four or None), o, ws (or None), counters, layer, B, Hq, Hkv,
    # D, num_pages, page_size, pages_per_seq, bias_len, pool_dtype,
    # in_dtype, int8_compute, split_pages, n_split, tile, block, gcmax,
    # sm_scale, stream
    "pfa_paged_k3": [_P] * 16 + [_I] * 17 + [_F, _P],
    # B, D, elt, gcmax, int8_compute, tile, split_pages, block: K3's shared
    # memory bytes; no stream, no launch
    "pfa_paged_k3_smem": [_I] * 8,
    # q8, k8, v, o, score_scale, v_scales (or None), B, Sq, Skv, Hq, Hkv, D,
    # causal, qk_dtype, pv_int8, out_dtype, stream
    "pfa_flash_fwd_quant": [_P] * 6 + [_I] * 10 + [_P],
    # q8, k8, v8, qs, ks, vs, o, B, Sq, Skv, Hq, Hkv, D, sm_scale, causal,
    # qdtype, out_dtype, stream
    "pfa_flash_quant": [_P] * 7 + [_I] * 6 + [_F, _I, _I, _I, _P],
    # x, y, rows, D, dtype, stream
    "pfa_softmax": [_P, _P, _I, _I, _I, _P],
    # x, gamma, beta (or None), y, rows, D, inv_d, eps, rms, dtype, stream
    "pfa_rownorm": [_P] * 4 + [_I, _I, _F, _F, _I, _I, _P],
    # x, slice, out, sink, n_bytes, slice_bytes, sentinel, stream
    "pfa_hbm_read": [_P] * 4 + [_L, _I, _U, _P],
    # x, y, n_bytes, chunk, stages, grid, stream (k10_plan)
    "pfa_hbm_copy": [_P, _P, _L] + [_I] * 3 + [_P],
    # x, out, sink, n, out_n, iters, sentinel, stream
    "pfa_exp_probe": [_P] * 3 + [_L, _I, _I, _U, _P],
    # x, out, l_out, sink, rows, cols, iters, mask_bound, masked, sentinel, stream
    "pfa_softmax_probe": [_P] * 4 + [_I] * 5 + [_U, _P],
    # kernel (0 = K11, 1 = K12), cols, masked, out (int *); no stream
    "pfa_probe_wave": [_I, _I, _I, ctypes.POINTER(_I)],
    # D, mode (K1Mode), out (int[7]: keys a tile, shared bytes, threads,
    # CTAs a SM, stages, producer and consumer registers of K1's bf16
    # kernel); no stream, no launch
    "pfa_k1_sm90_info": [_I, _I, ctypes.POINTER(_I)],
    # D, mode (0 int8-QK, 1 fp8-QK, 2 int8-full, 3 K6 int8, 4 K6 fp8), out
    # (int[8]: keys a tile, shared bytes, threads, CTAs a SM, stages,
    # producer and consumer registers, 1 when Q.K^T overlaps P.V) of the
    # quantized forward; no stream, no launch
    "pfa_quant_sm90_info": [_I, _I, ctypes.POINTER(_I)],
    # D, mode (StreamMode), out (int[16]: K4's then K5's rows a work tile,
    # rows of the ring's tile, shared bytes, threads, CTAs a SM, stages,
    # producer and consumer registers of the bf16 backward); no stream, no
    # launch
    "pfa_bwd_sm90_info": [_I, _I, ctypes.POINTER(_I)],
    # q, k, v, o, fm, B, S, H, D, sm_scale, causal, fast_exp, tile_keys,
    # stages, smem, grid, walk, stream: K13's bf16 body (k13_plan)
    "pfa_flash_fixedmax_sm90": [_P] * 5 + [_I] * 4 + [_F] + [_I] * 6 + [ctypes.POINTER(_I), _P],
    # D, fast_exp, out (int[9], as pfa_exp_sm90_info's) of K13's bf16 body;
    # no stream, no launch
    "pfa_fixedmax_sm90_info": [_I, _I, ctypes.POINTER(_I)],
    # q, k, v, o, B, Sq, Skv, H, D, sm_scale, tile_keys, stages, smem, grid,
    # walk, stream: K14's bf16 body (k14_plan)
    "pfa_flash_aug_sm90": [_P] * 4 + [_I] * 5 + [_F] + [_I] * 4 + [ctypes.POINTER(_I), _P],
    # q, k, v, o, B, Sq, Skv, H, D, sm_scale, nchain, tile_keys, stages,
    # smem, grid, walk, stream: K15's bf16 body (k15_plan)
    "pfa_flash_pair_sm90": [_P] * 4 + [_I] * 5 + [_F] + [_I] * 5 + [ctypes.POINTER(_I), _P],
    # nchain (0: K14, 1-4: K15), out (int[9], as pfa_exp_sm90_info's) of
    # K14's and K15's bf16 body; no stream, no launch
    "pfa_aug_pair_sm90_info": [_I, ctypes.POINTER(_I)],
    # q, k, v, o, B, S, Hq, Hkv, D, sm_scale, causal, dtype, stream
    "pfa_flash_pipelined": [_P] * 4 + [_I] * 5 + [_F, _I, _I, _P],
    # q, k, v, o, B, S, Hq, Hkv, D, sm_scale, causal, tile_keys, stages,
    # smem, grid, walk, stream: K16's bf16 body (k16_plan)
    "pfa_flash_pipelined_sm90": [_P] * 4 + [_I] * 5 + [_F] + [_I] * 5 + [ctypes.POINTER(_I), _P],
    # q, k, v, o, B, S, Hq, Hkv, D, sm_scale, causal, unroll, dtype, stream
    "pfa_flash_chunked": [_P] * 4 + [_I] * 5 + [_F, _I, _I, _I, _P],
    # q, k, v, o, B, S, Hq, Hkv, D, sm_scale, causal, unroll, tile_keys,
    # stages, smem, grid, walk (int[2 x q-blocks]), stream: K17's bf16 body
    # (k17_plan)
    "pfa_flash_chunked_sm90": [_P] * 4 + [_I] * 5 + [_F] + [_I] * 6 + [ctypes.POINTER(_I), _P],
    # q, k, v, o, B, S, Hq, Hkv, D, sm_scale, tile_keys, stages, smem, grid,
    # walk, stream: K19's bf16 body (k19_plan)
    "pfa_flash_fulltri_sm90": [_P] * 4 + [_I] * 5 + [_F] + [_I] * 4 + [ctypes.POINTER(_I), _P],
    # unroll (0: K19, 1: K16/K18), D, out (int[9]: keys a tile, stages,
    # shared bytes, threads, CTAs a SM, producer and consumer registers, 1
    # with the cross-stage overlap, 1 with the ping-pong) of K16-K19's bf16
    # body; no stream, no launch
    "pfa_exp_sm90_info": [_I, _I, ctypes.POINTER(_I)],
    # q, k, v, o, score_scale (or None), B, S, Hq, Hkv, D, q_row0, rows,
    # sm_scale, causal, qk_int8, dtype, stream
    "pfa_flash_tri": [_P] * 5 + [_I] * 7 + [_F, _I, _I, _I, _P],
    # q, k, v, o, B, S, Hq, Hkv, D, q_row0, rows, sm_scale, chained,
    # tile_keys, stages, smem, grid, walk, stream: one launch of K18's bf16
    # body (k18_plan)
    "pfa_flash_tri_sm90": [_P] * 4 + [_I] * 7 + [_F] + [_I] * 5 + [ctypes.POINTER(_I), _P],
    # q, k, v, o, score_scale, B, S, Hq, Hkv, D, q_row0, rows, causal,
    # chained, stages, smem, grid, stream: one launch of K18's int8 mode
    # with a bf16 V on the quantized body (k18_i8_plan)
    "pfa_flash_tri_i8_sm90": [_P] * 5 + [_I] * 12 + [_P],
    # D, out (int[8], as pfa_quant_sm90_info's) of K18 int8's instantiation
    # of the quantized body; no stream, no launch
    "pfa_flash_tri_i8_sm90_info": [_I, ctypes.POINTER(_I)],
    # q, k, v, o, B, S, Hq, Hkv, D, sm_scale, dtype, stream
    "pfa_flash_fulltri": [_P] * 4 + [_I] * 5 + [_F, _I, _P],
    # q, k, v, do, lse, di, dq, B, S, H, D, q_row0, rows, sm_scale, causal,
    # dtype, stream: K20 in fp32
    "pfa_flash_bwd_dq_rowblock": [_P] * 7 + [_I] * 6 + [_F, _I, _I, _P],
    # q, k, v, do, lse, di, dq, B, S, H, D, q_row0, rows, sm_scale, causal,
    # chained, stages, smem, grid, stream: one launch of K20's bf16 body
    # (K5's; k20_plan)
    "pfa_flash_bwd_dq_rowblock_sm90": [_P] * 7 + [_I] * 6 + [_F] + [_I] * 5 + [_P],
    # q, k, v, do, lse, di, dk, dv, B, S, H, D, kv_col0, cols, sm_scale,
    # causal, dtype, stream: K21 in fp32
    "pfa_flash_bwd_dkv_colblock": [_P] * 8 + [_I] * 6 + [_F, _I, _I, _P],
    # q, k, v, do, lse, di, dk, dv, B, S, H, D, kv_row0, rows, sm_scale,
    # causal, chained, stages, smem, grid, stream: one launch of K21's bf16
    # body (K4's; k21_plan)
    "pfa_flash_bwd_dkv_colblock_sm90": [_P] * 8 + [_I] * 6 + [_F] + [_I] * 5 + [_P],
}

#: dtype codes shared with the C side (csrc/common.cuh).
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2, torch.float8_e4m3fn: 3}

#: The widths the attention kernels (K1, K3, K4/K5, K6) are compiled for
#: and the dtypes of K1 and K4/K5; :func:`head_dim_plan` maps every head dim
#: up to :data:`MAX_HEAD_DIM` onto one of the widths.
KERNEL_HEAD_DIMS = (64, 128, 256)
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
#: The largest head dim any of the card's attention kernels takes.
MAX_HEAD_DIM = KERNEL_HEAD_DIMS[-1]
#: The card's kernels and modes compiled at D 256, each with the element
#: bytes of the rows it takes there: K1's bf16 body in its plain mode (with
#: or without lse) and its key-stream mode, K3 (every mode) over int8 and
#: bf16 pools. Every other kernel and mode -- K4/K5, K6, K1's 8-bit, REL,
#: DENSE, WINDOW and DROPOUT modes, the fp32 bodies -- takes head dims up to
#: 128. Only :func:`takes_head_dim` reads this table.
WIDE_KERNELS = {"K1": (2,), "K1 streams": (2,), "K3": (1, 2)}
#: The ROADMAP.md item that holds the head dims the card refuses.
WIDE_HEAD_DIM_ITEM = "A17"


def takes_head_dim(kernel: str, d: int, elt: int) -> bool:
    """Whether the card's ``kernel`` (a name of :func:`head_dim_plan`)
    takes head dim ``d`` of ``elt``-byte elements."""
    widest = KERNEL_HEAD_DIMS[-1] if elt in WIDE_KERNELS.get(kernel, ()) else 128
    return 1 <= d <= widest


def head_dim_plan(d: int, elt: int, kernel: str) -> Tuple[int, bool]:
    """The card's one rule for a head dim ``d`` of ``elt``-byte elements in
    ``kernel`` (``"K1"``, ``"K1 streams"``, ``"K1 rel"``, ``"K1 dense"``,
    ``"K1 window"``, ``"K1 dropout"``, ``"K1 int8qk"``, ``"K1 fp8qk"``,
    ``"K1 int8full"``, ``"K6"``, ``"K4/K5"`` or ``"K3"``; ``elt`` 4 is an
    fp32 body or pool): ``(D_c, copy)``.

    ``D_c`` is the compiled width that runs it: 64 for d <= 64, 128 for
    64 < d <= 128, 256 for 128 < d <= 256 where :data:`WIDE_KERNELS` holds
    the kernel at ``elt`` (JAX's ``_pad_head_dim`` pads to a multiple of 128
    there, and to 64 below it). The kernels keep the real d as the innermost
    dimension of their tensor maps and bulk copies, so the columns
    d..D_c-1 arrive as zeros and add nothing to Q.K^T or dP; every store is
    strided by d and guarded by it; the softmax scale stays the real d's.
    ``copy`` is True where a row of d elements is not a whole number of
    16-byte units, which a tensor map's row pitch and a bulk copy need
    (bf16 with d % 8 != 0, 8-bit with d % 16 != 0, fp32 with d % 4 != 0):
    the wrapper then pads its tensors into a D_c-wide copy (:func:`pad_head`,
    as ``jnp.pad``) and the kernel runs on that. Raises ValueError naming d
    and :data:`WIDE_HEAD_DIM_ITEM` for a head dim the kernel does not take,
    before anything is built or launched."""
    if d < 1:
        raise ValueError(f"head dim must be >= 1, got {d}")
    if d > MAX_HEAD_DIM:
        raise ValueError(
            f"head dim {d}: the card's attention kernels take head dims 1..{MAX_HEAD_DIM}; "
            f"D > 256 is part of ROADMAP.md's {WIDE_HEAD_DIM_ITEM}")
    if not takes_head_dim(kernel, d, elt):
        raise ValueError(
            f"head dim {d}: {kernel} on {elt}-byte elements takes head dims 1..128 on the card; "
            f"129-256 there is part of ROADMAP.md's {WIDE_HEAD_DIM_ITEM}")
    return next(w for w in KERNEL_HEAD_DIMS if d <= w), (d * elt) % 16 != 0


def pad_head(t: torch.Tensor, width: int) -> torch.Tensor:
    """``t`` (..., d) zero-padded to (..., width), contiguous (``t`` itself
    where d == width); 1-byte payloads (int8, e4m3) are padded as bytes."""
    d = t.shape[-1]
    if d == width:
        return t
    if t.element_size() == 1:
        return torch.nn.functional.pad(t.view(torch.uint8), (0, width - d)).view(t.dtype)
    return torch.nn.functional.pad(t, (0, width - d))


def cut_head(t: torch.Tensor, d: int) -> torch.Tensor:
    """A kernel's output of a :func:`pad_head` copy cut back to the first
    ``d`` columns, contiguous (``t`` itself where it is d wide)."""
    return t if t.shape[-1] == d else t[..., :d].contiguous()

#: Kernel launches since the last :func:`reset_launches`, by kernel name.
#: Incremented only where a wrapper has launched its kernel.
LAUNCHES: collections.Counter = collections.Counter()
#: Calls recorded into a CUDA graph under capture since the last
#: :func:`reset_launches`, by kernel name (not launches: each runs once per
#: replay of its graph).
CAPTURED: collections.Counter = collections.Counter()

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def reset_launches() -> None:
    LAUNCHES.clear()
    CAPTURED.clear()


def replay_launches(captured: Mapping[str, int], replays: int) -> collections.Counter:
    """The launches ``replays`` replays of a CUDA graph make: each kernel
    call its capture recorded (``captured``, the :data:`CAPTURED` counts
    the capture added) launches once a replay."""
    if replays < 0:
        raise ValueError(f"replays must be >= 0, got {replays}")
    return collections.Counter({name: n * replays for name, n in captured.items() if n * replays})


def count_replays(captured: Mapping[str, int], replays: int) -> None:
    """Add ``replays`` replays of a graph that captured ``captured`` to
    :data:`LAUNCHES` (:func:`replay_launches`): a graph's launches count as
    the card runs them, once a replay."""
    LAUNCHES.update(replay_launches(captured, replays))


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
        raise KernelLaunchError(
            "nvcc not found: the port's CUDA kernels build only where the "
            "CUDA toolkit is installed"
        )
    return path


def _run(procs: List[subprocess.Popen]) -> None:
    """Wait for every nvcc in ``procs``; raise with the first failure's output."""
    failed = None
    for proc in procs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0 and failed is None:
            failed = f"nvcc failed ({proc.returncode}): {' '.join(proc.args)}\n{stdout}\n{stderr}"
    if failed:
        raise KernelLaunchError(failed)


def build() -> Path:
    """Compile the kernels unless the library for these sources exists:
    one nvcc per source, all started together, then one link."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = _nvcc()
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    objs, procs = [], []
    for src in _sources():
        if src.suffix != ".cu":
            continue
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *compile_flags, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        ))
    _run(procs)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    _run([subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, objs)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )])
    for obj in objs:
        obj.unlink()
    os.replace(tmp, out)
    return out


#: g++ flags of the host libraries (the native page allocator and scheduler).
HOST_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]


def host_library(src: Path, name: str) -> Path:
    """Build the host C++ source ``src`` (no CUDA) with g++ into
    ``_build/libpfa_<name>_<hash>.so`` unless it exists, the hash covering
    the source and the flags as :func:`library_path`'s does; return its path.
    Raises :class:`KernelLaunchError` with g++'s output if the build fails."""
    h = hashlib.sha256(" ".join(HOST_FLAGS).encode())
    h.update(src.read_bytes())
    out = BUILD_DIR / f"libpfa_{name}_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    gxx = shutil.which("g++")
    if gxx is None:
        raise KernelLaunchError(f"g++ not found: {src.name} cannot be built")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([gxx, *HOST_FLAGS, str(src), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise KernelLaunchError(f"g++ failed ({proc.returncode}) on {src}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


_host_libs: Dict[str, ctypes.CDLL] = {}


def load_host_library(src: Path, name: str) -> ctypes.CDLL:
    """The host library ``name`` built from ``src`` (:func:`host_library`),
    loaded once a process."""
    with _lock:
        if name not in _host_libs:
            _host_libs[name] = ctypes.CDLL(str(host_library(src, name)))
        return _host_libs[name]


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


#: Arrival counters of the kernels whose CTAs merge their partial results
#: in the same launch (K3's splits, K4's slices), one int32 buffer a
#: (kernel, device): zeros at allocation, and the last CTA to arrive at
#: each counter resets it, so they are zeros between launches without a
#: memset per call. They belong to one launch at a time (one stream).
_COUNTERS: Dict[tuple, torch.Tensor] = {}
#: Counter buffers that a larger one replaced, kept alive (and zero).
_RETIRED_COUNTERS: List[torch.Tensor] = []


def arrival_counters(kernel: str, device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` zeroed int32 arrival counters of ``kernel`` on ``device``."""
    buf = _COUNTERS.get((kernel, device))
    if buf is None or buf.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"{kernel}'s counters must be allocated before CUDA-graph capture: "
                               "run the call once outside the capture first")
        if buf is not None:
            _RETIRED_COUNTERS.append(buf)  # a CUDA graph captured against it still reads it
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _COUNTERS[(kernel, device)] = buf
    return buf


def launch(name: str, device: torch.device, *args, count_as: Optional[str] = None) -> None:
    """Call C entry point ``name`` on ``device``'s current stream; raise on
    a launch error; count the launch under ``count_as`` (default ``name``),
    in :data:`CAPTURED` where the stream is being captured."""
    kernels = lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        capturing = torch.cuda.is_current_stream_capturing()
        err = getattr(kernels, name)(*args, stream)
    if err != 0:
        msg = kernels.pfa_error_string(err).decode()
        raise KernelLaunchError(f"{name}: CUDA error {err} ({msg})")
    (CAPTURED if capturing else LAUNCHES)[count_as or name] += 1
