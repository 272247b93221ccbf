"""HBM read and copy probes (kernels K9 and K10) and the measured read rate.

Port of ``photonic_flash_attention_tpu/ops/hbm_bw.py``:

* :func:`hbm_read_probe`: read every byte of ``x`` ((rows, cols), rows a
  multiple of 4096) and return an (8, cols) slice in x's dtype: the first 8
  rows of the last even-indexed 4096-row chunk, the rows the TPU kernel's
  DMA slot 0 holds at its end (x[8192:8200] for 3 chunks, x[0:8] for 1 or
  2). Kernel K9 (``csrc/probes.cu``, counted ``pfa_hbm_read``).
* :func:`hbm_copy`: y = x, reading and writing every byte. Kernel K10
  (``pfa_hbm_copy``): the TMA's 1-D bulk copy through a ring of
  shared-memory stages, one CTA a 32 KB chunk of the array
  (:func:`k10_plan`).
* :func:`hbm_read_bytes_per_s`: the read rate of K9 over a 256 MiB array,
  by the two-point fit of ``core/timing.py::fit_seconds``; the counterpart
  of ``bench.py``'s calibration loop (which is not a function in JAX).
  :func:`hbm_copy_bytes_per_s`: K10's bytes read and written per second.

CUDA tensors launch the kernels (any dtype; contiguous, 16-byte rows) or
raise; CPU tensors take the plain versions (a slice, a clone).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch

from ..core.timing import fit_seconds
from . import _build

#: Rows of one chunk of the TPU kernel's DMA stream (4 MB of bf16 x 512).
CHUNK_ROWS = 4096
#: bench.py's read stream: 256 MiB of bf16 as (262144, 512), five times the
#: card's 50 MB L2, so every launch streams from HBM.
READ_SHAPE = (262144, 512)
#: The copy stream: (131072, 512) bf16 in and out, 128 MiB each way.
COPY_SHAPE = (131072, 512)
#: A value the probes' folded register is compared with (see csrc/probes.cu).
SENTINEL = 0x9E3779B9
#: K10's ring: bytes a chunk (one bulk copy each way), stages, and a CTA a
#: chunk (else a persistent grid of at most a CTA a SM, walking the chunks
#: grid-strided). A CTA a chunk was the fastest setting on the H100
#: (PERF.md).
COPY_CHUNK = 32768
COPY_STAGES = 2
COPY_PERSISTENT = False
#: Dynamic shared memory a CTA may take on the H100 (``csrc/sm90.cuh``).
SMEM_MAX = 232448


class K10Plan(NamedTuple):
    """One K10 launch: ``chunks`` of ``chunk`` bytes (the last one the
    rest), ``stages`` ring stages and ``grid`` CTAs (the chunks, or
    min(chunks, SMs) where persistent), CTA b copying chunks b, b + grid,
    ... (``csrc/probes.cu::hbm_copy_ring``)."""
    chunk: int
    stages: int
    chunks: int
    grid: int


def k10_plan(n_bytes: int, sms: int = 132, *, chunk: int = COPY_CHUNK,
             stages: int = COPY_STAGES, persistent: bool = COPY_PERSISTENT) -> K10Plan:
    """K10's launch for ``n_bytes`` (a multiple of 16): the ring of
    ``stages`` stages of ``chunk`` bytes (a multiple of 16, below 1 MiB, all
    stages and their 8-byte mbarriers in :data:`SMEM_MAX`) and the grid: a
    CTA a chunk, or where ``persistent`` at most ``sms`` CTAs. The C
    launcher refuses any other."""
    if n_bytes <= 0 or n_bytes % 16:
        raise ValueError(f"K10 copies a positive multiple of 16 bytes, got {n_bytes}")
    if chunk <= 0 or chunk % 16 or chunk > (1 << 20) - 16:
        raise ValueError(f"K10's chunk must be a multiple of 16 bytes below 1 MiB, got {chunk}")
    if not 2 <= stages <= 8 or stages * (chunk + 8) > SMEM_MAX:
        raise ValueError(f"K10's ring of {stages} stages of {chunk} bytes does not fit: 2 to 8 "
                         f"stages in {SMEM_MAX} bytes")
    chunks = -(-n_bytes // chunk)
    return K10Plan(chunk, stages, chunks, min(chunks, sms) if persistent else chunks)


def _copy_into(x: torch.Tensor, y: torch.Tensor, plan: K10Plan) -> None:
    """One K10 launch on ``plan``: y = x."""
    _build.launch("pfa_hbm_copy", x.device, x.data_ptr(), y.data_ptr(),
                  x.numel() * x.element_size(), plan.chunk, plan.stages, plan.grid)


def _check_rows(x: torch.Tensor, name: str) -> None:
    if x.ndim != 2 or x.shape[0] == 0:
        raise ValueError(f"{name} takes a non-empty (rows, cols) array, got {tuple(x.shape)}")


def _check_cuda(x: torch.Tensor, name: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not x.is_contiguous() or (x.shape[1] * x.element_size()) % 16 or x.data_ptr() % 16:
        raise ValueError(f"{name} needs a contiguous, 16-byte aligned x with 16-byte rows")


def returned_row(rows: int) -> int:
    """First row of the slice :func:`hbm_read_probe` returns: the start of
    the last even-indexed chunk."""
    return (rows // CHUNK_ROWS - 1) // 2 * 2 * CHUNK_ROWS


def hbm_read_probe_plain(x: torch.Tensor) -> torch.Tensor:
    """K9's plain version: the returned slice alone."""
    r0 = returned_row(x.shape[0])
    return x[r0:r0 + 8].clone()


def hbm_read_probe(x: torch.Tensor) -> torch.Tensor:
    """Read every byte of ``x`` ((rows, cols), rows % 4096 == 0); return the
    (8, cols) slice of the TPU kernel (see the module docstring)."""
    _check_rows(x, "hbm_read_probe")
    if x.shape[0] % CHUNK_ROWS:
        raise ValueError(f"hbm_read_probe needs rows % {CHUNK_ROWS} == 0, got {x.shape[0]}")
    if x.device.type == "cpu":
        return hbm_read_probe_plain(x)
    _check_cuda(x, "K9 (hbm_read_probe)")
    r0 = returned_row(x.shape[0])
    out = torch.empty((8, x.shape[1]), dtype=x.dtype, device=x.device)
    sink = torch.empty(1, dtype=torch.int32, device=x.device)
    _build.launch("pfa_hbm_read", x.device, x.data_ptr(), x[r0].data_ptr(), out.data_ptr(),
                  sink.data_ptr(), x.numel() * x.element_size(), out.numel() * out.element_size(),
                  SENTINEL)
    return out


def hbm_copy_plain(x: torch.Tensor) -> torch.Tensor:
    """K10's plain version."""
    return x.clone()


def hbm_copy(x: torch.Tensor) -> torch.Tensor:
    """Identity copy of (rows, cols): reads N and writes N bytes. Rows must
    divide by the TPU kernel's tile height, min(4096, rows)."""
    _check_rows(x, "hbm_copy")
    if x.shape[0] % min(CHUNK_ROWS, x.shape[0]):
        raise ValueError(f"hbm_copy needs rows % {CHUNK_ROWS} == 0 above {CHUNK_ROWS} rows, "
                         f"got {x.shape[0]}")
    if x.device.type == "cpu":
        return hbm_copy_plain(x)
    _check_cuda(x, "K10 (hbm_copy)")
    y = torch.empty_like(x)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    _copy_into(x, y, k10_plan(x.numel() * x.element_size(), sms))
    return y


def hbm_read_bytes_per_s(
    x: Optional[torch.Tensor] = None,
    *,
    fit: Tuple[int, int] = (20, 220),
    device: Union[str, torch.device] = "cuda",
) -> float:
    """Measured read rate of :func:`hbm_read_probe` in bytes/s: x's bytes
    over the fitted time of one call. ``x`` defaults to bench.py's 256 MiB
    bf16 stream (:data:`READ_SHAPE`) on ``device``; on the card the calls
    are replayed from a CUDA graph, on the CPU the plain version is timed
    by wall clock."""
    if x is None:
        x = torch.ones(READ_SHAPE, dtype=torch.bfloat16, device=device)
    t = fit_seconds(lambda: hbm_read_probe(x), fit, x.device)
    return x.numel() * x.element_size() / t


def hbm_copy_bytes_per_s(
    x: Optional[torch.Tensor] = None,
    *,
    fit: Tuple[int, int] = (20, 220),
    device: Union[str, torch.device] = "cuda",
) -> float:
    """Measured rate of :func:`hbm_copy` in bytes/s, each byte counted once
    read and once written. ``x`` defaults to :data:`COPY_SHAPE` bf16."""
    if x is None:
        x = torch.ones(COPY_SHAPE, dtype=torch.bfloat16, device=device)
    t = fit_seconds(lambda: hbm_copy(x), fit, x.device)
    return 2 * x.numel() * x.element_size() / t
