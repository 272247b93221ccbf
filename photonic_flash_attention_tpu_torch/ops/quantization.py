"""Block quantization for attention activations and the KV cache.

Port of ``photonic_flash_attention_tpu/ops/quantization.py``: symmetric
per-block absmax scaling along one axis to int8 or fp8 (e4m3), the
dequantization, a KV-pair helper and the calibration error metrics. There
is no kernel (the JAX module has none either). The rounding is JAX's, as in
``ops/flash_fp8.py``: scales are absmax / qmax (1 where a block is all
zero), divided by a tensor; int8 payloads round half to even and clip to
+-127; e4m3 payloads clip to +-448 and cast (nearest even). Payloads and
scales are bit-equal to JAX's.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from .flash_fp8 import _cast, _scale_of

FP8_MAX = 448.0  # float8_e4m3fn max normal
INT8_MAX = 127.0
QUANT_DTYPES = (torch.int8, torch.float8_e4m3fn)


@dataclasses.dataclass
class QuantizedTensor:
    """Payload and per-block scales.

    ``values``: the low-precision payload, the source's shape.
    ``scales``: fp32, the source's shape with ``axis`` cut to
    ceil(size / ``block_size``) blocks.
    """

    values: torch.Tensor
    scales: torch.Tensor
    axis: int
    block_size: int

    @property
    def shape(self) -> torch.Size:
        return self.values.shape

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype

    def dequantize(self, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return dequantize(self, dtype)


def _block_absmax(x: torch.Tensor, axis: int, block_size: int) -> torch.Tensor:
    """Per-block absmax along ``axis`` (the last block zero-padded); the
    axis becomes the block count."""
    size = x.shape[axis]
    n_blocks = -(-size // block_size)
    pad = [0, 0] * (x.ndim - 1 - axis) + [0, n_blocks * block_size - size]
    xb = F.pad(x.float(), pad).reshape(*x.shape[:axis], n_blocks, block_size, *x.shape[axis + 1:])
    return xb.abs().amax(dim=axis + 1)


def _expand_scales(scales: torch.Tensor, axis: int, block_size: int, size: int) -> torch.Tensor:
    """Per-block scales repeated back to the full axis length."""
    return scales.repeat_interleave(block_size, dim=axis).narrow(axis, 0, size)


def quantize(
    x: torch.Tensor,
    dtype: torch.dtype,
    *,
    axis: int = -1,
    block_size: int = 128,
) -> QuantizedTensor:
    """Symmetric per-block quantization to ``torch.int8`` or
    ``torch.float8_e4m3fn`` along ``axis``."""
    if dtype not in QUANT_DTYPES:
        raise ValueError(f"dtype must be one of {QUANT_DTYPES}, got {dtype}")
    if block_size <= 0:
        raise ValueError(f"block_size must be positive, got {block_size}")
    axis = axis % x.ndim
    qmax = FP8_MAX if dtype == torch.float8_e4m3fn else INT8_MAX
    scales = _scale_of(_block_absmax(x, axis, block_size), qmax)
    scale_full = _expand_scales(scales, axis, block_size, x.shape[axis])
    values = _cast(x.float() / scale_full, dtype, qmax)
    return QuantizedTensor(values, scales, axis, block_size)


def dequantize(qt: QuantizedTensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    scale_full = _expand_scales(qt.scales, qt.axis, qt.block_size, qt.values.shape[qt.axis])
    return (qt.values.float() * scale_full).to(dtype)


def quantize_kv(
    k: torch.Tensor,
    v: torch.Tensor,
    dtype: torch.dtype = torch.int8,
    *,
    seq_axis: int = 1,
    block_size: int = 128,
) -> Tuple[QuantizedTensor, QuantizedTensor]:
    """Quantize a KV pair along the sequence axis (per-token-block scales)."""
    return (
        quantize(k, dtype, axis=seq_axis, block_size=block_size),
        quantize(v, dtype, axis=seq_axis, block_size=block_size),
    )


def quantization_error(x: torch.Tensor, qt: QuantizedTensor) -> dict:
    """Calibration metrics (Python floats): absolute and relative errors of
    the round trip, and accuracy = 1 - mean relative error."""
    xf = x.float()
    abs_err = (qt.dequantize(torch.float32) - xf).abs()
    rel = abs_err / xf.abs().clamp(min=1e-6)
    return {
        "max_abs_err": float(abs_err.max()),
        "mean_abs_err": float(abs_err.mean()),
        "max_rel_err": float(rel.max()),
        "mean_rel_err": float(rel.mean()),
        "accuracy": float(1.0 - rel.mean()),
    }
