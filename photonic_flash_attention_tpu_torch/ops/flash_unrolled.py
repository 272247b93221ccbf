"""Inference dispatch of the prefill path.

Port of ``photonic_flash_attention_tpu/ops/flash_unrolled.py::
flash_attention_best`` and ``unrolled_supported``. On the TPU the unrolled
kernel existed because of how Mosaic schedules a grid step, and its
envelope was a 16-tile VMEM cap. On the H100 one kernel (K1,
``ops/flash.py``) serves both entry points, and ``unrolled_supported``
becomes K1's shape envelope.

The JAX ``flash_attention_best`` lacks a bf16 gate, so fp32 inputs in its
envelope are computed in bf16; here fp32 stays fp32 (K1 has an fp32 path).
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash import KERNEL_HEAD_DIMS, flash_attention


def unrolled_supported(seq_len: int, head_dim: int) -> bool:
    """True when K1 takes this geometry (any length >= 1, D in {64, 128})."""
    return seq_len >= 1 and head_dim in KERNEL_HEAD_DIMS


def flash_attention_best(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Serving prefill entry point: K1 on CUDA, its plain version on CPU."""
    return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale)
