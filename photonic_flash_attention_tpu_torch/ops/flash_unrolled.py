"""Inference dispatch of the prefill path, and the engine's unrolled kind.

Port of ``photonic_flash_attention_tpu/ops/flash_unrolled.py::
flash_attention_unrolled``, ``flash_attention_best`` and
``unrolled_supported``. On the TPU the unrolled kernel existed because of
how Mosaic schedules a grid step, and its envelope was a 16-tile VMEM cap.
On the H100 one kernel (K1, ``ops/flash.py``) serves both entry points, and
``unrolled_supported`` becomes K1's shape envelope. Both take the per-key
bias stream ``k_bias`` (the unrolled TPU kernel's ``kbias_ref``); the
engine's key route folds ``kv_lens`` into it first, as the JAX engine does.

The JAX ``flash_attention_best`` lacks a bf16 gate, so fp32 inputs in its
envelope are computed in bf16; here fp32 stays fp32 (K1 has an fp32 path).
The int8 score product (``int8_qk``) is ROADMAP A9 (B8).
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash import KERNEL_HEAD_DIMS, flash_attention


def unrolled_supported(seq_len: int, head_dim: int, *, int8_qk: bool = False) -> bool:
    """True when K1 takes this geometry (any length >= 1, D in {64, 128});
    never for ``int8_qk``, which the port does not have yet."""
    return not int8_qk and seq_len >= 1 and head_dim in KERNEL_HEAD_DIMS


def flash_attention_unrolled(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    int8_qk: bool = False,
    k_bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The engine's unrolled kind: K1 with the optional (B, Skv) fp32
    per-key bias. Causal needs Sq == Skv, as in JAX. The TPU block sizes
    and ``interpret`` have no counterpart."""
    if int8_qk:
        raise NotImplementedError("the int8 score product is ROADMAP A9 (B8)")
    if causal and q.shape[1] != k.shape[1]:
        raise ValueError(
            f"causal unrolled flash requires Sq == Skv, got {q.shape[1]} vs {k.shape[1]}"
        )
    return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale, k_bias=k_bias)


def flash_attention_best(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    k_bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Serving prefill entry point: K1 on CUDA, its plain version on CPU."""
    return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale, k_bias=k_bias)
