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
The int8 score product (``int8_qk``) is K1's int8-QK mode: Q/K per-tensor
int8 (``_quant_per_tensor``), P.V in bf16 (V cast to bf16, as the JAX
kernel does), output in V's dtype; it has the same envelope. ``int8_qk``
with ``k_bias`` (which the engine never combines) is not ported.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .flash import KERNEL_DTYPES, flash_attention, flash_attention_qk_quant
from .flash_fp8 import _per_tensor_quant
from .reference import softmax_scale


def unrolled_supported(seq_len: int, head_dim: int, *, int8_qk: bool = False) -> bool:
    """True when K1 takes this geometry in bf16: any length >= 1, a head
    dim of 1 to 256 (``_build.head_dim_plan``), with ``int8_qk`` (K1's
    int8-QK mode) 1 to 128."""
    return seq_len >= 1 and _build.takes_head_dim("K1 int8qk" if int8_qk else "K1", head_dim, 2)


def _quant_per_tensor(x: torch.Tensor):
    """Per-tensor int8 payload and its 0-dim fp32 scale (absmax / 127)."""
    return _per_tensor_quant(x, torch.int8, 127.0)


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
    """The engine's unrolled kinds: K1 with the optional (B, Skv) fp32
    per-key bias, or with ``int8_qk`` K1's int8-QK mode (inference only).
    Causal needs Sq == Skv, as in JAX. The TPU block sizes and
    ``interpret`` have no counterpart."""
    if causal and q.shape[1] != k.shape[1]:
        raise ValueError(
            f"causal unrolled flash requires Sq == Skv, got {q.shape[1]} vs {k.shape[1]}"
        )
    if not int8_qk:
        return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale, k_bias=k_bias)
    if k_bias is not None:
        raise NotImplementedError("int8_qk with k_bias is not ported (the engine never combines them)")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention_unrolled(int8_qk=True) is inference only")
    q8, qs = _quant_per_tensor(q)
    k8, ks = _quant_per_tensor(k)
    score_scale = ((qs * ks) * softmax_scale(q.shape[-1], sm_scale)).reshape(1).float()
    out_dtype = v.dtype if v.dtype in KERNEL_DTYPES else torch.float32
    out = flash_attention_qk_quant(q8, k8, v.to(torch.bfloat16), score_scale, causal=causal,
                                   out_dtype=out_dtype)
    return out.to(v.dtype)


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
