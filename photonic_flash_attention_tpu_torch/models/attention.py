"""Drop-in attention module and its static kernel dispatch (PyTorch).

Port of ``photonic_flash_attention_tpu/models/attention.py``:

* :func:`dispatch_attention` — the JAX static threshold dispatch: the fused
  O(S^2) path (``ops/fused.py``) below ``flash_threshold`` or
  ``flash_min_tokens`` (``config.py``) or whenever a dense mask, an
  additive bias or the weights are asked for; the flash path
  (``ops/flash.py``: kernel K1 forward and K4/K5 backward on CUDA, their
  plain versions on CPU) otherwise. The TPU-only autotuner lookup of the
  JAX function has no counterpart.
* :func:`padding_mask_to_lens_bias` — a (B, Skv) keep-mask as the flash
  kernel's per-row lengths and per-key bias.
* :class:`PhotonicFlashAttention` — the q/k/v/out projections as an
  ``nn.Module`` (submodule names match the Flax ones, so weights map by
  name) over :func:`dispatch_attention`, as the JAX module with
  ``adaptive=False`` (the measured engine route is ROADMAP A7). Parameters
  are float32; compute runs in ``dtype``, as Flax's
  ``nn.Dense(dtype=...)`` casts inputs and kernels.

Not in this slice: ``kv_lens``/``k_bias`` on the flash route (ROADMAP B5)
and attention dropout (B10); both raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import get_config
from ..ops.flash import flash_attention
from ..ops.fused import fused_attention
from ..ops.reference import DEFAULT_MASK_VALUE

Attn = Tuple[torch.Tensor, Optional[torch.Tensor]]


def dense(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """Flax ``nn.Dense(dtype=x.dtype)``: weight and bias cast to x's dtype."""
    bias = layer.bias.to(x.dtype) if layer.bias is not None else None
    return F.linear(x, layer.weight.to(x.dtype), bias)


def padding_mask_to_lens_bias(keep: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, Skv) boolean keep-mask -> (kv_lens (B,) int32: last kept
    position + 1, k_bias (B, Skv) fp32: 0 = attend, mask value = ignore)."""
    keep = keep.to(torch.bool)
    pos = torch.arange(keep.shape[-1], dtype=torch.int32, device=keep.device)
    kv_lens = torch.where(keep, pos + 1, 0).amax(dim=-1).to(torch.int32)
    k_bias = torch.where(keep, 0.0, DEFAULT_MASK_VALUE).to(torch.float32)
    return kv_lens, k_bias


def dispatch_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    *,
    bias: Optional[torch.Tensor] = None,
    causal: bool = False,
    need_weights: bool = False,
    sm_scale: Optional[float] = None,
    kv_lens: Optional[torch.Tensor] = None,
    k_bias: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[torch.Tensor] = None,
) -> Attn:
    """Static threshold dispatch (JAX ``dispatch_attention``): returns
    (output (B, Sq, Hq, D), weights or None)."""
    if mask is not None and (kv_lens is not None or k_bias is not None):
        raise ValueError("pass either mask or kv_lens/k_bias, not both")
    if dropout_rate > 0.0 or dropout_seed is not None:
        raise NotImplementedError("attention dropout is not ported yet (ROADMAP A10, B10)")
    cfg = get_config()
    seq = max(q.shape[1], k.shape[1])
    if (
        need_weights
        or mask is not None
        or bias is not None
        or seq < cfg.flash_threshold
        or q.shape[0] * seq < cfg.flash_min_tokens
    ):
        if mask is None and (kv_lens is not None or k_bias is not None):
            # The fused path needs a dense mask: rebuild it from the key form.
            if k_bias is not None:
                keep = k_bias >= DEFAULT_MASK_VALUE / 2
            else:
                pos = torch.arange(k.shape[1], dtype=torch.int32, device=k.device)
                keep = pos[None] < kv_lens[:, None]
            mask = keep[:, None, None, :]
        return fused_attention(
            q, k, v, mask, bias=bias, causal=causal, sm_scale=sm_scale,
            need_weights=need_weights,
        )
    if kv_lens is not None or k_bias is not None:
        raise NotImplementedError(
            "kv_lens/k_bias on the flash route are not ported yet (ROADMAP A5, B5)"
        )
    return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale), None


class PhotonicFlashAttention(nn.Module):
    """Self-/cross-attention over (B, S, E) inputs; GQA when
    ``num_kv_heads < num_heads``. ``attention_dropout`` (probability
    dropout in train mode) must stay 0 until ROADMAP A10."""

    def __init__(
        self,
        embed_dim: int,
        num_heads: int,
        num_kv_heads: Optional[int] = None,
        *,
        causal: bool = False,
        attention_dropout: float = 0.0,
        use_bias: bool = True,
        dtype: torch.dtype = torch.bfloat16,
    ) -> None:
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(
                f"embed_dim {embed_dim} not divisible by num_heads {num_heads}"
            )
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads or num_heads
        self.head_dim = embed_dim // num_heads
        self.causal = causal
        self.attention_dropout = attention_dropout
        self.dtype = dtype
        kv_dim = self.num_kv_heads * self.head_dim
        self.q_proj = nn.Linear(embed_dim, num_heads * self.head_dim, bias=use_bias)
        self.k_proj = nn.Linear(embed_dim, kv_dim, bias=use_bias)
        self.v_proj = nn.Linear(embed_dim, kv_dim, bias=use_bias)
        self.out_proj = nn.Linear(num_heads * self.head_dim, embed_dim, bias=use_bias)

    def forward(
        self,
        query: torch.Tensor,
        key: Optional[torch.Tensor] = None,
        value: Optional[torch.Tensor] = None,
        mask: Optional[torch.Tensor] = None,
        *,
        need_weights: bool = False,
        kv_lens: Optional[torch.Tensor] = None,
        k_bias: Optional[torch.Tensor] = None,
    ) -> Attn:
        """Returns (output (B, Sq, E) in ``dtype``, weights or None)."""
        if self.training and self.attention_dropout > 0.0:
            raise NotImplementedError(
                "attention dropout in train mode is not ported yet (ROADMAP A10)"
            )
        key = query if key is None else key
        value = key if value is None else value
        b, sq, _ = query.shape
        skv = key.shape[1]
        x_q, x_k, x_v = (t.to(self.dtype) for t in (query, key, value))
        q = dense(x_q, self.q_proj).reshape(b, sq, self.num_heads, self.head_dim)
        k = dense(x_k, self.k_proj).reshape(b, skv, self.num_kv_heads, self.head_dim)
        v = dense(x_v, self.v_proj).reshape(b, skv, self.num_kv_heads, self.head_dim)
        out, weights = dispatch_attention(
            q, k, v, mask, causal=self.causal, need_weights=need_weights,
            kv_lens=kv_lens, k_bias=k_bias,
        )
        out = out.reshape(b, sq, self.num_heads * self.head_dim)
        return dense(out, self.out_proj), weights
