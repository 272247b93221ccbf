"""Drop-in attention module (PyTorch).

Port of ``photonic_flash_attention_tpu/models/attention.py::
PhotonicFlashAttention`` as an ``nn.Module``: it owns the q/k/v/out
projections (submodule names match the Flax ones, so weights map by name)
and runs the flash forward (``ops/flash.py``: kernel K1 on CUDA, its plain
version on CPU). Parameters are float32; compute runs in ``dtype``, as
Flax's ``nn.Dense(dtype=...)`` casts inputs and kernels.

Not in this slice: masks, key padding, attention weights and dropout
(ROADMAP Queue A, A4/A5/A10).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.flash import flash_attention


def dense(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """Flax ``nn.Dense(dtype=x.dtype)``: weight and bias cast to x's dtype."""
    bias = layer.bias.to(x.dtype) if layer.bias is not None else None
    return F.linear(x, layer.weight.to(x.dtype), bias)


class PhotonicFlashAttention(nn.Module):
    """Self-/cross-attention over (B, S, E) inputs; GQA when
    ``num_kv_heads < num_heads``."""

    def __init__(
        self,
        embed_dim: int,
        num_heads: int,
        num_kv_heads: Optional[int] = None,
        *,
        causal: bool = False,
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
    ) -> Tuple[torch.Tensor, None]:
        """Returns (output (B, Sq, E) in ``dtype``, None) — the JAX module's
        (output, weights) pair, without weights."""
        key = query if key is None else key
        value = key if value is None else value
        b, sq, _ = query.shape
        skv = key.shape[1]
        x_q, x_k, x_v = (t.to(self.dtype) for t in (query, key, value))
        q = dense(x_q, self.q_proj).reshape(b, sq, self.num_heads, self.head_dim)
        k = dense(x_k, self.k_proj).reshape(b, skv, self.num_kv_heads, self.head_dim)
        v = dense(x_v, self.v_proj).reshape(b, skv, self.num_kv_heads, self.head_dim)
        out = flash_attention(q, k, v, causal=self.causal)
        out = out.reshape(b, sq, self.num_heads * self.head_dim)
        return dense(out, self.out_proj), None
