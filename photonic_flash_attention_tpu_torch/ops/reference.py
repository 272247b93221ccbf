"""Reference attention (the numerics oracle), in plain PyTorch.

Port of ``photonic_flash_attention_tpu/ops/reference.py``: the same finite
mask value and the same O(S^2)-memory attention, computed in float32 on
whatever device the inputs live on. It is the plain version of the flash
kernel (``ops/flash.py``) and the oracle its tests compare against.

Shape convention: (batch, seq, num_heads, head_dim).
"""

from __future__ import annotations

from typing import Optional

import torch

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


def _scale(head_dim: int, sm_scale: Optional[float]) -> float:
    return sm_scale if sm_scale is not None else head_dim ** -0.5


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Standard attention in float32; returns (B, Sq, Hq, D) in q's dtype.

    Args:
      q: (B, Sq, Hq, D)
      k, v: (B, Skv, Hkv, D) with Hq % Hkv == 0 (GQA broadcast).
      causal: causal mask aligned to the sequence end (row i sees keys
        j <= i + Skv - Sq), as in the JAX reference.
      sm_scale: score scale; default 1/sqrt(D).
    """
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    if group > 1:
        k = k.repeat_interleave(group, dim=2)
        v = v.repeat_interleave(group, dim=2)
    qf = q.float() * _scale(d, sm_scale)
    scores = torch.einsum("bqhd,bkhd->bhqk", qf, k.float())
    if causal:
        row = torch.arange(sq, device=q.device)[:, None]
        col = torch.arange(skv, device=q.device)[None, :]
        scores = scores.masked_fill(col > row + (skv - sq), DEFAULT_MASK_VALUE)
    weights = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", weights, v.float())
    return out.to(q.dtype)
