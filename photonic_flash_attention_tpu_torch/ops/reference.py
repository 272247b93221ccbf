"""Reference attention (the numerics oracle), in plain PyTorch.

Port of ``photonic_flash_attention_tpu/ops/reference.py::attention_reference``:
the same finite mask value and the same O(S^2)-memory attention, computed
in float32 on whatever device the inputs live on, with the same optional
boolean ``mask``, additive ``bias`` and returned weights. It is the plain
version of the flash kernel (``ops/flash.py``), the fused short-sequence
path (``ops/fused.py``) and the oracle the tests compare against.

Shape convention: (batch, seq, num_heads, head_dim).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


def softmax_scale(head_dim: int, sm_scale: Optional[float]) -> float:
    """The score scale: ``sm_scale``, or 1/sqrt(head_dim) when it is None."""
    return sm_scale if sm_scale is not None else head_dim ** -0.5


def causal_keep(sq: int, skv: int, device) -> torch.Tensor:
    """(Sq, Skv) bool, True where query row i may see key j: the causal mask
    aligned to the sequence end, j <= i + Skv - Sq (as the JAX reference)."""
    row = torch.arange(sq, device=device)[:, None]
    col = torch.arange(skv, device=device)[None, :]
    return col <= row + (skv - sq)


def repeat_kv(t: torch.Tensor, group: int) -> torch.Tensor:
    """Broadcast K or V (B, S, Hkv, D) over a GQA group of q heads
    (``jnp.repeat`` on the head axis: q head h reads kv head h // group)."""
    return t.repeat_interleave(group, dim=2) if group > 1 else t


def attention_scores(
    q: torch.Tensor, k: torch.Tensor, *, sm_scale: Optional[float] = None
) -> torch.Tensor:
    """Scaled, unmasked scores (B, Hq, Sq, Skv) in float32, K broadcast over
    the GQA group."""
    k = repeat_kv(k, q.shape[2] // k.shape[2])
    qf = q.float() * softmax_scale(q.shape[-1], sm_scale)
    return torch.einsum("bqhd,bkhd->bhqk", qf, k.float())


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    *,
    bias: Optional[torch.Tensor] = None,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    need_weights: bool = False,
    weights_only: bool = False,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Standard attention in float32.

    Args:
      q: (B, Sq, Hq, D)
      k, v: (B, Skv, Hkv, D) with Hq % Hkv == 0 (GQA broadcast).
      mask: optional boolean mask broadcastable to (B, Hq, Sq, Skv);
        True = attend.
      bias: optional additive score bias broadcastable to (B, Hq, Sq, Skv).
      causal: causal mask aligned to the sequence end (row i sees keys
        j <= i + Skv - Sq), as in the JAX reference.
      sm_scale: score scale; default 1/sqrt(D).
      need_weights: also return the softmax weights (B, Hq, Sq, Skv), fp32.
      weights_only: skip the P.V product and return (None, weights).

    Returns:
      (output (B, Sq, Hq, D) in q's dtype or None, weights or None)
    """
    scores = attention_scores(q, k, sm_scale=sm_scale)
    if bias is not None:
        scores = scores + bias.float()
    if causal:
        keep = causal_keep(q.shape[1], k.shape[1], q.device)
        scores = scores.masked_fill(~keep, DEFAULT_MASK_VALUE)
    if mask is not None:
        scores = torch.where(mask.to(torch.bool), scores, DEFAULT_MASK_VALUE)
    weights = torch.softmax(scores, dim=-1)
    if weights_only:
        return None, weights
    vf = repeat_kv(v, q.shape[2] // v.shape[2]).float()
    out = torch.einsum("bhqk,bkhd->bqhd", weights, vf).to(q.dtype)
    return (out, weights) if need_weights else (out, None)
