"""Reference attention (the numerics oracle), in plain PyTorch.

Port of ``photonic_flash_attention_tpu/ops/reference.py``:
``attention_reference``, the same finite mask value and the same
O(S^2)-memory attention, computed in float32 on whatever device the inputs
live on, with the same optional boolean ``mask``, additive ``bias`` and
returned weights; and ``attention_blockwise``, the online-softmax recurrence
over KV blocks in plain PyTorch (O(S) memory in the scores). The first is
the plain version of the fused short-sequence path (``ops/fused.py``) and
the oracle the tests compare against. ``cdiv`` and ``round_up`` are the
JAX package's ``ops/pallas_utils.py`` helpers, copied; ``window_keep`` is
the flash kernels' causal and sliding-window predicate.

Shape convention: (batch, seq, num_heads, head_dim).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


def cdiv(a: int, b: int) -> int:
    """Ceiling division."""
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    """``x`` rounded up to a multiple of ``m``."""
    return cdiv(x, m) * m


def softmax_scale(head_dim: int, sm_scale: Optional[float]) -> float:
    """The score scale: ``sm_scale``, or 1/sqrt(head_dim) when it is None."""
    return sm_scale if sm_scale is not None else head_dim ** -0.5


Window = Tuple[Optional[int], Optional[int]]


def causal_keep(sq: int, skv: int, device) -> torch.Tensor:
    """(Sq, Skv) bool, True where query row i may see key j: the causal mask
    aligned to the sequence end, j <= i + Skv - Sq (as the JAX reference)."""
    return window_keep(sq, skv, True, None, device)


def window_keep(
    sq: int, skv: int, causal: bool, window: Optional[Window], device,
    c0: int = 0, c1: Optional[int] = None,
) -> Optional[torch.Tensor]:
    """(Sq, c1 - c0) bool, True where query row i may see key j in
    c0..c1-1: the end-aligned causal mask and the sliding ``window`` (lo,
    hi), inclusive bounds on rel = j - (i + Skv - Sq), None leaving that
    side open (the JAX kernels' "inside" window). None when every key is
    visible."""
    if not causal and window is None:
        return None
    c1 = skv if c1 is None else c1
    rel = (torch.arange(c0, c1, device=device)[None, :]
           - torch.arange(sq, device=device)[:, None] - (skv - sq))
    keep = rel <= 0 if causal else torch.ones_like(rel, dtype=torch.bool)
    lo, hi = window if window is not None else (None, None)
    if lo is not None:
        keep = keep & (rel >= lo)
    if hi is not None:
        keep = keep & (rel <= hi)
    return keep


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


def attention_blockwise(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    block_kv: int = 512,
) -> torch.Tensor:
    """Online-softmax blockwise attention in float32 (running max m,
    running sum l, rescaled accumulator), one KV block at a time: the
    recurrence the flash kernels implement, as a second, independently
    derived check on their math. (B, Sq, Hq, D) in, q's dtype out."""
    b, sq, hq, d = q.shape
    skv = k.shape[1]
    group = hq // k.shape[2]
    qf = (q.float() * softmax_scale(d, sm_scale)).transpose(1, 2)  # B H Sq D
    kf = repeat_kv(k, group).float().transpose(1, 2)
    vf = repeat_kv(v, group).float().transpose(1, 2)
    row = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    m = torch.full((b, hq, sq, 1), float("-inf"), device=q.device)
    l = torch.zeros((b, hq, sq, 1), device=q.device)
    acc = torch.zeros((b, hq, sq, d), device=q.device)
    for c0 in range(0, skv, block_kv):
        c1 = min(c0 + block_kv, skv)
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kf[:, :, c0:c1])
        if causal:
            col = torch.arange(c0, c1, device=q.device)[None, :]
            s = s.masked_fill(col > row, DEFAULT_MASK_VALUE)
        m_next = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_next)
        p = torch.exp(s - m_next)
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = alpha * acc + torch.einsum("bhqk,bhkd->bhqd", p, vf[:, :, c0:c1])
        m = m_next
    out = acc / torch.where(l == 0.0, torch.ones_like(l), l)
    return out.transpose(1, 2).to(q.dtype)
