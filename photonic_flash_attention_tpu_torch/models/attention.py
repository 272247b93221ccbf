"""Drop-in attention modules and the static kernel dispatch (PyTorch).

Port of ``photonic_flash_attention_tpu/models/attention.py``:

* :func:`dispatch_attention` — the JAX static threshold dispatch: the fused
  O(S^2) path (``ops/fused.py``) below ``flash_threshold`` or
  ``flash_min_tokens`` (``config.py``) or whenever a dense mask, an
  additive bias or the weights are asked for; the flash path otherwise
  (``ops/flash.py``: K1 forward, K4/K5 backward, or the masked backward
  when key padding comes as ``kv_lens``/``k_bias``). Attention dropout
  (``dropout_rate``, ``dropout_seed``) runs on both: K1's dropout stream on
  the flash path; on the fused path the weights alone are materialised,
  the same positional mask (``ops/dropout.py``) is applied and the result
  multiplied by V, so both paths give the identical sample for a seed.
  The TPU-only autotuner lookup of the JAX function has no counterpart.
* :func:`padding_mask_to_lens_bias` — a (B, Skv) keep-mask as the flash
  kernel's per-row lengths and per-key bias.
* :class:`PhotonicFlashAttention` — the q/k/v/out projections as an
  ``nn.Module`` (submodule names match the Flax ones, so weights map by
  name). With ``adaptive=True`` (the default) a call that records no
  gradient goes through the measured engine (``core/engine.py``); a call
  that does (grad enabled and an input requiring grad, the counterpart of
  a traced JAX call) takes :func:`dispatch_attention`. Parameters are
  float32; compute runs in ``dtype``, as Flax's ``nn.Dense(dtype=...)``
  casts inputs and kernels. In train mode ``attention_dropout`` drops
  attention probabilities (the call then takes :func:`dispatch_attention`,
  as JAX routes to the engine only without it) and ``dropout_rate`` the
  output (``F.dropout``, torch's generator: not the bits of Flax's
  ``nn.Dropout``). The attention-dropout seed is the call's
  ``dropout_seed``, or one drawn from torch's default generator.
* :class:`PhotonicMultiHeadAttention` — the ``nn.MultiheadAttention``-style
  facade: (B, S, E) batch-first, ``key_padding_mask`` (True = ignore),
  ``attn_mask``, head-averaged weights.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import get_config
from ..core.engine import get_engine
from ..ops.dropout import Seed, dropout_keep_grid
from ..ops.flash import flash_attention
from ..ops.flash_bwd import validate_dropout
from ..ops.fused import fused_attention
from ..ops.reference import DEFAULT_MASK_VALUE, repeat_kv

Attn = Tuple[torch.Tensor, Optional[torch.Tensor]]


def dense(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """Flax ``nn.Dense(dtype=x.dtype)``: weight and bias cast to x's dtype."""
    bias = layer.bias.to(x.dtype) if layer.bias is not None else None
    return F.linear(x, layer.weight.to(x.dtype), bias)


def model_device(device) -> torch.device:
    """Where a model is made: the card unless the caller asks for another
    device; without CUDA the card raises instead of falling back."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("models are made on the card by default and CUDA is not available; "
                           "pass device='cpu' to run on the CPU")
    return dev


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
    dropout_seed: Optional[Seed] = None,
) -> Attn:
    """Static threshold dispatch (JAX ``dispatch_attention``): returns
    (output (B, Sq, Hq, D), weights or None; with dropout the weights are
    the dropped ones, as the reference's ``nn.Dropout`` output)."""
    if mask is not None and (kv_lens is not None or k_bias is not None):
        raise ValueError("pass either mask or kv_lens/k_bias, not both")
    validate_dropout(dropout_rate, dropout_seed)
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
        if dropout_rate > 0.0:
            # The weights only, the flash path's positional mask, then V.
            _, w = fused_attention(q, k, v, mask, bias=bias, causal=causal, sm_scale=sm_scale,
                                   need_weights=True, weights_only=True)
            b, sq, hq, _ = q.shape
            keep = dropout_keep_grid(dropout_seed, dropout_rate, b, hq, sq, k.shape[1], q.device)
            wd = torch.where(keep, w, 0.0) / (1.0 - dropout_rate)
            vf = repeat_kv(v, hq // v.shape[2]).float()
            out = torch.einsum("bhqk,bkhd->bqhd", wd, vf).to(q.dtype)
            return out, (wd if need_weights else None)
        return fused_attention(
            q, k, v, mask, bias=bias, causal=causal, sm_scale=sm_scale,
            need_weights=need_weights,
        )
    return flash_attention(
        q, k, v, causal=causal, sm_scale=sm_scale, kv_lens=kv_lens, k_bias=k_bias,
        dropout_rate=dropout_rate, dropout_seed=dropout_seed,
    ), None


class PhotonicFlashAttention(nn.Module):
    """Self-/cross-attention over (B, S, E) inputs; GQA when
    ``num_kv_heads < num_heads``. ``adaptive``: calls that record no
    gradient and drop nothing route through the measured engine.
    ``attention_dropout``: probability dropout in train mode;
    ``dropout_rate``: output dropout in train mode."""

    def __init__(
        self,
        embed_dim: int,
        num_heads: int,
        num_kv_heads: Optional[int] = None,
        *,
        causal: bool = False,
        dropout_rate: float = 0.0,
        attention_dropout: float = 0.0,
        use_bias: bool = True,
        adaptive: bool = True,
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
        self.dropout_rate = dropout_rate
        self.attention_dropout = attention_dropout
        self.adaptive = adaptive
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
        dropout_seed: Optional[Seed] = None,
    ) -> Attn:
        """Returns (output (B, Sq, E) in ``dtype``, weights or None).
        ``dropout_seed`` seeds the attention dropout of a train-mode call
        (default: one drawn from torch's default generator)."""
        attn_rate = self.attention_dropout if self.training else 0.0
        if attn_rate > 0.0 and dropout_seed is None:
            dropout_seed = int(torch.randint(0, 2**31 - 1, (1,)))
        key = query if key is None else key
        value = key if value is None else value
        b, sq, _ = query.shape
        skv = key.shape[1]
        x_q, x_k, x_v = (t.to(self.dtype) for t in (query, key, value))
        q = dense(x_q, self.q_proj).reshape(b, sq, self.num_heads, self.head_dim)
        k = dense(x_k, self.k_proj).reshape(b, skv, self.num_kv_heads, self.head_dim)
        v = dense(x_v, self.v_proj).reshape(b, skv, self.num_kv_heads, self.head_dim)
        records_grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
        kw = dict(causal=self.causal, need_weights=need_weights, kv_lens=kv_lens, k_bias=k_bias)
        if self.adaptive and not records_grad and attn_rate == 0.0:
            out, weights = get_engine()(q, k, v, mask, **kw)
        else:
            out, weights = dispatch_attention(q, k, v, mask, dropout_rate=attn_rate,
                                              dropout_seed=dropout_seed, **kw)
        out = dense(out.reshape(b, sq, self.num_heads * self.head_dim), self.out_proj)
        return F.dropout(out, self.dropout_rate, self.training), weights

    @staticmethod
    def get_performance_stats() -> dict:
        """The engine's stats surface."""
        return get_engine().get_performance_stats()


class PhotonicMultiHeadAttention(nn.Module):
    """``nn.MultiheadAttention``-style facade (JAX ``attention.py:293``):
    (B, S, E) batch-first tensors, ``key_padding_mask`` (B, Skv) with True =
    ignore, an optional boolean ``attn_mask`` (True = attend, rank 2-4),
    head-averaged weights when ``need_weights`` and
    ``average_attn_weights``. Pure key padding reaches the kernels as
    ``kv_lens``/``k_bias``; with an ``attn_mask`` the two merge into one
    dense mask. The inner layer is the submodule ``attention``, as in
    Flax."""

    def __init__(
        self,
        embed_dim: int,
        num_heads: int,
        *,
        dropout_rate: float = 0.0,
        attention_dropout: float = 0.0,
        use_bias: bool = True,
        causal: bool = False,
        dtype: torch.dtype = torch.bfloat16,
    ) -> None:
        super().__init__()
        self.attention = PhotonicFlashAttention(
            embed_dim, num_heads, causal=causal, dropout_rate=dropout_rate,
            attention_dropout=attention_dropout, use_bias=use_bias, dtype=dtype,
        )

    def forward(
        self,
        query: torch.Tensor,
        key: Optional[torch.Tensor] = None,
        value: Optional[torch.Tensor] = None,
        key_padding_mask: Optional[torch.Tensor] = None,
        attn_mask: Optional[torch.Tensor] = None,
        *,
        need_weights: bool = True,
        average_attn_weights: bool = True,
        dropout_seed: Optional[Seed] = None,
    ) -> Attn:
        key = query if key is None else key
        b, sq, _ = query.shape
        skv = key.shape[1]
        mask = kv_lens = k_bias = None
        if attn_mask is not None:
            mask = attn_mask.to(torch.bool)
            if mask.ndim == 2:
                mask = mask[None, None]
            elif mask.ndim == 3:
                mask = mask[:, None]
        if key_padding_mask is not None:
            keep = ~key_padding_mask.to(torch.bool)
            if mask is None:
                kv_lens, k_bias = padding_mask_to_lens_bias(keep)
            else:
                mask = mask & keep[:, None, None, :].expand(b, 1, sq, skv)
        out, weights = self.attention(
            query, key, value, mask, need_weights=need_weights, kv_lens=kv_lens, k_bias=k_bias,
            dropout_seed=dropout_seed,
        )
        if weights is not None and average_attn_weights:
            weights = weights.mean(dim=1)
        return out, weights
