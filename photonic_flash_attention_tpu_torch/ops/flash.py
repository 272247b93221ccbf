"""Flash attention, forward (kernel K1, ``csrc/flash_fwd.cu``) and gradient.

Port of the plain contract of ``photonic_flash_attention_tpu/ops/flash.py``:
causal or not, causal aligned to the sequence end when Sq != Skv, native
GQA (Hq % Hkv == 0), ``sm_scale``.

* :func:`flash_attention` is differentiable: the counterpart of the JAX
  ``_flash_attention_core`` custom VJP (``_flash_core_fwd`` /
  ``_flash_core_bwd``) is :class:`_FlashAttentionFn`, whose forward runs K1
  with its logsumexp output and whose backward runs K4/K5
  (``ops/flash_bwd.py``). Without a gradient to take, K1 writes no lse, as
  the JAX primal path (``save_residuals=False``).
* :func:`flash_attention_with_lse` returns (o, lse), lse (B, Hq, Sq) fp32
  in natural log; rows with no valid key get lse = -inf and o = 0.

CUDA tensors launch the kernels (or raise); CPU tensors run the plain
versions, forward and backward. The key-padding, bias, window and dropout
streams of the JAX function are later slices (ROADMAP A5, A10).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from ._build import KERNEL_DTYPES, KERNEL_HEAD_DIMS
from .flash_bwd import flash_attention_bwd
from .reference import attention_scores, causal_keep, repeat_kv, softmax_scale

__all__ = [
    "KERNEL_DTYPES",
    "KERNEL_HEAD_DIMS",
    "flash_attention",
    "flash_attention_plain",
    "flash_attention_with_lse",
    "flash_attention_with_lse_plain",
]


def _validate(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(
            f"expected q (B,Sq,Hq,D) and k/v (B,Skv,Hkv,D); got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, sq, hq, d = q.shape
    _, skv, hkv, dk = k.shape
    if k.shape[0] != b or dk != d:
        raise ValueError(f"batch/head_dim mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}")
    if hq % hkv:
        raise ValueError(f"Hq {hq} not divisible by Hkv {hkv} (GQA)")
    if sq == 0 or skv == 0:
        raise ValueError("empty sequence")
    if causal and sq > skv:
        raise ValueError(
            f"causal attention with Sq ({sq}) > Skv ({skv}) leaves rows with no key"
        )
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"dtype mismatch: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"device mismatch: {q.device}, {k.device}, {v.device}")


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """K1's plain version: float32 attention on any device, output in q's
    dtype."""
    return flash_attention_with_lse_plain(q, k, v, causal=causal, sm_scale=sm_scale)[0]


def flash_attention_with_lse_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1-with-lse's plain version in float32: (o in q's dtype, lse
    (B, Hq, Sq) fp32, natural log; -inf and o = 0 for a row with no key)."""
    s = attention_scores(q, k, sm_scale=sm_scale)
    if causal:
        s = s.masked_fill(~causal_keep(q.shape[1], k.shape[1], q.device), float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - torch.where(torch.isinf(lse), 0.0, lse)[..., None])
    vf = repeat_kv(v, q.shape[2] // v.shape[2]).float()
    o = torch.einsum("bhqk,bkhd->bqhd", p, vf)
    return o.to(q.dtype), lse


def _flash_fwd_cuda(q, k, v, causal: bool, scale: float, save_lse: bool):
    """Launch K1: (o, lse or None)."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"K1 supports head_dim in {KERNEL_HEAD_DIMS}, got {d}")
    if q.dtype not in KERNEL_DTYPES:
        raise ValueError(f"K1 supports {KERNEL_DTYPES}, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"K1 needs contiguous inputs; {name} is not")
    o = torch.empty_like(q)
    lse = torch.empty(b, hq, sq, device=q.device, dtype=torch.float32) if save_lse else None
    _build.launch(
        "pfa_flash_fwd", q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr() if save_lse else None,
        b, sq, skv, hq, hkv, d, float(scale), int(causal),
        _build.DTYPE_CODES[q.dtype],
    )
    return o, lse


def _fwd_with_lse(q, k, v, causal: bool, scale: float):
    if q.device.type == "cuda":
        return _flash_fwd_cuda(q, k, v, causal, scale, save_lse=True)
    if q.device.type == "cpu":
        return flash_attention_with_lse_plain(q, k, v, causal=causal, sm_scale=scale)
    raise ValueError(f"unsupported device {q.device}")


class _FlashAttentionFn(torch.autograd.Function):
    """Custom gradient of flash attention (JAX ``_flash_attention_core``):
    the forward saves (q, k, v, o, lse); the backward repeats K/V over the
    GQA group (``repeat_interleave`` on the head axis, JAX's ``jnp.repeat``,
    matching K1's ``h / (Hq/Hkv)``), runs K4/K5 and sums dk/dv over the
    group (``_flash_core_bwd``, ``ops/flash.py:1152``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        o, lse = _fwd_with_lse(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        b, skv, hkv, d = k.shape
        group = q.shape[2] // hkv
        dq, dk, dv = flash_attention_bwd(
            q, repeat_kv(k, group), repeat_kv(v, group), o, lse, do.contiguous(),
            sm_scale=ctx.scale, causal=ctx.causal,
        )
        if group > 1:
            dk = dk.float().view(b, skv, hkv, group, d).sum(3).to(k.dtype)
            dv = dv.float().view(b, skv, hkv, group, d).sum(3).to(v.dtype)
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention. q (B, Sq, Hq, D), k/v (B, Skv, Hkv, D) -> (B, Sq, Hq, D)
    in q's dtype, fp32 softmax. fp32 inputs are computed in fp32 on both
    paths (never in bf16). Differentiable in q, k and v; dq/dk/dv come
    back in the inputs' dtypes."""
    _validate(q, k, v, causal)
    scale = softmax_scale(q.shape[-1], sm_scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttentionFn.apply(q, k, v, causal, scale)
    if q.device.type == "cuda":
        return _flash_fwd_cuda(q, k, v, causal, scale, save_lse=False)[0]
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, sm_scale=scale)
    raise ValueError(f"unsupported device {q.device}")


def flash_attention_with_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    kv_lens: Optional[torch.Tensor] = None,
    k_bias: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash attention also returning the per-row logsumexp (JAX
    ``flash_attention_with_lse``, ``ops/flash.py:1680``): (output
    (B, Sq, Hq, D), lse (B, Hq, Sq) fp32, natural log). Forward only."""
    if kv_lens is not None or k_bias is not None:
        raise NotImplementedError("kv_lens/k_bias streams are not ported yet (ROADMAP B5)")
    _validate(q, k, v, causal)
    return _fwd_with_lse(q, k, v, causal, softmax_scale(q.shape[-1], sm_scale))
