"""Flash-attention backward (kernels K4 dK/dV and K5 dQ, ``csrc/flash_bwd.cu``).

Port of ``photonic_flash_attention_tpu/ops/flash_bwd.py``. The JAX module
has two kernel pairs with one contract: the grid pair
(``flash_attention_bwd_pallas``: ``_dkv_kernel``, ``_dq_kernel``) and the
unrolled pair (``flash_attention_bwd_unrolled``: ``_dq_kernel_unrolled``,
``_dkv_kernel_unrolled``); the split exists only because of how Mosaic
schedules a grid step. Here one function, :func:`flash_attention_bwd`,
carries that contract and launches one kernel pair for every shape, and
:func:`bwd_unrolled_supported` becomes the kernels' shape envelope.

Layout is the port's (B, S, H, D) (the JAX functions take (B, H, S, D));
lse and di are (B, H, Sq) fp32, lse in natural log. K/V come in already
repeated to the q heads for GQA; the caller sums dk/dv over the group
(``ops/flash.py``). ``di = rowsum(o * dO)`` is computed in fp32 PyTorch,
as the JAX functions compute it in XLA. The dropout and window streams of
the grid pair are a later slice (ROADMAP B10) and raise here.

For CUDA tensors :func:`flash_attention_bwd` launches K4 and K5 (or
raises); for CPU tensors it runs :func:`flash_attention_bwd_plain`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from ._build import KERNEL_DTYPES, KERNEL_HEAD_DIMS
from .reference import attention_scores, causal_keep

Grads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def bwd_unrolled_supported(seq_len: int, head_dim: int) -> bool:
    """True when K4/K5 take this geometry: any length >= 1, D in {64, 128}.

    The JAX envelope (S a multiple of the blocks, at most 12 tiles, Q/dO
    resident in VMEM) bounds the TPU's unrolled pair; K4/K5 stream their
    tiles, mask ragged edges and serve every length.
    """
    return seq_len >= 1 and head_dim in KERNEL_HEAD_DIMS


def _validate(q, k, v, o, lse, do, causal: bool) -> None:
    if q.ndim != 4 or k.shape != v.shape or o.shape != q.shape or do.shape != q.shape:
        raise ValueError(
            f"expected q/o/do (B,Sq,H,D) and k/v (B,Skv,H,D); got q {tuple(q.shape)}, "
            f"k {tuple(k.shape)}, v {tuple(v.shape)}, o {tuple(o.shape)}, "
            f"do {tuple(do.shape)}"
        )
    b, sq, h, d = q.shape
    if k.shape[0] != b or k.shape[2] != h or k.shape[3] != d:
        raise ValueError(
            f"k/v {tuple(k.shape)} must match q {tuple(q.shape)} in batch, heads "
            "(repeated for GQA) and head_dim"
        )
    if lse.shape != (b, h, sq):
        raise ValueError(f"lse must be (B, H, Sq) = {(b, h, sq)}, got {tuple(lse.shape)}")
    if causal and sq > k.shape[1]:
        raise ValueError(
            f"causal attention with Sq ({sq}) > Skv ({k.shape[1]}) leaves rows with no key"
        )
    if len({t.device for t in (q, k, v, o, lse, do)}) != 1:
        raise ValueError("q, k, v, o, lse and do must lie on one device")


def flash_bwd_di(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``di = rowsum(o * dO)`` in fp32, (B, H, Sq) contiguous."""
    return (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    *,
    sm_scale: float,
    causal: bool,
) -> Grads:
    """K4/K5's plain version, in fp32, from the formulas of the JAX kernels
    (``flash_bwd.py::_p_and_ds``), not through autograd:

        P = exp(S*scale - lse)   dV = P^T dO   dP = dO V^T
        dS = P * (dP - di) * scale   dK = dS^T Q   dQ = dS K

    The mask is applied before the exp, so rows with lse = -inf give P = 0.
    Returns (dq, dk, dv) in the inputs' dtypes.
    """
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    logits = attention_scores(q, k, sm_scale=sm_scale) - lse.float()[..., None]
    if causal:
        keep = causal_keep(q.shape[1], k.shape[1], q.device)
        p = torch.where(keep, torch.exp(logits), 0.0)
    else:
        p = torch.exp(logits)
    di = flash_bwd_di(o, do)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - di[..., None]) * sm_scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_cuda(q, k, v, do, lse, di) -> None:
    d = q.shape[-1]
    if not all(bwd_unrolled_supported(s, d) for s in (q.shape[1], k.shape[1])):
        raise ValueError(
            f"K4/K5 take lengths >= 1 and head_dim in {KERNEL_HEAD_DIMS}; got Sq {q.shape[1]}, "
            f"Skv {k.shape[1]}, D {d}"
        )
    if q.dtype not in KERNEL_DTYPES or not (q.dtype == k.dtype == v.dtype == do.dtype):
        raise ValueError(
            f"K4/K5 take q, k, v, do all of one dtype in {KERNEL_DTYPES}; got "
            f"{q.dtype}, {k.dtype}, {v.dtype}, {do.dtype}"
        )
    if lse.dtype != torch.float32 or di.dtype != torch.float32:
        raise ValueError("lse and di must be float32")
    for name, t in (("q", q), ("k", k), ("v", v), ("do", do), ("lse", lse), ("di", di)):
        if t.device.type != "cuda":
            raise ValueError(f"K4/K5 run on CUDA tensors; {name} is on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"K4/K5 need contiguous inputs; {name} is not")


def flash_bwd_dkv(q, k, v, do, lse, di, *, sm_scale: float, causal: bool):
    """Launch K4 on CUDA tensors: (dk, dv) in k's dtype."""
    _check_cuda(q, k, v, do, lse, di)
    b, sq, h, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _build.launch(
        "pfa_flash_bwd_dkv", q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        di.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, sq, k.shape[1], h, d, float(sm_scale), int(causal), _build.DTYPE_CODES[q.dtype],
    )
    return dk, dv


def flash_bwd_dq(q, k, v, do, lse, di, *, sm_scale: float, causal: bool):
    """Launch K5 on CUDA tensors: dq in q's dtype."""
    _check_cuda(q, k, v, do, lse, di)
    b, sq, h, d = q.shape
    dq = torch.empty_like(q)
    _build.launch(
        "pfa_flash_bwd_dq", q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        di.data_ptr(), dq.data_ptr(),
        b, sq, k.shape[1], h, d, float(sm_scale), int(causal), _build.DTYPE_CODES[q.dtype],
    )
    return dq


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    *,
    sm_scale: float,
    causal: bool,
    window: Optional[Tuple[Optional[int], Optional[int], str]] = None,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[torch.Tensor] = None,
) -> Grads:
    """Flash-attention backward: (dq, dk, dv) in the inputs' dtypes.

    q, o, do (B, Sq, H, D); k, v (B, Skv, H, D), repeated for GQA; lse
    (B, H, Sq) fp32 natural log, as ``flash_attention_with_lse`` returns
    it. O(S) memory on CUDA: probability tiles exist only in registers.
    """
    if window is not None or dropout_rate > 0.0 or dropout_seed is not None:
        raise NotImplementedError(
            "window and dropout streams of the backward are not ported yet (ROADMAP B10)"
        )
    _validate(q, k, v, o, lse, do, causal)
    if q.device.type == "cuda":
        di = flash_bwd_di(o, do)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, di, sm_scale=sm_scale, causal=causal)
        dq = flash_bwd_dq(q, k, v, do, lse, di, sm_scale=sm_scale, causal=causal)
        return dq, dk, dv
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, sm_scale=sm_scale, causal=causal)
    raise ValueError(f"unsupported device {q.device}")
