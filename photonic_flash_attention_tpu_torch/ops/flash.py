"""Flash-attention forward (kernel K1, ``csrc/flash_fwd.cu``).

Port of the plain contract of ``photonic_flash_attention_tpu/ops/flash.py::
flash_attention`` (forward only): causal or not, causal aligned to the
sequence end when Sq != Skv, native GQA (Hq % Hkv == 0), ``sm_scale``.

For CUDA tensors :func:`flash_attention` launches K1 (or raises); for CPU
tensors it runs the plain version, :func:`flash_attention_plain`. The
key-padding, bias, window, dropout and lse streams of the JAX function are
later slices (ROADMAP Queue A: A2, A5, A10).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .reference import attention_reference

#: Head dims K1 is compiled for.
KERNEL_HEAD_DIMS = (64, 128)
KERNEL_DTYPES = (torch.bfloat16, torch.float32)


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
    """K1's plain version: float32 reference attention on any device."""
    return attention_reference(q, k, v, causal=causal, sm_scale=sm_scale)


def _flash_fwd_cuda(q, k, v, causal: bool, scale: float) -> torch.Tensor:
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
    _build.launch(
        "pfa_flash_fwd", q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        b, sq, skv, hq, hkv, d, float(scale), int(causal),
        _build.DTYPE_CODES[q.dtype],
    )
    return o


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention forward. q (B, Sq, Hq, D), k/v (B, Skv, Hkv, D) ->
    (B, Sq, Hq, D) in q's dtype, fp32 softmax. fp32 inputs are computed in
    fp32 on both paths (never in bf16)."""
    _validate(q, k, v, causal)
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cuda":
        return _flash_fwd_cuda(q, k, v, causal, scale)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, sm_scale=scale)
    raise ValueError(f"unsupported device {q.device}")
