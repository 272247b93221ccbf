"""Paged-KV decode: token write (kernel K2) and decode attention (kernel K3).

Port of ``photonic_flash_attention_tpu/ops/paged.py``:
``paged_attention_xla`` (the plain gather oracle), ``paged_decode_attention``
and ``_quant_token_write``. Kernels: ``csrc/paged_decode.cu``.

Pool layout is token-major, ``(L, Hkv, num_pages, page_size, D)``; the JAX
pools are token-minor ``(L, Hkv, P, D, page)`` for the TPU's 128-lane DMA.
:func:`to_jax_layout` converts between the two. int8 pools carry fp32
per-token scales ``(L, Hkv, P, page)`` (the same as in JAX). A token's flat
slot is ``page_id * page_size + offset``; page 0 is the serving engine's
trash page.

Each wrapper launches its kernel for CUDA tensors (or raises) and runs its
plain version for CPU tensors. Pools are updated in place.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from .reference import DEFAULT_MASK_VALUE, softmax_scale

INT8_MAX = 127.0
POOL_DTYPES = (torch.int8, torch.bfloat16, torch.float32)
#: K3 keeps a group's q, scores and accumulator in the dynamic shared memory
#: a block gets without an opt-in (48 KB); this bounds (Hq/Hkv) * D.
_MAX_GROUP_ELEMS = 4096


def to_jax_layout(pool: torch.Tensor) -> torch.Tensor:
    """(..., page, D) token-major pool <-> (..., D, page) token-minor (JAX)."""
    return pool.transpose(-1, -2)


def _quant_token_write(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token symmetric int8 quantization. x (..., D) -> (int8 payload,
    fp32 scales (...)). absmax/127, scale 1 where absmax is 0, round half
    to even (as ``jnp.round``)."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1)
    # Divide by a tensor: PyTorch turns division by a Python scalar into a
    # multiplication by its reciprocal, which is not IEEE division.
    scale = torch.where(
        absmax == 0.0, torch.ones_like(absmax), absmax / torch.full_like(absmax, INT8_MAX)
    )
    payload = torch.round(xf / scale[..., None]).clamp(-INT8_MAX, INT8_MAX)
    return payload.to(torch.int8), scale


def paged_attention_xla(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    lengths: torch.Tensor,
    page_indices: torch.Tensor,
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
    *,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Gather-based paged attention over ONE layer's pool (the oracle).

    q (B, Hq, D); pages (Hkv, P, page, D); scales (Hkv, P, page) for int8;
    lengths (B,); page_indices (B, pages_per_seq). Returns (B, Hq, D).
    As in JAX, a row with length 0 averages over its masked keys.
    """
    b, hq, d = q.shape
    hkv, _, page, _ = k_pages.shape
    group = hq // hkv
    pps = page_indices.shape[1]
    s_total = pps * page
    scale = softmax_scale(d, sm_scale)
    idx = page_indices.long()

    def gather(pages, scales):
        g = pages[:, idx]  # (Hkv, B, pps, page, D)
        g = g.permute(1, 0, 2, 3, 4).reshape(b, hkv, s_total, d).float()
        if scales is not None:
            sc = scales[:, idx].permute(1, 0, 2, 3).reshape(b, hkv, s_total)
            g = g * sc[..., None]
        return g

    k = gather(k_pages, k_scales)
    v = gather(v_pages, v_scales)
    qf = q.float().reshape(b, hkv, group, d) * scale
    s = torch.einsum("bhgd,bhsd->bhgs", qf, k)
    pos = torch.arange(s_total, device=q.device)
    valid = pos[None] < lengths.to(q.device)[:, None]  # (B, S)
    s = s.masked_fill(~valid[:, None, None], DEFAULT_MASK_VALUE)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgs,bhsd->bhgd", p, v)
    return o.reshape(b, hq, d).to(q.dtype)


# -- K2: token write ---------------------------------------------------------


def paged_token_write_plain(
    k_new, v_new, k_pages, v_pages, k_scales, v_scales, flat_slots, layer: int
) -> None:
    """K2's plain version (any device): write token t's K/V for all Hkv
    heads at ``flat_slots[t]`` of layer ``layer``, in place."""
    page = k_pages.shape[3]
    slots = flat_slots.long()
    pids, offs = slots // page, slots % page
    if k_scales is not None:
        k8, ks = _quant_token_write(k_new)
        v8, vs = _quant_token_write(v_new)
        k_pages[layer][:, pids, offs] = k8.transpose(0, 1)
        v_pages[layer][:, pids, offs] = v8.transpose(0, 1)
        k_scales[layer][:, pids, offs] = ks.transpose(0, 1)
        v_scales[layer][:, pids, offs] = vs.transpose(0, 1)
    else:
        k_pages[layer][:, pids, offs] = k_new.transpose(0, 1).to(k_pages.dtype)
        v_pages[layer][:, pids, offs] = v_new.transpose(0, 1).to(v_pages.dtype)


def _check_pools(k_pages, v_pages, k_scales, v_scales, layer: int) -> None:
    if k_pages.ndim != 5 or v_pages.shape != k_pages.shape:
        raise ValueError(
            f"pools must be (L, Hkv, P, page, D) and equal; got "
            f"{tuple(k_pages.shape)}, {tuple(v_pages.shape)}"
        )
    if k_pages.dtype not in POOL_DTYPES or v_pages.dtype != k_pages.dtype:
        raise ValueError(f"pool dtype must be one of {POOL_DTYPES}, got {k_pages.dtype}")
    quantized = k_pages.dtype == torch.int8
    if quantized != (k_scales is not None) or (k_scales is None) != (v_scales is None):
        raise ValueError("int8 pools need k_scales and v_scales; other pools take none")
    if quantized:
        for s in (k_scales, v_scales):
            if s.shape != k_pages.shape[:4] or s.dtype != torch.float32:
                raise ValueError(
                    f"scales must be float32 {tuple(k_pages.shape[:4])}, got "
                    f"{s.dtype} {tuple(s.shape)}"
                )
    if not 0 <= layer < k_pages.shape[0]:
        raise ValueError(f"layer {layer} out of range for {k_pages.shape[0]} layers")


def _check_cuda(*tensors: Optional[torch.Tensor]) -> torch.device:
    device = None
    for t in tensors:
        if t is None:
            continue
        if t.device.type != "cuda" or (device is not None and t.device != device):
            raise ValueError(f"all tensors must be on one CUDA device; got {t.device}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
        device = t.device
    return device


def paged_token_write(
    k_new: torch.Tensor,  # (B, Hkv, D)
    v_new: torch.Tensor,
    k_pages: torch.Tensor,  # (L, Hkv, P, page, D)
    v_pages: torch.Tensor,
    k_scales: Optional[torch.Tensor],  # (L, Hkv, P, page) fp32 for int8 pools
    v_scales: Optional[torch.Tensor],
    flat_slots: torch.Tensor,  # (B,) int32
    layer: int,
) -> None:
    """Write each sequence's new K/V token into its page, in place (K2).
    int8 pools quantize per token first. Non-int8 pools take k/v_new of
    their own dtype."""
    _check_pools(k_pages, v_pages, k_scales, v_scales, layer)
    b, hkv, d = k_new.shape
    if v_new.shape != k_new.shape or k_pages.shape[1] != hkv or k_pages.shape[4] != d:
        raise ValueError(
            f"k/v_new {tuple(k_new.shape)} do not match pools {tuple(k_pages.shape)}"
        )
    if flat_slots.shape != (b,) or flat_slots.dtype != torch.int32:
        raise ValueError("flat_slots must be int32 (B,)")
    quantized = k_scales is not None
    allowed = (torch.bfloat16, torch.float32) if quantized else (k_pages.dtype,)
    if v_new.dtype != k_new.dtype or k_new.dtype not in allowed:
        raise ValueError(f"k/v_new dtype {k_new.dtype} does not fit a {k_pages.dtype} pool")
    if k_new.device.type == "cpu":
        paged_token_write_plain(
            k_new, v_new, k_pages, v_pages, k_scales, v_scales, flat_slots, layer
        )
        return
    device = _check_cuda(
        k_new, v_new, k_pages, v_pages, k_scales, v_scales, flat_slots
    )
    _build.launch(
        "pfa_paged_token_write", device,
        k_new.data_ptr(), v_new.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scales.data_ptr() if quantized else None,
        v_scales.data_ptr() if quantized else None,
        flat_slots.data_ptr(),
        int(layer), b, hkv, d, k_pages.shape[2], k_pages.shape[3],
        _build.DTYPE_CODES[k_new.dtype], _build.DTYPE_CODES[k_pages.dtype],
    )


# -- K3: decode attention ----------------------------------------------------


def paged_decode_attend_plain(
    q, k_pages, v_pages, lengths, page_indices, layer: int, k_scales, v_scales, scale
) -> torch.Tensor:
    """K3's plain version: the gather oracle on layer ``layer``, with zeros
    for sequences of length 0 (as the TPU kernel, ``paged.py:680``)."""
    quantized = k_scales is not None
    o = paged_attention_xla(
        q, k_pages[layer], v_pages[layer], lengths, page_indices,
        k_scales[layer] if quantized else None,
        v_scales[layer] if quantized else None,
        sm_scale=scale,
    )
    return o.masked_fill((lengths.to(o.device) <= 0)[:, None, None], 0.0)


def paged_decode_attend(
    q: torch.Tensor,  # (B, Hq, D) float32
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    lengths: torch.Tensor,  # (B,) int32 tokens to attend over
    page_indices: torch.Tensor,  # (B, pages_per_seq) int32
    layer: int,
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
    *,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """One query token per sequence over its first ``lengths[b]`` pooled
    tokens (K3). Returns (B, Hq, D) float32; zeros where length is 0."""
    _check_pools(k_pages, v_pages, k_scales, v_scales, layer)
    if q.ndim != 3 or q.dtype != torch.float32:
        raise ValueError(f"q must be float32 (B, Hq, D), got {q.dtype} {tuple(q.shape)}")
    b, hq, d = q.shape
    hkv = k_pages.shape[1]
    if hq % hkv or k_pages.shape[4] != d:
        raise ValueError(f"q {tuple(q.shape)} does not fit pools {tuple(k_pages.shape)}")
    if lengths.shape != (b,) or lengths.dtype != torch.int32:
        raise ValueError("lengths must be int32 (B,)")
    if page_indices.ndim != 2 or page_indices.shape[0] != b or page_indices.dtype != torch.int32:
        raise ValueError("page_indices must be int32 (B, pages_per_seq)")
    scale = softmax_scale(d, sm_scale)
    if q.device.type == "cpu":
        return paged_decode_attend_plain(
            q, k_pages, v_pages, lengths, page_indices, layer, k_scales, v_scales, scale
        )
    if d % 8 or hq * d > _MAX_GROUP_ELEMS * hkv:
        raise ValueError(f"K3 needs D % 8 == 0 and (Hq/Hkv)*D <= {_MAX_GROUP_ELEMS}")
    quantized = k_scales is not None
    device = _check_cuda(q, k_pages, v_pages, k_scales, v_scales, lengths, page_indices)
    o = torch.empty_like(q)
    _build.launch(
        "pfa_paged_decode_attend", device,
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scales.data_ptr() if quantized else None,
        v_scales.data_ptr() if quantized else None,
        lengths.data_ptr(), page_indices.data_ptr(), o.data_ptr(),
        int(layer), b, hq, hkv, d, k_pages.shape[2], k_pages.shape[3],
        page_indices.shape[1], float(scale), _build.DTYPE_CODES[k_pages.dtype],
    )
    return o


def paged_decode_attention(
    q: torch.Tensor,  # (B, Hq, D) float32
    k_new: torch.Tensor,  # (B, Hkv, D) current token's K (unquantized)
    v_new: torch.Tensor,
    k_pages: torch.Tensor,  # (L, Hkv, P, page, D)
    v_pages: torch.Tensor,
    lengths: torch.Tensor,  # (B,) length INCLUDING the current token
    page_indices: torch.Tensor,  # (B, pages_per_seq)
    flat_slots: torch.Tensor,  # (B,) slot of the current token
    layer: int,
    k_scales: Optional[torch.Tensor] = None,  # (L, Hkv, P, page)
    v_scales: Optional[torch.Tensor] = None,
    *,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Decode step for one layer: write the token's K/V into the pool (K2),
    then attend over it (K3). Pools are updated IN PLACE; returns o
    (B, Hq, D) float32. The JAX function returns the updated pools instead."""
    if k_scales is None:
        k_new, v_new = k_new.to(k_pages.dtype), v_new.to(v_pages.dtype)
    paged_token_write(
        k_new, v_new, k_pages, v_pages, k_scales, v_scales, flat_slots, layer
    )
    return paged_decode_attend(
        q, k_pages, v_pages, lengths, page_indices, layer, k_scales, v_scales,
        sm_scale=sm_scale,
    )
