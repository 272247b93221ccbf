"""Paged-KV decode: token write (kernel K2) and decode attention (kernel K3).

Port of ``photonic_flash_attention_tpu/ops/paged.py``:
``paged_attention_xla`` (the plain gather oracle), ``paged_decode_attention``,
``paged_attention_hf`` (the read-only head-folded decode, with its
int8-compute mode), ``paged_attention`` (the read-only decode of the TPU
kernel ``_paged_kernel``, on K3's decode attend), ``paged_attention_auto``
and ``_quant_token_write``. Kernels: K2 in ``csrc/paged_decode.cu``, K3
(split-KV over bulk-copied pages, every mode, and the fused write + attend
of the decode step) in ``csrc/paged_decode_sm90.cu``.

Pool layout is token-major, ``(L, Hkv, num_pages, page_size, D)``; the JAX
pools are token-minor ``(L, Hkv, P, D, page)`` for the TPU's 128-lane DMA.
:func:`to_jax_layout` converts between the two. int8 pools carry fp32
per-token scales ``(L, Hkv, P, page)`` (the same as in JAX). A token's flat
slot is ``page_id * page_size + offset``; page 0 is the serving engine's
trash page.

Each wrapper launches its kernel for CUDA tensors (or raises) and runs its
plain version for CPU tensors. Pools are updated in place. The decode step
(:func:`paged_decode_attention`) is ONE launch on the card, as the TPU
kernel: K3 writes the token and attends (counted
``pfa_paged_decode_fused``).

``token_bias`` (B, Hkv, >= S_cap) fp32 (JAX ``paged_decode_attention(
token_bias=...)``, the TPU kernel's ``bias_ref``) adds a per-(head,
key-token) score bias indexed by the token's logical position in its
sequence, before the length mask: the T5 relative-position bias at
decode. K3 takes it in its token-bias mode.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from . import _build
from .reference import DEFAULT_MASK_VALUE, softmax_scale

INT8_MAX = 127.0
POOL_DTYPES = (torch.int8, torch.bfloat16, torch.float32)
#: The largest query-head group K3 takes: (Hq/Hkv) * D elements.
_MAX_GROUP_ELEMS = 4096
#: Bytes of K and V rows one of K3's ring stages holds (its tile of tokens).
_K3_STAGE_BYTES = 16384
#: Tokens of one K3 split (rounded up to whole pages, and to whole requant
#: blocks in int8 compute): a (sequence, kv head, split) is one work item of
#: K3's persistent grid. With 1 << 30, every sequence is one split (the
#: lever that shows what the split buys).
_K3_SPLIT_TOKENS = 256
#: Splits a sequence at most: a longer table takes longer splits, so the
#: last split of a row merges at most this many records.
_K3_MAX_SPLITS = 32
#: Shared memory a K3 CTA may take on the H100 (227 KB), its ring stages and
#: consumer warps (csrc/paged_decode_sm90.cu: NST, NCW).
_K3_SMEM_MAX = 232_448
_K3_STAGES, _K3_CONSUMER_WARPS = 4, 4


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
    token_bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Gather-based paged attention over ONE layer's pool (the oracle).

    q (B, Hq, D); pages (Hkv, P, page, D); scales (Hkv, P, page) for int8;
    lengths (B,); page_indices (B, pages_per_seq); ``token_bias`` (B, Hkv,
    pages_per_seq * page) added to the scaled scores before the length
    mask. Returns (B, Hq, D). As in JAX, a row with length 0 averages over
    its masked keys.
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
    if token_bias is not None:
        s = s + token_bias.float()[:, :, None, :]
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


# -- K3: the plan and the launch ---------------------------------------------


class K3Plan(NamedTuple):
    """How K3 cuts one call (csrc/paged_decode_sm90.cu): ``tile`` tokens a
    ring stage, splits of ``split_pages`` pages (``n_split`` of them a
    sequence), up to ``gcmax`` query heads a CTA (``n_gchunk`` CTAs a kv
    head's group), the int8-compute requant ``block`` in tokens (0 in float
    mode) and the CTA's shared memory in bytes."""

    tile: int
    split_pages: int
    n_split: int
    gcmax: int
    n_gchunk: int
    block: int
    smem: int


def _align(x: int, a: int) -> int:
    return -(-x // a) * a


def k3_smem(b: int, d: int, elt: int, gcmax: int, tile: int, split_pages: int,
            block: int) -> int:
    """K3's shared memory (the kernel's ``k3_layout``) at head dim ``d``:
    mbarriers and a flag, the batch's lengths and their prefix of active
    items, a split's page ids, the new token's rows, the warps' end-of-split
    states (float mode) or the int8-compute block state (``block`` > 0),
    each ``D_c`` wide (``_build.head_dim_plan``), and the ring, whose rows
    are d wide."""
    dc = _build.head_dim_plan(d, elt, "K3")[0]
    off = (2 * _K3_STAGES * 8 + 16 + _align((2 * b + 1) * 4, 16) + _align(split_pages * 4, 16)
           + _align(2 * dc * elt + 16, 16))
    if block:
        off += 4 * (gcmax * block + block + 2 * gcmax * dc + 4 * gcmax)
    else:
        off += 4 * _K3_CONSUMER_WARPS * gcmax * (dc + 2)
    stage = _align(tile * (2 * d * elt + (8 if elt == 1 else 0)), 128)
    return _align(off, 128) + _K3_STAGES * stage


@functools.lru_cache(maxsize=256)
def k3_plan(b: int, hq: int, hkv: int, d: int, elt: int, page: int, pps: int,
            block_pages: Optional[int] = None) -> K3Plan:
    """K3's work items and tiles for B sequences of ``pps`` page-table
    entries of ``page`` tokens, from the shapes alone (never from
    ``lengths``: no host read). ``block_pages`` (int8 compute) is the
    requant block: splits are whole blocks. Raises ValueError for a call K3
    does not take.

    Tile: the tokens whose K and V rows fill ``_K3_STAGE_BYTES`` (rounded
    down to a power of two), cut to divide the page (or a whole number of
    pages). Head dims 1 to 256 over int8 and bf16 pools, 1 to 128 over
    fp32 ones (``_build.head_dim_plan``); the kernel's rows
    are d wide, so ``d * elt`` must be a multiple of 16 here (the wrapper
    pads a call whose rows are not). Heads: the group in one
    CTA when G = 1, else in chunks of 2 x elt heads, at most 4 (32 fp32
    registers of q and of the accumulator a lane, 16 for fp32 pools).
    Split: ``_K3_SPLIT_TOKENS``, or 1 / ``_K3_MAX_SPLITS`` of the table if
    that is more, rounded up to whole pages (blocks), at most the table.
    Cached: decode calls it once a layer a step with the same shapes."""
    if b <= 0:
        raise ValueError(f"K3 needs a batch, got B {b}")
    dc, copy = _build.head_dim_plan(d, elt, "K3")
    if copy:
        raise ValueError(f"K3 needs D in whole 16-byte rows: D {d} of {elt}-byte elements; "
                         f"pad the pools to {dc}")
    if hkv <= 0 or hq % hkv or hq * d > _MAX_GROUP_ELEMS * hkv:
        raise ValueError(f"K3 needs Hq % Hkv == 0 and (Hq/Hkv)*D <= {_MAX_GROUP_ELEMS}; "
                         f"got Hq {hq}, Hkv {hkv}, D {d}")
    if page <= 0 or pps <= 0:
        raise ValueError(f"K3 needs pages of >= 1 token and a page table; got page {page}, "
                         f"pages_per_seq {pps}")
    if elt == 1 and page % 4:
        raise ValueError(f"K3 needs page_size % 4 == 0 for an int8 pool (its scales are "
                         f"bulk-copied in 16-byte runs); got {page}")
    cap = 1 << (_K3_STAGE_BYTES // (2 * d * elt)).bit_length() - 1
    tile = math.gcd(page, cap) if page >= cap else cap // page * page
    group = hq // hkv
    gcmax = 1 if group == 1 else min(2 * elt, 4)
    n_gchunk = -(-group // gcmax)
    unit = block_pages or 1
    n_units = -(-pps // unit)
    tokens = max(_K3_SPLIT_TOKENS, -(-pps * page // _K3_MAX_SPLITS))
    units = min(n_units, max(1, -(-tokens // (unit * page))))
    split_pages = units * unit
    n_split = -(-pps // split_pages)
    block = unit * page if block_pages else 0
    smem = k3_smem(b, d, elt, gcmax, tile, split_pages, block)
    if smem > _K3_SMEM_MAX:
        raise ValueError(f"K3 needs its CTA in {_K3_SMEM_MAX} bytes of shared memory; a split "
                         f"of {split_pages} pages, tile {tile}, block {block} tokens, "
                         f"{gcmax} heads, D {d} take {smem}")
    return K3Plan(tile, split_pages, n_split, gcmax, n_gchunk, block, smem)


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _k3_launch(count_as: str, device: torch.device, q, k_pages, v_pages, k_scales, v_scales,
               lengths, page_indices, layer: int, sm_scale: float, *, q8=None,
               score_scale=None, token_bias=None, k_new=None, v_new=None, flat_slots=None,
               block_pages: Optional[int] = None) -> torch.Tensor:
    """One K3 launch on rank-5 pools, counted under ``count_as``; returns o
    (B, Hq, D) fp32. Float mode takes ``q`` fp32; int8 compute ``q8`` and
    its ``score_scale`` (a device scalar) with ``block_pages``; the fused
    decode ``k_new``, ``v_new`` and ``flat_slots``.

    Head dims as :func:`k3_plan` takes them. Where the pool's rows are
    not whole 16-byte units (int8 d % 16 != 0, bf16 d % 8 != 0, fp32 d % 4
    != 0: d 100 in int8 or bf16), the call runs on a D_c-wide padded copy
    of the layer's pools (and of q, k_new, v_new); the fused decode then
    writes its token into the copy, and the layer's pools take the copy's
    first d columns back. Each such call copies the layer's pools twice: a
    server at such a head dim should keep its pools D_c wide."""
    b, hq, d = (q if q is not None else q8).shape
    _, hkv, num_pages, page, _ = k_pages.shape
    pps = page_indices.shape[1]
    dc, copy = _build.head_dim_plan(d, k_pages.element_size(), "K3")
    fused = flat_slots is not None
    pools = (k_pages, v_pages)
    if copy:
        lyr = slice(int(layer), int(layer) + 1)
        k_pages, v_pages = (_build.pad_head(t[lyr], dc) for t in pools)
        if k_scales is not None:
            k_scales, v_scales = k_scales[lyr], v_scales[lyr]
        q, q8, k_new, v_new = (None if t is None else _build.pad_head(t, dc)
                               for t in (q, q8, k_new, v_new))
        layer, d_run = 0, dc
    else:
        d_run = d
    plan = k3_plan(b, hq, hkv, d_run, k_pages.element_size(), page, pps, block_pages)
    for t in (k_pages, v_pages, k_scales, v_scales):
        if t is not None and t.data_ptr() % 16:
            raise ValueError("K3 needs its pools and scales 16-byte aligned")
    o = torch.empty(b, hq, d_run, device=device, dtype=torch.float32)
    rows = b * hkv * plan.n_gchunk
    ws = None
    if plan.n_split > 1:  # the splits' (m, l, acc) records, D_c wide
        ws = torch.empty(rows * plan.n_split * plan.gcmax * (dc + 2), device=device,
                         dtype=torch.float32)
    counters = _build.arrival_counters("K3", device, rows)
    _build.launch(
        "pfa_paged_k3", device,
        _ptr(q), _ptr(q8), _ptr(score_scale), k_pages.data_ptr(), v_pages.data_ptr(),
        _ptr(k_scales), _ptr(v_scales), lengths.data_ptr(), page_indices.data_ptr(),
        _ptr(token_bias), _ptr(k_new), _ptr(v_new), _ptr(flat_slots), o.data_ptr(), _ptr(ws),
        counters.data_ptr(),
        int(layer), b, hq, hkv, d_run, num_pages, page, pps,
        token_bias.shape[-1] if token_bias is not None else 0,
        _build.DTYPE_CODES[k_pages.dtype],
        _build.DTYPE_CODES[k_new.dtype] if fused else 0, int(q8 is not None),
        plan.split_pages, plan.n_split, plan.tile, plan.block, plan.gcmax, float(sm_scale),
        count_as=count_as,
    )
    if copy and fused:
        for pool, padded in zip(pools, (k_pages, v_pages)):
            pool[lyr].copy_(padded[..., :d])
    return _build.cut_head(o, d)


# -- K3: decode attention ----------------------------------------------------


def paged_decode_attend_plain(
    q, k_pages, v_pages, lengths, page_indices, layer: int, k_scales, v_scales, scale,
    token_bias=None,
) -> torch.Tensor:
    """K3's plain version: the gather oracle on layer ``layer``, with zeros
    for sequences of length 0 (as the TPU kernel, ``paged.py:680``);
    ``token_bias`` already fitted to the page-table capacity."""
    quantized = k_scales is not None
    o = paged_attention_xla(
        q, k_pages[layer], v_pages[layer], lengths, page_indices,
        k_scales[layer] if quantized else None,
        v_scales[layer] if quantized else None,
        sm_scale=scale, token_bias=token_bias,
    )
    return o.masked_fill((lengths.to(o.device) <= 0)[:, None, None], 0.0)


def fit_token_bias(token_bias: torch.Tensor, b: int, hkv: int, s_cap: int) -> torch.Tensor:
    """(B, Hkv, >= or < S_cap) -> (B, Hkv, S_cap) fp32: zero-padded or cut
    to the page-table capacity, as the JAX wrapper (``paged.py:769-775``)."""
    if token_bias.ndim != 3 or tuple(token_bias.shape[:2]) != (b, hkv):
        raise ValueError(f"token_bias must be (B, Hkv, S) = ({b}, {hkv}, S), got "
                         f"{tuple(token_bias.shape)}")
    tb = token_bias.float()
    if tb.shape[-1] < s_cap:
        return torch.nn.functional.pad(tb, (0, s_cap - tb.shape[-1]))
    return tb[..., :s_cap].contiguous()


def _check_decode(q, k_pages, v_pages, k_scales, v_scales, lengths, page_indices,
                  layer: int) -> None:
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
    token_bias: Optional[torch.Tensor] = None,  # (B, Hkv, S) fp32
) -> torch.Tensor:
    """One query token per sequence over its first ``lengths[b]`` pooled
    tokens (K3, the pool read only). Returns (B, Hq, D) float32; zeros where
    length is 0. ``token_bias`` (B, Hkv, S), padded or cut to pages_per_seq
    * page, takes K3's token-bias mode (counted
    ``pfa_paged_decode_attend_tbias``)."""
    return _k3_attend(q, k_pages, v_pages, lengths, page_indices, layer, k_scales, v_scales,
                      sm_scale, token_bias, None)


def _k3_attend(q, k_pages, v_pages, lengths, page_indices, layer: int, k_scales, v_scales,
               sm_scale: Optional[float], token_bias, count_as: Optional[str]) -> torch.Tensor:
    """:func:`paged_decode_attend`, counted under ``count_as`` when given."""
    _check_decode(q, k_pages, v_pages, k_scales, v_scales, lengths, page_indices, layer)
    b, _, d = q.shape
    hkv = k_pages.shape[1]
    scale = softmax_scale(d, sm_scale)
    s_cap = page_indices.shape[1] * k_pages.shape[3]
    if token_bias is not None:
        token_bias = fit_token_bias(token_bias.to(q.device), b, hkv, s_cap)
    if q.device.type == "cpu":
        return paged_decode_attend_plain(
            q, k_pages, v_pages, lengths, page_indices, layer, k_scales, v_scales, scale,
            token_bias,
        )
    device = _check_cuda(q, k_pages, v_pages, k_scales, v_scales, lengths, page_indices,
                         token_bias)
    if count_as is None:
        count_as = ("pfa_paged_decode_attend_tbias" if token_bias is not None
                    else "pfa_paged_decode_attend")
    return _k3_launch(count_as, device, q, k_pages, v_pages, k_scales, v_scales, lengths,
                      page_indices, layer, scale, token_bias=token_bias)


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
    token_bias: Optional[torch.Tensor] = None,  # (B, Hkv, >= S_cap) fp32
) -> torch.Tensor:
    """Decode step for one layer: write the token's K/V into the pool, then
    attend over it (with ``token_bias`` in K3's token-bias mode). Pools are
    updated IN PLACE; returns o (B, Hq, D) float32. The JAX function
    returns the updated pools instead.

    On the card this is ONE launch of K3's fused mode, as the TPU kernel
    (counted ``pfa_paged_decode_fused``, ``pfa_paged_decode_fused_tbias``
    with a bias): the token is written as K2 writes it (bit for bit) and
    the output equals the write followed by the attend, wherever
    ``flat_slots`` lies; k/v_new may be bf16 or fp32 for any pool. On the
    CPU, the plain write (K2's plain version) then the plain attend."""
    if q.device.type == "cpu":
        if k_scales is None:
            k_new, v_new = k_new.to(k_pages.dtype), v_new.to(v_pages.dtype)
        paged_token_write(
            k_new, v_new, k_pages, v_pages, k_scales, v_scales, flat_slots, layer
        )
        return paged_decode_attend(
            q, k_pages, v_pages, lengths, page_indices, layer, k_scales, v_scales,
            sm_scale=sm_scale, token_bias=token_bias,
        )
    _check_decode(q, k_pages, v_pages, k_scales, v_scales, lengths, page_indices, layer)
    b, _, d = q.shape
    hkv = k_pages.shape[1]
    if k_new.shape != (b, hkv, d) or v_new.shape != k_new.shape:
        raise ValueError(f"k/v_new must be (B, Hkv, D) = ({b}, {hkv}, {d}); got "
                         f"{tuple(k_new.shape)}, {tuple(v_new.shape)}")
    if k_new.dtype not in (torch.bfloat16, torch.float32) or v_new.dtype != k_new.dtype:
        raise ValueError(f"k/v_new must be bf16 or fp32 and alike, got {k_new.dtype}, "
                         f"{v_new.dtype}")
    if flat_slots.shape != (b,) or flat_slots.dtype != torch.int32:
        raise ValueError("flat_slots must be int32 (B,)")
    scale = softmax_scale(d, sm_scale)
    if token_bias is not None:
        s_cap = page_indices.shape[1] * k_pages.shape[3]
        token_bias = fit_token_bias(token_bias.to(q.device), b, hkv, s_cap)
    device = _check_cuda(q, k_new, v_new, k_pages, v_pages, k_scales, v_scales, lengths,
                         page_indices, flat_slots, token_bias)
    name = "pfa_paged_decode_fused" + ("_tbias" if token_bias is not None else "")
    return _k3_launch(name, device, q, k_pages, v_pages, k_scales, v_scales, lengths,
                      page_indices, layer, scale, token_bias=token_bias, k_new=k_new,
                      v_new=v_new, flat_slots=flat_slots)


# -- K3 as paged_attention_hf ------------------------------------------------


def _quant_per_tensor(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 (the JAX wrapper's q quantization):
    (int8 values, fp32 scale () = absmax/127, 1 where absmax is 0)."""
    xf = x.float()
    absmax = xf.abs().amax()
    scale = torch.where(absmax == 0.0, torch.ones_like(absmax), absmax / torch.full_like(absmax, INT8_MAX))
    return torch.round(xf / scale).clamp(-INT8_MAX, INT8_MAX).to(torch.int8), scale


def _hf_layout(k_pages, v_pages, k_scales, v_scales, layer):
    """Rank-4 pools (one layer) -> rank 5 with layer 0; returns the pools,
    scales and the layer as an int."""
    if k_pages.ndim == 4:
        if layer is not None:
            raise ValueError("rank-4 pools take no layer")
        k_pages, v_pages = k_pages[None], v_pages[None]
        if k_scales is not None:
            k_scales, v_scales = k_scales[None], v_scales[None]
        return k_pages, v_pages, k_scales, v_scales, 0
    if layer is None:
        raise ValueError("rank-5 pools need a layer")
    return k_pages, v_pages, k_scales, v_scales, int(layer)


def paged_attention_hf_plain(
    q, k_pages, v_pages, lengths, page_indices, layer: int, k_scales, v_scales,
    scale: float, pages_per_block: int, int8_compute: bool,
) -> torch.Tensor:
    """K3-as-``paged_attention_hf``'s plain version on rank-5 pools: the
    TPU kernel's recurrence over blocks of ``pages_per_block`` pages (the
    same block boundaries, so the int8 P requant rounds as there). Returns
    (B, Hq, D) float32; zeros for a row of length 0."""
    b, hq, d = q.shape
    hkv, page = k_pages.shape[1], k_pages.shape[3]
    group = hq // hkv
    quantized = k_scales is not None
    bt = pages_per_block * page
    pps = page_indices.shape[1]
    n_blocks = -(-pps // pages_per_block)
    tables = torch.zeros(b, n_blocks * pages_per_block, dtype=torch.long, device=q.device)
    tables[:, :pps] = page_indices.long()
    lens = lengths.to(q.device).long()
    qg = q.float().reshape(b, hkv, group, d)
    if int8_compute:
        q8, qs = _quant_per_tensor(qg)
        qg, score_scale = q8.float(), qs * scale
    else:
        score_scale = torch.tensor(scale, dtype=torch.float32, device=q.device)
    m = torch.full((b, hkv, group, 1), float("-inf"), device=q.device)
    l = torch.zeros((b, hkv, group, 1), device=q.device)
    acc = torch.zeros((b, hkv, group, d), device=q.device)

    def gather(pool, blk_tables):  # -> (B, Hkv, bt, ...)
        g = pool[layer][:, blk_tables]  # (Hkv, B, ppb, page, ...)
        return g.transpose(0, 1).reshape(b, hkv, bt, *pool.shape[4:])

    for blk in range(n_blocks):
        active = (blk * bt < lens)[:, None, None, None]
        if not bool(active.any()):
            continue
        pt = tables[:, blk * pages_per_block:(blk + 1) * pages_per_block]
        kb, vb = gather(k_pages, pt).float(), gather(v_pages, pt).float()
        # int8 x int8 products summed in fp32 are exact integers here.
        s = torch.einsum("bhgd,bhtd->bhgt", qg, kb) * score_scale
        if quantized:
            s = s * gather(k_scales, pt)[:, :, None, :]
        pos = blk * bt + torch.arange(bt, device=q.device)
        s = s.masked_fill(~(pos[None] < lens[:, None])[:, None, None, :], DEFAULT_MASK_VALUE)
        m_next = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_next)
        alpha = torch.exp(m - m_next)
        l_next = alpha * l + p.sum(-1, keepdim=True)
        if quantized:
            p = p * gather(v_scales, pt)[:, :, None, :]
        if int8_compute:
            pmax = p.amax(-1, keepdim=True)
            zero = pmax == 0.0
            pinv = torch.where(zero, 0.0, torch.full_like(pmax, INT8_MAX) / pmax)
            p8 = torch.trunc(p * pinv + 0.5)
            pscale = torch.where(zero, 0.0, pmax / torch.full_like(pmax, INT8_MAX))
            pv = torch.einsum("bhgt,bhtd->bhgd", p8, vb) * pscale
        else:
            pv = torch.einsum("bhgt,bhtd->bhgd", p, vb)
        acc = torch.where(active, acc * alpha + pv, acc)
        m = torch.where(active, m_next, m)
        l = torch.where(active, l_next, l)
    o = acc / torch.where(l == 0.0, torch.ones_like(l), l)
    return o.reshape(b, hq, d)


def paged_attention_hf(
    q: torch.Tensor,  # (B, Hq, D)
    k_pages: torch.Tensor,  # (Hkv, P, page, D) or (L, Hkv, P, page, D)
    v_pages: torch.Tensor,
    lengths: torch.Tensor,  # (B,) int32
    page_indices: torch.Tensor,  # (B, pages_per_seq) int32
    k_scales: Optional[torch.Tensor] = None,  # (Hkv, P, page) or (L, Hkv, P, page)
    v_scales: Optional[torch.Tensor] = None,
    *,
    sm_scale: Optional[float] = None,
    pages_per_block: int = 8,
    int8_compute: Optional[bool] = None,
    layer: Optional[int] = None,
) -> torch.Tensor:
    """Read-only paged decode, one query token per sequence over its first
    ``lengths[b]`` pooled tokens (JAX ``paged_attention_hf``): K3 on CUDA,
    its plain version on CPU. Returns (B, Hq, D) in q's dtype; zeros for a
    row of length 0 (unlike :func:`paged_attention_xla`).

    ``int8_compute`` (default: on exactly for int8 pools) quantizes q per
    tensor here, as JAX does outside its kernel, and runs both products in
    int8 with int32 sums, requantizing P per block of ``pages_per_block``
    pages. The JAX arguments ``num_buffers`` and ``interpret`` are the TPU
    kernel's DMA pipelining and Mosaic's interpreter; they have no
    counterpart here."""
    k_pages, v_pages, k_scales, v_scales, lyr = _hf_layout(
        k_pages, v_pages, k_scales, v_scales, layer
    )
    _check_pools(k_pages, v_pages, k_scales, v_scales, lyr)
    if q.ndim != 3 or not q.is_floating_point():
        raise ValueError(f"q must be float (B, Hq, D), got {q.dtype} {tuple(q.shape)}")
    b, hq, d = q.shape
    hkv = k_pages.shape[1]
    if hq % hkv or k_pages.shape[4] != d:
        raise ValueError(f"q {tuple(q.shape)} does not fit pools {tuple(k_pages.shape)}")
    if lengths.shape != (b,) or lengths.dtype != torch.int32:
        raise ValueError("lengths must be int32 (B,)")
    if page_indices.ndim != 2 or page_indices.shape[0] != b or page_indices.dtype != torch.int32:
        raise ValueError("page_indices must be int32 (B, pages_per_seq)")
    if pages_per_block <= 0:
        raise ValueError(f"pages_per_block must be positive, got {pages_per_block}")
    quantized = k_scales is not None
    if int8_compute is None:
        int8_compute = quantized
    if int8_compute and not quantized:
        raise ValueError("int8_compute needs an int8 pool")
    scale = softmax_scale(d, sm_scale)
    if q.device.type == "cpu":
        return paged_attention_hf_plain(
            q, k_pages, v_pages, lengths, page_indices, lyr, k_scales, v_scales,
            scale, pages_per_block, int8_compute,
        ).to(q.dtype)
    device = _check_cuda(q, k_pages, v_pages, k_scales, v_scales, lengths, page_indices)
    qf = q.float().contiguous()
    if int8_compute:
        q8, qs = _quant_per_tensor(qf)
        # q's dequant scale x sm_scale stays on the card (no host read).
        o = _k3_launch("pfa_paged_hf_int8", device, None, k_pages, v_pages, k_scales, v_scales,
                       lengths, page_indices, lyr, scale, q8=q8, score_scale=qs * scale,
                       block_pages=pages_per_block)
    else:
        o = _k3_launch("pfa_paged_hf", device, qf, k_pages, v_pages, k_scales, v_scales,
                       lengths, page_indices, lyr, scale)
    return o.to(q.dtype)


# -- K3 as paged_attention ---------------------------------------------------


def paged_attention(
    q: torch.Tensor,  # (B, Hq, D)
    k_pages: torch.Tensor,  # (Hkv, P, page, D) or (L, Hkv, P, page, D)
    v_pages: torch.Tensor,
    lengths: torch.Tensor,  # (B,) int32
    page_indices: torch.Tensor,  # (B, pages_per_seq) int32
    k_scales: Optional[torch.Tensor] = None,  # (Hkv, P, page) or (L, Hkv, P, page)
    v_scales: Optional[torch.Tensor] = None,
    *,
    sm_scale: Optional[float] = None,
    pages_per_block: int = 4,
    layer: Optional[int] = None,
) -> torch.Tensor:
    """Read-only paged decode (JAX ``paged_attention``, the TPU kernel
    ``_paged_kernel``): one query token per sequence over its first
    ``lengths[b]`` pooled tokens, int8 pools dequantized per token (K by
    its scale in the score, V's scale folded into P). K3's decode attend on
    CUDA (counted ``pfa_paged_attention``), its plain version on CPU; q is
    computed in fp32 and the result returned in q's dtype; zeros for a row
    of length 0, as the TPU kernel gives. Rank-5 pools need ``layer``.
    ``pages_per_block`` is the TPU kernel's DMA block: it is checked and
    has no counterpart (K3 stages its own pages)."""
    if pages_per_block <= 0:
        raise ValueError(f"pages_per_block must be positive, got {pages_per_block}")
    if q.ndim != 3 or not q.is_floating_point():
        raise ValueError(f"q must be float (B, Hq, D), got {q.dtype} {tuple(q.shape)}")
    k_pages, v_pages, k_scales, v_scales, lyr = _hf_layout(
        k_pages, v_pages, k_scales, v_scales, layer
    )
    o = _k3_attend(q.float().contiguous(), k_pages, v_pages, lengths, page_indices, lyr,
                   k_scales, v_scales, sm_scale, None, "pfa_paged_attention")
    return o.to(q.dtype)


def paged_attention_auto(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    lengths: torch.Tensor,
    page_indices: torch.Tensor,
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
    *,
    sm_scale: Optional[float] = None,
    pages_per_block: int = 4,
    layer: Optional[int] = None,
) -> torch.Tensor:
    """Device-aware dispatch (JAX ``paged_attention_auto``): on CUDA,
    :func:`paged_attention` (K3), which raises for a pool K3 does not take
    (D above 256, or above 128 over an fp32 pool, a group (Hq/Hkv) * D
    above 4096, an int8 pool's page
    not a multiple of 4); on the CPU :func:`paged_attention_xla` on the
    layer's slice, as JAX's non-TPU branch. The choice comes from the
    device alone. As in JAX, the two branches differ on a row of length 0:
    the kernel gives 0, the gather averages the masked keys."""
    if q.device.type != "cpu":
        return paged_attention(
            q, k_pages, v_pages, lengths, page_indices, k_scales, v_scales,
            sm_scale=sm_scale, pages_per_block=pages_per_block, layer=layer,
        )
    if k_pages.ndim == 5:
        if layer is None:
            raise ValueError("rank-5 pools need a layer")
        lyr = int(layer)
        k_pages, v_pages = k_pages[lyr], v_pages[lyr]
        if k_scales is not None:
            k_scales, v_scales = k_scales[lyr], v_scales[lyr]
    return paged_attention_xla(
        q, k_pages, v_pages, lengths, page_indices, k_scales, v_scales, sm_scale=sm_scale,
    )
