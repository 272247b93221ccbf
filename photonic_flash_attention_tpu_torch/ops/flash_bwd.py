"""Flash-attention backward (kernels K4 dK/dV and K5 dQ: bf16 in
``csrc/flash_bwd_sm90.cu``, fp32 and the C entries in ``csrc/flash_bwd.cu``).

Port of ``photonic_flash_attention_tpu/ops/flash_bwd.py``. The JAX module
has two kernel pairs with one contract: the grid pair
(``flash_attention_bwd_pallas``: ``_dkv_kernel``, ``_dq_kernel``) and the
unrolled pair (``flash_attention_bwd_unrolled``: ``_dq_kernel_unrolled``,
``_dkv_kernel_unrolled``); the split exists only because of how Mosaic
schedules a grid step. Here one function, :func:`flash_attention_bwd`,
carries that contract and launches one kernel pair for every shape, and
:func:`bwd_unrolled_supported` becomes the kernels' shape envelope.

Layout is the port's (B, S, H, D) (the JAX functions take (B, H, S, D));
lse and di are (B, Hq, Sq) fp32, lse in natural log. The pair computes the
whole backward function of JAX's ``_flash_core_bwd`` (``ops/flash.py``),
whose XLA parts (``di = rowsum(o * dO)``, the GQA repeat of K/V and the
group sum of dK/dV) live in the kernels here: K/V come with Hkv heads
(query head h reads KV head h // (Hq / Hkv), K1's mapping and
``jnp.repeat``'s order), K5 computes di in its prologue and writes it for
K4, which walks each KV head's group of query heads and returns dk/dv with
Hkv heads, summed over the group in fp32 and rounded once; so K5 launches
first. The grid pair's streams are here too: the sliding ``window`` (lo,
hi) on rel = col - (row + Skv - Sq) (JAX ``_tile_masks``), whose key and
query tile ranges the kernels walk, and attention dropout
(``dropout_rate``, ``dropout_seed``), whose keep mask K4 and K5
regenerate from the position (``ops/dropout.py``): it scales dV's P and
dP by 1 / (1 - rate) where kept, and di = rowsum(o * dO) over the dropped
output (JAX ``_p_and_ds``).

For CUDA tensors :func:`flash_attention_bwd` launches K5 and then K4 (or
raises); for CPU tensors it runs :func:`flash_attention_bwd_plain`, the
blockwise :func:`flash_attention_bwd_masked_plain` (also the whole
backward of the key-stream and relative-bias paths of ``ops/flash.py``,
as the JAX package keeps those in XLA), which takes the same native GQA
(it repeats K/V inside and sums dk/dv over the group in fp32).
:func:`flash_bwd_di` stays as the plain helper of di.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import torch

from . import _build
from ._build import KERNEL_DTYPES
from .dropout import Seed, dropout_scale, keep_scale, keep_threshold, seed_u32
from .reference import Window, repeat_kv, window_keep

Grads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

#: An open side of a window as the kernels take it (|rel| never reaches it).
WINDOW_OPEN = 1 << 30


def kernel_window(window: Optional[Window]) -> Tuple[int, int]:
    """A window (lo, hi) as the kernels' two ints, open sides at
    -/+ ``WINDOW_OPEN``."""
    lo, hi = window if window is not None else (None, None)
    lo = -WINDOW_OPEN if lo is None else max(int(lo), -WINDOW_OPEN)
    hi = WINDOW_OPEN if hi is None else min(int(hi), WINDOW_OPEN)
    return lo, hi


def kernel_dropout(rate: float, seed: Optional[Seed]) -> Tuple[int, int, float]:
    """(seed, keep threshold, 1 / (1 - rate)) as the kernels take them;
    threshold 0 keeps every score."""
    if rate <= 0.0:
        return 0, 0, 1.0
    return seed_u32(seed), keep_threshold(rate), keep_scale(rate)


def validate_dropout(rate: float, seed: Optional[Seed]) -> None:
    """The JAX rules: a rate in (0, 1), and a seed with it."""
    if rate > 0.0:
        if not 0.0 < rate < 1.0:
            raise ValueError(f"dropout_rate must be in (0, 1), got {rate}")
        if seed is None:
            raise ValueError("dropout_rate > 0 requires dropout_seed")


def bwd_unrolled_supported(seq_len: int, head_dim: int) -> bool:
    """True when K4/K5 take this geometry: any length >= 1, a head dim of 1
    to 128 (``_build.head_dim_plan``'s "K4/K5").

    The JAX envelope (S a multiple of the blocks, at most 12 tiles, Q/dO
    resident in VMEM) bounds the TPU's unrolled pair; K4/K5 stream their
    tiles, mask ragged edges and serve every length.
    """
    return seq_len >= 1 and _build.takes_head_dim("K4/K5", head_dim, 2)


def _validate(q, k, v, o, lse, do, causal: bool) -> None:
    if q.ndim != 4 or k.shape != v.shape or o.shape != q.shape or do.shape != q.shape:
        raise ValueError(
            f"expected q/o/do (B,Sq,Hq,D) and k/v (B,Skv,Hkv,D); got q {tuple(q.shape)}, "
            f"k {tuple(k.shape)}, v {tuple(v.shape)}, o {tuple(o.shape)}, "
            f"do {tuple(do.shape)}"
        )
    b, sq, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(
            f"k/v {tuple(k.shape)} must match q {tuple(q.shape)} in batch and head_dim"
        )
    if k.shape[2] < 1 or h % k.shape[2]:
        raise ValueError(
            f"q heads ({h}) must be a multiple of the k/v heads ({k.shape[2]}) for GQA"
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
    """``di = rowsum(o * dO)`` in fp32, (B, H, Sq) contiguous. Only o is
    converted: the product promotes dO to fp32 as it reads it (the same
    values, one fp32 copy fewer)."""
    return (o.float() * do).sum(-1).transpose(1, 2).contiguous()


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
    window: Optional[Window] = None,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[Seed] = None,
) -> Grads:
    """K4/K5's plain version: :func:`flash_attention_bwd_masked_plain`
    without key streams or bias, (dq, dk, dv) in the inputs' dtypes."""
    return flash_attention_bwd_masked_plain(
        q, k, v, o, lse, do, sm_scale=sm_scale, causal=causal, window=window,
        dropout_rate=dropout_rate, dropout_seed=dropout_seed,
    )[:3]


def flash_attention_bwd_masked_plain(
    q: torch.Tensor,  # (B, Sq, Hq, D)
    k: torch.Tensor,  # (B, Skv, Hkv, D); Hq a multiple of Hkv
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,  # (B, H, Sq) natural log
    do: torch.Tensor,
    *,
    sm_scale: float,
    causal: bool,
    kv_lens: Optional[torch.Tensor] = None,
    k_bias: Optional[torch.Tensor] = None,
    window: Optional[Window] = None,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[Seed] = None,
    rel_vec: Optional[torch.Tensor] = None,
    block_kv: int = 512,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor],
           Optional[torch.Tensor]]:
    """The plain backward (JAX ``_flash_bwd``, ``ops/flash.py:717``, with
    the formulas of the Pallas pair's ``_p_and_ds``), one KV block at a
    time in float32, not through autograd:

        P = exp(S*scale + bias - lse)   dV = (P*M)^T dO   dP = (dO V^T) * M
        dS = P * (dP - di)   dK = dS^T Q * scale   dQ = dS K * scale

    P is zero outside the valid keys (causal, window, lengths; masked before
    the exp, so a row with lse = -inf gives P = 0), M the dropout mask's
    multiplier (1 without dropout), di = rowsum(o * dO). GQA: K/V are
    repeated over the group here (query head h reads KV head h // group)
    and dK/dV summed over it in fp32, then rounded once. ``rel_vec``
    (H, Sq+Skv-1) is K1's relative-bias vector (rel = col - (row + Skv -
    Sq) at index col - row + Sq - 1). Returns (dq, dk, dv) in the inputs'
    dtypes, the ``k_bias`` gradient (B, Skv) fp32 (sum of ds over heads and
    query rows) or None, and the ``rel_vec`` gradient (H, Sq+Skv-1) fp32
    (sum of ds over batch and each diagonal; the JAX table gradient is its
    sum over each bucket, the slope gradient its dot with rel) or None."""
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    qf = q.float().transpose(1, 2)
    kf = repeat_kv(k.float(), h // hkv).transpose(1, 2)
    vf = repeat_kv(v.float(), h // hkv).transpose(1, 2)
    dof = do.float().transpose(1, 2)
    di = (o.float().transpose(1, 2) * dof).sum(-1, keepdim=True)
    lse_e = lse.float()[..., None]
    dq = torch.zeros_like(qf)
    dk, dv = torch.empty_like(kf), torch.empty_like(vf)
    dkb = torch.empty(b, skv, device=q.device) if k_bias is not None else None
    dvec = torch.zeros(h, sq + skv - 1, device=q.device) if rel_vec is not None else None
    for c0 in range(0, skv, block_kv):
        c1 = min(c0 + block_kv, skv)
        kb, vb = kf[:, :, c0:c1], vf[:, :, c0:c1]
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kb) * sm_scale
        if rel_vec is not None:
            idx = (torch.arange(c0, c1, device=q.device)[None, :]
                   - torch.arange(sq, device=q.device)[:, None] + sq - 1)
            s = s + rel_vec.float()[:, idx][None]
        if k_bias is not None:
            s = s + k_bias.float()[:, None, None, c0:c1]
        valid = window_keep(sq, skv, causal, window, q.device, c0, c1)
        if kv_lens is not None:
            by_len = (torch.arange(c0, c1, device=q.device) < kv_lens.to(q.device).long()[:, None])
            by_len = by_len[:, None, None, :]
            valid = by_len if valid is None else valid & by_len
        p = torch.exp(s - lse_e)
        if valid is not None:
            p = torch.where(valid, p, 0.0)
        dp = torch.einsum("bhqd,bhkd->bhqk", dof, vb)
        pv = p
        if dropout_rate > 0.0:
            mscale = dropout_scale(dropout_seed, dropout_rate, b, h, sq, skv, q.device, c0, c1)
            pv, dp = p * mscale, dp * mscale
        dv[:, :, c0:c1] = torch.einsum("bhqk,bhqd->bhkd", pv, dof)
        dsb = p * (dp - di)  # gradient of (scores + bias), unscaled
        ds = dsb * sm_scale
        dq += torch.einsum("bhqk,bhkd->bhqd", ds, kb)
        dk[:, :, c0:c1] = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
        if dkb is not None:
            dkb[:, c0:c1] = dsb.sum(dim=(1, 2))
        if dvec is not None:
            dvec.index_add_(1, idx.reshape(-1), dsb.sum(0).reshape(h, -1))
    group_sum = lambda t: t.view(b, hkv, h // hkv, skv, d).sum(2)  # noqa: E731
    back = lambda t, like: t.transpose(1, 2).to(like.dtype)  # noqa: E731
    return back(dq, q), back(group_sum(dk), k), back(group_sum(dv), v), dkb, dvec


def _check_cuda(lse, di, **tensors) -> Tuple[int, bool]:
    """What K4/K5 take, checked; returns the head dim's plan (D_c, copy)
    (``_build.head_dim_plan``: head dims up to 128)."""
    q = tensors["q"]
    d = q.shape[-1]
    plan = _build.head_dim_plan(d, q.element_size(), "K4/K5")
    if min(q.shape[1], tensors["k"].shape[1]) < 1:
        raise ValueError(f"K4/K5 take lengths >= 1; got Sq {q.shape[1]}, "
                         f"Skv {tensors['k'].shape[1]}")
    if q.dtype not in KERNEL_DTYPES or any(t.dtype != q.dtype for t in tensors.values()):
        raise ValueError(
            f"K4/K5 take {', '.join(tensors)} all of one dtype in {KERNEL_DTYPES}; got "
            f"{', '.join(str(t.dtype) for t in tensors.values())}"
        )
    if lse.dtype != torch.float32 or (di is not None and di.dtype != torch.float32):
        raise ValueError("lse and di must be float32")
    for name, t in (*tensors.items(), ("lse", lse), ("di", di)):
        if t is None:
            continue
        if t.device.type != "cuda":
            raise ValueError(f"K4/K5 run on CUDA tensors; {name} is on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"K4/K5 need contiguous inputs; {name} is not")
        if t.dtype == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError(
                f"K4/K5 need 16-byte-aligned bf16 inputs (TMA); {name} starts at {t.data_ptr():#x}"
            )
    return plan


def _padded(plan: Tuple[int, bool], *tensors):
    """The tensors padded into D_c-wide copies where the plan asks for one."""
    dc, copy = plan
    return tuple(_build.pad_head(t, dc) if copy else t for t in tensors)


def _mode(name: str, window: Optional[Window], dropout_rate: float) -> str:
    """The launch counter of a K4/K5 launch: its dropout or window mode."""
    if dropout_rate > 0.0:
        return f"{name}_dropout"
    return f"{name}_window" if window is not None else name


def _streams(window, dropout_rate, dropout_seed) -> tuple:
    """The five window and dropout arguments of the C entries."""
    return (*kernel_window(window), *kernel_dropout(dropout_rate, dropout_seed))


#: Keys of a K4 work tile (two consumer warpgroups of 64) and queries of
#: its ring tile (``csrc/flash_bwd_sm90.cu``: ``BLOCK``, ``DkvCfg::BQ``).
K4_BLOCK, K4_QUERY_TILE = 128, 64
#: The head dims at which K4 cuts a group into slices: its compiled widths.
K4_SLICE_HEAD_DIMS = (64, 128)


def k4_query_tiles(sq: int, skv: int, causal: bool, window: Optional[Window] = None) -> List[int]:
    """The query tiles each 128-key block of K4 walks for one head: the
    ring tiles from which its keys are seen (``common.cuh``'s
    ``band_q_begin``/``band_q_end``, the first floored to a tile)."""
    lo, hi = kernel_window(window)
    hi = 0 if causal and hi > 0 else hi
    off, bq = skv - sq, K4_QUERY_TILE
    tiles = []
    for kv0 in range(0, skv, K4_BLOCK):
        first = kv0 - off - hi
        begin = 0 if first <= 0 else first // bq * bq
        end = min(max(kv0 + K4_BLOCK - off - lo, 0), sq)
        tiles.append(-(-(end - begin) // bq) if end > begin else 0)
    return tiles


@functools.lru_cache(maxsize=256)
def k4_slices(b: int, sq: int, skv: int, hq: int, hkv: int, causal: bool,
              window: Optional[Window] = None, sms: int = 132) -> int:
    """The slices K4 cuts each KV head's group of ``hq // hkv`` query heads
    into: the fewest (a divisor of the group, at least two heads a slice)
    whose longest work tile, its heads times its key block's query tiles,
    is no longer than the mean work of an SM on the persistent grid of
    ``sms``. One slice a group gives B x Hkv x key blocks work tiles, too
    few to balance at Llama's B1 Hkv8 S2048 causal (128 tiles, the first
    walking 8 x 32 query tiles against a mean of 132 an SM: 2 slices of 4
    heads). Each slice more writes and reads its fp32 dK/dV partials once,
    and a slice of one head pays that for too little work (``chip_smoke.py``'s
    ``K4 slices`` table, PERF.md). MHA and groups of 2: 1."""
    group = hq // hkv
    cuts = [n for n in range(1, group + 1) if group % n == 0 and (n == 1 or group // n >= 2)]
    tiles = k4_query_tiles(sq, skv, causal, window)
    per_sm = b * hq * sum(tiles) / sms
    for slices in cuts:
        if group // slices * max(tiles, default=0) <= per_sm:
            return slices
    return cuts[-1]


def flash_bwd_dq(q, k, v, o, lse, do, *, sm_scale: float, causal: bool,
                 window: Optional[Window] = None, dropout_rate: float = 0.0,
                 dropout_seed: Optional[Seed] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K5 on CUDA tensors: (dq in q's dtype, di (B, Hq, Sq) fp32),
    di = rowsum(o * dO) computed in the kernel's prologue for K4. q, o, do
    (B, Sq, Hq, D), k, v (B, Skv, Hkv, D). A head dim whose rows are not
    whole 16-byte units (bf16 d % 8 != 0) runs on D_c-wide padded copies.
    Counted as ``pfa_flash_bwd_dq``, ``_window`` or ``_dropout``."""
    plan = _check_cuda(lse, None, q=q, k=k, v=v, o=o, do=do)
    d = q.shape[-1]
    q, k, v, o, do = _padded(plan, q, k, v, o, do)
    b, sq, hq, d_run = q.shape
    dq = torch.empty_like(q)
    di = torch.empty(b, hq, sq, dtype=torch.float32, device=q.device)
    _build.launch(
        "pfa_flash_bwd_dq", q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
        dq.data_ptr(), di.data_ptr(),
        b, sq, k.shape[1], hq, k.shape[2], d_run, float(sm_scale), int(causal),
        *_streams(window, dropout_rate, dropout_seed), _build.DTYPE_CODES[q.dtype],
        count_as=_mode("pfa_flash_bwd_dq", window, dropout_rate),
    )
    return _build.cut_head(dq, d), di


def flash_bwd_dkv(q, k, v, do, lse, di, *, sm_scale: float, causal: bool,
                  window: Optional[Window] = None, dropout_rate: float = 0.0,
                  dropout_seed: Optional[Seed] = None, slices: Optional[int] = None):
    """Launch K4 on CUDA tensors: (dk, dv) (B, Skv, Hkv, D) in k's dtype,
    summed over each GQA group in fp32 and rounded once. di from K5
    (:func:`flash_bwd_dq`). ``slices`` (bf16 at head dims 64 and 128; a
    divisor of the group, by default :func:`k4_slices`) cuts each group's
    query heads; with more than one, the slices' fp32 partials go through a
    workspace and the last to arrive sums them in slice order. fp32 and
    other head dims take one slice. A head dim whose rows are not whole
    16-byte units runs on padded copies, as in :func:`flash_bwd_dq`.
    Counted as ``pfa_flash_bwd_dkv``, ``_window`` or ``_dropout``."""
    plan = _check_cuda(lse, di, q=q, k=k, v=v, do=do)
    d = q.shape[-1]
    q, k, v, do = _padded(plan, q, k, v, do)
    b, sq, hq, _ = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if slices is None and q.dtype == torch.bfloat16 and q.shape[-1] in K4_SLICE_HEAD_DIMS:
        sms = torch.cuda.get_device_properties(q.device).multi_processor_count
        slices = k4_slices(b, sq, skv, hq, hkv, causal, window, sms)
    slices = slices or 1
    if slices > 1 and q.shape[-1] not in K4_SLICE_HEAD_DIMS:
        raise ValueError(f"K4 cuts a group into slices at head dims {K4_SLICE_HEAD_DIMS} only "
                         f"(its combine stores whole rows); head dim {d} takes one slice")
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    ws = counters = None
    if slices > 1:
        blocks = b * hkv * -(-skv // K4_BLOCK)  # (b, KV head, key block)
        ws = torch.empty(2 * slices * blocks * K4_BLOCK * plan[0], dtype=torch.float32,
                         device=q.device)
        counters = _build.arrival_counters("K4", q.device, blocks)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    _build.launch(
        "pfa_flash_bwd_dkv", q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        di.data_ptr(), dk.data_ptr(), dv.data_ptr(), ptr(ws), ptr(counters),
        b, sq, skv, hq, hkv, q.shape[-1], int(slices), float(sm_scale), int(causal),
        *_streams(window, dropout_rate, dropout_seed), _build.DTYPE_CODES[q.dtype],
        count_as=_mode("pfa_flash_bwd_dkv", window, dropout_rate),
    )
    return _build.cut_head(dk, d), _build.cut_head(dv, d)


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
    window: Optional[Window] = None,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[Seed] = None,
) -> Grads:
    """Flash-attention backward: (dq, dk, dv) in the inputs' dtypes.

    q, o, do (B, Sq, Hq, D); k, v (B, Skv, Hkv, D) with Hq a multiple of
    Hkv (query head h reads KV head h // (Hq / Hkv)); dk, dv come out
    (B, Skv, Hkv, D), summed over the group in fp32 and rounded once. lse
    (B, Hq, Sq) fp32 natural log, as ``flash_attention_with_lse`` returns
    it. ``window`` (lo, hi) and ``dropout_rate``/``dropout_seed`` must be
    the forward's. On CUDA: K5 (dq and di), then K4 (dk, dv), one launch
    each and nothing else; O(S) memory: probability tiles exist only in
    registers.
    """
    validate_dropout(dropout_rate, dropout_seed)
    _validate(q, k, v, o, lse, do, causal)
    kw = dict(sm_scale=sm_scale, causal=causal, window=window, dropout_rate=dropout_rate,
              dropout_seed=dropout_seed)
    if q.device.type == "cuda":
        # K1's o is contiguous already; K5 reads o by rows of 16-byte loads.
        dq, di = flash_bwd_dq(q, k, v, o.contiguous(), lse, do, **kw)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, di, **kw)
        return dq, dk, dv
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    raise ValueError(f"unsupported device {q.device}")
