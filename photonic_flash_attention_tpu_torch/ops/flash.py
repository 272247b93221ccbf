"""Flash attention, forward (kernel K1, ``csrc/flash_fwd.cu``) and gradient.

Port of the contract of ``photonic_flash_attention_tpu/ops/flash.py::
flash_attention``: causal or not, causal aligned to the sequence end when
Sq != Skv, native GQA (Hq % Hkv == 0), ``sm_scale``, the key-padding
streams ``kv_lens`` (B,) int32 and ``k_bias`` (B, Skv) fp32 (the JAX
kernel's ``lens_ref``/``kbias_ref``), the sliding ``window`` (lo, hi)
on rel = col - (row + Skv - Sq), attention dropout (``dropout_rate``,
``dropout_seed``; the keep mask of ``ops/dropout.py``), and the
structured biases ``rel_bias``/``attn_bias``, with the JAX function's rules
for combining them.

* :func:`flash_attention` is differentiable. Plain, windowed or with
  dropout, its gradient is :class:`_FlashAttentionFn` (JAX
  ``_flash_attention_core`` and ``_flash_attention_core_dropout``): K1
  with its logsumexp output forward, K4/K5 (``ops/flash_bwd.py``) with the
  same window and dropout mask backward. With key streams it is
  :class:`_FlashAttentionMaskedFn` (JAX ``_flash_attention_core_masked``),
  with ``rel_bias`` :class:`_FlashAttentionRelFn` (JAX
  ``_flash_attention_core_rel``): K1 with the streams or the bias forward,
  and ``ops/flash_bwd.py::flash_attention_bwd_masked_plain`` backward, the
  port of the JAX ``_flash_bwd``, which returns dq, dk, dv and the
  gradients of ``k_bias`` and of the relative-bias vector. The JAX package computes that
  backward in XLA, not in Pallas, so plain PyTorch is its faithful port,
  on the card too. Without a gradient to take, K1 writes no lse, as the
  JAX primal path (``save_residuals=False``).
* :func:`flash_attention_with_lse` returns (o, lse), lse (B, Hq, Sq) fp32
  in natural log; rows with no valid key (``kv_lens == 0``) get lse = -inf
  and o = 0.

Masking: keys past ``kv_lens[b]`` (whole tiles of them are skipped), above
the causal diagonal or outside the window drop out (-inf; a row left with
no key gets o = 0 and lse = -inf); ``k_bias`` is added to the scaled
score, which is clamped at ``DEFAULT_MASK_VALUE``. That value is finite, so
a row whose keys are all masked by ``k_bias`` alone averages over them, as
in the JAX kernel. K1 walks only the key tiles the causal mask and the
window leave, so a windowed call costs S * w, not S^2.

Dropout multiplies the P.V operand by 1 / (1 - rate) where the position's
hash keeps it; the softmax sum, and so the lse, keep the undropped sum
(JAX ``ops/flash.py:372-391``).

Structured biases: ``rel_bias`` (:class:`~.rel_bias.T5RelBias` or
:class:`~.rel_bias.ALiBi`) adds a function of ``col - (row + Skv - Sq)``;
K1's relative-bias mode takes it as one fp32 vector per head over every
offset of the call (``rel_bias.bias_vector``), not as the JAX far/band
kernel split; the backward returns that vector's gradient (the sum of the
score gradient over each diagonal) and autograd carries it back through
``bias_vector``'s gather to the T5 table or the ALiBi slopes. ``attn_bias``
(B, 1|Hq, Sq, Skv) fp32 is a dense additive bias (0 = attend,
``DEFAULT_MASK_VALUE`` = ignore, or real values) that K1's dense-bias mode
reads one (64, 64) tile per K/V step; tiles above the causal diagonal read
nothing. Both add the bias to the scaled score and clamp at the mask
value, as the key streams do; their plain versions run the materialised
bias through the same plain oracle. ``attn_bias`` has no backward, as in
JAX: under autograd it raises.

CUDA tensors launch the kernels (or raise); CPU tensors run the plain
versions, forward and backward.

K1's quantized modes (the JAX kernel's ``scale_ref``, ``pv_quant`` and
``vs_ref``) sit behind :func:`flash_attention_qk_quant`, which takes the
8-bit payloads that ``ops/flash_fp8.py`` and ``ops/flash_unrolled.py`` make:
int8 or e4m3 Q/K with one fp32 score scale on the device, and bf16 V, or
int8 V with per-column scales. Its plain version and K6's share
:func:`quant_blocks_plain`, the online softmax over ``QUANT_BLOCK_KV``-key
blocks on which P is requantized.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from ._build import KERNEL_DTYPES, KERNEL_HEAD_DIMS
from .dropout import Seed, dropout_scale, seed_u32
from .flash_bwd import (
    flash_attention_bwd,
    flash_attention_bwd_masked_plain,
    kernel_dropout,
    kernel_window,
)
from .rel_bias import RelBias, T5RelBias, bias_vector, vector_bias
from .reference import (
    DEFAULT_MASK_VALUE,
    Window,
    attention_scores,
    repeat_kv,
    softmax_scale,
    window_keep,
)

__all__ = [
    "KERNEL_DTYPES",
    "KERNEL_HEAD_DIMS",
    "QUANT_BLOCK_KV",
    "flash_attention",
    "flash_attention_bwd_masked_plain",
    "flash_attention_plain",
    "flash_attention_qk_quant",
    "flash_attention_qk_quant_plain",
    "flash_attention_with_lse",
    "flash_attention_with_lse_plain",
    "merge_partial_attention",
    "quant_blocks_plain",
]

Streams = Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool) -> None:
    """q (B, Sq, Hq, D), k/v (B, Skv, Hkv, D), Hq % Hkv == 0, no empty
    sequence, and no causal row without a key."""
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


def _validate(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool,
    kv_lens: Optional[torch.Tensor] = None,
    k_bias: Optional[torch.Tensor] = None,
) -> None:
    _check_shapes(q, k, v, causal)
    b, skv = q.shape[0], k.shape[1]
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"dtype mismatch: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"device mismatch: {q.device}, {k.device}, {v.device}")
    if kv_lens is not None and tuple(kv_lens.shape) != (b,):
        raise ValueError(f"kv_lens must be shape ({b},), got {tuple(kv_lens.shape)}")
    if k_bias is not None and tuple(k_bias.shape) != (b, skv):
        raise ValueError(f"k_bias must be shape ({b}, {skv}), got {tuple(k_bias.shape)}")
    for name, t in (("kv_lens", kv_lens), ("k_bias", k_bias)):
        if t is not None and t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")


def _validate_options(q, k, kv_lens, k_bias, rel_bias, attn_bias, window, dropout_rate,
                      dropout_seed) -> None:
    """The JAX function's rules (``ops/flash.py:1572-1662``), in its order:
    dropout's rate, combinations and seed; the dense bias's combinations
    and shape; the key streams against ``rel_bias`` and ``window``; the
    window against ``rel_bias``; the relative bias's heads."""
    b, sq, hq, _ = q.shape
    skv = k.shape[1]
    if dropout_rate > 0.0:
        if not 0.0 < dropout_rate < 1.0:
            raise ValueError(f"dropout_rate must be in (0, 1), got {dropout_rate}")
        if kv_lens is not None or k_bias is not None or rel_bias is not None or window is not None:
            raise ValueError("dropout_rate cannot be combined with kv_lens/k_bias/rel_bias/window")
        if dropout_seed is None:
            raise ValueError("dropout_rate > 0 requires dropout_seed")
    if attn_bias is not None:
        if (kv_lens is not None or k_bias is not None or rel_bias is not None
                or window is not None or dropout_rate > 0.0):
            raise ValueError("attn_bias cannot be combined with kv_lens/k_bias/rel_bias/window/dropout")
        if (attn_bias.ndim != 4 or attn_bias.shape[0] != b or attn_bias.shape[1] not in (1, hq)
                or tuple(attn_bias.shape[2:]) != (sq, skv)):
            raise ValueError(f"attn_bias must be (B, 1|Hq, Sq, Skv) = ({b}, 1|{hq}, {sq}, {skv}), "
                             f"got {tuple(attn_bias.shape)}")
        if attn_bias.device != q.device:
            raise ValueError(f"attn_bias is on {attn_bias.device}, q on {q.device}")
    if (kv_lens is not None or k_bias is not None) and (rel_bias is not None or window is not None):
        raise ValueError("kv_lens/k_bias cannot be combined with rel_bias or window")
    if window is not None:
        if rel_bias is not None:
            raise ValueError("window cannot be combined with rel_bias")
        if len(window) != 2:
            raise ValueError(f"window must be (lo, hi), got {window!r}")
    if rel_bias is not None and rel_bias.num_heads != hq:
        raise ValueError(f"rel_bias heads {rel_bias.num_heads} != q heads {hq}")


def _stream_keep(q, k, causal: bool, kv_lens, window: Optional[Window] = None
                 ) -> Optional[torch.Tensor]:
    """Structural key validity, broadcastable to (B, Hq, Sq, Skv): the
    causal diagonal, the window and ``kv_lens``; None when every key is
    valid."""
    keep = window_keep(q.shape[1], k.shape[1], causal, window, q.device)
    keep = keep[None, None] if keep is not None else None
    if kv_lens is not None:
        pos = torch.arange(k.shape[1], device=q.device)
        by_len = (pos[None] < kv_lens.to(q.device).long()[:, None])[:, None, None, :]
        keep = by_len if keep is None else keep & by_len
    return keep


def _rel_vector(rel_bias: RelBias, sq: int, skv: int) -> torch.Tensor:
    """K1's (Hq, Sq+Skv-1) fp32 bias vector over rel = -(Skv-1) .. Sq-1,
    differentiable in the table or the slopes."""
    return bias_vector(rel_bias, -(skv - 1), sq + skv - 1).float()


def _rel_counter(rel_bias: RelBias) -> str:
    return "pfa_flash_fwd_relbias" if isinstance(rel_bias, T5RelBias) else "pfa_flash_fwd_alibi"


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    kv_lens: Optional[torch.Tensor] = None,
    k_bias: Optional[torch.Tensor] = None,
    rel_bias: Optional[RelBias] = None,
    attn_bias: Optional[torch.Tensor] = None,
    window: Optional[Window] = None,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[Seed] = None,
) -> torch.Tensor:
    """K1's plain version: float32 attention on any device, output in q's
    dtype; a structured bias is materialised."""
    bias = attn_bias.float() if attn_bias is not None else None
    if rel_bias is not None:
        bias = vector_bias(_rel_vector(rel_bias, q.shape[1], k.shape[1]), q.shape[1], k.shape[1])
    return flash_attention_with_lse_plain(
        q, k, v, causal=causal, sm_scale=sm_scale, kv_lens=kv_lens, k_bias=k_bias, bias=bias,
        window=window, dropout_rate=dropout_rate, dropout_seed=dropout_seed,
    )[0]


def flash_attention_with_lse_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    kv_lens: Optional[torch.Tensor] = None,
    k_bias: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    window: Optional[Window] = None,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[Seed] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1-with-lse's plain version in float32: (o in q's dtype, lse
    (B, Hq, Sq) fp32, natural log; -inf and o = 0 for a row with no key).
    The kernel's arithmetic: scores plus ``k_bias`` and the dense ``bias``
    (broadcastable to (B, Hq, Sq, Skv)) clamped at the mask value,
    structurally invalid keys (causal, window, lengths) at -inf, softmax
    from the row max; with dropout the P.V operand is p * keep / (1 -
    rate) and the lse keeps the undropped sum."""
    s = attention_scores(q, k, sm_scale=sm_scale)
    if k_bias is not None:
        s = torch.clamp_min(s + k_bias.float()[:, None, None, :], DEFAULT_MASK_VALUE)
    if bias is not None:
        s = torch.clamp_min(s + bias.float(), DEFAULT_MASK_VALUE)
    keep = _stream_keep(q, k, causal, kv_lens, window)
    if keep is not None:
        s = s.masked_fill(~keep, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - torch.where(torch.isinf(m), 0.0, m))
    l = e.sum(dim=-1, keepdim=True)
    p = e / torch.where(l == 0.0, torch.ones_like(l), l)
    lse = torch.where(l > 0.0, m + torch.log(l), float("-inf"))[..., 0]
    if dropout_rate > 0.0:
        b, sq, hq, _ = q.shape
        p = p * dropout_scale(dropout_seed, dropout_rate, b, hq, sq, k.shape[1], q.device)
    vf = repeat_kv(v, q.shape[2] // v.shape[2]).float()
    o = torch.einsum("bhqk,bkhd->bqhd", p, vf)
    return o.to(q.dtype), lse


def _stream_args(q: torch.Tensor, kv_lens, k_bias) -> Streams:
    """The streams as the kernel takes them: int32 and fp32, contiguous."""
    lens = kv_lens.to(device=q.device, dtype=torch.int32).contiguous() if kv_lens is not None else None
    bias = k_bias.to(device=q.device, dtype=torch.float32).contiguous() if k_bias is not None else None
    return lens, bias


def _check_k1(q, k, v) -> None:
    """What K1 takes: head dim, dtype, contiguous inputs; in bf16 on
    16-byte-aligned bases (its TMA loads)."""
    d = q.shape[-1]
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"K1 supports head_dim in {KERNEL_HEAD_DIMS}, got {d}")
    if q.dtype not in KERNEL_DTYPES:
        raise ValueError(f"K1 supports {KERNEL_DTYPES}, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"K1 needs contiguous inputs; {name} is not")
        if q.dtype == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError(f"K1 needs 16-byte-aligned inputs; {name} starts at {t.data_ptr():#x}")


def _flash_fwd_cuda(q, k, v, causal: bool, scale: float, save_lse: bool, kv_lens=None, k_bias=None,
                    window: Optional[Window] = None, dropout_rate: float = 0.0,
                    dropout_seed: Optional[Seed] = None):
    """Launch K1: (o, lse or None). Counted as ``pfa_flash_fwd``, or as
    ``pfa_flash_fwd_streams`` when a key-padding stream is given,
    ``pfa_flash_fwd_window`` with a window, ``pfa_flash_fwd_dropout`` with
    dropout."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    _check_k1(q, k, v)
    lens, bias = _stream_args(q, kv_lens, k_bias)
    if q.dtype == torch.bfloat16 and lens is None and bias is None and not scale > 0.0:
        # The bf16 kernel keeps the running max on the raw scores and
        # scales inside the exponent (csrc/flash_fwd_sm90.cu).
        raise ValueError(f"K1's bf16 kernel takes sm_scale > 0 without a bias, got {scale}")
    if dropout_rate > 0.0:
        count = "pfa_flash_fwd_dropout"
    elif window is not None:
        count = "pfa_flash_fwd_window"
    else:
        count = "pfa_flash_fwd_streams" if lens is not None or bias is not None else None
    o = torch.empty_like(q)
    lse = torch.empty(b, hq, sq, device=q.device, dtype=torch.float32) if save_lse else None
    _build.launch(
        "pfa_flash_fwd", q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr() if save_lse else None,
        lens.data_ptr() if lens is not None else None,
        bias.data_ptr() if bias is not None else None,
        b, sq, skv, hq, hkv, d, float(scale), int(causal),
        *kernel_window(window), *kernel_dropout(dropout_rate, dropout_seed),
        _build.DTYPE_CODES[q.dtype],
        count_as=count,
    )
    return o, lse


def _flash_fwd_bias_cuda(q, k, v, causal: bool, scale: float, count: str, *, vec=None, dense=None,
                         save_lse: bool = False):
    """Launch K1's relative-bias mode (``vec``, the (Hq, Sq+Skv-1) vector of
    :func:`_rel_vector`) or its dense-bias mode (``dense`` (B, 1|Hq, Sq,
    Skv)): (o, lse or None), counted as ``count`` (``pfa_flash_fwd_relbias``
    (T5), ``pfa_flash_fwd_alibi`` or ``pfa_flash_fwd_densebias``), with
    ``_lse`` appended when it writes the lse."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    _check_k1(q, k, v)
    if vec is not None:
        vec = vec.detach().to(device=q.device, dtype=torch.float32).contiguous()
    if dense is not None:
        dense = dense.to(dtype=torch.float32).contiguous()
    o = torch.empty_like(q)
    lse = torch.empty(b, hq, sq, device=q.device, dtype=torch.float32) if save_lse else None
    _build.launch(
        "pfa_flash_fwd_bias", q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr() if save_lse else None,
        vec.data_ptr() if vec is not None else None,
        dense.data_ptr() if dense is not None else None,
        b, sq, skv, hq, hkv, d, dense.shape[1] if dense is not None else 0, float(scale),
        int(causal), _build.DTYPE_CODES[q.dtype],
        count_as=f"{count}_lse" if save_lse else count,
    )
    return o, lse


def _on_device(q, cuda, cpu):
    """``cuda()`` for CUDA tensors, ``cpu()`` for CPU tensors."""
    if q.device.type == "cuda":
        return cuda()
    if q.device.type == "cpu":
        return cpu()
    raise ValueError(f"unsupported device {q.device}")


def _fwd_with_lse(q, k, v, causal: bool, scale: float, kv_lens=None, k_bias=None, window=None,
                  dropout_rate: float = 0.0, dropout_seed=None):
    kw = dict(kv_lens=kv_lens, k_bias=k_bias, window=window, dropout_rate=dropout_rate,
              dropout_seed=dropout_seed)
    return _on_device(
        q,
        lambda: _flash_fwd_cuda(q, k, v, causal, scale, True, **kw),
        lambda: flash_attention_with_lse_plain(q, k, v, causal=causal, sm_scale=scale, **kw),
    )


def _group_sum(t: torch.Tensor, hkv: int, dtype: torch.dtype) -> torch.Tensor:
    """(B, S, Hq, D) per-q-head gradient -> (B, S, Hkv, D), summed over the
    GQA group."""
    b, s, hq, d = t.shape
    if hq == hkv:
        return t.to(dtype)
    return t.float().view(b, s, hkv, hq // hkv, d).sum(3).to(dtype)


class _FlashAttentionFn(torch.autograd.Function):
    """Custom gradient of flash attention (JAX ``_flash_attention_core``
    and ``_flash_attention_core_dropout``): the forward saves (q, k, v, o,
    lse); the backward repeats K/V over the GQA group (``repeat_interleave``
    on the head axis, JAX's ``jnp.repeat``, matching K1's ``h / (Hq/Hkv)``),
    runs K4/K5 with the forward's window and dropout mask and sums dk/dv
    over the group (``_flash_core_bwd``, ``ops/flash.py:1152``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float, window, dropout_rate: float, dropout_seed):
        o, lse = _fwd_with_lse(q, k, v, causal, scale, window=window, dropout_rate=dropout_rate,
                               dropout_seed=dropout_seed)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.window, ctx.dropout = window, (dropout_rate, dropout_seed)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        hkv = k.shape[2]
        group = q.shape[2] // hkv
        dq, dk, dv = flash_attention_bwd(
            q, repeat_kv(k, group), repeat_kv(v, group), o, lse, do.contiguous(),
            sm_scale=ctx.scale, causal=ctx.causal, window=ctx.window,
            dropout_rate=ctx.dropout[0], dropout_seed=ctx.dropout[1],
        )
        return (dq, _group_sum(dk, hkv, k.dtype), _group_sum(dv, hkv, v.dtype),
                None, None, None, None, None)


class _FlashAttentionMaskedFn(torch.autograd.Function):
    """Custom gradient of key-padded flash attention (JAX
    ``_flash_attention_core_masked``, ``ops/flash.py:1247-1323``): K1 with
    the streams forward, saving lse; the plain blockwise backward with the
    GQA repeat and group sum. ``kv_lens`` takes no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, kv_lens, k_bias, causal: bool, scale: float):
        o, lse = _fwd_with_lse(q, k, v, causal, scale, kv_lens, k_bias)
        ctx.save_for_backward(q, k, v, o, lse, kv_lens, k_bias)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, kv_lens, k_bias = ctx.saved_tensors
        hkv = k.shape[2]
        group = q.shape[2] // hkv
        dq, dk, dv, dkb, _ = flash_attention_bwd_masked_plain(
            q, repeat_kv(k, group), repeat_kv(v, group), o, lse, do,
            sm_scale=ctx.scale, causal=ctx.causal, kv_lens=kv_lens, k_bias=k_bias,
        )
        if dkb is not None:
            dkb = dkb.to(k_bias.dtype)
        return (
            dq, _group_sum(dk, hkv, k.dtype), _group_sum(dv, hkv, v.dtype),
            None, dkb, None, None,
        )


class _FlashAttentionRelFn(torch.autograd.Function):
    """Custom gradient of relative-bias flash attention (JAX
    ``_flash_attention_core_rel``, ``ops/flash.py:1421-1494``): K1's
    relative-bias mode with lse forward; the plain blockwise backward
    (JAX's is XLA too) gives dq, dk, dv and the gradient of the bias
    vector ``vec``, which autograd carries to the table or the slopes."""

    @staticmethod
    def forward(ctx, q, k, v, vec, causal: bool, scale: float, count: str):
        sq, skv = q.shape[1], k.shape[1]
        o, lse = _on_device(
            q,
            lambda: _flash_fwd_bias_cuda(q, k, v, causal, scale, count, vec=vec, save_lse=True),
            lambda: flash_attention_with_lse_plain(q, k, v, causal=causal, sm_scale=scale,
                                                   bias=vector_bias(vec, sq, skv)),
        )
        ctx.save_for_backward(q, k, v, o, lse, vec)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, vec = ctx.saved_tensors
        hkv = k.shape[2]
        group = q.shape[2] // hkv
        dq, dk, dv, _, dvec = flash_attention_bwd_masked_plain(
            q, repeat_kv(k, group), repeat_kv(v, group), o, lse, do,
            sm_scale=ctx.scale, causal=ctx.causal, rel_vec=vec,
        )
        return (dq, _group_sum(dk, hkv, k.dtype), _group_sum(dv, hkv, v.dtype),
                dvec.to(vec.dtype), None, None, None)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    kv_lens: Optional[torch.Tensor] = None,
    k_bias: Optional[torch.Tensor] = None,
    rel_bias: Optional[RelBias] = None,
    attn_bias: Optional[torch.Tensor] = None,
    window: Optional[Window] = None,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[Seed] = None,
) -> torch.Tensor:
    """Attention. q (B, Sq, Hq, D), k/v (B, Skv, Hkv, D) -> (B, Sq, Hq, D)
    in q's dtype, fp32 softmax. fp32 inputs are computed in fp32 on both
    paths (never in bf16). ``kv_lens`` (B,) int32 valid key lengths and
    ``k_bias`` (B, Skv) additive per-key score bias (0 = attend,
    ``DEFAULT_MASK_VALUE`` = ignore) may be combined. ``window`` (lo, hi):
    inclusive bounds on rel = col - (row + Skv - Sq), None = open on that
    side; ``window=(-w + 1, 0)`` with ``causal=True`` is local attention
    over the last w keys. ``dropout_rate`` in (0, 1) with ``dropout_seed``
    (int or one-element tensor): attention-probability dropout with the
    positional mask of ``ops/dropout.py``. ``rel_bias`` (T5 buckets or
    ALiBi, heads = Hq) or ``attn_bias`` (B, 1|Hq, Sq, Skv) fp32 add a
    structured score bias. Combinations follow the JAX function's rules.
    Differentiable in q, k, v, ``k_bias`` and the ``rel_bias`` table or
    slopes; the gradients come back in the inputs' dtypes. ``attn_bias``
    is forward only: with an input that requires grad it raises
    ``NotImplementedError``."""
    _validate(q, k, v, causal, kv_lens, k_bias)
    _validate_options(q, k, kv_lens, k_bias, rel_bias, attn_bias, window, dropout_rate,
                      dropout_seed)
    scale = softmax_scale(q.shape[-1], sm_scale)
    sq, skv = q.shape[1], k.shape[1]
    rate = float(dropout_rate) if dropout_rate > 0.0 else 0.0
    seed = seed_u32(dropout_seed) if rate > 0.0 else None
    table = None
    if rel_bias is not None:
        table = rel_bias.table if isinstance(rel_bias, T5RelBias) else rel_bias.slopes
    grads = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (q, k, v, k_bias, attn_bias, table)
    )
    if attn_bias is not None:
        if grads:
            raise NotImplementedError(
                "flash_attention with attn_bias has no backward (as the JAX function)")
        return _on_device(
            q,
            lambda: _flash_fwd_bias_cuda(q, k, v, causal, scale, "pfa_flash_fwd_densebias",
                                         dense=attn_bias)[0],
            lambda: flash_attention_plain(q, k, v, causal=causal, sm_scale=scale,
                                          attn_bias=attn_bias),
        )
    if rel_bias is not None:
        vec = _rel_vector(rel_bias, sq, skv)
        if grads:
            return _FlashAttentionRelFn.apply(q, k, v, vec, causal, scale, _rel_counter(rel_bias))
        return _on_device(
            q,
            lambda: _flash_fwd_bias_cuda(q, k, v, causal, scale, _rel_counter(rel_bias), vec=vec)[0],
            lambda: flash_attention_with_lse_plain(q, k, v, causal=causal, sm_scale=scale,
                                                   bias=vector_bias(vec, sq, skv))[0],
        )
    if grads and (kv_lens is not None or k_bias is not None):
        return _FlashAttentionMaskedFn.apply(q, k, v, kv_lens, k_bias, causal, scale)
    if grads:
        return _FlashAttentionFn.apply(q, k, v, causal, scale, window, rate, seed)
    kw = dict(kv_lens=kv_lens, k_bias=k_bias, window=window, dropout_rate=rate, dropout_seed=seed)
    return _on_device(
        q,
        lambda: _flash_fwd_cuda(q, k, v, causal, scale, False, **kw)[0],
        lambda: flash_attention_plain(q, k, v, causal=causal, sm_scale=scale, **kw),
    )


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
    (B, Sq, Hq, D), lse (B, Hq, Sq) fp32, natural log). A row with
    ``kv_lens == 0`` gets o = 0 and lse = -inf: K1 takes the lengths
    natively, so the JAX unrolled path's repair of such rows is built in.
    Forward only."""
    _validate(q, k, v, causal, kv_lens, k_bias)
    return _fwd_with_lse(q, k, v, causal, softmax_scale(q.shape[-1], sm_scale), kv_lens, k_bias)


def merge_partial_attention(o1: torch.Tensor, lse1: torch.Tensor, o2: torch.Tensor,
                            lse2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge two normalized partial-attention results by logsumexp (JAX
    ``merge_partial_attention``, ``ops/flash.py:1041``), in float32. Each
    part is (output (..., D) normalized over its own keys, lse (...)); a
    part that saw no valid key has lse = -inf and a zero output, and is
    absorbed exactly; both -inf give o = 0 and lse = -inf. Plain PyTorch
    on either device: the ring's merge (``parallel/ring.py``) and the
    segmented experiment's."""
    m = torch.maximum(lse1, lse2)
    m_safe = torch.where(torch.isneginf(m), 0.0, m)
    w1 = torch.where(torch.isneginf(lse1), 0.0, torch.exp(lse1 - m_safe))
    w2 = torch.where(torch.isneginf(lse2), 0.0, torch.exp(lse2 - m_safe))
    denom = w1 + w2
    safe = torch.where(denom == 0.0, 1.0, denom)
    o = (o1.float() * w1[..., None] + o2.float() * w2[..., None]) / safe[..., None]
    lse = torch.where(denom == 0.0, float("-inf"), m_safe + torch.log(safe))
    return o, lse


# -- quantized modes of K1 ---------------------------------------------------

#: Keys per block of the quantized kernels (K1's modes, K6). P is
#: requantized against the running max after each block, so the result
#: depends on the block: kernels and plain versions walk the same 128-key
#: blocks, the JAX kernels' smallest ``block_kv``.
QUANT_BLOCK_KV = 128
#: ln(127): int8 P.V folds the static P scale of 127 into the exp (JAX
#: ``ops/flash.py:362``).
LN_127 = 4.8441870864585885
QUANT_PAYLOADS = (torch.int8, torch.float8_e4m3fn)


def quant_blocks_plain(qf, kf, vf, *, causal: bool, score, requant, exp_shift: float = 0.0,
                       pv_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The quantized kernels' online softmax in fp32, one ``QUANT_BLOCK_KV``
    block of keys at a time (the JAX kernels' arithmetic at that block).

    ``qf`` (B, H, Sq, D), ``kf``/``vf`` (B, H, Skv, D): payload values in
    fp32, K/V repeated over the GQA group. ``score(s_raw, c0, c1)``
    dequantizes a block of raw scores; masked keys (above the end-aligned
    causal diagonal) score ``DEFAULT_MASK_VALUE``; p = exp(s - m +
    exp_shift) with m the running max after the block; ``requant(p)`` gives
    the P.V operand values; ``pv_scale`` (broadcastable to (B, H, 1, D))
    scales each block's P.V sum. Returns acc * (1 / l), fp32 (B, H, Sq, D).
    Integer payload products are exact in fp32 (below 2**24)."""
    b, h, sq, d = qf.shape
    skv = kf.shape[2]
    row = torch.arange(sq, device=qf.device)[:, None] + (skv - sq)
    m = torch.full((b, h, sq, 1), float("-inf"), device=qf.device)
    l = torch.zeros((b, h, sq, 1), device=qf.device)
    acc = torch.zeros((b, h, sq, d), device=qf.device)
    for c0 in range(0, skv, QUANT_BLOCK_KV):
        c1 = min(c0 + QUANT_BLOCK_KV, skv)
        s = score(qf @ kf[:, :, c0:c1].transpose(-1, -2), c0, c1)
        if causal:
            col = torch.arange(c0, c1, device=qf.device)
            s = s.masked_fill(col[None, :] > row, DEFAULT_MASK_VALUE)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new + exp_shift)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        pv = requant(p) @ vf[:, :, c0:c1]
        if pv_scale is not None:
            pv = pv * pv_scale
        acc = acc * alpha + pv
        m = m_new
    return acc * torch.where(l == 0.0, 1.0, 1.0 / l)


def _check_qk_quant(q8, k8, v, score_scale, causal, v_scales, out_dtype) -> bool:
    """Validate K1's quantized-mode inputs; True for int8 P.V."""
    _check_shapes(q8, k8, v, causal)
    if q8.dtype not in QUANT_PAYLOADS or k8.dtype != q8.dtype:
        raise ValueError(f"Q/K payloads must both be int8 or float8_e4m3fn, got {q8.dtype}, {k8.dtype}")
    pv_int8 = v.dtype == torch.int8
    if pv_int8 and (v_scales is None or q8.dtype != torch.int8):
        raise ValueError("int8 V (int8 P.V) needs int8 Q/K and v_scales (B, Hkv, D)")
    if not pv_int8 and not v.dtype.is_floating_point:
        raise ValueError(f"V must be int8 or floating point, got {v.dtype}")
    if score_scale.numel() != 1 or score_scale.dtype != torch.float32:
        raise ValueError("score_scale must be one fp32 value")
    if out_dtype not in KERNEL_DTYPES:
        raise ValueError(f"out_dtype must be one of {KERNEL_DTYPES}, got {out_dtype}")
    for t in (k8, v, score_scale, v_scales):
        if t is not None and t.device != q8.device:
            raise ValueError(f"device mismatch: {t.device}, q on {q8.device}")
    return pv_int8


def flash_attention_qk_quant_plain(q8, k8, v, score_scale, *, causal: bool = False,
                                   v_scales: Optional[torch.Tensor] = None,
                                   out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """K1's quantized modes in plain PyTorch: scores = (q8 . k8) *
    score_scale; P.V with P rounded to V's dtype (fp32 V: P unrounded), or,
    for int8 V, P = exp(s - m + ln 127) truncated from p + 0.5 and o scaled
    by ``v_scales`` (B, Hkv, D) per column at the end (JAX ``pv_quant``)."""
    pv_int8 = _check_qk_quant(q8, k8, v, score_scale, causal, v_scales, out_dtype)
    group = q8.shape[2] // k8.shape[2]
    qf = q8.float().transpose(1, 2)
    kf = repeat_kv(k8.float(), group).transpose(1, 2)
    vf = repeat_kv(v.float(), group).transpose(1, 2)
    sc = score_scale.float().reshape(())
    if pv_int8:
        requant = lambda p: torch.clamp(torch.trunc(p + 0.5), max=127.0)  # noqa: E731
    elif v.dtype == torch.float32:
        requant = lambda p: p  # noqa: E731
    else:
        requant = lambda p: p.to(v.dtype).float()  # noqa: E731
    out = quant_blocks_plain(qf, kf, vf, causal=causal, score=lambda s, c0, c1: s * sc,
                             requant=requant, exp_shift=LN_127 if pv_int8 else 0.0)
    if pv_int8:
        out = out * v_scales.float().repeat_interleave(group, dim=1)[:, :, None, :]
    return out.transpose(1, 2).to(out_dtype)


def flash_attention_qk_quant(q8, k8, v, score_scale, *, causal: bool = False,
                             v_scales: Optional[torch.Tensor] = None,
                             out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """K1's quantized modes: (B, Sq, Hq, D) int8/e4m3 Q and (B, Skv, Hkv, D)
    K payloads, ``score_scale`` (1,) fp32 = qs * ks * sm_scale on Q's device
    (never read by the host), V bf16 (or int8 with ``v_scales``). Counted
    as ``pfa_flash_fwd_int8qk``, ``_fp8qk`` or ``_int8full``. On the card V
    must be bf16 or int8; the plain version also takes fp32 V."""
    if q8.device.type == "cpu":
        return flash_attention_qk_quant_plain(q8, k8, v, score_scale, causal=causal,
                                              v_scales=v_scales, out_dtype=out_dtype)
    if q8.device.type != "cuda":
        raise ValueError(f"unsupported device {q8.device}")
    pv_int8 = _check_qk_quant(q8, k8, v, score_scale, causal, v_scales, out_dtype)
    b, sq, hq, d = q8.shape
    skv, hkv = k8.shape[1], k8.shape[2]
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"K1 supports head_dim in {KERNEL_HEAD_DIMS}, got {d}")
    if not pv_int8 and v.dtype != torch.bfloat16:
        raise ValueError(f"K1's quantized modes take bf16 or int8 V on the card, got {v.dtype}")
    for name, t in (("q", q8), ("k", k8), ("v", v), ("score_scale", score_scale), ("v_scales", v_scales)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"K1 needs contiguous inputs; {name} is not")
    for name, t in (("q", q8), ("k", k8), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"K1's quantized modes need 16-byte-aligned q, k, v (TMA); {name} "
                             f"starts at {t.data_ptr():#x}")
    if pv_int8 and (v_scales.dtype != torch.float32 or tuple(v_scales.shape) != (b, hkv, d)):
        raise ValueError(f"v_scales must be fp32 ({b}, {hkv}, {d})")
    mode = "int8full" if pv_int8 else ("int8qk" if q8.dtype == torch.int8 else "fp8qk")
    o = torch.empty(q8.shape, dtype=out_dtype, device=q8.device)
    _build.launch(
        "pfa_flash_fwd_quant", q8.device,
        q8.data_ptr(), k8.data_ptr(), v.data_ptr(), o.data_ptr(), score_scale.data_ptr(),
        v_scales.data_ptr() if pv_int8 else None,
        b, sq, skv, hq, hkv, d, int(causal), _build.DTYPE_CODES[q8.dtype], int(pv_int8),
        _build.DTYPE_CODES[out_dtype],
        count_as=f"pfa_flash_fwd_{mode}",
    )
    return o
