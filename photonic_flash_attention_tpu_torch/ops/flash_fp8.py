"""Quantized (fp8 / int8) flash attention: the engine's quantized kinds.

Port of ``photonic_flash_attention_tpu/ops/flash_fp8.py``. Every function
is inference only (it raises if a gradient is asked for), takes
(B, S, H, D) tensors with native GQA, and aligns causal to the sequence end.

* :func:`flash_attention_int8qk` / :func:`flash_attention_fp8qk`: Q and K
  quantized per tensor (int8, or e4m3), their scales folded with
  ``sm_scale`` into one fp32 score scale that stays on the device; P.V in
  V's dtype (bf16, or fp32; other dtypes go to bf16); output in that dtype.
  Kernel K1's int8-QK and fp8-QK modes (``csrc/flash_quant_sm90.cu``).
* :func:`flash_attention_int8full`: the same int8 Q.K, and V int8 per
  (batch, kv head, column) with P requantized to int8 after a folded
  ln 127; output in V's dtype if bf16/fp32, else bf16. K1's int8-full mode.
* :func:`flash_attention_quant` (``flash_attention_fp8``,
  ``flash_attention_int8``): Q and K quantized per 128-row block of each
  (batch, head), V per column, P requantized per block; output in q's
  dtype. Kernel K6 (``csrc/flash_quant_sm90.cu``: TMA, 8-bit ``wgmma``).

The quantization passes are plain PyTorch, as they are plain XLA in JAX,
with JAX's rounding: ``torch.round`` rounds half to even like
``jnp.round``; values are clipped to +-qmax before the cast; e4m3 is a
round-to-nearest-even cast. The 128-row scale blocks run along S for each
(batch, head) from row 0; the last may be partial (JAX pads S with zeros
first, which raise no absmax, so its blocks are the same).

The JAX tile sizes (``block_q``) and ``interpret`` have no counterpart.
``block_kv`` is the kv block on which P is requantized: the port's kernels
and plain versions walk 128-key blocks (``ops/flash.py::QUANT_BLOCK_KV``),
so it takes only 128 (JAX's defaults are 512; its tests compare at 128).
CUDA tensors launch the kernels (or raise); CPU tensors run the plain
versions on the same payloads.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import _build
from ._build import KERNEL_DTYPES
from .flash import QUANT_BLOCK_KV, _check_shapes, flash_attention_qk_quant, quant_blocks_plain
from .reference import cdiv, repeat_kv, softmax_scale

__all__ = [
    "flash_attention_block_quant",
    "flash_attention_block_quant_plain",
    "flash_attention_fp8",
    "flash_attention_fp8qk",
    "flash_attention_int8",
    "flash_attention_int8full",
    "flash_attention_int8qk",
    "flash_attention_quant",
]

_SCALE_BLOCK = 128  # row-block size of the Q/K scales

#: qdtype -> (payload dtype, qmax)
_QPARAMS = {
    "fp8": (torch.float8_e4m3fn, 448.0),
    "int8": (torch.int8, 127.0),
}


def _scale_of(absmax: torch.Tensor, qmax: float) -> torch.Tensor:
    """absmax / qmax, 1 where absmax is 0. Divides by a tensor: PyTorch on
    CUDA turns a division by a Python float into a reciprocal multiply."""
    return torch.where(absmax == 0.0, 1.0, absmax / torch.full((), qmax, device=absmax.device))


def _cast(scaled: torch.Tensor, qdtype: torch.dtype, qmax: float) -> torch.Tensor:
    if qdtype == torch.int8:
        return torch.clamp(torch.round(scaled), -qmax, qmax).to(torch.int8)
    return torch.clamp(scaled, -qmax, qmax).to(qdtype)


def _row_block_quantize(x: torch.Tensor, qdtype: torch.dtype, qmax: float):
    """Per-(B, H, 128-row-block) symmetric quantization.

    x (B, S, H, D) -> payload (B, S, H, D) qdtype, scales (B, H, S) fp32
    (repeated within each 128-row block, the JAX layout)."""
    b, s, h, d = x.shape
    nblk = cdiv(s, _SCALE_BLOCK)
    xb = F.pad(x.float(), (0, 0, 0, 0, 0, nblk * _SCALE_BLOCK - s)).view(b, nblk, _SCALE_BLOCK, h, d)
    scale = _scale_of(xb.abs().amax(dim=(2, 4), keepdim=True), qmax)  # (B, nblk, 1, H, 1)
    payload = _cast(xb / scale, qdtype, qmax).view(b, nblk * _SCALE_BLOCK, h, d)[:, :s]
    scales = scale.view(b, nblk, h).transpose(1, 2).repeat_interleave(_SCALE_BLOCK, dim=2)
    return payload.contiguous(), scales[:, :, :s].contiguous()


def _col_quantize(x: torch.Tensor, qdtype: torch.dtype, qmax: float):
    """Per-(B, H, feature-column) quantization for V (commutes with the
    sequence contraction of P.V): payload (B, S, H, D), scales (B, H, D)."""
    xf = x.float()
    scale = _scale_of(xf.abs().amax(dim=1, keepdim=True), qmax)  # (B, 1, H, D)
    return _cast(xf / scale, qdtype, qmax), scale[:, 0].contiguous()


def _per_tensor_quant(x: torch.Tensor, qdtype: torch.dtype, qmax: float):
    """One symmetric scale for the whole tensor: (payload, 0-dim fp32
    scale on x's device)."""
    xf = x.float()
    scale = _scale_of(xf.abs().amax(), qmax)
    return _cast(xf / scale, qdtype, qmax), scale


def _check(q, k, v, causal: bool, block_kv: Optional[int], name: str) -> None:
    """The checks of a public function, before its quantization passes."""
    _check_shapes(q, k, v, causal)
    if block_kv not in (None, QUANT_BLOCK_KV):
        raise ValueError(f"{name} requantizes P on {QUANT_BLOCK_KV}-key blocks; "
                         f"block_kv must be {QUANT_BLOCK_KV} or None, got {block_kv}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(f"{name} is inference only: it has no gradient (as in JAX)")


def _qk_per_tensor(q, k, qdtype: torch.dtype, qmax: float, scale: float):
    """Per-tensor Q/K payloads and the (1,) fp32 score scale (qs * ks) *
    sm_scale, in that order as in JAX, on the device."""
    q8, qs = _per_tensor_quant(q, qdtype, qmax)
    k8, ks = _per_tensor_quant(k, qdtype, qmax)
    return q8, k8, ((qs * ks) * scale).reshape(1).float()


def flash_attention_int8qk(q, k, v, *, causal: bool = False, sm_scale: Optional[float] = None,
                           block_kv: Optional[int] = None) -> torch.Tensor:
    """INT8-QK flash attention: per-tensor int8 Q/K, P.V in V's dtype
    (bf16 or fp32; other dtypes in bf16), output in that dtype. On the card
    V must be bf16 or a dtype that goes to bf16 (the engine offers the kind
    so)."""
    _check(q, k, v, causal, block_kv, "flash_attention_int8qk")
    vt = v if v.dtype in KERNEL_DTYPES else v.to(torch.bfloat16)
    q8, k8, sc = _qk_per_tensor(q, k, torch.int8, 127.0, softmax_scale(q.shape[-1], sm_scale))
    return flash_attention_qk_quant(q8, k8, vt, sc, causal=causal, out_dtype=vt.dtype)


def flash_attention_fp8qk(q, k, v, *, causal: bool = False, sm_scale: Optional[float] = None,
                          block_kv: Optional[int] = None) -> torch.Tensor:
    """FP8-QK flash attention: :func:`flash_attention_int8qk` with e4m3
    Q/K payloads (qmax 448); e4m3 Q.K runs natively on the H100."""
    _check(q, k, v, causal, block_kv, "flash_attention_fp8qk")
    vt = v if v.dtype in KERNEL_DTYPES else v.to(torch.bfloat16)
    q8, k8, sc = _qk_per_tensor(q, k, torch.float8_e4m3fn, 448.0,
                                softmax_scale(q.shape[-1], sm_scale))
    return flash_attention_qk_quant(q8, k8, vt, sc, causal=causal, out_dtype=vt.dtype)


def flash_attention_int8full(q, k, v, *, causal: bool = False, sm_scale: Optional[float] = None,
                             block_kv: Optional[int] = None) -> torch.Tensor:
    """Fully-int8 flash attention: per-tensor int8 Q/K, int8 V with
    per-(B, Hkv, column) scales, P requantized to int8 with the static
    scale 127 folded into the exp. Output in V's dtype if bf16/fp32, else
    bf16."""
    _check(q, k, v, causal, block_kv, "flash_attention_int8full")
    out_dtype = v.dtype if v.dtype in KERNEL_DTYPES else torch.bfloat16
    q8, k8, sc = _qk_per_tensor(q, k, torch.int8, 127.0, softmax_scale(q.shape[-1], sm_scale))
    v8, vs = _col_quantize(v, torch.int8, 127.0)
    return flash_attention_qk_quant(q8, k8, v8, sc, causal=causal, v_scales=vs, out_dtype=out_dtype)


def _check_block_quant(q8, k8, v8, qs, ks, vs, qdtype: str, causal: bool) -> None:
    _check_shapes(q8, k8, v8, causal)
    if qdtype not in _QPARAMS:
        raise ValueError(f"qdtype must be one of {sorted(_QPARAMS)}, got {qdtype!r}")
    want = _QPARAMS[qdtype][0]
    if not (q8.dtype == k8.dtype == v8.dtype == want):
        raise ValueError(f"{qdtype} payloads must be {want}, got {q8.dtype}, {k8.dtype}, {v8.dtype}")
    b, sq, hq, d = q8.shape
    skv, hkv = k8.shape[1], k8.shape[2]
    for name, t, shape in (("qs", qs, (b, hq, sq)), ("ks", ks, (b, hkv, skv)), ("vs", vs, (b, hkv, d))):
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{name} must be fp32 {shape}, got {t.dtype} {tuple(t.shape)}")


def flash_attention_block_quant_plain(q8, k8, v8, qs, ks, vs, *, qdtype: str, causal: bool = False,
                                      sm_scale: float, out_dtype: torch.dtype) -> torch.Tensor:
    """K6's plain version (JAX ``_flash_quant_kernel`` at ``block_kv`` 128):
    s = s_raw * (qs * sm_scale) * ks; P requantized per 128-key block
    (int8 round(p * 127), fp8 (p * 448) to e4m3); each block's P.V scaled
    by vs / qmax; o = acc * (1 / l). Payloads (B, S, H, D), scales qs
    (B, Hq, Sq), ks (B, Hkv, Skv), vs (B, Hkv, D)."""
    _check_block_quant(q8, k8, v8, qs, ks, vs, qdtype, causal)
    qt_dtype, qmax = _QPARAMS[qdtype]
    group = q8.shape[2] // k8.shape[2]
    qf = q8.float().transpose(1, 2)
    kf = repeat_kv(k8.float(), group).transpose(1, 2)
    vf = repeat_kv(v8.float(), group).transpose(1, 2)
    row_scale = (qs.float() * sm_scale)[..., None]  # (B, Hq, Sq, 1)
    ksg = ks.float().repeat_interleave(group, dim=1)  # (B, Hq, Skv)
    vq = vs.float().repeat_interleave(group, dim=1)[:, :, None, :] / torch.full(
        (), qmax, device=vs.device)

    def score(s_raw, c0, c1):
        return s_raw * row_scale * ksg[:, :, None, c0:c1]

    if qt_dtype == torch.int8:
        requant = lambda p: torch.round(p * qmax)  # noqa: E731
    else:
        requant = lambda p: (p * qmax).to(qt_dtype).float()  # noqa: E731
    out = quant_blocks_plain(qf, kf, vf, causal=causal, score=score, requant=requant, pv_scale=vq)
    return out.transpose(1, 2).to(out_dtype)


def flash_attention_block_quant(q8, k8, v8, qs, ks, vs, *, qdtype: str, causal: bool = False,
                                sm_scale: float, out_dtype: torch.dtype) -> torch.Tensor:
    """Kernel K6 on block-quantized payloads (see the plain version for the
    arithmetic); counted as ``pfa_flash_quant_fp8`` or ``pfa_flash_quant_int8``.
    The kernel writes bf16 or fp32; another ``out_dtype`` is cast from fp32,
    as the JAX kernel casts its fp32 result."""
    if q8.device.type == "cpu":
        return flash_attention_block_quant_plain(q8, k8, v8, qs, ks, vs, qdtype=qdtype,
                                                 causal=causal, sm_scale=sm_scale,
                                                 out_dtype=out_dtype)
    if q8.device.type != "cuda":
        raise ValueError(f"unsupported device {q8.device}")
    _check_block_quant(q8, k8, v8, qs, ks, vs, qdtype, causal)
    b, sq, hq, d = q8.shape
    skv, hkv = k8.shape[1], k8.shape[2]
    # A head dim up to 128; 8-bit rows not of whole 16-byte units (d % 16
    # != 0) run on D_c-wide padded copies of the payloads and of vs.
    dc, copy = _build.head_dim_plan(d, 1, "K6")
    for name, t in (("q", q8), ("k", k8), ("v", v8), ("qs", qs), ("ks", ks), ("vs", vs)):
        if t.device != q8.device or not t.is_contiguous():
            raise ValueError(f"K6 needs contiguous inputs on {q8.device}; {name} is not")
        if name in ("q", "k", "v") and t.data_ptr() % 16:
            raise ValueError(f"K6 needs 16-byte-aligned q, k, v (TMA); {name} starts at "
                             f"{t.data_ptr():#x}")
    if copy:
        q8, k8, v8, vs = (_build.pad_head(t, dc) for t in (q8, k8, v8, vs))
    kernel_dtype = out_dtype if out_dtype in KERNEL_DTYPES else torch.float32
    o = torch.empty(q8.shape, dtype=kernel_dtype, device=q8.device)
    _build.launch(
        "pfa_flash_quant", q8.device,
        q8.data_ptr(), k8.data_ptr(), v8.data_ptr(), qs.data_ptr(), ks.data_ptr(), vs.data_ptr(),
        o.data_ptr(), b, sq, skv, hq, hkv, q8.shape[-1], float(sm_scale), int(causal),
        _build.DTYPE_CODES[q8.dtype], _build.DTYPE_CODES[kernel_dtype],
        count_as=f"pfa_flash_quant_{qdtype}",
    )
    return _build.cut_head(o, d).to(out_dtype)


def flash_attention_quant(q, k, v, *, qdtype: str = "fp8", causal: bool = False,
                          sm_scale: Optional[float] = None,
                          block_kv: Optional[int] = None) -> torch.Tensor:
    """Quantized flash attention (inference only): Q/K per 128-row-block
    scales, V per-column scales, P requantized per 128-key block; output in
    q's dtype. ``qdtype`` is "fp8" (e4m3) or "int8"."""
    _check(q, k, v, causal, block_kv, "flash_attention_quant")
    if qdtype not in _QPARAMS:
        raise ValueError(f"qdtype must be one of {sorted(_QPARAMS)}, got {qdtype!r}")
    qt_dtype, qmax = _QPARAMS[qdtype]
    q8, qs = _row_block_quantize(q, qt_dtype, qmax)
    k8, ks = _row_block_quantize(k, qt_dtype, qmax)
    v8, vs = _col_quantize(v, qt_dtype, qmax)
    return flash_attention_block_quant(q8, k8, v8, qs, ks, vs, qdtype=qdtype, causal=causal,
                                       sm_scale=softmax_scale(q.shape[-1], sm_scale),
                                       out_dtype=q.dtype)


def flash_attention_fp8(q, k, v, **kwargs) -> torch.Tensor:
    """FP8 (e4m3) flash attention."""
    return flash_attention_quant(q, k, v, qdtype="fp8", **kwargs)


def flash_attention_int8(q, k, v, **kwargs) -> torch.Tensor:
    """INT8 flash attention."""
    return flash_attention_quant(q, k, v, qdtype="int8", **kwargs)

