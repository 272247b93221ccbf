"""Input validation for attention calls and engine configs.

Port of ``photonic_flash_attention_tpu/utils/validation.py``: the same
shape, dtype and cap checks on (B, S, H, D) inputs, the block-size check
of the config's tiling knobs, the finiteness gate, padding to a multiple
and the mask broadcast, raising the same ``ValidationError``.

``check_finite`` reduces on the tensor's own device and reads one bool on
the host (a CUDA tensor syncs there). JAX's traced branch (a
``jax.debug.callback`` warning inside ``jit``) has no counterpart: calls
here are eager.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import get_config
from .exceptions import ValidationError

_ALLOWED_DTYPES = (torch.float32, torch.bfloat16, torch.float16)

#: Alignment of ``block_q``/``block_kv`` (JAX's 128-lane rule, kept for the
#: config's tiling knobs, which carry JAX's values).
_LANE = 128


def validate_attention_inputs(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> None:
    """Validate (B, S, H, D)-shaped attention inputs: ranks, dtypes, matching
    batch, sequence and head dims, GQA divisibility, the configured
    sequence and batch caps, and a rank 2-4 mask."""
    for name, t in (("query", query), ("key", key), ("value", value)):
        if t.ndim != 4:
            raise ValidationError(
                f"{name} must be rank-4 (batch, seq, heads, head_dim), got shape {tuple(t.shape)}"
            )
        if t.dtype not in _ALLOWED_DTYPES:
            raise ValidationError(f"{name} has unsupported dtype {t.dtype}")

    bq, sq, hq, dq = query.shape
    bk, sk, hk, dk = key.shape
    bv, sv, hv, _ = value.shape
    if (bk, sk) != (bv, sv):
        raise ValidationError(f"key/value seq mismatch: {tuple(key.shape)} vs {tuple(value.shape)}")
    if bq != bk:
        raise ValidationError(f"batch mismatch: query {bq} vs key {bk}")
    if dq != dk:
        raise ValidationError(f"head_dim mismatch: query {dq} vs key {dk}")
    if hk != hv:
        raise ValidationError(f"kv head mismatch: key {hk} vs value {hv}")
    if hq % hk != 0:
        raise ValidationError(
            f"num query heads ({hq}) must be a multiple of kv heads ({hk}) for GQA"
        )
    cfg = get_config()
    if sq > cfg.max_sequence_length or sk > cfg.max_sequence_length:
        raise ValidationError(
            f"sequence length {max(sq, sk)} exceeds cap {cfg.max_sequence_length}"
        )
    if bq > cfg.max_batch_size:
        raise ValidationError(f"batch size {bq} exceeds cap {cfg.max_batch_size}")
    if mask is not None and mask.ndim not in (2, 3, 4):
        raise ValidationError(f"mask must be rank 2-4, got shape {tuple(mask.shape)}")


def validate_block_config(block_q: int, block_kv: int, head_dim: int) -> None:
    """Tiling sanity: block sizes positive multiples of 128, a positive
    head dim."""
    for name, v in (("block_q", block_q), ("block_kv", block_kv)):
        if v <= 0 or v % _LANE != 0:
            raise ValidationError(f"{name}={v} must be a positive multiple of {_LANE}")
    if head_dim <= 0:
        raise ValidationError(f"head_dim={head_dim} must be positive")


def validate_quant_mode(mode: str) -> str:
    """``mode`` if it is one of "bf16", "fp8", "int8"; else raise."""
    if mode not in ("bf16", "fp8", "int8"):
        raise ValidationError(f"quant_mode must be bf16|fp8|int8, got {mode!r}")
    return mode


def check_finite(x: torch.Tensor, name: str = "tensor") -> torch.Tensor:
    """``x`` unchanged if every element is finite; else ``ValidationError``.
    The reduction runs on ``x``'s device; one bool comes back."""
    if not bool(torch.isfinite(x.float()).all()):
        raise ValidationError(f"{name} contains NaN/Inf")
    return x


def pad_to_multiple(x: torch.Tensor, multiple: int, axis: int) -> Tuple[torch.Tensor, int]:
    """Zero-pad ``axis`` of ``x`` to a multiple; returns (padded, original_size)."""
    size = x.shape[axis]
    rem = size % multiple
    if rem == 0:
        return x, size
    axis = axis % x.ndim
    widths = [0, 0] * (x.ndim - 1 - axis) + [0, multiple - rem]  # F.pad: last dim first
    return F.pad(x, widths), size


def normalize_mask(
    mask: Optional[torch.Tensor],
    batch: int,
    num_heads: int,
    q_len: int,
    kv_len: int,
) -> Optional[torch.Tensor]:
    """Broadcast a rank-2/3/4 boolean mask to (B, H, Sq, Skv) (a view)."""
    if mask is None:
        return None
    m = mask
    if m.ndim == 2:  # (Sq, Skv)
        m = m[None, None]
    elif m.ndim == 3:  # (B, Sq, Skv)
        m = m[:, None]
    return m.expand(batch, num_heads, q_len, kv_len)
