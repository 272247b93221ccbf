"""Input validation for attention calls.

Port of ``photonic_flash_attention_tpu/utils/validation.py::
validate_attention_inputs`` and ``validate_quant_mode``: the same shape,
dtype and cap checks on (B, S, H, D) inputs, raising the same
``ValidationError``. The JAX module's TPU tiling checks (128-lane block
alignment) have no counterpart.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import get_config
from .exceptions import ValidationError

_ALLOWED_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


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


def validate_quant_mode(mode: str) -> str:
    """``mode`` if it is one of "bf16", "fp8", "int8"; else raise."""
    if mode not in ("bf16", "fp8", "int8"):
        raise ValidationError(f"quant_mode must be bf16|fp8|int8, got {mode!r}")
    return mode
