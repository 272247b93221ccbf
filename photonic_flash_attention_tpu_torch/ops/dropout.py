"""Positional attention dropout: the keep mask as a hash of the position.

Port of ``photonic_flash_attention_tpu/ops/pallas_utils.py::dropout_keep``
(the rest of that module is Pallas plumbing). A murmur3-style 32-bit
finalizer over ``(row * kv_stride + col) ^ seed ^ (bh * 0x9E3779B1)``; a
score is kept where the hash is at least ``min(int(rate * 2**32),
2**32 - 1)``. The mask depends only on the position, so K1's forward, K4's
transposed backward, K5, the plain versions and the fused path
(``models/attention.py``) regenerate the same mask, and no (Sq, Skv) mask
tensor is ever stored; the kernels' copy is ``csrc/common.cuh::
dropout_keep``. It equals the JAX function bit for bit.

PyTorch has no dependable uint32 arithmetic, so the hash runs in int64 on
values kept in [0, 2**32): every step is masked to 32 bits, and each
product by a 32-bit constant is split into its 16-bit halves so that no
intermediate passes 2**49.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B1
_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35

Seed = Union[int, torch.Tensor]


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 ``x`` in [0, 2**32) and a constant
    ``c`` in [0, 2**32), without passing 2**49."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def seed_u32(seed: Seed) -> int:
    """A dropout seed as the hash takes it: an int (or a one-element
    tensor, read on the host) reduced to 32 bits (two's complement for a
    negative int32, as JAX's ``astype(uint32)``)."""
    return int(seed.reshape(()).item() if isinstance(seed, torch.Tensor) else seed) & _M32


def keep_threshold(rate: float) -> int:
    """The keep threshold of ``rate``: a hash at or above it is kept."""
    return min(int(rate * 4294967296.0), 4294967295)


def keep_scale(rate: float) -> float:
    """The factor a kept probability is multiplied by, 1 / (1 - rate)."""
    return 1.0 / (1.0 - rate)


def dropout_keep(
    seed: Seed,
    rows: torch.Tensor,
    cols: torch.Tensor,
    kv_stride: int,
    rate: float,
    bh: Optional[Union[int, torch.Tensor]] = None,
) -> torch.Tensor:
    """Bool keep mask (True = keep) of the positions ``rows`` x ``cols``
    (integer tensors, broadcastable; global query rows, unaligned, and key
    columns), ``kv_stride`` the true key length, ``bh`` the flattened
    ``b * Hq + h`` (int or broadcastable tensor; None = 0)."""
    device = rows.device if isinstance(rows, torch.Tensor) else None
    r = torch.as_tensor(rows, device=device).long() & _M32
    c = torch.as_tensor(cols, device=device).long() & _M32
    x = ((_mul32(r, kv_stride & _M32) + c) & _M32) ^ seed_u32(seed)
    if bh is not None:
        x = x ^ _mul32(torch.as_tensor(bh, device=device).long() & _M32, _GOLDEN)
    x = _mul32(x, _C1)
    x = x ^ (x >> 13)
    x = _mul32(x, _C2)
    x = x ^ (x >> 16)
    return x >= keep_threshold(rate)


def dropout_keep_grid(
    seed: Seed, rate: float, batch: int, heads: int, sq: int, skv: int, device,
    c0: int = 0, c1: Optional[int] = None,
) -> torch.Tensor:
    """(B, Hq, Sq, c1 - c0) bool keep mask of key columns c0..c1-1 of a
    call: ``bh = b * Hq + h``, the row unaligned, stride Skv, as JAX's
    forward, backward and fused path."""
    c1 = skv if c1 is None else c1
    rows = torch.arange(sq, device=device)[None, None, :, None]
    cols = torch.arange(c0, c1, device=device)[None, None, None, :]
    bh = (torch.arange(batch, device=device)[:, None] * heads
          + torch.arange(heads, device=device)[None, :])[:, :, None, None]
    return dropout_keep(seed, rows, cols, skv, rate, bh=bh)


def dropout_scale(
    seed: Seed, rate: float, batch: int, heads: int, sq: int, skv: int, device,
    c0: int = 0, c1: Optional[int] = None,
) -> torch.Tensor:
    """(B, Hq, Sq, c1 - c0) fp32 P.V multiplier: 1 / (1 - rate) where
    :func:`dropout_keep_grid` keeps, 0 where it drops."""
    keep = dropout_keep_grid(seed, rate, batch, heads, sq, skv, device, c0, c1)
    return torch.where(keep, keep_scale(rate), 0.0).to(torch.float32)


def fold_seed(seed: int, data: int) -> int:
    """A new seed in [0, 2**31) from ``seed`` and ``data`` (a step, a
    microbatch or a layer index): the same finalizer over both, on the
    host. The trainer and the models derive every dropout seed this way
    from one base seed, so a run is reproducible from that seed and a
    recomputed forward (remat) draws the same masks."""
    x = ((seed & _M32) * _GOLDEN + (data & _M32) * 2 + 1) & _M32  # Python ints: exact
    x = ((x ^ (x >> 16)) * _C1) & _M32
    x = ((x ^ (x >> 13)) * _C2) & _M32
    return (x ^ (x >> 16)) & 0x7FFFFFFF
