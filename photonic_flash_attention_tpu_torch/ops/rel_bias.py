"""Structured relative-position biases (T5 buckets, ALiBi), in PyTorch.

Port of ``photonic_flash_attention_tpu/ops/rel_bias.py``: the bias specs
(:class:`T5RelBias`, :class:`ALiBi`), T5's log-binned
:func:`relative_position_bucket` and its Python-int twin
:func:`static_bucket`, :func:`alibi_slopes`, :func:`bias_table`,
:func:`rel_statics`, :func:`bias_from_table` and :func:`materialize`
(sequence-end alignment, ``kv_offset = skv - sq``).

Both biases are functions of ``rel = col - row`` only, so the flash kernel
(K1's relative-bias mode, ``csrc/flash_fwd.cu``) takes one fp32 vector per
head over every offset a call can see, built here by :func:`bias_vector`,
instead of the JAX kernel's in-tile bucket math. The bucket boundaries
truncate a float32 logarithm, and the CPU's ``log`` and the card's may
differ by one ulp where the exact value is an integer; so every bucket of
the port comes from :func:`bucket_range`, which runs
:func:`relative_position_bucket` on the CPU (the numbers XLA's CPU ``log``
gives) and caches the result on the device asked for. The kernel's bias,
the plain versions' dense bias and the serving path's decode bias are
gathers of the same buckets.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple, Union

import torch


def relative_position_bucket(
    relative_position: torch.Tensor,
    *,
    bidirectional: bool,
    num_buckets: int,
    max_distance: int,
) -> torch.Tensor:
    """T5's log-binned relative-position bucketing on an integer tensor
    (HF ``_relative_position_bucket``). The logarithm is float32 and the
    divisors are float32 tensors, as in the JAX function, so the truncation
    lands where XLA's does; see :func:`bucket_range` for the device."""
    n = relative_position.to(torch.int32)
    ret = torch.zeros_like(n)
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n > 0).to(torch.int32) * num_buckets
        n = n.abs()
    else:
        n = -torch.clamp(n, max=0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    f32 = dict(dtype=torch.float32, device=n.device)
    ratio = torch.clamp(n, min=1).to(torch.float32) / torch.tensor(float(max_exact), **f32)
    scaled = (
        torch.log(ratio)
        / torch.tensor(math.log(max_distance / max_exact), **f32)
        * torch.tensor(float(num_buckets - max_exact), **f32)
    )
    val_large = torch.clamp(max_exact + scaled.to(torch.int32), max=num_buckets - 1)
    return ret + torch.where(is_small, n, val_large)


def static_bucket(
    relative_position: int,
    *,
    bidirectional: bool,
    num_buckets: int,
    max_distance: int,
) -> int:
    """Python-int twin of :func:`relative_position_bucket`."""
    ret = 0
    n = relative_position
    if bidirectional:
        num_buckets //= 2
        if n > 0:
            ret += num_buckets
        n = abs(n)
    else:
        n = -min(n, 0)
    max_exact = num_buckets // 2
    if n < max_exact:
        return ret + n
    val_large = max_exact + int(
        math.log(max(n, 1) / max_exact)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    )
    return ret + min(val_large, num_buckets - 1)


@functools.lru_cache(maxsize=64)
def _bucket_range(lo: int, n: int, bidirectional: bool, num_buckets: int,
                  max_distance: int, device: torch.device) -> torch.Tensor:
    rel = torch.arange(lo, lo + n, dtype=torch.int32)
    buckets = relative_position_bucket(
        rel, bidirectional=bidirectional, num_buckets=num_buckets, max_distance=max_distance
    )
    return buckets.long().to(device)


def bucket_range(
    lo: int,
    n: int,
    *,
    bidirectional: bool,
    num_buckets: int,
    max_distance: int,
    device="cpu",
) -> torch.Tensor:
    """Buckets (int64, on ``device``) of rel = lo .. lo+n-1: the one place
    the port computes T5 buckets (on the CPU; cached per device, so a
    decode step reuses them without a host copy)."""
    return _bucket_range(int(lo), int(n), bool(bidirectional), int(num_buckets),
                         int(max_distance), torch.device(device))


@dataclasses.dataclass(frozen=True)
class T5RelBias:
    """T5 relative-position bias: ``score += table[bucket(col - row)]``.

    ``table`` (num_buckets, num_heads) is the learned embedding (HF
    ``relative_attention_bias.weight`` layout); ``bidirectional`` True for
    encoder self-attention, False for the decoder; ``max_distance`` the
    log-bucket saturation distance (HF default 128)."""

    table: torch.Tensor
    bidirectional: bool
    max_distance: int = 128

    @property
    def num_buckets(self) -> int:
        return self.table.shape[0]

    @property
    def num_heads(self) -> int:
        return self.table.shape[1]


@dataclasses.dataclass(frozen=True)
class ALiBi:
    """ALiBi bias: ``score += slopes[h] * (col - row)``; ``slopes``
    (num_heads,), conventionally :func:`alibi_slopes`."""

    slopes: torch.Tensor

    @property
    def num_heads(self) -> int:
        return self.slopes.shape[0]


RelBias = Union[T5RelBias, ALiBi]


def alibi_slopes(num_heads: int) -> torch.Tensor:
    """The ALiBi geometric slope schedule: 2^(-8i/n) for i in 1..n,
    extended for non-power-of-two head counts by interleaving the next
    power of two. float32 (num_heads,)."""

    def pow2_slopes(n: int):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start * (start ** i) for i in range(n)]

    if math.log2(num_heads).is_integer():
        vals = pow2_slopes(num_heads)
    else:
        closest = 2 ** math.floor(math.log2(num_heads))
        vals = pow2_slopes(closest)
        extra = pow2_slopes(2 * closest)[0::2]
        vals = vals + extra[: num_heads - closest]
    return torch.tensor(vals, dtype=torch.float32)


def bias_table(spec: RelBias) -> Tuple[str, torch.Tensor]:
    """(kind, (H, W) fp32 table): T5's table transposed to head-major
    (W = num_buckets); ALiBi's slopes as a column (W = 1)."""
    if isinstance(spec, T5RelBias):
        return "t5", spec.table.float().T
    if isinstance(spec, ALiBi):
        return "alibi", spec.slopes.float()[:, None]
    raise TypeError(f"unknown rel-bias spec: {type(spec)!r}")


def rel_statics(spec: RelBias) -> Tuple[str, bool, int, int]:
    """(kind, bidirectional, buckets, max_distance) of a spec."""
    if isinstance(spec, T5RelBias):
        return ("t5", spec.bidirectional, spec.num_buckets, spec.max_distance)
    return ("alibi", False, 1, 0)


def _gather(kind: str, tab_hw: torch.Tensor, lo: int, idx: torch.Tensor, *, bidirectional: bool,
            num_buckets: int, max_distance: int, n: int) -> torch.Tensor:
    """(H, *idx.shape) bias of rel = lo + idx, idx in [0, n)."""
    if kind == "alibi":
        rel = (idx + lo).to(torch.float32)
        return tab_hw[:, 0][(...,) + (None,) * idx.ndim] * rel
    buckets = bucket_range(lo, n, bidirectional=bidirectional, num_buckets=num_buckets,
                           max_distance=max_distance, device=tab_hw.device)
    return tab_hw[:, buckets[idx]]


def bias_from_table(
    kind: str,
    tab_hw: torch.Tensor,  # (H, W) fp32 as produced by bias_table
    rel: torch.Tensor,  # integer, any shape
    *,
    bidirectional: bool,
    num_buckets: int,
    max_distance: int,
) -> torch.Tensor:
    """The bias of every entry of ``rel``: (H, *rel.shape) fp32."""
    rel = rel.to(tab_hw.device).long()
    lo, hi = int(rel.min()), int(rel.max())
    return _gather(kind, tab_hw, lo, rel - lo, bidirectional=bidirectional,
                   num_buckets=num_buckets, max_distance=max_distance, n=hi - lo + 1)


def bias_vector(spec: RelBias, lo: int, n: int) -> torch.Tensor:
    """(H, n) fp32 bias of rel = lo .. lo+n-1 on the spec's device. K1's
    relative-bias mode takes lo = -(Skv-1), n = Sq+Skv-1: every offset
    ``col - (row + Skv - Sq)`` of a call."""
    kind, tab = bias_table(spec)
    _, bidir, nb, maxd = rel_statics(spec)
    idx = torch.arange(n, device=tab.device)
    return _gather(kind, tab, lo, idx, bidirectional=bidir, num_buckets=nb,
                   max_distance=maxd, n=n).contiguous()


def vector_bias(vec: torch.Tensor, sq: int, skv: int) -> torch.Tensor:
    """Dense (1, H, Sq, Skv) bias from K1's per-head vector ``vec`` (H,
    Sq+Skv-1) over rel = -(Skv-1) .. Sq-1: element (row, col) reads index
    col - row + Sq - 1 (rel = col - (row + Skv - Sq)). A gather, so the
    gradient reaches ``vec``."""
    dev = vec.device
    idx = torch.arange(skv, device=dev)[None, :] - torch.arange(sq, device=dev)[:, None] + sq - 1
    return vec[:, idx][None]


def materialize(
    spec: RelBias,
    sq: int,
    skv: int,
    *,
    kv_offset: Optional[int] = None,
) -> torch.Tensor:
    """Dense (1, H, Sq, Skv) fp32 bias for the fused/oracle path. ``rel =
    col - (row + kv_offset)``, ``kv_offset`` by default ``skv - sq``
    (sequence-end alignment, as the flash kernel's causal mask)."""
    off = skv - sq if kv_offset is None else kv_offset
    lo = -(sq - 1) - off
    return vector_bias(bias_vector(spec, lo, sq + skv - 1), sq, skv)  # rel = lo .. skv - 1 - off
