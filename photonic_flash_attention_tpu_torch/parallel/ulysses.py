"""Ulysses sequence parallelism: all-to-all head x sequence re-sharding.

Port of ``photonic_flash_attention_tpu/parallel/ulysses.py``
(``ulysses_attention`` :32, ``make_ulysses_attention`` :98). An all-to-all
(``dist.all_to_all_single`` on the axis's process group) swaps the sharded
dim from sequence to heads, every rank runs single-device flash attention
over the FULL sequence for its head block (``ops/flash.py::
flash_attention``: K1 forward, K4/K5 for its gradient, the masked backward
with key streams), and a second all-to-all swaps back. Both exchanges are
differentiable (the backward runs the inverse exchange). Needs
``num_heads % axis_size == 0`` and ``num_kv_heads % axis_size == 0``.

Against the ring: two bulk exchanges instead of n - 1 neighbour steps and
full-sequence K1 calls, but each rank then holds the whole sequence.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.flash import flash_attention
from ..utils.exceptions import DistributionError
from . import collectives as C
from .mesh import axis_group, mesh_shape
from .ring import shard_global, unshard_global
from .telemetry import get_telemetry


def ulysses_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    group,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    kv_lens: Optional[torch.Tensor] = None,
    k_bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Ulysses on local shards (JAX ``ulysses_attention``).

    q/k/v: LOCAL (B, S_local, H, D) shards over the ranks of ``group``;
    ``kv_lens`` (B,) GLOBAL lengths, the same on every rank (after the
    exchange the whole sequence is resident, so they reach K1 unchanged);
    ``k_bias`` the (B, S_local) LOCAL shard of a global per-key bias,
    all-gathered to the full sequence. Returns the local output shard."""
    # sequence-sharded -> head-sharded: split heads, gather the sequence.
    qh, kh, vh = (C.all_to_all(t, 2, 1, group) for t in (q, k, v))
    bias_full = C.gather_partial(k_bias, 1, group) if k_bias is not None else None
    oh = flash_attention(
        qh, kh, vh, causal=causal, sm_scale=sm_scale,
        kv_lens=kv_lens.to(torch.int32) if kv_lens is not None else None, k_bias=bias_full,
    )
    # head-sharded -> sequence-sharded: split the sequence, gather heads.
    return C.all_to_all(oh, 1, 2, group)


def make_ulysses_attention(
    mesh,
    *,
    seq_axis: str = "seq",
    data_axis: Optional[str] = "data",
    causal: bool = False,
    sm_scale: Optional[float] = None,
):
    """A Ulysses callable over ``mesh`` (JAX ``make_ulysses_attention``):
    ``fn(q, k, v, kv_lens=None, k_bias=None)`` on GLOBAL (B, S, H, D)
    tensors, the same on every rank (batch on ``data_axis``, sequence on
    ``seq_axis``; heads shard only inside the exchange), returning the
    global output on every rank. Differentiable."""
    axes = mesh_shape(mesh)
    if seq_axis not in axes:
        raise DistributionError(f"mesh has no axis {seq_axis!r}")
    dax = data_axis if data_axis in axes else None
    place = [(0, dax), (1, seq_axis)]
    group = axis_group(mesh, seq_axis)
    n_seq = axes[seq_axis]

    def fn(q, k, v, kv_lens=None, k_bias=None):
        h, hkv = q.shape[2], k.shape[2]
        if h % n_seq:
            raise DistributionError(f"ulysses requires num_heads ({h}) % seq axis size "
                                    f"({n_seq}) == 0; use ring attention instead")
        if hkv % n_seq:
            raise DistributionError(f"ulysses requires num_kv_heads ({hkv}) % seq axis size "
                                    f"({n_seq}) == 0 (GQA); use ring attention instead")
        ql, kl, vl = (shard_global(t, place, mesh) for t in (q, k, v))
        kw = {}
        if kv_lens is not None:
            kw["kv_lens"] = shard_global(kv_lens, [(0, dax)], mesh)
        if k_bias is not None:
            kw["k_bias"] = shard_global(k_bias, place, mesh)
        out = ulysses_attention(ql, kl, vl, group=group, causal=causal, sm_scale=sm_scale, **kw)
        # Each exchange moves (n - 1) / n of a rank's shard: q, k, v in, o out.
        tel = get_telemetry()
        local_bytes = q.numel() // n_seq * q.element_size()
        for _ in range(4):
            tel.record(seq_axis, "all_to_all", local_bytes * (n_seq - 1) // n_seq, n_seq)
        return unshard_global(out, place, mesh)

    return fn

