"""Ring attention: sequence-parallel attention over one mesh axis.

Port of ``photonic_flash_attention_tpu/parallel/ring.py``: ``softmax_merge``
:35, ``ring_attention`` :57, ``_ring_fwd_with_lse`` :171, the custom VJP
``_make_ring_core`` :258 (``core_bwd`` :290), ``ring_attention_grad`` :444
and ``make_ring_attention`` :489.

* K/V live sequence-sharded over the ranks of the axis's process group.
  Each of the n steps runs the local Q shard against the K/V block that is
  resident, through K1 with its logsumexp (``ops/flash.py::
  flash_attention_with_lse``; native GQA, ``kv_lens`` clipped to the
  resident shard, the ``k_bias`` shard that rides with its K/V block), and
  the partials merge by logsumexp in float32 (:func:`softmax_merge`).
* Rotation: the next block is sent to rank + 1 and the previous rank's
  received (``dist.batch_isend_irecv``, JAX's ``ppermute``), issued before
  the step's K1 and waited after it, so NCCL's copy overlaps the kernel.
* A step's body is JAX's three-way choice (full / diagonal / skip), made on
  the host: the rank and the step are host integers, and the replicated
  ``kv_lens`` is read to the host once a call, so the loop itself never
  waits for the device (JAX decides inside ``lax.switch``).
  :func:`ring_step` is that body as a plain function of (me, n, step,
  resident shards); the process-group loop calls it, and so can a check
  that plays every rank's schedule in one process.
* The gradient (:class:`_RingAttentionFn`, JAX's custom VJP): a second ring
  pass in which each K/V block travels with its dK/dV (and d bias)
  accumulator, n rotations bringing them home, while dQ accumulates on
  the query's rank. ``core_bwd`` is XLA in JAX, not a Pallas kernel, so it
  is plain PyTorch here on either device: the probabilities recomputed
  from the saved lse, GQA by repeating K/V over the group and summing
  dK/dV per group in float32, blocked over query rows so that the float32
  score block stays within ``BWD_BLOCK_BYTES``.

:func:`ring_attention` / :func:`ring_attention_grad` take LOCAL shards and
a process group (JAX's ``shard_map`` body and ``axis_name``).
:func:`make_ring_attention` is the wrapper over a mesh: every rank passes
the same GLOBAL (B, S, H, D) tensors, each rank cuts its block (batch on
``data``, sequence on ``seq``, heads on ``model``), runs the ring, and the
output is all-gathered back to the global tensor on every rank
(differentiably: the gradient of a replicated input comes back
replicated). JAX's ``block_q``/``block_kv``/``interpret`` have no
counterpart (K1 picks its tiles).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from ..ops.flash import flash_attention_with_lse, merge_partial_attention
from ..ops.reference import repeat_kv, softmax_scale
from . import collectives as C
from .mesh import axis_group, mesh_shape
from .telemetry import get_telemetry

#: Bytes of one float32 (B, H, rows, S_local) score block of the backward.
BWD_BLOCK_BYTES = 256 << 20

Partial = Tuple[torch.Tensor, torch.Tensor]


def softmax_merge(o1: torch.Tensor, lse1: torch.Tensor, o2: torch.Tensor,
                  lse2: torch.Tensor) -> Partial:
    """Merge two partial attention results by logsumexp: o (B, S, H, D),
    lse (B, H, S); returns (o float32, lse). A fully masked partial
    (lse = -inf, o = 0) is absorbed exactly. The arithmetic is
    :func:`~..ops.flash.merge_partial_attention`'s."""
    o, lse = merge_partial_attention(o1, lse1.transpose(1, 2), o2, lse2.transpose(1, 2))
    return o, lse.transpose(1, 2)


def _skips(src: int, me: int, causal: bool, lens_host: Optional[List[int]], s_local: int) -> bool:
    """JAX's skip body: a causal block in the future, or a shard past every
    row's length (``lens_host``: the global lengths on the host)."""
    if causal and src > me:
        return True
    return lens_host is not None and all(n <= src * s_local for n in lens_host)


def ring_step(
    q: torch.Tensor,
    kb: torch.Tensor,
    vb: torch.Tensor,
    *,
    me: int,
    n: int,
    step: int,
    causal: bool,
    sm_scale: float,
    kv_lens: Optional[torch.Tensor] = None,
    lens_host: Optional[List[int]] = None,
    k_bias: Optional[torch.Tensor] = None,
) -> Optional[Partial]:
    """Step ``step`` of rank ``me`` out of ``n``: the local queries against
    the resident block of shard ``src = (me - step) mod n``. Returns
    (o float32, lse) of K1 with lse, or None where JAX's body is the skip:
    a causal block in the future, or a shard past every row's
    ``kv_lens`` (``lens_host``: the same lengths on the host)."""
    s_local = q.shape[1]
    src = (me - step) % n
    if _skips(src, me, causal, lens_host if kv_lens is not None else None, s_local):
        return None
    lens_b = None
    if kv_lens is not None:
        lens_b = (kv_lens - src * s_local).clamp(0, s_local).to(torch.int32)
    o, lse = flash_attention_with_lse(q, kb, vb, causal=causal and src == me, sm_scale=sm_scale,
                                      kv_lens=lens_b, k_bias=k_bias)
    return o.float(), lse


def _merge(acc: Optional[Partial], part: Optional[Partial]) -> Optional[Partial]:
    if part is None:
        return acc
    return part if acc is None else softmax_merge(*acc, *part)


def _ring_fwd_with_lse(q, k, v, group, causal: bool, scale: float, kv_lens=None,
                       k_bias=None) -> Partial:
    """The ring forward on local shards: (o float32, lse (B, H, S_local))."""
    n, me = dist.get_world_size(group), dist.get_rank(group)
    lens_host = kv_lens.tolist() if kv_lens is not None else None  # the call's one host read
    kv_lens = kv_lens.to(torch.int32) if kv_lens is not None else None
    blocks = [k.contiguous(), v.contiguous(),
              k_bias.float().contiguous() if k_bias is not None else None]
    acc = None
    for step in range(n):
        reqs, nxt = C.rotate_start(blocks, group) if step < n - 1 else ([], None)
        acc = _merge(acc, ring_step(q, blocks[0], blocks[1], me=me, n=n, step=step,
                                    causal=causal, sm_scale=scale, kv_lens=kv_lens,
                                    lens_host=lens_host, k_bias=blocks[2]))
        C.rotate_finish(reqs)
        if nxt is not None:
            blocks = nxt
    if acc is None:  # no step had a key
        b, s_local, h, _ = q.shape
        acc = (torch.zeros(q.shape, dtype=torch.float32, device=q.device),
               torch.full((b, h, s_local), float("-inf"), device=q.device))
    return acc


def ring_attention(
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
    """Ring attention forward on local shards (JAX ``ring_attention``).

    q/k/v: LOCAL (B, S_local, H, D) shards of a sequence concatenated over
    the ranks of ``group`` in rank order (equal shards; Hq % Hkv == 0).
    ``kv_lens``: (B,) GLOBAL valid key lengths, the same on every rank;
    ``k_bias``: the (B, S_local) LOCAL shard of a global per-key bias.
    Returns the local output shard in q's dtype."""
    scale = softmax_scale(q.shape[-1], sm_scale)
    return _ring_fwd_with_lse(q, k, v, group, causal, scale, kv_lens, k_bias)[0].to(q.dtype)


def _bwd_contribution(qf, dof, lse, di, kb, vb, bias_b, *, src: int, me: int, causal: bool,
                      scale: float, kv_lens, group: int):
    """(dq, dk, dv, d bias) increments of the local queries against block
    ``src`` (JAX ``contribution``), in float32, blocked over query rows."""
    b, s_local, hq, d = qf.shape
    hkv = kb.shape[2]
    kbf = repeat_kv(kb.float(), group)
    vbf = repeat_kv(vb.float(), group)
    dq = torch.zeros_like(qf)
    dk = torch.zeros(b, s_local, hq, d, device=qf.device)
    dv = torch.zeros_like(dk)
    db = torch.zeros(b, s_local, device=qf.device) if bias_b is not None else None
    col = torch.arange(s_local, device=qf.device)
    key_ok = None
    if kv_lens is not None:
        key_ok = (src * s_local + col)[None, :] < kv_lens.long()[:, None]  # (B, S_local)
    rows = max(1, min(s_local, BWD_BLOCK_BYTES // (4 * b * hq * s_local)))
    for r0 in range(0, s_local, rows):
        r1 = min(r0 + rows, s_local)
        qr, dor = qf[:, r0:r1], dof[:, r0:r1]
        s = torch.einsum("bqhd,bkhd->bhqk", qr, kbf) * scale
        if bias_b is not None:
            s = s + bias_b[:, None, None, :]
        valid = None
        if causal and src == me:
            valid = (col[None, :] <= torch.arange(r0, r1, device=qf.device)[:, None])[None, None]
        if key_ok is not None:
            kv = key_ok[:, None, None, :]
            valid = kv if valid is None else valid & kv
        lse_r = lse[:, :, r0:r1, None]
        finite = torch.isfinite(lse_r)
        p = torch.exp(s - torch.where(finite, lse_r, 0.0)) * finite
        if valid is not None:
            p = torch.where(valid, p, 0.0)
        dv += torch.einsum("bhqk,bqhd->bkhd", p, dor)
        dp = torch.einsum("bqhd,bkhd->bhqk", dor, vbf)
        ds_raw = p * (dp - di[:, :, r0:r1, None])
        ds = ds_raw * scale
        dq[:, r0:r1] = torch.einsum("bhqk,bkhd->bqhd", ds, kbf)
        dk += torch.einsum("bhqk,bqhd->bkhd", ds, qr)
        if db is not None:
            db += ds_raw.sum(dim=(1, 2))
    if group > 1:
        dk = dk.view(b, s_local, hkv, group, d).sum(3)
        dv = dv.view(b, s_local, hkv, group, d).sum(3)
    return dq, dk, dv, db


class _RingAttentionFn(torch.autograd.Function):
    """Differentiable ring attention (JAX ``_make_ring_core``): the ring
    forward saving (q, k, v, o float32, lse); the backward a second ring
    pass, K/V and the dK/dV/d-bias accumulators rotating together n
    times, dQ local. ``kv_lens`` takes no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, kv_lens, k_bias, group, causal: bool, scale: float):
        o, lse = _ring_fwd_with_lse(q, k, v, group, causal, scale, kv_lens, k_bias)
        ctx.save_for_backward(q, k, v, kv_lens, k_bias, o, lse)
        ctx.group, ctx.causal, ctx.scale = group, causal, scale
        return o.to(q.dtype)

    @staticmethod
    def backward(ctx, do):
        q, k, v, kv_lens, k_bias, o, lse = ctx.saved_tensors
        group, causal, scale = ctx.group, ctx.causal, ctx.scale
        n, me = dist.get_world_size(group), dist.get_rank(group)
        s_local = q.shape[1]
        qf, dof = q.float(), do.float()
        di = (o * dof).sum(-1).transpose(1, 2)  # (B, H, S_local)
        lens_host = kv_lens.tolist() if kv_lens is not None else None
        gsize = q.shape[2] // k.shape[2]
        dq = torch.zeros_like(qf)
        blocks = [k.contiguous(), v.contiguous(),
                  k_bias.float().contiguous() if k_bias is not None else None]
        acc = [torch.zeros(k.shape, device=k.device), torch.zeros(v.shape, device=v.device),
               torch.zeros(k.shape[:2], device=k.device) if k_bias is not None else None]
        for step in range(n):
            src = (me - step) % n
            skip = _skips(src, me, causal, lens_host, s_local)
            # K/V go on to the next step (not after the last); the
            # accumulators go every step, n rotations bringing them home.
            reqs, nxt = C.rotate_start(blocks, group) if step < n - 1 else ([], None)
            if not skip:
                dq_i, dk_i, dv_i, db_i = _bwd_contribution(
                    qf, dof, lse, di, blocks[0], blocks[1], blocks[2], src=src, me=me,
                    causal=causal, scale=scale, kv_lens=kv_lens, group=gsize)
                dq += dq_i
                acc[0] += dk_i
                acc[1] += dv_i
                if db_i is not None:
                    acc[2] += db_i
            areqs, acc = C.rotate_start(acc, group)
            C.rotate_finish(reqs + areqs)
            if nxt is not None:
                blocks = nxt
        dbias = acc[2].to(k_bias.dtype) if k_bias is not None else None
        return (dq.to(q.dtype), acc[0].to(k.dtype), acc[1].to(v.dtype), None, dbias,
                None, None, None)


def ring_attention_grad(
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
    """Differentiable :func:`ring_attention` (JAX ``ring_attention_grad``):
    gradients for q, k, v and ``k_bias``; GQA with Hq a multiple of Hkv."""
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"ring_attention_grad requires Hq ({q.shape[2]}) to be a multiple "
                         f"of Hkv ({k.shape[2]})")
    scale = softmax_scale(q.shape[-1], sm_scale)
    return _RingAttentionFn.apply(q, k, v, kv_lens, k_bias, group, causal, scale)


def shard_global(x: torch.Tensor, placement, mesh) -> torch.Tensor:
    """This rank's block of a replicated global tensor: ``placement`` is
    [(dim, axis or None), ...]; differentiable (:func:`~.collectives.scatter`)."""
    for dim, axis in placement:
        if axis is not None:
            x = C.scatter(x, dim, axis_group(mesh, axis))
    return x


def unshard_global(x: torch.Tensor, placement, mesh) -> torch.Tensor:
    """The inverse of :func:`shard_global`: the blocks all-gathered back into
    the global tensor on every rank."""
    for dim, axis in reversed(placement):
        if axis is not None:
            x = C.gather(x, dim, axis_group(mesh, axis))
    return x


def make_ring_attention(
    mesh,
    *,
    seq_axis: str = "seq",
    data_axis: Optional[str] = "data",
    model_axis: Optional[str] = "model",
    causal: bool = False,
    sm_scale: Optional[float] = None,
    differentiable: bool = False,
):
    """A ring-attention callable over ``mesh`` (JAX ``make_ring_attention``).

    ``fn(q, k, v, kv_lens=None, k_bias=None)`` takes the GLOBAL (B, S, H, D)
    tensors, the same on every rank, with batch on ``data_axis``, sequence
    on ``seq_axis`` and heads on ``model_axis`` (an axis the mesh lacks, or
    None, is not sharded), ``kv_lens`` (B,) and ``k_bias`` (B, S) global,
    and returns the global output on every rank. ``differentiable=True``
    builds on :func:`ring_attention_grad`."""
    axes = mesh_shape(mesh)
    if seq_axis not in axes:
        raise ValueError(f"mesh has no axis {seq_axis!r}")
    dax = data_axis if data_axis in axes else None
    max_ = model_axis if model_axis in axes else None
    qkv_place = [(0, dax), (1, seq_axis), (2, max_)]
    group = axis_group(mesh, seq_axis)
    n_seq = axes[seq_axis]
    base = ring_attention_grad if differentiable else ring_attention

    def fn(q, k, v, kv_lens=None, k_bias=None):
        ql, kl, vl = (shard_global(t, qkv_place, mesh) for t in (q, k, v))
        kw = {}
        if kv_lens is not None:
            kw["kv_lens"] = shard_global(kv_lens, [(0, dax)], mesh)
        if k_bias is not None:
            kw["k_bias"] = shard_global(k_bias, [(0, dax), (1, seq_axis)], mesh)
        out = base(ql, kl, vl, group=group, causal=causal, sm_scale=sm_scale, **kw)
        # Analytic accounting: each of the n - 1 steps moves this rank's
        # K and V shards to its neighbour.
        tel = get_telemetry()
        shard_bytes = k.numel() // n_seq * k.element_size()
        for _ in range(n_seq - 1):
            tel.record(seq_axis, "ppermute", 2 * shard_bytes, n_seq)
        return unshard_global(out, qkv_place, mesh)

    return fn
