"""The unrolled-backward experiment: kernels K20 (dQ) and K21 (dK/dV).

Port of ``benchmarks/flash_bwd_unrolled_experiment.py``, run by JAX as
``python benchmarks/flash_bwd_unrolled_experiment.py`` and here as ``python
-m photonic_flash_attention_tpu_torch.experiments.flash_bwd_unrolled_experiment
[--device cpu|cuda]``. The experiment unrolls the inner grid dimension of
the flash backward into one call per block, over static extents:

* dq: one call per ``block_q`` row-block, over the kv blocks up to the
  row-block's last row when causal (JAX's ``_dq_kernel_unrolled``). K20
  (:func:`dq_rowblocks`) is launched once per row-block. In bf16 each
  launch is K5's Hopper body (``csrc/flash_bwd_sm90.cu``,
  ``pfa_flash_bwd_dq_rowblock_sm90``) over the row-block's 128-row work
  tiles, the last (longest, causal) first, each walking K5's key tiles up
  to its diagonal (:func:`k20_plan`); rows of a work tile past the
  row-block's end are computed and not stored. The row-blocks are launched
  last first (:data:`K20_DESCENDING`), each after the first a programmatic
  dependent launch. It is counted as ``pfa_flash_bwd_dq_rowblock``. fp32
  inputs stay on the mma.sync body (``csrc/flash_bwd_experiments.cu``:
  64-row CTAs, counted as ``pfa_flash_bwd_dq_rowblock_fp32``).
* dk/dv: one call per ``block_kv`` key block, over the query blocks from
  the diagonal on (``_dkv_kernel_unrolled``). K21 (:func:`dkv_colblocks`)
  is launched once per key block. In bf16 each launch is K4's Hopper body
  (``csrc/flash_bwd_sm90.cu``, ``pfa_flash_bwd_dkv_colblock_sm90``: TMA
  ring, ``wgmma``, warp-specialised, persistent) over the block's 128-key
  work tiles, each keeping its dK and dV in fp32 registers and walking
  64-query tiles from its diagonal to S (:func:`k21_plan`); keys of a work
  tile past the block's end are computed and not stored. The launches
  after a call's first are programmatic dependent launches. It is counted
  as ``pfa_flash_bwd_dkv_colblock``. fp32 inputs stay on the mma.sync body
  (``csrc/flash_bwd_experiments.cu``: 64-key CTAs, counted as
  ``pfa_flash_bwd_dkv_colblock_fp32``): TMA cannot convert on load.

Each launch writes its rows of one (B, H, S, D) output in place, where JAX
concatenates the calls' outputs. JAX's static extents have no counterpart
on the card: the tiles they add past a CTA's diagonal are wholly masked.

Contract (JAX's, :func:`flash_bwd_unrolled`): q, k, v, o, dO [B, H, S, D],
no GQA; lse (B, H, S) fp32 in natural log; ``di = rowsum(o * dO)`` in fp32
PyTorch (XLA in JAX); causal ``col <= row``; q, k, v and dO cast to bf16 in
the body, P rounded to bf16 before dV += P^T dO and dS before dQ += dS K
and dK += dS^T Q, fp32 accumulation; (dq, dk, dv) in the inputs' dtypes.
JAX's grids are ``S // block`` and leave the tail rows and keys out where
S is not a multiple (dq comes back short, dk/dv miss the tail rows' sums):
the port raises. On the card D in {64, 128}, bf16 or fp32 inputs
(converted on load), contiguous, and blocks that are multiples of 64; the
blocks set only the launches (K20's by ``block_q``, K21's by ``block_kv``).
K20 and K21 in bf16 also take only 16-byte-aligned bases of q, k, v and dO.

``main`` is JAX's: parity against the port's grid backward
(``ops/flash_bwd.py::flash_attention_bwd``, K4 and K5 on the card) under
max abs over max 3e-2, then each geometry and block timed against it.
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import _build
from ..ops.flash import flash_attention_with_lse
from ..ops import flash_bwd as bwd_ops
from ..ops.flash_bwd import flash_attention_bwd, flash_bwd_dkv, flash_bwd_dq
from . import _common as C

__all__ = ["RangePlan", "dkv_colblocks", "dkv_colblocks_plain", "dq_rowblocks",
           "dq_rowblocks_plain", "flash_bwd_di", "flash_bwd_unrolled", "flash_bwd_unrolled_plain",
           "k20_plan", "k21_plan", "main"]

Grads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

#: JAX's parity case (B, S, H, D), its blocks and gate (max abs over the
#: reference's max abs).
PARITY_SHAPE = (1, 1024, 2, 64)
PARITY_BLOCKS = (256, 256)
PARITY_GATE = 3e-2
#: JAX's perf geometries: (name, (B, S, H, D), causal), and blocks
#: (block_q, block_kv).
CASES = (
    ("d64 b4 s2048 causal", (4, 2048, 12, 64), True),
    ("d64 b1 s8192 causal", (1, 8192, 12, 64), True),
    ("d128 b4 s4096 causal", (4, 4096, 8, 128), True),
)
BLOCKS = ((512, 512), (256, 512), (512, 256))
#: The row whose kernels are also timed alone: (case name, blocks).
HEADLINE = ("d64 b4 s2048 causal", (512, 512))
CARD_DTYPES = (torch.bfloat16, torch.float32)
CARD_HEAD_DIMS = (64, 128)
#: The card kernels' rows a CTA: a block must be a multiple of it.
CARD_BLOCK = 64
#: The card checks beside the mains' geometries: ((B, S, H, D), dtype,
#: blocks), each causal and not (blocks of 64, a single launch of 320
#: rows or keys, D 128, fp32 inputs).
CARD_CHECKS = (
    ((1, 256, 2, 64), torch.bfloat16, ((128, 128), (64, 128), (128, 64))),
    ((2, 320, 3, 128), torch.bfloat16, ((64, 320), (320, 64))),
    ((1, 256, 2, 64), torch.float32, ((128, 64),)),
    ((1, 192, 2, 128), torch.float32, ((64, 192),)),
)


#: Dynamic shared memory a CTA may take on the H100 (``csrc/sm90.cuh``).
SMEM_MAX = 232448
#: Rows of a work tile of K4/K5's body (queries in K5, keys in K4): two
#: consumer warpgroups of 64.
WORK_ROWS = 128
#: K20's bf16 launch order: the last row-block (the longest, causal) first.
K20_DESCENDING = True


class RangePlan(NamedTuple):
    """One K20 or K21 launch on K5's or K4's bf16 body, from the shapes
    alone: its work tiles (the 128-row blocks of its range x H x B), the
    persistent grid (min(work tiles, SMs)), and the ring's stages and
    dynamic shared memory (K5's ``DqCfg`` or K4's ``DkvCfg``), which the C
    launcher checks against its own."""
    work: int
    grid: int
    stages: int
    smem: int


def _fits(n: int) -> bool:
    """Whether ``n`` bytes of tiles fit beside the barriers and the
    alignment slack (``csrc/flash_bwd_sm90.cu::fits``)."""
    return n + 8 * 12 + 1024 <= SMEM_MAX


def _k4_ring(d: int) -> Tuple[int, int]:
    """K4's ring at head dim ``d`` (``csrc/flash_bwd_sm90.cu::DkvCfg``):
    K and V of a 128-key work tile double-buffered where they fit beside
    two ring stages, then as many stages (4 to 2) of 64-query Q and dO
    tiles with their lse and di as fit; (stages, dynamic shared memory)."""
    kv, qo = WORK_ROWS * d * 2, 64 * d * 2
    stage = 2 * qo + 2 * 64 * 4
    kvbuf = 2 if _fits(4 * kv + 2 * stage) else 1
    stages = next(n for n in (4, 3, 2) if n == 2 or _fits(2 * kvbuf * kv + n * stage))
    return stages, 2 * kvbuf * kv + stages * stage + 8 * (2 * stages + 2 * kvbuf) + 1024


def _k5_ring(d: int) -> Tuple[int, int, int, int]:
    """K5's plain ring at head dim ``d`` (``csrc/flash_bwd_sm90.cu::DqCfg``):
    K and V tiles of ``bkv`` keys (128 at D 64, 64 at D 128) a stage; Q and
    dO of a 128-row work tile double-buffered where they fit beside four
    stages, then as many stages (4 to 2) as fit; (bkv, Q/dO buffers,
    stages, dynamic shared memory)."""
    bkv = 64 if d == 128 else 128
    qo, kv = WORK_ROWS * d * 2, bkv * d * 2
    qbuf = 2 if _fits(4 * qo + 4 * kv) else 1
    stages = next(n for n in (4, 3, 2) if n == 2 or _fits(2 * qbuf * qo + 2 * n * kv))
    return bkv, qbuf, stages, 2 * qbuf * qo + 2 * stages * kv + 8 * (2 * stages + 2 * qbuf) + 1024


def _range_work(name: str, unit: str, b: int, s: int, h: int, d: int, row0: int,
                rows: int) -> int:
    """The work tiles of a K20 or K21 launch over [row0, row0 + rows) of S,
    or ValueError where the body does not take the launch."""
    if d not in CARD_HEAD_DIMS:
        raise ValueError(f"{name} takes head_dim in {CARD_HEAD_DIMS} on the card, got {d}")
    if b < 1 or h < 1 or s < 1:
        raise ValueError(f"bad shape: B {b}, S {s}, H {h}")
    if row0 < 0 or rows < 1 or row0 + rows > s or row0 % CARD_BLOCK or rows % CARD_BLOCK:
        raise ValueError(f"{name}: the {unit} range must lie in [0, S {s}) on the grid of "
                         f"{CARD_BLOCK} {unit}s, got {rows} {unit}s from {row0}")
    return -(-rows // WORK_ROWS) * b * h


@functools.lru_cache(maxsize=None)
def k20_plan(b: int, s: int, h: int, d: int, q_row0: int, rows: int,
             sms: int = 132) -> RangePlan:
    """One K20 launch in bf16: query rows [``q_row0``, ``q_row0 + rows``)
    of every (b, h), on K5's body (the (B, H, S, D) tensors taken as K5's
    (B H, S, 1, D)). The range must lie in [0, S) on the grid of 64 rows."""
    work = _range_work("K20", "row", b, s, h, d, q_row0, rows)
    return RangePlan(work, min(work, sms), *_k5_ring(d)[2:])


@functools.lru_cache(maxsize=None)
def k21_plan(b: int, s: int, h: int, d: int, kv_row0: int, rows: int,
             sms: int = 132) -> RangePlan:
    """One K21 launch in bf16: keys [``kv_row0``, ``kv_row0 + rows``) of
    every (b, h), on K4's body (the (B, H, S, D) tensors taken as K4's (B
    H, S, 1, D)). The range must lie in [0, S) on the grid of 64 keys."""
    work = _range_work("K21", "key", b, s, h, d, kv_row0, rows)
    return RangePlan(work, min(work, sms), *_k4_ring(d))


def _check(q, k, v, o, lse, do, block_q: int, block_kv: int) -> None:
    if q.ndim != 4 or any(t.shape != q.shape for t in (o, do)):
        raise ValueError(f"expected q, o, do [B, H, S, D] of one shape; got {tuple(q.shape)}, "
                         f"{tuple(o.shape)}, {tuple(do.shape)}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k and v must share [B, H, S, D] (no GQA); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, s, _ = q.shape
    if lse.shape != (b, h, s):
        raise ValueError(f"lse must be (B, H, S) = {(b, h, s)}, got {tuple(lse.shape)}")
    if len({t.device for t in (q, k, v, o, lse, do)}) != 1:
        raise ValueError("q, k, v, o, lse and do must lie on one device")
    C.check_blocks(s, block_q, "block_q")
    C.check_blocks(s, block_kv, "block_kv")


def flash_bwd_di(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``di = rowsum(o * dO)`` in fp32 of [B, H, S, D] o and dO, (B, H, S)
    contiguous (JAX's XLA prolog, ``:134``; K4/K5's formula)."""
    return bwd_ops.flash_bwd_di(o.transpose(1, 2), do.transpose(1, 2))


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16, held in fp32 (JAX's ``.astype(bfloat16)``
    before an fp32-accumulated product)."""
    return t.to(torch.bfloat16).float()


def _p_ds(q, k, v, do, lse, di, r0: int, c0: int, sm_scale: float, masked: bool):
    """One (query block, key block) of JAX's bodies in the query-major
    domain: p = exp(s * scale - lse), zero where ``col > row`` if
    ``masked``; ds = p * (dp - di) * scale. q, k, v, do bf16 values in
    fp32."""
    s = q @ k.transpose(-1, -2)
    p = torch.exp(s * sm_scale - lse[..., None])
    if masked:
        row = torch.arange(r0, r0 + q.shape[-2], device=q.device)[:, None]
        col = torch.arange(c0, c0 + k.shape[-2], device=q.device)[None, :]
        p = torch.where(col <= row, p, 0.0)
    dp = do @ v.transpose(-1, -2)
    return p, p * (dp - di[..., None]) * sm_scale


def dq_rowblocks_plain(q, k, v, do, lse, di, *, sm_scale: float, causal: bool, block_q: int,
                       block_kv: int) -> torch.Tensor:
    """K20's plain version, JAX's ``_dq_kernel_unrolled`` call by call: per
    row-block i, the kv blocks of its static extent (``min(ceil((i+1) bq /
    bkv), n_kv)`` when causal, ``:141-143``), masked where ``(j+1) bkv >
    i bq``; dq += bf16(ds) K. dq in q's dtype."""
    b, h, s, d = q.shape
    qf, kf, vf, dof = (_bf16(t) for t in (q, k, v, do))
    n_kv = s // block_kv
    dq = torch.empty(b, h, s, d, dtype=torch.float32, device=q.device)
    for i in range(s // block_q):
        r0 = i * block_q
        rows = slice(r0, r0 + block_q)
        extent = min(-(-(r0 + block_q) // block_kv), n_kv) if causal else n_kv
        acc = torch.zeros(b, h, block_q, d, dtype=torch.float32, device=q.device)
        for j in range(extent):
            cols = slice(j * block_kv, (j + 1) * block_kv)
            _, ds = _p_ds(qf[:, :, rows], kf[:, :, cols], vf[:, :, cols], dof[:, :, rows],
                          lse[:, :, rows].float(), di[:, :, rows], r0, j * block_kv, sm_scale,
                          causal and (j + 1) * block_kv > r0)
            acc += _bf16(ds) @ kf[:, :, cols]
        dq[:, :, rows] = acc
    return dq.to(q.dtype)


def dkv_colblocks_plain(q, k, v, do, lse, di, *, sm_scale: float, causal: bool, block_q: int,
                        block_kv: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K21's plain version, JAX's ``_dkv_kernel_unrolled`` call by call: per
    key block ki, the query blocks from ``(ki bkv) // bq`` (``:173``; 0 when
    not causal), masked where ``ki bkv + bkv > j bq``; dv += bf16(p)^T dO,
    dk += bf16(ds)^T Q. dk, dv in k's and v's dtypes."""
    b, h, s, d = q.shape
    qf, kf, vf, dof = (_bf16(t) for t in (q, k, v, do))
    dk = torch.empty(b, h, s, d, dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    for ki in range(s // block_kv):
        c0 = ki * block_kv
        cols = slice(c0, c0 + block_kv)
        acc_k = torch.zeros(b, h, block_kv, d, dtype=torch.float32, device=q.device)
        acc_v = torch.zeros_like(acc_k)
        for j in range(c0 // block_q if causal else 0, s // block_q):
            rows = slice(j * block_q, (j + 1) * block_q)
            p, ds = _p_ds(qf[:, :, rows], kf[:, :, cols], vf[:, :, cols], dof[:, :, rows],
                          lse[:, :, rows].float(), di[:, :, rows], j * block_q, c0, sm_scale,
                          causal and c0 + block_kv > j * block_q)
            acc_v += _bf16(p).transpose(-1, -2) @ dof[:, :, rows]
            acc_k += _bf16(ds).transpose(-1, -2) @ qf[:, :, rows]
        dk[:, :, cols], dv[:, :, cols] = acc_k, acc_v
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_unrolled_plain(q, k, v, o, lse, do, *, sm_scale: float, causal: bool,
                             block_q: int = 512, block_kv: int = 512) -> Grads:
    """K20's and K21's plain versions on JAX's blocks: (dq, dk, dv)."""
    _check(q, k, v, o, lse, do, block_q, block_kv)
    di = flash_bwd_di(o, do)
    kw = dict(sm_scale=sm_scale, causal=causal, block_q=block_q, block_kv=block_kv)
    return (dq_rowblocks_plain(q, k, v, do, lse, di, **kw),
            *dkv_colblocks_plain(q, k, v, do, lse, di, **kw))


def _check_card(q, k, v, do, lse, di, block_q: int, block_kv: int) -> None:
    C.check_card(q, CARD_DTYPES, CARD_HEAD_DIMS, "K20/K21", k, v, do, lse, di)
    if not q.dtype == k.dtype == v.dtype == do.dtype:
        raise ValueError(f"K20/K21 take q, k, v, do of one dtype; got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}, {do.dtype}")
    if lse.dtype != torch.float32 or di.dtype != torch.float32:
        raise ValueError("K20/K21 take lse and di in float32")
    for name, blk in (("block_q", block_q), ("block_kv", block_kv)):
        if blk % CARD_BLOCK:
            raise ValueError(f"K20/K21 take blocks that are multiples of {CARD_BLOCK} on the "
                             f"card (a CTA's rows), got {name} {blk}")


def _k20_launches(q, k, v, do, lse, di, dq, *, sm_scale: float, causal: bool, block_q: int,
                  descending: bool, chained: bool) -> None:
    """K20 in bf16 into ``dq``: one launch a row-block on K5's body
    (:func:`k20_plan`), the last row-block first where ``descending``, each
    launch after the first a programmatic dependent launch where
    ``chained``. The order and the chaining are the levers the card's
    timing sets; :func:`dq_rowblocks` runs the shipped ones."""
    C.check_aligned("K20", q, k, v, do)
    b, h, s, d = q.shape
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    starts = range(0, s, block_q)
    for n, row0 in enumerate(reversed(starts) if descending else starts):
        plan = k20_plan(b, s, h, d, row0, block_q, sms)
        _build.launch("pfa_flash_bwd_dq_rowblock_sm90", q.device, q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), do.data_ptr(), lse.data_ptr(), di.data_ptr(), dq.data_ptr(),
                      b, s, h, d, row0, block_q, float(sm_scale), int(causal),
                      int(chained and n > 0), plan.stages, plan.smem, plan.grid,
                      count_as="pfa_flash_bwd_dq_rowblock")


def dq_rowblocks(q, k, v, do, lse, di, *, sm_scale: float, causal: bool, block_q: int = 512,
                 block_kv: int = 512) -> torch.Tensor:
    """dq from precomputed ``di``: on the card K20 launched once per
    ``block_q`` row-block (each counted: bf16 on K5's Hopper body as
    ``pfa_flash_bwd_dq_rowblock``, the last row-block first and each launch
    after the first a programmatic dependent launch; fp32 on the mma.sync
    body as ``pfa_flash_bwd_dq_rowblock_fp32``), :func:`dq_rowblocks_plain`
    on the CPU."""
    kw = dict(sm_scale=sm_scale, causal=causal, block_q=block_q, block_kv=block_kv)
    C.check_blocks(q.shape[2], block_q, "block_q")
    C.check_blocks(q.shape[2], block_kv, "block_kv")

    def cuda() -> torch.Tensor:
        _check_card(q, k, v, do, lse, di, block_q, block_kv)
        b, h, s, d = q.shape
        dq = torch.empty_like(q)
        if q.dtype == torch.bfloat16:
            _k20_launches(q, k, v, do, lse, di, dq, sm_scale=sm_scale, causal=causal,
                          block_q=block_q, descending=K20_DESCENDING, chained=True)
            return dq
        for i in range(s // block_q):
            _build.launch("pfa_flash_bwd_dq_rowblock", q.device, q.data_ptr(), k.data_ptr(),
                          v.data_ptr(), do.data_ptr(), lse.data_ptr(), di.data_ptr(),
                          dq.data_ptr(), b, s, h, d, i * block_q, block_q, float(sm_scale),
                          int(causal), _build.DTYPE_CODES[q.dtype],
                          count_as="pfa_flash_bwd_dq_rowblock_fp32")
        return dq

    return C.on_device(q, cuda, lambda: dq_rowblocks_plain(q, k, v, do, lse, di, **kw))


def dkv_colblocks(q, k, v, do, lse, di, *, sm_scale: float, causal: bool, block_q: int = 512,
                  block_kv: int = 512) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) from precomputed ``di``: on the card K21 launched once per
    ``block_kv`` key block (each counted: bf16 on K4's Hopper body by
    :func:`k21_plan` as ``pfa_flash_bwd_dkv_colblock``, each launch after
    the first a programmatic dependent launch; fp32 on the mma.sync body as
    ``pfa_flash_bwd_dkv_colblock_fp32``), :func:`dkv_colblocks_plain` on the
    CPU."""
    kw = dict(sm_scale=sm_scale, causal=causal, block_q=block_q, block_kv=block_kv)
    C.check_blocks(q.shape[2], block_q, "block_q")
    C.check_blocks(q.shape[2], block_kv, "block_kv")

    def cuda() -> Tuple[torch.Tensor, torch.Tensor]:
        _check_card(q, k, v, do, lse, di, block_q, block_kv)
        b, h, s, d = q.shape
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                di.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, s, h, d)
        if q.dtype != torch.bfloat16:
            for ki in range(s // block_kv):
                _build.launch("pfa_flash_bwd_dkv_colblock", q.device, *ptrs, ki * block_kv,
                              block_kv, float(sm_scale), int(causal),
                              _build.DTYPE_CODES[q.dtype],
                              count_as="pfa_flash_bwd_dkv_colblock_fp32")
            return dk, dv
        C.check_aligned("K21", q, k, v, do)
        sms = torch.cuda.get_device_properties(q.device).multi_processor_count
        for ki in range(s // block_kv):
            plan = k21_plan(b, s, h, d, ki * block_kv, block_kv, sms)
            _build.launch("pfa_flash_bwd_dkv_colblock_sm90", q.device, *ptrs, ki * block_kv,
                          block_kv, float(sm_scale), int(causal), int(ki > 0), plan.stages,
                          plan.smem, plan.grid, count_as="pfa_flash_bwd_dkv_colblock")
        return dk, dv

    return C.on_device(q, cuda, lambda: dkv_colblocks_plain(q, k, v, do, lse, di, **kw))


def flash_bwd_unrolled(q, k, v, o, lse, do, *, sm_scale: float, causal: bool,
                       block_q: int = 512, block_kv: int = 512) -> Grads:
    """The flash backward in JAX's [B, H, S, D] domain, one call per block:
    (dq, dk, dv) in the inputs' dtypes. K20 and K21 for CUDA tensors,
    :func:`flash_bwd_unrolled_plain` for CPU tensors."""
    _check(q, k, v, o, lse, do, block_q, block_kv)
    di = flash_bwd_di(o, do)
    kw = dict(sm_scale=sm_scale, causal=causal, block_q=block_q, block_kv=block_kv)
    return (dq_rowblocks(q, k, v, do, lse, di, **kw), *dkv_colblocks(q, k, v, do, lse, di, **kw))


# -- main ---------------------------------------------------------------------


def _prep(rng: np.random.Generator, shape, causal: bool, dev: torch.device):
    """JAX's ``_prep``: bf16 q, k, v, then o and lse from the port's flash
    forward (K1 with lse on the card), then dO, drawn in (B, S, H, D).
    Returns the (B, S, H, D) tensors (q, k, v, o, do) and the contiguous
    [B, H, S, D] copies with lse (q, k, v, o, lse, do)."""
    q, k, v = (C.normal(rng, shape, torch.bfloat16, dev) for _ in range(3))
    o, lse = flash_attention_with_lse(q, k, v, causal=causal)
    do = C.normal(rng, shape, torch.bfloat16, dev)
    t = lambda x: x.transpose(1, 2).contiguous()  # noqa: E731
    return (q, k, v, o, do), (t(q), t(k), t(v), t(o), lse, t(do))


def _fit(b: int, s: int, h: int, d: int, causal: bool, device: torch.device) -> Tuple[int, int]:
    """JAX's window sizing: ~50 ms at 50 TFLOP/s of its backward count (2.5
    forwards), at least 20 calls; a single pair of calls on the CPU."""
    if device.type != "cuda":
        return (1, 2)
    est_ms = 2.5 * C.attention_flops(b, s, h, d, causal) / 50e12 * 1e3
    hi = max(20, int(50.0 / est_ms))
    return (hi // 10, hi)


def main(device: Optional[str] = None, *, parity_shape=PARITY_SHAPE,
         parity_blocks: Tuple[int, int] = PARITY_BLOCKS, cases: Sequence = CASES,
         blocks: Sequence = BLOCKS, headline: Tuple[str, Tuple[int, int]] = HEADLINE,
         fit: Optional[Tuple[int, int]] = None) -> Dict[str, dict]:
    """JAX's ``main``: parity of dq, dk, dv (blocks 256) against the port's
    ``flash_attention_bwd`` under max abs over max 3e-2, causal and not;
    then per case ``flash_attention_bwd`` (K4 + K5) and each block of
    ``blocks`` that divides S timed (``k45_ms``, ``unrolled_ms``, JAX's
    ``t_ref / t`` as ``ratio``). On the ``headline`` row K20's launches
    (``k20_ms``) and K21's (``k21_ms``) are also timed alone on the call's
    ``di``, and on the card K5 (``k5_ms``, which computes di in its
    prologue) and K4 (``k4_ms``, on the call's ``di``) alone. Returns the
    rows by name; a failure raises."""
    dev = C.resolve_device(device)
    rng = np.random.default_rng(0)
    print("== parity ==", flush=True)
    rows: Dict[str, dict] = {}
    s, d = parity_shape[1], parity_shape[3]
    bq, bkv = (min(blk, s) for blk in parity_blocks)
    for causal in (False, True):
        (qs, ks, vs, os_, dos), (q, k, v, o, lse, do) = _prep(rng, parity_shape, causal, dev)
        ref = flash_attention_bwd(qs, ks, vs, os_, lse, dos, sm_scale=d ** -0.5, causal=causal)
        got = flash_bwd_unrolled(q, k, v, o, lse, do, sm_scale=d ** -0.5, causal=causal,
                                 block_q=bq, block_kv=bkv)
        for name, a, r in zip(("dq", "dk", "dv"), got, ref):
            a, r = a.float(), r.transpose(1, 2).float()
            rel = float((a - r).abs().max() / ((r.abs().max()) + 1e-9))
            print(f"causal={causal} {name}: rel {rel:.2e}", flush=True)
            if not rel < PARITY_GATE:
                raise AssertionError(f"flash_bwd_unrolled parity causal={causal} {name}: "
                                     f"{rel:.3e} >= {PARITY_GATE}")
            rows[f"parity causal={causal} {name}"] = {"rel_err": rel, "gate": PARITY_GATE}
    print("== perf ==", flush=True)
    for name, shape, causal in cases:
        b, s, h, d = shape
        (qs, ks, vs, os_, dos), (q, k, v, o, lse, do) = _prep(rng, shape, causal, dev)
        sm = d ** -0.5
        it = fit or _fit(b, s, h, d, causal, dev)
        fl = 2.5 * C.attention_flops(b, s, h, d, causal)
        t_ref = C.timed_ms(lambda: flash_attention_bwd(qs, ks, vs, os_, lse, dos, sm_scale=sm,
                                                       causal=causal), dev, it)
        for bq, bkv in blocks:
            if s % bq or s % bkv:
                continue
            kw = dict(sm_scale=sm, causal=causal, block_q=bq, block_kv=bkv)
            t = C.timed_ms(lambda: flash_bwd_unrolled(q, k, v, o, lse, do, **kw), dev, it)
            key = f"{name} unrolled bq={bq} bkv={bkv}"
            row = {"shape": shape, "causal": causal, "blocks": (bq, bkv), "unrolled_ms": t,
                   "k45_ms": t_ref, "ratio": t_ref / t, "flops": fl,
                   "launches": (s // bq, s // bkv)}
            line = (f"{key} ({dev.type}): {t:.4f} ms ({fl / t / 1e9:.1f} TF) vs grid (K4 + K5) "
                    f"{t_ref:.4f} ms -> {t_ref / t:.2f}x")
            if (name, (bq, bkv)) == headline:
                di = flash_bwd_di(o, do)
                row["k20_ms"] = C.timed_ms(lambda: dq_rowblocks(q, k, v, do, lse, di, **kw), dev,
                                           it)
                row["k21_ms"] = C.timed_ms(lambda: dkv_colblocks(q, k, v, do, lse, di, **kw),
                                           dev, it)
                line += f"; K20 alone {row['k20_ms']:.4f} ms, K21 alone {row['k21_ms']:.4f} ms"
                if dev.type == "cuda":  # K4/K5 have no CPU route of their own
                    row["k5_ms"] = C.timed_ms(lambda: flash_bwd_dq(qs, ks, vs, os_, lse, dos,
                                                                   sm_scale=sm, causal=causal),
                                              dev, it)
                    row["k4_ms"] = C.timed_ms(lambda: flash_bwd_dkv(qs, ks, vs, dos, lse, di,
                                                                    sm_scale=sm, causal=causal),
                                              dev, it)
                    line += f", K5 alone {row['k5_ms']:.4f} ms, K4 alone {row['k4_ms']:.4f} ms"
            rows[key] = row
            print(line, flush=True)
    return rows


if __name__ == "__main__":
    C.cli(main, "The unrolled-backward experiment (K20, K21) against K4 + K5.")
