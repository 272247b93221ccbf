"""The pipeline experiment's forward variants: kernels K16-K19.

Port of ``benchmarks/flash_pipeline_experiment.py``: its six variants of
the flash forward, each run by JAX as ``python
benchmarks/flash_pipeline_experiment.py [chunked|tri|i8|seg|fulltri]`` and
here as ``python -m
photonic_flash_attention_tpu_torch.experiments.flash_pipeline_experiment
[chunked|tri|i8|seg|fulltri] [--device cpu|cuda]`` (no variant: ``main``).

* :func:`flash_unrolled` (JAX's ``_kernel``): the KV loop unrolled in one
  body so QK(j+1) can overlap softmax(j). K16 (``pfa_flash_pipelined``) in
  bf16 is the Hopper body of ``csrc/flash_experiments_sm90.cu`` with one
  key tile of K1's width a TMA ring stage (128 keys at D 64, 96 at D 128),
  tile j+1's Q.K^T issued on ``wgmma`` before tile j's softmax and P.V
  (FA3's intra-warpgroup overlap, the lever), 128-row work tiles on K1's
  persistent grid (:func:`k16_plan`); fp32 inputs stay on the mma.sync
  body (QK(j+1) into a second score fragment, K/V double-buffered by
  ``cp.async``, counted as ``pfa_flash_pipelined_fp32``). JAX keeps a
  head's whole K/V in VMEM, a VMEM choice that does not carry over.
* :func:`flash_chunked` (``_kernel_chunked``): the KV loop in chunks of
  ``unroll`` tiles, one chunk a TPU grid step with the state carried in
  scratch, dead chunks skipped whole when causal. K17
  (``pfa_flash_chunked``) in bf16 is the Hopper body of
  ``csrc/flash_experiments_sm90.cu``: a ring stage is one chunk of
  ``unroll`` 64-key tiles, loaded by TMA under one mbarrier wait a chunk,
  its tiles unrolled at compile time on ``wgmma``, 128-row work tiles on
  K1's persistent grid (:func:`k17_plan`); fp32 inputs stay on the mma.sync
  body (one ``cp.async`` group and one barrier a chunk, counted as
  ``pfa_flash_chunked_fp32``). The chunk-granular causal skip is kept
  (tiles of a live chunk run, masked). The card takes ``unroll`` in
  :data:`CARD_UNROLLS`, counted in its own 64-key tiles, whatever
  ``block_kv``.
* :func:`flash_triangular` (``_kernel_tri``): causal, one launch per q
  row-block of ``block_q`` rows over a static kv extent of whole
  ``block_kv`` tiles, the mask only on tiles past the row-block's first
  row. K18 (``pfa_flash_tri``) is launched once per row-block with its
  first row and row count; each launch writes its rows in place into one
  output (JAX concatenates the pieces). In bf16 each launch is K16's
  Hopper body walking the row-block's 128-row q-blocks
  (:func:`k18_plan`), and every launch after a call's first is a
  programmatic dependent launch that may start on the SMs the one ahead of
  it frees; fp32 inputs stay on the mma.sync body (64-row CTAs, counted as
  ``pfa_flash_tri_fp32``). The static extent has no counterpart on the
  card: a work tile stops at its own diagonal, since the extent's tiles
  past it are wholly masked and add exactly nothing.
* :func:`flash_tri_i8` (``_kernel_tri_i8``): the same host loop with Q and
  K quantized per tensor to int8 (``ops/flash_fp8.py::_per_tensor_quant``,
  JAX's ``_quant_pt`` bit for bit), Q.K int8 x int8 -> int32 scaled in
  fp32 by the (1,) device scalar qs * ks * scale, P.V in bf16, output in
  V's dtype; causal or not (every row-block the full extent). K18's int8
  mode with a bf16 V (counted as ``pfa_flash_tri_i8``) is K1's Hopper
  int8-QK body (``csrc/flash_quant_sm90.cu``, ``flash_quant_sm90<D,
  INT8QK, true>``: TMA, s8 ``wgmma`` Q.K^T, bf16 ``wgmma`` P.V, the scale
  read on the device) over the row-block's 128-row work tiles on the
  persistent grid (:func:`k18_i8_plan`), rows past the row-block computed
  and not stored, every launch after a call's first chained as K18's bf16
  ones; an fp32 V stays on the s8 ``mma.sync`` body (64-row CTAs, counted
  as ``pfa_flash_tri_i8_fp32``).
* :func:`flash_segmented` (JAX's ``flash_segmented``, no kernel of its
  own): per q row-block, interior non-causal segments of at most
  ``seg_tiles`` tiles and one causal diagonal segment, each a call of
  ``ops/flash.py::flash_attention_with_lse`` (K1 with lse on the card),
  merged by :func:`lse_merge` (JAX's formula, plain PyTorch).
* :func:`flash_fulltri` (``_kernel_fulltri``): causal, a head's whole
  triangle in one body. K19 (``pfa_flash_fulltri``) runs one CTA per
  (b, h) that walks every 128-row q-block of its head, heaviest first
  (:func:`k19_plan`), streaming K/V tiles through a TMA ring with no drain
  between rows; the next row's Q and first K/V tile are in flight during
  the current row's last tile and epilogue. In bf16 the Hopper body of
  ``csrc/flash_experiments_sm90.cu`` (``wgmma``, warp-specialised); fp32
  inputs stay on the mma.sync body (64-row tiles by ``cp.async``, counted
  as ``pfa_flash_fulltri_fp32``). One CTA a head (48 at the headline B4
  H12, for 132 SMs) is the function measured: no split.

Contract (JAX's): q (B, S, Hq, D), k/v (B, S, Hkv, D), square, GQA (q head
h reads kv head h // (Hq/Hkv)), causal ``col <= row`` (top-left; K1's
diagonal for square shapes); q, k, v are cast to bf16 in the body and p to
bf16 before P.V, fp32 accumulate; output in q's dtype (tri_i8: V's). On
the card D in {64, 128}, bf16 or fp32 inputs (fp32 converted on load);
K16-K19's bf16 inputs on 16-byte-aligned bases (their TMA loads), with
sm_scale > 0 and S <= 65536, else ``ValueError``.
``block_q``/``block_kv`` are JAX's TPU tiles: the plain versions walk them,
the card kernels their own 64 x 64 tiles. JAX's grids are ``S // block``
(``S // (block_kv * unroll)`` for chunked) and silently drop the tail keys
or leave the tail rows unwritten where S is not a multiple: the port
raises. Each ``*_plain`` version is ``_common.online_plain`` with JAX's
``NEG_INF`` mask and initial max and a bf16 body; a kv block wholly above
the diagonal is skipped there, which is exact: JAX's chunked kernel runs
such blocks inside a live chunk, and each adds p = 0 with alpha = 1, since
every row's running max is finite after the first block (column 0).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import _build
from ..ops.flash import flash_attention, flash_attention_with_lse
from ..ops.flash import flash_attention_qk_quant
from ..ops.flash_fp8 import _qk_per_tensor, flash_attention_int8qk
from ..ops.flash_unrolled import flash_attention_unrolled
from ..ops.reference import softmax_scale
from . import _common as C

__all__ = ["ExpPlan", "I8Plan", "flash_chunked", "flash_chunked_plain", "flash_fulltri",
           "flash_fulltri_plain", "flash_segmented", "flash_tri_i8", "flash_tri_i8_plain",
           "flash_triangular", "flash_triangular_plain", "flash_unrolled", "flash_unrolled_plain",
           "k13_plan", "k14_plan", "k15_plan", "k16_plan", "k17_plan", "k18_i8_plan", "k18_plan",
           "k19_plan",
           "lse_merge", "main", "main_chunked", "main_fulltri", "main_i8", "main_seg", "main_tri"]

#: JAX's parity case and gate (max abs against ``flash_attention``).
PARITY_SHAPE = (1, 1024, 2, 64)
PARITY_GATE = 3e-2
#: JAX's perf cases: (name, (B, S, Hq, Hkv, D), causal).
CASES = (
    ("bf16 d64 b1 s8192 noncausal", (1, 8192, 12, 12, 64), False),
    ("bf16 d64 b4 s2048 causal", (4, 2048, 12, 12, 64), True),
    ("bf16 d128gqa b4 s4096 causal", (4, 4096, 32, 8, 128), True),
    ("bf16 d128gqa b4 s4096 noncausal", (4, 4096, 32, 8, 128), False),
)
CARD_DTYPES = (torch.bfloat16, torch.float32)
CARD_HEAD_DIMS = (64, 128)
#: The chunk lengths K17 is compiled for, in its 64-key tiles (JAX's
#: ``unroll`` values in ``main2``).
CARD_UNROLLS = (2, 4)
#: JAX's int8 parity gate: max abs over the reference's max abs.
I8_PARITY_GATE = 5e-2

#: ``main_chunked`` (JAX's ``main2``): parity blocks (block_q, block_kv,
#: unroll), perf cases (name, (B, S, Hq, Hkv, D), causal) and sweep.
CHUNKED_PARITY_SHAPE = (1, 2048, 2, 64)
CHUNKED_PARITY_CFGS = ((512, 512, 2), (512, 256, 4), (1024, 256, 4))
CHUNKED_CASES = (
    ("d64 b4 s2048 causal", (4, 2048, 12, 12, 64), True),
    ("d64 b1 s8192 causal", (1, 8192, 12, 12, 64), True),
    ("d64 b1 s8192 noncausal", (1, 8192, 12, 12, 64), False),
    ("d128gqa b4 s4096 causal", (4, 4096, 32, 8, 128), True),
    ("d128gqa b4 s4096 noncausal", (4, 4096, 32, 8, 128), False),
)
CHUNKED_SWEEP = ((512, 512, 2), (512, 256, 4), (1024, 256, 4), (1024, 512, 2), (512, 512, 4))
#: ``main_tri`` (``main3``): causal cases (name, (B, S, Hq, Hkv, D)) and
#: blocks.
TRI_PARITY_SHAPE = (1, 2048, 2, 64)
TRI_CASES = (
    ("d64 b4 s2048", (4, 2048, 12, 12, 64)),
    ("d64 b1 s8192", (1, 8192, 12, 12, 64)),
    ("d128gqa b4 s4096", (4, 4096, 32, 8, 128)),
)
TRI_BLOCKS = ((512, 512), (1024, 512), (512, 256))
#: ``main_i8`` (``main4``): cases (name, (B, S, Hq, Hkv, D), causal).
I8_PARITY_SHAPE = (1, 2048, 2, 64)
I8_CASES = (
    ("d64 b4 s2048 causal", (4, 2048, 12, 12, 64), True),
    ("d128gqa b4 s4096 causal", (4, 4096, 32, 8, 128), True),
    ("d128gqa b4 s4096 noncausal", (4, 4096, 32, 8, 128), False),
    ("d64 b1 s8192 causal", (1, 8192, 12, 12, 64), True),
)
#: ``main_seg`` (``main5``): causal cases (name, (B, S, H, D)); parity at
#: seg_tiles 2 (several segments merged), perf at :data:`SEG_TILES`.
SEG_PARITY_SHAPE = (1, 2048, 2, 64)
SEG_TILES = 12
SEG_BLOCK = 512
SEG_CASES = (("d64 b1 s16384", (1, 16384, 4, 64)), ("d64 b1 s32768", (1, 32768, 2, 64)))
#: ``main_fulltri`` (``main6``): parity at blocks 256, causal cases (name,
#: (B, S, Hq, Hkv, D)) against ``flash_attention_unrolled``.
FULLTRI_PARITY_SHAPE = (1, 1024, 2, 64)
FULLTRI_CASES = (("d64 b4 s2048", (4, 2048, 12, 12, 64)),
                 ("d128gqa b4 s2048", (4, 2048, 32, 8, 128)))
#: (B, S, Hq, Hkv, D, dtype) at which the card checks hold K17-K19 against
#: their plain versions: small, 64-ragged (S a multiple of 64, not of 128),
#: D 128 with GQA, fp32, then every geometry the mains above give them.
CARD_CHECK_SHAPES = ((2, 256, 4, 4, 64, torch.bfloat16), (1, 192, 4, 2, 64, torch.bfloat16),
                     (2, 320, 8, 2, 128, torch.bfloat16), (1, 192, 4, 1, 128, torch.float32),
                     (4, 2048, 12, 12, 64, torch.bfloat16), (1, 8192, 12, 12, 64, torch.bfloat16),
                     (4, 4096, 32, 8, 128, torch.bfloat16), (4, 2048, 32, 8, 128, torch.bfloat16))
CARD_CHECK_IDS = ("small", "ragged64", "gqa-d128", "fp32", "b4s2048", "s8192", "gqa-s4096",
                  "gqa-s2048")


def check_block(s: int, span: int = 1) -> int:
    """A card check's plain block: the largest of 512 ... 16 that divides
    S ``span`` times over."""
    return next(blk for blk in (512, 256, 128, 64, 32, 16) if s % (blk * span) == 0)


def check_tri_blocks(s: int) -> Tuple[Tuple[int, int], ...]:
    """The (block_q, block_kv) a card check gives K18 at length S: each of
    ``main_tri``'s :data:`TRI_BLOCKS` that divides S (its launches of 512
    and 1024 rows), else one of :func:`check_block`'s."""
    return (tuple(bk for bk in TRI_BLOCKS if s % bk[0] == 0 and s % bk[1] == 0)
            or ((check_block(s), check_block(s, 2)),))


# -- K13-K19's bf16 body: launch plans (csrc/flash_experiments_sm90.cu) -------

#: Dynamic shared memory a CTA may take on the H100 (``csrc/sm90.cuh``).
SMEM_MAX = 232448
#: Query rows of a work tile (two consumer warpgroups of 64; K15: nchain).
SM90_ROWS = 128
#: The longest S the bf16 body's walk holds (512 q-blocks, MAX_QB).
SM90_MAX_SEQ = 512 * SM90_ROWS


class ExpPlan(NamedTuple):
    """One launch of K13-K19's bf16 body, from the shapes alone: the C
    launcher takes every field, refuses a tile width, stage count, shared
    memory or grid that is not its own, and walks ``walk`` as it is.
    ``chunk_keys``: the keys of a ring stage (K13-K16, K18, K19: one
    tile); with two stages or more the next stage's Q.K^T is issued before
    this stage's last P.V. ``walk``: (q0, chunks) of the q-blocks of 128
    rows (K15: 64 nchain) in the order the work tiles take them: K19's CTA
    runs them in this order, and the persistent grid of K13-K18 gives
    q-block i to its work tiles t with t // (Hq B) == i; each runs its
    first ``chunks`` chunks of ``chunk_keys`` keys (K15: its chains a
    prefix each, to their own diagonals). The plan functions are cached: a
    launch pays for its plan once a shape."""
    tile_keys: int
    chunk_keys: int
    stages: int
    smem: int
    grid: int
    walk: Tuple[Tuple[int, int], ...]


def _sm90_smem(d: int, chunk_keys: int, stages: int, rows: int = SM90_ROWS,
               ones: int = 0) -> int:
    """Q (``rows`` a work tile) double-buffered, ``stages`` K and V blocks,
    K14's ``ones`` block, the mbarriers and 1024 bytes of alignment slack
    (``x_smem``)."""
    return (2 * rows * d * 2 + 2 * stages * chunk_keys * d * 2 + ones + 8 * (2 * stages + 4)
            + 1024)


def _sm90_stages(d: int, chunk_keys: int, rows: int = SM90_ROWS, ones: int = 0) -> int:
    """The most ring stages that fit (``x_max_stages``)."""
    n = 0
    while _sm90_smem(d, chunk_keys, n + 1, rows, ones) <= SMEM_MAX:
        n += 1
    return n


def _check_plan_shape(s: int, hq: int, hkv: int, d: int, name: str = "K16-K19") -> None:
    if d not in CARD_HEAD_DIMS:
        raise ValueError(f"{name} take head_dim in {CARD_HEAD_DIMS}, got {d}")
    if s < 1 or hkv < 1 or hq % hkv:
        raise ValueError(f"bad shape: S {s}, Hq {hq}, Hkv {hkv}")
    if s > SM90_MAX_SEQ:
        raise ValueError(f"{name}'s bf16 body takes S <= {SM90_MAX_SEQ} (its walk), got {s}")


def _walk(s: int, chunk_keys: int, causal: bool, row0: int = 0,
          row_end: Optional[int] = None, rows: int = SM90_ROWS,
          skv: Optional[int] = None) -> Tuple[Tuple[int, int], ...]:
    """The q-blocks of ``rows`` rows from ``row0`` up to ``row_end`` (S),
    causal ones heaviest (last) first, each with the chunks its rows see:
    those whose first key is at or below its last row below the row end
    when causal, every chunk of the ``skv`` (S) keys otherwise."""
    row_end = s if row_end is None else row_end
    skv = s if skv is None else skv
    q0s = range(row0, row_end, rows)
    return tuple((q0, -(-min(min(row_end, q0 + rows) if causal else skv, skv) // chunk_keys))
                 for q0 in (reversed(q0s) if causal else q0s))


def _wide_plan(s: int, d: int, grid: int, causal: bool, row0: int = 0,
               row_end: Optional[int] = None) -> ExpPlan:
    """A plan whose ring stage is one key tile of K1's width (K16, K18,
    K19: 128 keys at D 64, 96 at D 128, where 128 spills), as many stages
    as fit, over :func:`_walk`'s q-blocks."""
    tile = 96 if d == 128 else 128
    stages = _sm90_stages(d, tile)
    return ExpPlan(tile, tile, stages, _sm90_smem(d, tile, stages), grid,
                   _walk(s, tile, causal, row0, row_end))


@functools.lru_cache(maxsize=None)
def k19_plan(b: int, s: int, hq: int, hkv: int, d: int) -> ExpPlan:
    """K19's launch: one CTA per (b, h) (grid B x Hq); each walks its head's
    128-row q-blocks from the last, over key tiles of K1's width (128 at D
    64, 96 at D 128) up to the block's last row, one tile a stage, as many
    stages as fit."""
    _check_plan_shape(s, hq, hkv, d)
    return _wide_plan(s, d, b * hq, True)


@functools.lru_cache(maxsize=None)
def k16_plan(b: int, s: int, hq: int, hkv: int, d: int, causal: bool,
             sms: int = 132) -> ExpPlan:
    """K16's launch: K19's ring (one tile of K1's width a stage, as many
    stages as fit) on K1's persistent grid (min(work tiles, ``sms``) CTAs
    over every 128-row q-block of S in snake order, causal ones heaviest
    first and each up to its diagonal, else each over all of S)."""
    _check_plan_shape(s, hq, hkv, d)
    return _wide_plan(s, d, min(-(-s // SM90_ROWS) * hq * b, sms), causal)


@functools.lru_cache(maxsize=None)
def k13_plan(b: int, s: int, h: int, d: int, causal: bool, sms: int = 132) -> ExpPlan:
    """K13's launch (``flash_fixedmax_sm90``, K16's instantiation with the
    fixed-max step): K16's plan under K13's name, for H heads of q, k and
    v (no GQA) and D in (64, 128), S <= 65536."""
    _check_plan_shape(s, h, h, d, "K13")
    return _wide_plan(s, d, min(-(-s // SM90_ROWS) * h * b, sms), causal)


@functools.lru_cache(maxsize=None)
def k18_plan(b: int, s: int, hq: int, hkv: int, d: int, q_row0: int, rows: int,
             sms: int = 132) -> ExpPlan:
    """One K18 launch, of rows [``q_row0``, ``q_row0 + rows``): K16's body
    over the 128-row q-blocks from ``q_row0`` (any row) up to the row end,
    heaviest first, each over the key tiles up to its last row below the
    row end; grid min(work tiles, ``sms``)."""
    _check_plan_shape(s, hq, hkv, d)
    if not 0 <= q_row0 < s:
        raise ValueError(f"K18: q_row0 must lie in [0, S {s}), got {q_row0}")
    if rows <= 0 or q_row0 + rows > s:
        raise ValueError(f"K18: rows must be > 0 and end at or before S {s}, got {rows} rows "
                         f"from {q_row0}")
    return _wide_plan(s, d, min(-(-rows // SM90_ROWS) * hq * b, sms), True, q_row0,
                      q_row0 + rows)


class I8Plan(NamedTuple):
    """One launch of K18's int8 mode (bf16 V) on K1's Hopper int8-QK body
    (``csrc/flash_quant_sm90.cu``, ``flash_quant_sm90<D, INT8QK, true>``),
    from the shapes alone: its work tiles (the 128-row blocks of its range
    x Hq x B), the persistent grid (min(work tiles, SMs)), and the ring's
    stages and dynamic shared memory (``Cfg<D, INT8QK>``), which the C
    launcher checks against its own. The kernel's work tile t runs the
    range's 128-row q-block t // (Hq B), counted from the last when causal,
    over the 128-key tiles up to the q-block's last row (all of S when not
    causal), its rows past the range end computed and not stored."""
    work: int
    grid: int
    stages: int
    smem: int


#: Query rows of K18 int8's work tile and keys of its ring stage (the
#: quantized body's BQ and BKV).
I8_ROWS = 128


def _k18_i8_ring(d: int) -> Tuple[int, int]:
    """K18 int8's ring at head dim ``d`` (``Cfg<D, INT8QK>``): int8 Q of a
    work tile double-buffered, stages of int8 K and bf16 V, as many (4 to
    2) as fit beside the mbarriers and the alignment slack; (stages,
    dynamic shared memory)."""
    q, stage = I8_ROWS * d, I8_ROWS * d * 3
    fixed = 2 * q + 8 * 12 + 1024
    stages = next(n for n in (4, 3, 2) if n == 2 or fixed + n * (stage + 16) <= SMEM_MAX)
    return stages, 2 * q + stages * stage + 8 * (2 * stages + 12) + 1024


@functools.lru_cache(maxsize=None)
def k18_i8_plan(b: int, s: int, hq: int, hkv: int, d: int, q_row0: int, rows: int,
                sms: int = 132) -> I8Plan:
    """One launch of K18's int8 mode with a bf16 V: query rows
    [``q_row0``, ``q_row0 + rows``) (any first row) of every (b, h), on K1's
    Hopper int8-QK body."""
    if d not in CARD_HEAD_DIMS:
        raise ValueError(f"K18 int8 takes head_dim in {CARD_HEAD_DIMS} on the card, got {d}")
    if b < 1 or s < 1 or hkv < 1 or hq % hkv:
        raise ValueError(f"bad shape: B {b}, S {s}, Hq {hq}, Hkv {hkv}")
    if not 0 <= q_row0 < s or rows < 1 or q_row0 + rows > s:
        raise ValueError(f"K18 int8: the rows must lie in [0, S {s}), got {rows} rows from "
                         f"{q_row0}")
    work = -(-rows // I8_ROWS) * hq * b
    return I8Plan(work, min(work, sms), *_k18_i8_ring(d))


@functools.lru_cache(maxsize=None)
def k17_plan(b: int, s: int, hq: int, hkv: int, d: int, unroll: int, *, causal: bool = True,
             sms: int = 132) -> ExpPlan:
    """K17's launch: a ring stage is one chunk of ``unroll`` 64-key tiles;
    as many stages as fit (one at D 128 unroll 4: no cross-chunk overlap);
    K1's persistent grid (min(work tiles, ``sms``) CTAs walking the 128-row
    work tiles in snake order: heads fastest, then batch rows, then the
    walk's q-blocks, causal ones longest first)."""
    _check_plan_shape(s, hq, hkv, d)
    if unroll not in CARD_UNROLLS:
        raise ValueError(f"K17 takes unroll in {CARD_UNROLLS} on the card, got {unroll}")
    span = 64 * unroll
    stages = _sm90_stages(d, span)
    grid = min(-(-s // SM90_ROWS) * hq * b, sms)
    return ExpPlan(64, span, stages, _sm90_smem(d, span, stages), grid, _walk(s, span, causal))


#: K14's B operand of the ones product in shared memory (``XCfg::ONES_BYTES``).
K14_ONES_BYTES = 256
#: K15's key tile at each chain count the card takes (``PAIR_BKV``): the
#: widest whose consumer warpgroup holds its registers with no spill.
K15_TILE_KEYS = {1: 128, 2: 128, 3: 128, 4: 64}
#: The longest Skv K14 and K15 take (1024 tiles of 64 keys, ``MAX_KEYS``).
K14_K15_MAX_KEYS = 65536


def _check_k14_k15_shape(sq: int, skv: int, h: int, rows: int) -> None:
    if sq < 1 or skv < 1 or h < 1:
        raise ValueError(f"bad shape: Sq {sq}, Skv {skv}, H {h}")
    if -(-sq // rows) > 512 or skv > K14_K15_MAX_KEYS:
        raise ValueError(f"the bf16 body takes Sq <= {512 * rows} (its walk of {rows}-row "
                         f"q-blocks) and Skv <= {K14_K15_MAX_KEYS}, got Sq {sq}, Skv {skv}")


@functools.lru_cache(maxsize=None)
def k14_plan(b: int, sq: int, skv: int, h: int, sms: int = 132) -> ExpPlan:
    """K14's launch (D 64, causal ``col <= row``): K16's instantiation, 128
    keys a stage and as many stages as fit beside the ones block, on K1's
    persistent grid (min(work tiles, ``sms``) CTAs) over the 128-row
    q-blocks of Sq heaviest first, each over the key tiles up to its last
    row below Sq and inside Skv."""
    _check_k14_k15_shape(sq, skv, h, SM90_ROWS)
    stages = _sm90_stages(64, 128, ones=K14_ONES_BYTES)
    return ExpPlan(128, 128, stages, _sm90_smem(64, 128, stages, ones=K14_ONES_BYTES),
                   min(-(-sq // SM90_ROWS) * h * b, sms), _walk(sq, 128, True, skv=skv))


@functools.lru_cache(maxsize=None)
def k15_plan(b: int, sq: int, skv: int, h: int, nchain: int, sms: int = 132) -> ExpPlan:
    """K15's launch (D 64, causal): a work tile is ``nchain`` chains of 64
    rows, one consumer warpgroup each, against one ring stage of
    ``K15_TILE_KEYS[nchain]`` keys; as many stages as fit; K1's persistent
    grid over the q-blocks of 64 ``nchain`` rows of Sq heaviest first, each
    over the key tiles its last chain's rows below Sq see inside Skv (each
    chain stops at its own diagonal in the kernel)."""
    if nchain not in K15_TILE_KEYS:
        raise ValueError(f"K15 takes nchain in {tuple(K15_TILE_KEYS)} on the card, got {nchain}")
    rows, tile = 64 * nchain, K15_TILE_KEYS[nchain]
    _check_k14_k15_shape(sq, skv, h, rows)
    stages = _sm90_stages(64, tile, rows)
    return ExpPlan(tile, tile, stages, _sm90_smem(64, tile, stages, rows),
                   min(-(-sq // rows) * h * b, sms), _walk(sq, tile, True, rows=rows, skv=skv))


@functools.lru_cache(maxsize=None)
def _c_walk(walk: Tuple[Tuple[int, int], ...]):
    """A plan's walk as the C launcher reads it: int[2 x q-blocks]."""
    return (ctypes.c_int * (2 * len(walk)))(*(x for pair in walk for x in pair))


def _check_sm90(name: str, scale: float, *tensors: torch.Tensor) -> None:
    """What the bf16 body takes beyond :func:`C.check_card`: 16-byte-aligned
    bases (TMA) and sm_scale > 0 (the scale folded into the exponent)."""
    if not scale > 0.0:
        raise ValueError(f"{name}'s bf16 body takes sm_scale > 0, got {scale}")
    C.check_aligned(name, *tensors)


def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check(q, k, v, block_q: int, block_kv: int) -> None:
    C.check_qkv(q, k, v, gqa=True)
    C.check_blocks(q.shape[1], block_q, "block_q")
    C.check_blocks(q.shape[1], block_kv, "block_kv")


def flash_unrolled_plain(q, k, v, *, block_q: int = 512, block_kv: int = 512,
                         causal: bool = False, sm_scale: Optional[float] = None
                         ) -> torch.Tensor:
    """K16's plain version on JAX's blocks: q, k, v in bf16, s = q.k^T *
    scale (fp32), masked at -1e30, the running max from -1e30, p to bf16
    for P.V; every kv block visited, as JAX's body does."""
    _check(q, k, v, block_q, block_kv)
    return C.online_plain(q, k, v, bq=block_q, bkv=block_kv, causal=causal,
                          scale=softmax_scale(q.shape[-1], sm_scale), bf16_body=True,
                          mask_value=C.NEG_INF, skip_dead=False, m_init=C.NEG_INF)


def _unrolled_cuda(q, k, v, causal: bool, scale: float) -> torch.Tensor:
    """K16: bf16 on the Hopper body by :func:`k16_plan`, counted as
    ``pfa_flash_pipelined``; fp32 on the mma.sync body, counted as
    ``pfa_flash_pipelined_fp32``."""
    name = "K16 pfa_flash_pipelined"
    C.check_card(q, CARD_DTYPES, CARD_HEAD_DIMS, name, k, v)
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    o = torch.empty_like(q)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr())
    if q.dtype != torch.bfloat16:
        _build.launch("pfa_flash_pipelined", q.device, *ptrs, b, s, hq, hkv, d, float(scale),
                      int(causal), _build.DTYPE_CODES[q.dtype],
                      count_as="pfa_flash_pipelined_fp32")
        return o
    _check_sm90(name, scale, q, k, v)
    plan = k16_plan(b, s, hq, hkv, d, causal, _sms(q.device))
    _build.launch("pfa_flash_pipelined_sm90", q.device, *ptrs, b, s, hq, hkv, d, float(scale),
                  int(causal), plan.tile_keys, plan.stages, plan.smem, plan.grid,
                  _c_walk(plan.walk), count_as="pfa_flash_pipelined")
    return o


def flash_unrolled(q, k, v, *, block_q: int = 512, block_kv: int = 512, causal: bool = False,
                   sm_scale: Optional[float] = None) -> torch.Tensor:
    """(B, S, Hq, D) flash forward. K16 on the card,
    :func:`flash_unrolled_plain` on the CPU."""
    _check(q, k, v, block_q, block_kv)
    scale = softmax_scale(q.shape[-1], sm_scale)
    return C.on_device(
        q,
        lambda: _unrolled_cuda(q, k, v, causal, scale),
        lambda: flash_unrolled_plain(q, k, v, block_q=block_q, block_kv=block_kv, causal=causal,
                                     sm_scale=sm_scale),
    )


# -- K17: chunked KV staging (JAX's _kernel_chunked) --------------------------


def _check_chunked(q, k, v, block_q: int, block_kv: int, unroll: int) -> None:
    C.check_qkv(q, k, v, gqa=True)
    if unroll < 1:
        raise ValueError(f"unroll must be >= 1, got {unroll}")
    C.check_blocks(q.shape[1], block_q, "block_q")
    C.check_blocks(q.shape[1], block_kv * unroll, "block_kv * unroll")


def flash_chunked_plain(q, k, v, *, block_q: int = 512, block_kv: int = 512, unroll: int = 4,
                        causal: bool = False, sm_scale: Optional[float] = None) -> torch.Tensor:
    """K17's plain version on JAX's blocks (its chunks are ``unroll`` of
    them in order, the same online softmax)."""
    _check_chunked(q, k, v, block_q, block_kv, unroll)
    return C.online_plain(q, k, v, bq=block_q, bkv=block_kv, causal=causal,
                          scale=softmax_scale(q.shape[-1], sm_scale), bf16_body=True,
                          mask_value=C.NEG_INF, m_init=C.NEG_INF)


def _chunked_cuda(q, k, v, unroll: int, causal: bool, scale: float) -> torch.Tensor:
    """K17: bf16 on the Hopper body by :func:`k17_plan`, counted as
    ``pfa_flash_chunked``; fp32 on the mma.sync body, counted as
    ``pfa_flash_chunked_fp32``."""
    name = "K17 pfa_flash_chunked"
    C.check_card(q, CARD_DTYPES, CARD_HEAD_DIMS, name, k, v)
    if unroll not in CARD_UNROLLS:
        raise ValueError(f"{name} takes unroll in {CARD_UNROLLS} on the card "
                         f"(64-key tiles a chunk), got {unroll}")
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    o = torch.empty_like(q)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr())
    if q.dtype != torch.bfloat16:
        _build.launch("pfa_flash_chunked", q.device, *ptrs, b, s, hq, hkv, d, float(scale),
                      int(causal), int(unroll), _build.DTYPE_CODES[q.dtype],
                      count_as="pfa_flash_chunked_fp32")
        return o
    _check_sm90(name, scale, q, k, v)
    plan = k17_plan(b, s, hq, hkv, d, unroll, causal=causal, sms=_sms(q.device))
    _build.launch("pfa_flash_chunked_sm90", q.device, *ptrs, b, s, hq, hkv, d, float(scale),
                  int(causal), int(unroll), plan.tile_keys, plan.stages, plan.smem, plan.grid,
                  _c_walk(plan.walk), count_as="pfa_flash_chunked")
    return o


def flash_chunked(q, k, v, *, block_q: int = 512, block_kv: int = 512, unroll: int = 4,
                  causal: bool = False, sm_scale: Optional[float] = None) -> torch.Tensor:
    """(B, S, Hq, D) flash forward over kv chunks of ``unroll`` tiles. K17
    on the card (chunks of ``unroll`` 64-key tiles), :func:`flash_chunked_plain`
    on the CPU."""
    _check_chunked(q, k, v, block_q, block_kv, unroll)
    scale = softmax_scale(q.shape[-1], sm_scale)
    return C.on_device(
        q,
        lambda: _chunked_cuda(q, k, v, unroll, causal, scale),
        lambda: flash_chunked_plain(q, k, v, block_q=block_q, block_kv=block_kv, unroll=unroll,
                                    causal=causal, sm_scale=sm_scale),
    )


# -- K18: one launch per q row-block (JAX's _kernel_tri, _kernel_tri_i8) ------


def _tri_cuda(q, k, v, block_q: int, causal: bool, scale: float,
              score_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One K18 launch per row-block of ``block_q`` rows, each writing its
    rows of one output in place (a work tile stops at its own diagonal when
    causal: JAX's static extent adds only wholly masked tiles), every launch
    of a Hopper body after the call's first a programmatic dependent launch.
    bf16 on the experiments' Hopper body by :func:`k18_plan` (causal),
    counted as ``pfa_flash_tri``; fp32 on the mma.sync body, counted as
    ``pfa_flash_tri_fp32``. With ``score_scale`` q and k are int8 payloads
    and the output is in V's dtype: a bf16 V on K1's Hopper int8-QK body by
    :func:`k18_i8_plan`, counted as ``pfa_flash_tri_i8``; an fp32 V on the
    s8 mma.sync body, counted as ``pfa_flash_tri_i8_fp32``. A Hopper body's
    unaligned base raises ``ValueError`` before any launch."""
    int8 = score_scale is not None
    name = "K18 pfa_flash_tri" + ("_i8" if int8 else "")
    C.check_card(v, CARD_DTYPES, CARD_HEAD_DIMS, name, q, k)
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    o = torch.empty(q.shape, dtype=v.dtype, device=q.device)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr())
    if int8 and v.dtype == torch.bfloat16:
        C.check_aligned(name, q, k, v)
        sms = _sms(q.device)
        for i in range(s // block_q):
            plan = k18_i8_plan(b, s, hq, hkv, d, i * block_q, block_q, sms)
            _build.launch("pfa_flash_tri_i8_sm90", q.device, *ptrs, score_scale.data_ptr(), b, s,
                          hq, hkv, d, i * block_q, block_q, int(causal), int(i > 0), plan.stages,
                          plan.smem, plan.grid, count_as="pfa_flash_tri_i8")
        return o
    if int8 or q.dtype != torch.bfloat16:
        sc = score_scale.data_ptr() if int8 else None
        for i in range(s // block_q):
            _build.launch("pfa_flash_tri", q.device, *ptrs, sc, b, s, hq, hkv, d, i * block_q,
                          block_q, float(scale), int(causal), int(int8),
                          _build.DTYPE_CODES[v.dtype],
                          count_as="pfa_flash_tri_i8_fp32" if int8 else "pfa_flash_tri_fp32")
        return o
    _check_sm90(name, scale, q, k, v)
    sms = _sms(q.device)
    for i in range(s // block_q):
        plan = k18_plan(b, s, hq, hkv, d, i * block_q, block_q, sms)
        _build.launch("pfa_flash_tri_sm90", q.device, *ptrs, b, s, hq, hkv, d, i * block_q,
                      block_q, float(scale), int(i > 0), plan.tile_keys, plan.stages, plan.smem,
                      plan.grid, _c_walk(plan.walk), count_as="pfa_flash_tri")
    return o


def _check_tri(q, k, v, block_q: int, block_kv: int) -> None:
    C.check_qkv(q, k, v, gqa=True)
    C.check_blocks(q.shape[1], block_q, "block_q")
    C.check_blocks(q.shape[1], block_kv, "block_kv")


def flash_triangular_plain(q, k, v, *, block_q: int = 512, block_kv: int = 512,
                           sm_scale: Optional[float] = None) -> torch.Tensor:
    """K18's plain version: causal, each q row-block over its static extent
    (the kv blocks up to its last row) on JAX's blocks."""
    _check_tri(q, k, v, block_q, block_kv)
    return C.online_plain(q, k, v, bq=block_q, bkv=block_kv, causal=True,
                          scale=softmax_scale(q.shape[-1], sm_scale), bf16_body=True,
                          mask_value=C.NEG_INF, m_init=C.NEG_INF)


def flash_triangular(q, k, v, *, block_q: int = 512, block_kv: int = 512,
                     sm_scale: Optional[float] = None) -> torch.Tensor:
    """Causal (B, S, Hq, D) flash forward, one call per q row-block over a
    static extent. K18 on the card, :func:`flash_triangular_plain` on the
    CPU."""
    _check_tri(q, k, v, block_q, block_kv)
    scale = softmax_scale(q.shape[-1], sm_scale)
    return C.on_device(
        q,
        lambda: _tri_cuda(q, k, v, block_q, True, scale),
        lambda: flash_triangular_plain(q, k, v, block_q=block_q, block_kv=block_kv,
                                       sm_scale=sm_scale),
    )


def quant_qk(q, k, sm_scale: Optional[float] = None):
    """Per-tensor int8 Q and K (JAX's ``_quant_pt``: absmax / 127, round
    half to even, clip at +-127) and the (1,) fp32 score scale qs * ks *
    scale, on q's device."""
    return _qk_per_tensor(q, k, torch.int8, 127.0, softmax_scale(q.shape[-1], sm_scale))


def _tri_i8_payload_plain(q8, k8, score_scale, v, block_q: int, block_kv: int,
                          causal: bool) -> torch.Tensor:
    """K18 int8 mode's plain version on the payloads: s = (q8 . k8^T exact
    in fp32) * the score scale, p and V in bf16, output in V's dtype (the
    payloads go in as V's dtype: exact)."""
    return C.online_plain(q8.to(v.dtype), k8.to(v.dtype), v, bq=block_q, bkv=block_kv,
                          causal=causal, scale=score_scale, bf16_body=True, mask_value=C.NEG_INF,
                          m_init=C.NEG_INF)


def _tri_i8_payloads(q8, k8, score_scale, v, block_q: int, block_kv: int,
                     causal: bool) -> torch.Tensor:
    """The int8 variant after its quantization (:func:`quant_qk`'s
    payloads and score scale): K18's int8 mode alone on the card, its plain
    version on the CPU."""
    return C.on_device(
        v, lambda: _tri_cuda(q8, k8, v, block_q, causal, 0.0, score_scale=score_scale),
        lambda: _tri_i8_payload_plain(q8, k8, score_scale, v, block_q, block_kv, causal))


def flash_tri_i8_plain(q, k, v, *, block_q: int = 512, block_kv: int = 512, causal: bool = True,
                       sm_scale: Optional[float] = None) -> torch.Tensor:
    """K18 int8 mode's plain version: Q and K quantized by :func:`quant_qk`,
    then the payloads' blockwise online softmax."""
    _check_tri(q, k, v, block_q, block_kv)
    return _tri_i8_payload_plain(*quant_qk(q, k, sm_scale), v, block_q, block_kv, causal)


def flash_tri_i8(q, k, v, *, block_q: int = 512, block_kv: int = 512, causal: bool = True,
                 sm_scale: Optional[float] = None) -> torch.Tensor:
    """(B, S, Hq, D) flash forward with per-tensor int8 Q.K, one call per q
    row-block. K18's int8 mode on the card (the quantization in plain
    PyTorch before it), :func:`flash_tri_i8_plain` on the CPU."""
    _check_tri(q, k, v, block_q, block_kv)
    return C.on_device(
        q, lambda: _tri_i8_payloads(*quant_qk(q, k, sm_scale), v, block_q, block_kv, causal),
        lambda: flash_tri_i8_plain(q, k, v, block_q=block_q, block_kv=block_kv, causal=causal,
                                   sm_scale=sm_scale),
    )


# -- segmented: K1 with lse per segment, merged by logsumexp ------------------


def lse_merge(o_acc: torch.Tensor, lse_acc: torch.Tensor, o_i: torch.Tensor,
              lse_i: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge two partial softmax results over disjoint keys: o (B, S, H, D)
    fp32, lse (B, H, S) natural log; JAX's formula with its ``isfinite``
    guards (a side whose lse is -inf weighs 0; both -inf leave o 0)."""
    m = torch.maximum(lse_acc, lse_i)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    w1 = torch.where(torch.isfinite(lse_acc), torch.exp(lse_acc - m_safe), 0.0)
    w2 = torch.where(torch.isfinite(lse_i), torch.exp(lse_i - m_safe), 0.0)
    den = torch.where(w1 + w2 == 0.0, 1.0, w1 + w2)
    o = o_acc * (w1 / den).transpose(1, 2)[..., None] + o_i * (w2 / den).transpose(1, 2)[..., None]
    return o, m_safe + torch.log(den)


def segments(i: int, n_kv: int, seg_tiles: int, causal: bool):
    """Row-block ``i``'s (first tile, tiles, diagonal) segments: interior
    non-causal runs of at most ``seg_tiles`` tiles, then, when causal, the
    diagonal tile alone."""
    kv_tiles = i + 1 if causal else n_kv
    interior = kv_tiles - 1 if causal else kv_tiles
    segs = [(s0, min(seg_tiles, interior - s0), False) for s0 in range(0, interior, seg_tiles)]
    return segs + [(kv_tiles - 1, 1, True)] if causal else segs


def flash_segmented(q, k, v, *, causal: bool = True, block_q: int = 512, block_kv: int = 512,
                    seg_tiles: int = 12, sm_scale: Optional[float] = None) -> torch.Tensor:
    """(B, S, Hq, D) flash forward, per q row-block a few segment calls of
    ``flash_attention_with_lse`` (K1 with lse on the card, its plain version
    on the CPU) merged by :func:`lse_merge`; the diagonal segment is causal
    on square local coordinates, so ``block_q`` must equal ``block_kv``.
    On the CPU it differs from JAX's function by p's rounding: K1's plain
    version keeps p in fp32 where JAX's unrolled body rounds it to bf16."""
    C.check_qkv(q, k, v, gqa=True)
    if block_q != block_kv:
        raise ValueError(f"flash_segmented: the diagonal segment needs square tiles, "
                         f"block_q {block_q} != block_kv {block_kv}")
    if seg_tiles < 1:
        raise ValueError(f"seg_tiles must be >= 1, got {seg_tiles}")
    C.check_blocks(q.shape[1], block_q, "block_q")
    scale = softmax_scale(q.shape[-1], sm_scale)
    out = torch.empty_like(q)
    for i in range(q.shape[1] // block_q):
        r0 = i * block_q
        qb = q[:, r0:r0 + block_q].contiguous()
        o_acc = lse_acc = None
        for t0, n, diag in segments(i, q.shape[1] // block_kv, seg_tiles, causal):
            c0, c1 = t0 * block_kv, (t0 + n) * block_kv
            o_i, lse_i = flash_attention_with_lse(qb, k[:, c0:c1].contiguous(),
                                                  v[:, c0:c1].contiguous(), causal=diag,
                                                  sm_scale=scale)
            if o_acc is None:
                o_acc, lse_acc = o_i.float(), lse_i
            else:
                o_acc, lse_acc = lse_merge(o_acc, lse_acc, o_i.float(), lse_i)
        out[:, r0:r0 + block_q] = o_acc.to(q.dtype)
    return out


# -- K19: one CTA per head walks the whole triangle (JAX's _kernel_fulltri) ---


def flash_fulltri_plain(q, k, v, *, block_q: int = 512, block_kv: int = 512,
                        sm_scale: Optional[float] = None) -> torch.Tensor:
    """K19's plain version: every q block of a head over the kv blocks up to
    its last row, on JAX's blocks: the function of
    :func:`flash_triangular_plain`."""
    return flash_triangular_plain(q, k, v, block_q=block_q, block_kv=block_kv,
                                  sm_scale=sm_scale)


def _fulltri_cuda(q, k, v, scale: float) -> torch.Tensor:
    """K19: bf16 on the Hopper body by :func:`k19_plan`, counted as
    ``pfa_flash_fulltri``; fp32 on the mma.sync body, counted as
    ``pfa_flash_fulltri_fp32``."""
    name = "K19 pfa_flash_fulltri"
    C.check_card(q, CARD_DTYPES, CARD_HEAD_DIMS, name, k, v)
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    o = torch.empty_like(q)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr())
    if q.dtype != torch.bfloat16:
        _build.launch("pfa_flash_fulltri", q.device, *ptrs, b, s, hq, hkv, d, float(scale),
                      _build.DTYPE_CODES[q.dtype], count_as="pfa_flash_fulltri_fp32")
        return o
    _check_sm90(name, scale, q, k, v)
    plan = k19_plan(b, s, hq, hkv, d)
    _build.launch("pfa_flash_fulltri_sm90", q.device, *ptrs, b, s, hq, hkv, d, float(scale),
                  plan.tile_keys, plan.stages, plan.smem, plan.grid, _c_walk(plan.walk),
                  count_as="pfa_flash_fulltri")
    return o


def flash_fulltri(q, k, v, *, block_q: int = 512, block_kv: int = 512,
                  sm_scale: Optional[float] = None) -> torch.Tensor:
    """Causal (B, S, Hq, D) flash forward, a head's whole triangle in one
    body. K19 on the card, :func:`flash_fulltri_plain` on the CPU."""
    _check_tri(q, k, v, block_q, block_kv)
    scale = softmax_scale(q.shape[-1], sm_scale)
    return C.on_device(
        q,
        lambda: _fulltri_cuda(q, k, v, scale),
        lambda: flash_fulltri_plain(q, k, v, block_q=block_q, block_kv=block_kv,
                                    sm_scale=sm_scale),
    )


def _fit(flops: float, device: torch.device, rate: float = 60e12,
         least: int = 30) -> Tuple[int, int]:
    """JAX's window sizing: ~60 ms at ``rate`` FLOP/s, at least ``least``
    calls; a single pair of calls on the CPU."""
    if device.type != "cuda":
        return (1, 2)
    hi = max(least, int(60.0 / (flops / rate * 1e3)))
    return (hi // 10, hi)


def main(device: Optional[str] = None, *, parity_shape=PARITY_SHAPE, cases: Sequence = CASES,
         fit: Optional[Tuple[int, int]] = None, slice_len: int = 1024) -> Dict[str, dict]:
    """JAX's ``main``: parity (bf16 q, k, v) against the port's
    ``flash_attention`` (K1) under max abs 3e-2, causal and not; then each
    perf case timed against K1, with the error against the fp32 oracle on a
    (1, ``slice_len``) slice. Returns the rows by name."""
    dev = C.resolve_device(device)
    rng = np.random.default_rng(0)
    print("== parity ==", flush=True)
    q, k, v = (C.normal(rng, parity_shape, torch.bfloat16, dev) for _ in range(3))
    rows = {}
    blk = min(512, parity_shape[1])
    for causal in (False, True):
        a = flash_unrolled(q, k, v, causal=causal, block_q=blk, block_kv=blk)
        r = flash_attention(q, k, v, causal=causal)
        err = float((a.float() - r.float()).abs().max())
        print(f"causal={causal}: max abs err {err:.2e}", flush=True)
        if not err < PARITY_GATE:
            raise AssertionError(f"flash_unrolled parity causal={causal}: {err:.3e}")
        rows[f"parity causal={causal}"] = {"max_abs_err": err, "gate": PARITY_GATE}
    print("== perf ==", flush=True)
    for name, (b, s, hq, hkv, d), causal in cases:
        qq = C.normal(rng, (b, s, hq, d), torch.bfloat16, dev)
        kk, vv = (C.normal(rng, (b, s, hkv, d), torch.bfloat16, dev) for _ in range(2))
        fl = C.attention_flops(b, s, hq, d, causal)
        it = fit or _fit(fl, dev)
        blk = min(512, s)
        sl = min(slice_len, s)
        qs, ks, vs = (t[:1, :sl] for t in (qq, kk, vv))
        err = C.rel_err_norm(flash_unrolled(qs, ks, vs, causal=causal, block_q=min(512, sl),
                                            block_kv=min(512, sl)),
                             C.oracle(qs, ks, vs, causal=causal))
        t_new = C.timed_ms(lambda: flash_unrolled(qq, kk, vv, causal=causal, block_q=blk,
                                                  block_kv=blk), dev, it)
        t_ref = C.timed_ms(lambda: flash_attention(qq, kk, vv, causal=causal), dev, it)
        rows[name] = {"shape": (b, s, hq, hkv, d), "causal": causal, "unrolled_ms": t_new,
                      "k1_ms": t_ref, "flops": fl, "rel_err": err}
        print(f"{name} ({dev.type}): unrolled {t_new:.4f} ms ({fl / t_new / 1e9:.1f} TF) vs "
              f"grid (K1) {t_ref:.4f} ms ({fl / t_ref / 1e9:.1f} TF) -> {t_ref / t_new:.2f}x, "
              f"rel-err {err:.2e}", flush=True)
    return rows


def _inputs(rng: np.random.Generator, shape, dev: torch.device):
    """bf16 q (B, S, Hq, D) and k, v (B, S, Hkv, D) from ``rng``."""
    b, s, hq, hkv, d = shape
    return (C.normal(rng, (b, s, hq, d), torch.bfloat16, dev),
            *(C.normal(rng, (b, s, hkv, d), torch.bfloat16, dev) for _ in range(2)))


def _parity(rows: dict, key: str, a: torch.Tensor, r: torch.Tensor, *,
            relative: bool = False) -> None:
    """JAX's parity gate: max abs under 3e-2, or with ``relative`` max abs
    over the reference's max abs under 5e-2 (int8)."""
    a, r = a.float(), r.float()
    err = float((a - r).abs().max())
    gate = PARITY_GATE
    if relative:
        err, gate = err / (float(r.abs().max()) + 1e-9), I8_PARITY_GATE
    print(f"{key}: {'rel' if relative else 'max abs'} err {err:.2e} (gate {gate})", flush=True)
    if not err < gate:
        raise AssertionError(f"{key}: parity error {err:.3e} >= {gate}")
    rows[key] = {"max_abs_err" if not relative else "rel_err": err, "gate": gate}


def _slice_err(fn, q, k, v, causal: bool, slice_len: int) -> float:
    """rel_err_norm of ``fn`` against the fp32 oracle on a (1, ``slice_len``)
    slice."""
    sl = min(slice_len, q.shape[1])
    qs, ks, vs = (t[:1, :sl] for t in (q, k, v))
    return C.rel_err_norm(fn(qs, ks, vs), C.oracle(qs, ks, vs, causal=causal))


def _line(name: str, dev, variant: str, t: float, fl: float, ref: str, t_ref: float,
          err: float) -> None:
    print(f"{name} ({dev.type}): {variant} {t:.4f} ms ({fl / t / 1e9:.1f} TF) vs {ref} "
          f"{t_ref:.4f} ms ({fl / t_ref / 1e9:.1f} TF) -> {t_ref / t:.2f}x, rel-err {err:.2e}",
          flush=True)


def main_chunked(device: Optional[str] = None, *, parity_shape=CHUNKED_PARITY_SHAPE,
                 parity_cfgs: Sequence = CHUNKED_PARITY_CFGS, cases: Sequence = CHUNKED_CASES,
                 sweep: Optional[Sequence] = None, fit: Optional[Tuple[int, int]] = None,
                 slice_len: int = 1024) -> Dict[str, dict]:
    """JAX's ``main2``: parity (bf16) of each (block_q, block_kv, unroll) of
    ``parity_cfgs`` against K1 under max abs 3e-2, causal and not; then per
    case K1 and each configuration of ``sweep`` that divides S, timed, with
    the error against the fp32 oracle on a (1, ``slice_len``) slice. The
    default sweep is JAX's on the CPU; on the card, whose chunk is
    ``unroll`` of its own 64-key tiles whatever the blocks, one run per
    unroll in :data:`CARD_UNROLLS`."""
    dev = C.resolve_device(device)
    if sweep is None:
        sweep = tuple((512, 512, u) for u in CARD_UNROLLS) if dev.type == "cuda" else CHUNKED_SWEEP
    rng = np.random.default_rng(0)
    print("== chunked parity ==", flush=True)
    q, k, v = (C.normal(rng, parity_shape, torch.bfloat16, dev) for _ in range(3))
    s = parity_shape[1]
    rows: Dict[str, dict] = {}
    for causal in (False, True):
        r = flash_attention(q, k, v, causal=causal)
        for bq, bkv, u in parity_cfgs:
            bq, bkv = min(bq, s), min(bkv, s // u)
            a = flash_chunked(q, k, v, causal=causal, block_q=bq, block_kv=bkv, unroll=u)
            _parity(rows, f"parity causal={causal} bq={bq} bkv={bkv} u={u}", a, r)
    print("== chunked perf ==", flush=True)
    for name, shape, causal in cases:
        b, s, hq, hkv, d = shape
        qq, kk, vv = _inputs(rng, shape, dev)
        fl = C.attention_flops(b, s, hq, d, causal)
        it = fit or _fit(fl, dev)
        t_ref = C.timed_ms(lambda: flash_attention(qq, kk, vv, causal=causal), dev, it)
        print(f"{name} ({dev.type}): grid (K1) {t_ref:.4f} ms ({fl / t_ref / 1e9:.1f} TF)",
              flush=True)
        for bq, bkv, u in sweep:
            if s % (bkv * u) or s % bq:
                continue
            sl = min(slice_len, s)
            err = _slice_err(lambda a, b_, c: flash_chunked(
                a, b_, c, causal=causal, block_q=min(bq, sl), block_kv=min(bkv, sl // u),
                unroll=u), qq, kk, vv, causal, sl)
            t = C.timed_ms(lambda: flash_chunked(qq, kk, vv, causal=causal, block_q=bq,
                                                 block_kv=bkv, unroll=u), dev, it)
            key = f"{name} chunked bq={bq} bkv={bkv} u={u}"
            rows[key] = {"shape": shape, "causal": causal, "unroll": u, "chunked_ms": t,
                         "k1_ms": t_ref, "flops": fl, "rel_err": err}
            _line(key, dev, "chunked", t, fl, "grid (K1)", t_ref, err)
    return rows


def main_tri(device: Optional[str] = None, *, parity_shape=TRI_PARITY_SHAPE,
             cases: Sequence = TRI_CASES, blocks: Sequence = TRI_BLOCKS,
             fit: Optional[Tuple[int, int]] = None, slice_len: int = 1024) -> Dict[str, dict]:
    """JAX's ``main3``: parity (bf16, blocks 512) against causal K1 under max
    abs 3e-2; then per causal case K1 and each (block_q, block_kv) of
    ``blocks`` that divides S, timed, with the error against the fp32
    oracle on a (1, ``slice_len``) slice."""
    dev = C.resolve_device(device)
    rng = np.random.default_rng(0)
    print("== triangular parity ==", flush=True)
    q, k, v = (C.normal(rng, parity_shape, torch.bfloat16, dev) for _ in range(3))
    blk = min(512, parity_shape[1])
    rows: Dict[str, dict] = {}
    _parity(rows, "parity", flash_triangular(q, k, v, block_q=blk, block_kv=blk),
            flash_attention(q, k, v, causal=True))
    print("== triangular perf (causal) ==", flush=True)
    for name, shape in cases:
        b, s, hq, hkv, d = shape
        qq, kk, vv = _inputs(rng, shape, dev)
        fl = C.attention_flops(b, s, hq, d, True)
        it = fit or _fit(fl, dev)
        t_ref = C.timed_ms(lambda: flash_attention(qq, kk, vv, causal=True), dev, it)
        for bq, bkv in blocks:
            if s % bq or s % bkv:
                continue
            sl = min(slice_len, s)
            err = _slice_err(lambda a, b_, c: flash_triangular(
                a, b_, c, block_q=min(bq, sl), block_kv=min(bkv, sl)), qq, kk, vv, True, sl)
            t = C.timed_ms(lambda: flash_triangular(qq, kk, vv, block_q=bq, block_kv=bkv), dev,
                           it)
            key = f"{name} tri bq={bq} bkv={bkv}"
            rows[key] = {"shape": shape, "causal": True, "tri_ms": t, "k1_ms": t_ref,
                         "flops": fl, "rel_err": err}
            _line(key, dev, "tri", t, fl, "grid (K1)", t_ref, err)
    return rows


def main_i8(device: Optional[str] = None, *, parity_shape=I8_PARITY_SHAPE,
            cases: Sequence = I8_CASES, fit: Optional[Tuple[int, int]] = None,
            slice_len: int = 1024) -> Dict[str, dict]:
    """JAX's ``main4``: parity (bf16, causal) against K1 under max abs over
    max |K1| 5e-2; then per case the int8 triangular variant and
    ``flash_attention_int8qk`` (K1's int8-QK mode), each timed as the whole
    call (the quantization passes in it: ``tri_i8_ms``, ``k1_ms``) and as
    its kernel alone on payloads quantized once (``tri_i8_kernel_ms``,
    ``k1_kernel_ms``), with the error against the fp32 oracle on a (1,
    ``slice_len``) slice."""
    dev = C.resolve_device(device)
    rng = np.random.default_rng(0)
    print("== tri-i8 parity ==", flush=True)
    q, k, v = (C.normal(rng, parity_shape, torch.bfloat16, dev) for _ in range(3))
    blk = min(512, parity_shape[1])
    rows: Dict[str, dict] = {}
    _parity(rows, "parity", flash_tri_i8(q, k, v, causal=True, block_q=blk, block_kv=blk),
            flash_attention(q, k, v, causal=True), relative=True)
    print("== tri-i8 perf ==", flush=True)
    for name, shape, causal in cases:
        b, s, hq, hkv, d = shape
        qq, kk, vv = _inputs(rng, shape, dev)
        fl = C.attention_flops(b, s, hq, d, causal)
        it = fit or _fit(fl, dev, rate=80e12)
        sl = min(slice_len, s)
        blk = min(512, sl)
        err = _slice_err(lambda a, b_, c: flash_tri_i8(a, b_, c, causal=causal, block_q=blk,
                                                       block_kv=blk), qq, kk, vv, causal, sl)
        bk = min(512, s)
        q8, k8, sc = quant_qk(qq, kk)
        t_kernel = C.timed_ms(lambda: _tri_i8_payloads(q8, k8, sc, vv, bk, bk, causal), dev, it)
        t = C.timed_ms(lambda: flash_tri_i8(qq, kk, vv, causal=causal, block_q=bk, block_kv=bk),
                       dev, it)
        t_ref_kernel = C.timed_ms(lambda: flash_attention_qk_quant(
            q8, k8, vv, sc, causal=causal, out_dtype=vv.dtype), dev, it)
        t_ref = C.timed_ms(lambda: flash_attention_int8qk(qq, kk, vv, causal=causal), dev, it)
        rows[name] = {"shape": shape, "causal": causal, "tri_i8_ms": t, "k1_ms": t_ref,
                      "tri_i8_kernel_ms": t_kernel, "k1_kernel_ms": t_ref_kernel, "flops": fl,
                      "rel_err": err}
        _line(name, dev, "tri-i8", t, fl, "grid-int8qk (K1)", t_ref, err)
        _line(name, dev, "tri-i8 kernel alone", t_kernel, fl, "grid-int8qk (K1) kernel alone",
              t_ref_kernel, err)
    return rows


def main_seg(device: Optional[str] = None, *, parity_shape=SEG_PARITY_SHAPE,
             cases: Sequence = SEG_CASES, block: int = SEG_BLOCK, fit: Optional[Tuple[int, int]] = None,
             slice_len: int = 2048) -> Dict[str, dict]:
    """JAX's ``main5``: parity (bf16, causal, seg_tiles 2: several segments
    merged) against K1 under max abs 3e-2; then per causal case K1 and the
    segmented variant (:data:`SEG_TILES`) timed, with the error against the fp32
    oracle on a (1, ``slice_len``) slice."""
    dev = C.resolve_device(device)
    rng = np.random.default_rng(0)
    print("== segmented parity ==", flush=True)
    q, k, v = (C.normal(rng, parity_shape, torch.bfloat16, dev) for _ in range(3))
    blk = min(block, parity_shape[1])
    rows: Dict[str, dict] = {}
    _parity(rows, "parity", flash_segmented(q, k, v, causal=True, seg_tiles=2, block_q=blk,
                                            block_kv=blk),
            flash_attention(q, k, v, causal=True))
    print("== segmented perf (causal) ==", flush=True)
    for name, (b, s, h, d) in cases:
        shape = (b, s, h, h, d)
        qq, kk, vv = _inputs(rng, shape, dev)
        fl = C.attention_flops(b, s, h, d, True)
        it = fit or _fit(fl, dev, rate=70e12, least=20)
        sl = min(slice_len, s)
        blk = min(block, sl)
        err = _slice_err(lambda a, b_, c: flash_segmented(a, b_, c, causal=True,
                                                          seg_tiles=SEG_TILES, block_q=blk,
                                                          block_kv=blk),
                         qq, kk, vv, True, sl)
        t_g = C.timed_ms(lambda: flash_attention(qq, kk, vv, causal=True), dev, it)
        t_s = C.timed_ms(lambda: flash_segmented(qq, kk, vv, causal=True, seg_tiles=SEG_TILES,
                                                 block_q=block, block_kv=block), dev, it)
        rows[name] = {"shape": shape, "causal": True, "segmented_ms": t_s, "k1_ms": t_g,
                      "flops": fl, "rel_err": err}
        _line(name, dev, "segmented", t_s, fl, "grid (K1)", t_g, err)
    return rows


def main_fulltri(device: Optional[str] = None, *, parity_shape=FULLTRI_PARITY_SHAPE,
                 cases: Sequence = FULLTRI_CASES, fit: Optional[Tuple[int, int]] = None,
                 slice_len: int = 1024) -> Dict[str, dict]:
    """JAX's ``main6``: parity (bf16, blocks 256) against causal K1 under max
    abs 3e-2; then per causal case ``flash_attention_unrolled`` (K1 on the
    card) and the full-triangle variant timed, with the error against the
    fp32 oracle on a (1, ``slice_len``) slice."""
    dev = C.resolve_device(device)
    rng = np.random.default_rng(0)
    print("== fulltri parity ==", flush=True)
    q, k, v = (C.normal(rng, parity_shape, torch.bfloat16, dev) for _ in range(3))
    blk = min(256, parity_shape[1])
    rows: Dict[str, dict] = {}
    _parity(rows, "parity", flash_fulltri(q, k, v, block_q=blk, block_kv=blk),
            flash_attention(q, k, v, causal=True))
    print("== fulltri perf (headline geometry) ==", flush=True)
    for name, shape in cases:
        b, s, hq, hkv, d = shape
        qq, kk, vv = _inputs(rng, shape, dev)
        fl = C.attention_flops(b, s, hq, d, True)
        it = fit or _fit(fl, dev, rate=70e12)
        sl = min(slice_len, s)
        blk = min(512, sl)
        err = _slice_err(lambda a, b_, c: flash_fulltri(a, b_, c, block_q=blk, block_kv=blk),
                         qq, kk, vv, True, sl)
        t_ref = C.timed_ms(lambda: flash_attention_unrolled(qq, kk, vv, causal=True), dev, it)
        bk = min(512, s)
        t = C.timed_ms(lambda: flash_fulltri(qq, kk, vv, block_q=bk, block_kv=bk), dev, it)
        rows[name] = {"shape": shape, "causal": True, "fulltri_ms": t, "k1_ms": t_ref,
                      "flops": fl, "rel_err": err}
        _line(name, dev, "fulltri", t, fl, "per-row (K1)", t_ref, err)
    return rows


#: The command line's variants: JAX's ``sys.argv[1]``.
VARIANTS = {"chunked": main_chunked, "tri": main_tri, "i8": main_i8, "seg": main_seg,
            "fulltri": main_fulltri}

if __name__ == "__main__":
    C.cli(main, __doc__.splitlines()[0], VARIANTS)
