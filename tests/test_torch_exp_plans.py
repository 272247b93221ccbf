"""The launch plans of K13-K19's bf16 body (``k13_plan``, ``k14_plan``,
``k15_plan``, ``k16_plan``, ``k17_plan``, ``k18_plan``, ``k19_plan`` in
``experiments/flash_pipeline_experiment.py``) and of K18's int8 mode
(``k18_i8_plan``), on the CPU.

The C launchers of ``csrc/flash_experiments_sm90.cu`` take every field of a
plan: they refuse a tile width, stage count, shared memory or grid that is
not their own, and the kernel walks the plan's q-blocks and runs each one's
chunks as the plan lists them. So these pure functions are what the card
runs: K19's walk covers each causal (row-block, key tile) pair of a head
once, heaviest row first, on a grid of B x Hq CTAs; K16's does the same
(every pair when not causal) on the persistent grid; K18's launches of one
call claim each row once, inside their own row-block, each q-block over
exactly the key tiles its rows below the row end see; K17's chunks per
128-row work tile follow the chunk-granular causal skip (every chunk when
not causal); every plan's shared memory fits the H100's 232,448 bytes with
as many stages as fit. Parametrised over the card checks' shapes
(``CARD_CHECK_SHAPES``) and the mains' geometries. K14's walk covers each
causal (128-row q-block, key tile) pair once with Sq and Skv apart; K15's,
with each chain stopping at its own diagonal (the kernel's rule, mirrored
here), covers each (chain, key tile) pair of a chain with rows below Sq
once, and loads no tile that no live chain runs. K13's plan is K16's (its
instantiation) under K13's name and checks. K18's int8 mode with a bf16 V
(``k18_i8_plan``, K1's Hopper int8-QK body in ``csrc/flash_quant_sm90.cu``):
its launches store each row once, each over the 128-key tiles its
q-block sees, a range ending inside a work tile or starting off the
128-row grid stores only its rows, the ring is ``Cfg<D, INT8QK>``'s, bad
arguments raise; and ``_tri_cuda``'s routing by V's dtype, seen on the
CPU through a recording stand-in for ``_build.launch``: a bf16 V on the
Hopper entry (the first launch plain, the rest chained), an fp32 V on the
mma.sync one, an unaligned bf16 V raising before any launch.
"""

import math

import numpy as np
import pytest
import torch

from photonic_flash_attention_tpu_torch.experiments import flash_pipeline_experiment as ux

SHAPES = sorted({shape[:5] for shape in ux.CARD_CHECK_SHAPES}
                | {shape for _, shape, _ in ux.CHUNKED_CASES}
                | {shape for _, shape in ux.FULLTRI_CASES}
                | {shape for _, shape, _ in ux.CASES}
                | {shape for _, shape in ux.TRI_CASES})
IDS = ["b{}s{}h{}-{}d{}".format(*shape) for shape in SHAPES]


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_k19_walk_covers_each_causal_pair_once(shape):
    b, s, hq, hkv, d = shape
    plan = ux.k19_plan(b, s, hq, hkv, d)
    assert plan.grid == b * hq
    assert plan.tile_keys == plan.chunk_keys == (96 if d == 128 else 128)
    # each q-block runs its first n tiles, in key order from key 0
    pairs = [(q0, t * plan.tile_keys) for q0, n in plan.walk for t in range(n)]
    want = {(q0, kv0) for q0 in range(0, s, 128) for kv0 in range(0, s, plan.tile_keys)
            if kv0 <= min(s - 1, q0 + 127)}
    assert len(pairs) == len(want) and set(pairs) == want
    rows = [q0 for q0, _ in plan.walk]
    assert rows == sorted(rows, reverse=True)  # heaviest (last) row-block first
    assert len(set(rows)) == len(rows) == math.ceil(s / 128)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("unroll", ux.CARD_UNROLLS)
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_k17_live_chunks(shape, unroll, causal):
    b, s, hq, hkv, d = shape
    plan = ux.k17_plan(b, s, hq, hkv, d, unroll, causal=causal, sms=132)
    span = 64 * unroll
    assert plan.tile_keys == 64 and plan.chunk_keys == span
    nqb = math.ceil(s / 128)
    q0s = [q0 for q0, _ in plan.walk]
    # every q-block once; causal ones longest first
    assert q0s == sorted(range(0, nqb * 128, 128), reverse=causal)
    want = [min(math.ceil((q0 + 128) / span), math.ceil(s / span)) if causal else
            math.ceil(s / span) for q0 in q0s]
    assert [n for _, n in plan.walk] == want
    assert plan.grid == min(nqb * hq * b, 132)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_k16_walk_covers_each_pair_once(shape, causal):
    b, s, hq, hkv, d = shape
    plan = ux.k16_plan(b, s, hq, hkv, d, causal, 132)
    assert plan.tile_keys == plan.chunk_keys == (96 if d == 128 else 128)
    nqb = math.ceil(s / 128)
    assert plan.grid == min(nqb * hq * b, 132)
    pairs = [(q0, t * plan.tile_keys) for q0, n in plan.walk for t in range(n)]
    want = {(q0, kv0) for q0 in range(0, s, 128) for kv0 in range(0, s, plan.tile_keys)
            if not causal or kv0 <= min(s - 1, q0 + 127)}
    assert len(pairs) == len(want) and set(pairs) == want
    q0s = [q0 for q0, _ in plan.walk]
    # every q-block once; causal ones heaviest (last) first
    assert q0s == sorted(range(0, nqb * 128, 128), reverse=causal)


def _tri_blocks(s):
    return sorted(set(ux.check_tri_blocks(s))
                  | {bk for bk in ux.TRI_BLOCKS if s % bk[0] == 0 and s % bk[1] == 0})


TRI_PARAMS = [(shape, bq) for shape in SHAPES
              for bq in sorted({bq for bq, _ in _tri_blocks(shape[1])})]


@pytest.mark.parametrize("shape, block_q", TRI_PARAMS,
                         ids=[f"{IDS[SHAPES.index(shape)]}-bq{bq}" for shape, bq in TRI_PARAMS])
def test_k18_walks_cover_each_causal_pair_once(shape, block_q):
    """The launches of one call (one a row-block of ``block_q`` rows) store
    each row of S once, each inside its own launch's rows, and each
    q-block runs exactly the key tiles up to its last stored row: so every
    causal (row, key tile) pair is computed and stored once."""
    b, s, hq, hkv, d = shape
    tile = 96 if d == 128 else 128
    stored = []
    for row0 in range(0, s, block_q):
        plan = ux.k18_plan(b, s, hq, hkv, d, row0, block_q, 132)
        assert plan.tile_keys == plan.chunk_keys == tile
        assert plan.grid == min(len(plan.walk) * hq * b, 132)
        assert len(plan.walk) == math.ceil(block_q / 128)
        q0s = [q0 for q0, _ in plan.walk]
        assert q0s == sorted(q0s, reverse=True)  # heaviest first
        for q0, n in plan.walk:
            end = min(q0 + 128, row0 + block_q)  # the rows it stores: [q0, end)
            assert row0 <= q0 < end <= row0 + block_q and (q0 - row0) % 128 == 0
            assert n == math.ceil(end / tile)  # to its last stored row, no tile past it
            stored.append((q0, end))
    stored.sort()
    assert stored[0][0] == 0 and stored[-1][1] == s
    assert all(a[1] == b_[0] for a, b_ in zip(stored, stored[1:]))  # each row once


@pytest.mark.parametrize("kernel", ["k19", "k17 u2", "k17 u4", "k16", "k18"])
@pytest.mark.parametrize("d", ux.CARD_HEAD_DIMS)
def test_plan_shared_memory_fits(kernel, d):
    plan = (ux.k19_plan(4, 2048, 12, 12, d) if kernel == "k19"
            else ux.k16_plan(4, 2048, 12, 12, d, True) if kernel == "k16"
            else ux.k18_plan(4, 2048, 12, 12, d, 512, 512) if kernel == "k18"
            else ux.k17_plan(4, 2048, 12, 12, d, int(kernel[-1])))
    assert plan.smem <= ux.SMEM_MAX
    assert plan.smem == ux._sm90_smem(d, plan.chunk_keys, plan.stages)
    # as many stages as fit: one more does not
    assert ux._sm90_smem(d, plan.chunk_keys, plan.stages + 1) > ux.SMEM_MAX
    want = {("k19", 64): 6, ("k19", 128): 3, ("k17 u2", 64): 6, ("k17 u4", 64): 3,
            ("k17 u2", 128): 2, ("k17 u4", 128): 1, ("k16", 64): 6, ("k16", 128): 3,
            ("k18", 64): 6, ("k18", 128): 3}
    assert plan.stages == want[(kernel, d)]


def test_plan_bad_arguments():
    with pytest.raises(ValueError, match="head_dim"):
        ux.k19_plan(1, 320, 2, 2, 96)
    with pytest.raises(ValueError, match="unroll"):
        ux.k17_plan(1, 320, 2, 2, 64, 3)
    with pytest.raises(ValueError, match="shape"):
        ux.k17_plan(1, 320, 3, 2, 64, 2)
    # the kernel's walk holds 512 q-blocks
    assert len(ux.k19_plan(1, ux.SM90_MAX_SEQ, 1, 1, 64).walk) == 512
    with pytest.raises(ValueError, match="S <="):
        ux.k17_plan(1, ux.SM90_MAX_SEQ + 1, 1, 1, 64, 2)


@pytest.mark.parametrize("call, match", [
    (lambda: ux.k16_plan(1, 320, 2, 2, 96, True), "head_dim"),
    (lambda: ux.k18_plan(1, 320, 2, 2, 96, 0, 64), "head_dim"),
    (lambda: ux.k16_plan(1, ux.SM90_MAX_SEQ + 1, 1, 1, 64, False), "S <="),
    (lambda: ux.k18_plan(1, ux.SM90_MAX_SEQ + 1, 1, 1, 64, 0, 512), "S <="),
    (lambda: ux.k18_plan(1, 320, 2, 2, 64, 320, 64), "q_row0"),
    (lambda: ux.k18_plan(1, 320, 2, 2, 64, -64, 64), "q_row0"),
    (lambda: ux.k18_plan(1, 320, 2, 2, 64, 0, 0), "rows"),
    (lambda: ux.k18_plan(1, 320, 2, 2, 64, 256, 128), "rows"),
    (lambda: ux.k16_plan(1, 320, 3, 2, 64, True), "shape"),
], ids=["k16-d96", "k18-d96", "k16-long", "k18-long", "k18-row0-at-s", "k18-row0-neg",
        "k18-no-rows", "k18-past-s", "k16-gqa"])
def test_k16_k18_plan_bad_arguments(call, match):
    with pytest.raises(ValueError, match=match):
        call()


# -- K14 and K15 (csrc/flash_experiments_sm90.cu: flash_aug_sm90,
# flash_pair_sm90<nchain>), Sq and Skv apart --------------------------------

#: (B, Sq, Skv, H): the mains' geometries, the card checks' shapes (the
#: ragged lengths of each nchain among them) and Sq != Skv each way.
AUG_PAIR_SHAPES = [(4, 2048, 2048, 12), (1, 8192, 8192, 12), (2, 256, 256, 4), (1, 96, 160, 2),
                   (1, 160, 96, 2), (2, 384, 384, 4), (1, 1536, 1536, 3), (4, 1920, 1920, 12),
                   (2, 192, 320, 3), (2, 384, 192, 3), (2, 288, 288, 3), (2, 320, 320, 3),
                   (1, 1000, 4100, 2), (1, 4100, 1000, 2)]
AUG_PAIR_IDS = ["b{}sq{}skv{}h{}".format(*shape) for shape in AUG_PAIR_SHAPES]


def _needed(q_lo, q_hi, skv, tile):
    """The key tiles that rows [q_lo, q_hi) see, causal col <= row."""
    return {kv0 for kv0 in range(0, skv, tile) if kv0 <= q_hi - 1}


@pytest.mark.parametrize("shape", AUG_PAIR_SHAPES, ids=AUG_PAIR_IDS)
def test_k14_walk_covers_each_causal_pair_once(shape):
    b, sq, skv, h = shape
    plan = ux.k14_plan(b, sq, skv, h, 132)
    assert plan.tile_keys == plan.chunk_keys == 128
    assert plan.grid == min(math.ceil(sq / 128) * h * b, 132)
    q0s = [q0 for q0, _ in plan.walk]
    assert q0s == sorted(range(0, sq, 128), reverse=True)  # every q-block once, heaviest first
    for q0, n in plan.walk:
        # its first n tiles, exactly those its rows below Sq see inside Skv
        assert set(range(0, n * 128, 128)) == _needed(q0, min(q0 + 128, sq), skv, 128)


@pytest.mark.parametrize("nchain", sorted(ux.K15_TILE_KEYS))
@pytest.mark.parametrize("shape", AUG_PAIR_SHAPES, ids=AUG_PAIR_IDS)
def test_k15_walk_covers_each_chain_pair_once(shape, nchain):
    """The producer loads the tiles the work tile's last live chain sees;
    each chain runs the first min(ceil((q0c + 64) / tile), n) of them (the
    kernel's ``own``): for every chain with rows below Sq, exactly the tiles
    its rows see, so each (row, key tile) pair is computed once."""
    b, sq, skv, h = shape
    plan = ux.k15_plan(b, sq, skv, h, nchain, 132)
    rows, tile = 64 * nchain, ux.K15_TILE_KEYS[nchain]
    assert plan.tile_keys == plan.chunk_keys == tile
    assert plan.grid == min(math.ceil(sq / rows) * h * b, 132)
    assert [q0 for q0, _ in plan.walk] == sorted(range(0, sq, rows), reverse=True)
    for q0, n in plan.walk:
        owns = []
        for q0c in range(q0, q0 + rows, 64):
            own = min(-(-(q0c + 64) // tile), n)
            assert 1 <= own <= n
            if q0c < sq:  # a chain past Sq computes its own tiles and stores nothing
                assert set(range(0, own * tile, tile)) == _needed(q0c, min(q0c + 64, sq), skv,
                                                                  tile)
                owns.append(own)
        assert n == max(owns)  # no tile loaded that no live chain runs


@pytest.mark.parametrize("nchain", [0] + sorted(ux.K15_TILE_KEYS))
def test_k14_k15_plan_shared_memory_fits(nchain):
    plan = (ux.k14_plan(4, 2048, 2048, 12) if nchain == 0
            else ux.k15_plan(4, 2048, 2048, 12, nchain))
    rows = 128 if nchain == 0 else 64 * nchain
    ones = ux.K14_ONES_BYTES if nchain == 0 else 0
    assert plan.smem <= ux.SMEM_MAX
    assert plan.smem == ux._sm90_smem(64, plan.chunk_keys, plan.stages, rows, ones)
    assert ux._sm90_smem(64, plan.chunk_keys, plan.stages + 1, rows, ones) > ux.SMEM_MAX
    assert plan.stages == {0: 6, 1: 6, 2: 6, 3: 5, 4: 10}[nchain]


@pytest.mark.parametrize("call, match", [
    (lambda: ux.k15_plan(1, 320, 320, 2, 5), "nchain"),
    (lambda: ux.k15_plan(1, 320, 320, 2, 0), "nchain"),
    (lambda: ux.k14_plan(1, 0, 320, 2), "shape"),
    (lambda: ux.k15_plan(1, 320, 0, 2, 2), "shape"),
    (lambda: ux.k14_plan(1, 128 * 512 + 1, 320, 2), "Sq <="),
    (lambda: ux.k15_plan(1, 64 * 512 + 1, 320, 2, 1), "Sq <="),
    (lambda: ux.k14_plan(1, 320, ux.K14_K15_MAX_KEYS + 1, 2), "Skv <="),
], ids=["k15-nchain5", "k15-nchain0", "k14-no-rows", "k15-no-keys", "k14-long", "k15-n1-long",
        "k14-long-keys"])
def test_k14_k15_plan_bad_arguments(call, match):
    with pytest.raises(ValueError, match=match):
        call()


# -- K13 (csrc/flash_experiments_sm90.cu: flash_fixedmax_sm90<D, FAST>) ------


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_k13_plan_is_k16s(shape, causal):
    """K13 runs K16's instantiation: the same ring (tile, stages, shared
    memory), grid and walk, for q, k and v of one head count."""
    b, s, h, _, d = shape
    for sms in (132, 16):
        assert ux.k13_plan(b, s, h, d, causal, sms) == ux.k16_plan(b, s, h, h, d, causal, sms)


@pytest.mark.parametrize("call, match", [
    (lambda: ux.k13_plan(1, 320, 2, 96, True), "K13 take head_dim"),
    (lambda: ux.k13_plan(1, 320, 2, 32, False), "K13 take head_dim"),
    (lambda: ux.k13_plan(1, ux.SM90_MAX_SEQ + 1, 1, 64, True), "K13's bf16 body takes S <="),
    (lambda: ux.k13_plan(1, 0, 1, 64, True), "shape"),
], ids=["d96", "d32", "long", "empty"])
def test_k13_plan_bad_arguments(call, match):
    with pytest.raises(ValueError, match=match):
        call()
    assert len(ux.k13_plan(1, ux.SM90_MAX_SEQ, 1, 64, True).walk) == 512


# -- K18's int8-QK mode on K1's Hopper int8-QK body (csrc/flash_quant_sm90.cu:
# flash_quant_sm90<D, INT8QK, true>) -----------------------------------------

#: (shape, block_q, causal): every card-check shape and main geometry at
#: each block the card checks and the int8 main give it, causal and not.
I8_PARAMS = [(shape, bq, causal) for shape in SHAPES
             for bq in sorted({ux.check_block(shape[1]), min(512, shape[1])})
             for causal in (True, False)]


def _i8_walk(plan, b, s, hq, row0, rows, causal):
    """A mirror of the kernel's walk (``work_tile<ROWBLOCK>`` in
    ``csrc/flash_quant_sm90.cu``): work tile t of the plan runs q-block i =
    t // (Hq B) of the range's 128-row q-blocks, counted from the last when
    causal, over the 128-key tiles up to its last row (all of S when not
    causal); yields (q0, key tiles) per work tile."""
    nqb = -(-rows // 128)
    for t in range(plan.work):
        i = t // (hq * b)
        q0 = row0 + ((nqb - 1 - i) if causal else i) * 128
        yield q0, -(-min(s, q0 + 128) // 128) if causal else -(-s // 128)


@pytest.mark.parametrize("shape, block_q, causal", I8_PARAMS,
                         ids=[f"{IDS[SHAPES.index(sh)]}-bq{bq}-{'causal' if c else 'full'}"
                              for sh, bq, c in I8_PARAMS])
def test_k18_i8_walks_store_each_row_once(shape, block_q, causal):
    """The launches of one call store each row of S once, inside their own
    row-block, each row over exactly the 128-key tiles it sees (up to its
    own diagonal when causal, all of S otherwise); the work tiles are the
    row-block's 128-row q-blocks x Hq x B, heaviest first when causal, the
    grid min(work, SMs)."""
    b, s, hq, hkv, d = shape
    seen = {}  # row -> (its q-block's first row, key tiles)
    for row0 in range(0, s, block_q):
        plan = ux.k18_i8_plan(b, s, hq, hkv, d, row0, block_q, 132)
        assert plan.work == math.ceil(block_q / 128) * hq * b
        assert plan.grid == min(plan.work, 132)
        walk = list(_i8_walk(plan, b, s, hq, row0, block_q, causal))
        q0s = list(dict.fromkeys(q0 for q0, _ in walk))
        assert q0s == sorted(q0s, reverse=causal)  # causal: heaviest first
        assert sorted(q0s) == list(range(row0, row0 + block_q, 128))
        assert len(walk) == len(q0s) * hq * b  # each q-block once a (b, h)
        for q0, n in dict.fromkeys(walk):
            for row in range(q0, min(q0 + 128, row0 + block_q)):  # stored rows
                assert row not in seen
                seen[row] = (q0, n)
    assert sorted(seen) == list(range(s))
    for row, (q0, n) in seen.items():
        if causal:
            assert row // 128 < n  # its diagonal key tile runs
            assert (n - 1) * 128 <= min(s, q0 + 128) - 1  # none wholly above its q-block
        else:
            assert n == math.ceil(s / 128)


@pytest.mark.parametrize("row0, rows", [(64, 64), (64, 192), (0, 320), (1, 318), (256, 64)])
def test_k18_i8_range_ending_inside_a_work_tile(row0, rows):
    """A launch whose range ends inside its last 128-row work tile (or
    starts off the 128-row grid) computes the tile and stores only the
    range: each row once, none outside."""
    s = 320
    plan = ux.k18_i8_plan(1, s, 4, 2, 64, row0, rows)
    assert plan.work == math.ceil(rows / 128) * 4
    for causal in (True, False):
        q0s = dict.fromkeys(q0 for q0, _ in _i8_walk(plan, 1, s, 4, row0, rows, causal))
        stored = sorted(row for q0 in q0s for row in range(q0, min(q0 + 128, row0 + rows)))
        assert stored == list(range(row0, row0 + rows))


@pytest.mark.parametrize("d", ux.CARD_HEAD_DIMS)
def test_k18_i8_plan_ring_is_the_quantized_bodys(d):
    """``Cfg<D, INT8QK>``: int8 Q double-buffered, stages of int8 K and bf16
    V, four stages at both head dims, within the H100's shared memory."""
    plan = ux.k18_i8_plan(4, 2048, 12, 12, d, 0, 512)
    q, stage = 128 * d, 128 * d * 3
    assert plan.stages == 4
    assert plan.smem == 2 * q + 4 * stage + 8 * (2 * 4 + 12) + 1024
    assert plan.smem <= ux.SMEM_MAX
    assert {64: 115872, 128: 230560}[d] == plan.smem


@pytest.mark.parametrize("call, match", [
    (lambda: ux.k18_i8_plan(1, 320, 2, 2, 96, 0, 64), "head_dim"),
    (lambda: ux.k18_i8_plan(1, 320, 3, 2, 64, 0, 64), "shape"),
    (lambda: ux.k18_i8_plan(0, 320, 2, 2, 64, 0, 64), "shape"),
    (lambda: ux.k18_i8_plan(1, 320, 2, 2, 64, 320, 64), "rows must lie"),
    (lambda: ux.k18_i8_plan(1, 320, 2, 2, 64, -64, 64), "rows must lie"),
    (lambda: ux.k18_i8_plan(1, 320, 2, 2, 64, 0, 0), "rows must lie"),
    (lambda: ux.k18_i8_plan(1, 320, 2, 2, 64, 256, 128), "rows must lie"),
], ids=["d96", "gqa", "b0", "row0-at-s", "row0-neg", "no-rows", "past-s"])
def test_k18_i8_plan_bad_arguments(call, match):
    with pytest.raises(ValueError, match=match):
        call()


class _Launches:
    """Stands in for ``_build.launch`` and the SM count: records each launch
    (entry point, its integer arguments, counter) instead of calling the
    library, so the CPU sees what ``_tri_cuda`` would launch on the card."""

    def __init__(self, monkeypatch):
        self.calls = []
        monkeypatch.setattr(ux._build, "launch", self.launch)
        monkeypatch.setattr(ux, "_sms", lambda device: 132)

    def launch(self, name, device, *args, count_as=None):
        self.calls.append((name, args, count_as))


def _payloads(v_dtype, s=320, offset=0):
    """int8 q and k payloads, their (1,) score scale and V on the CPU (V
    starting ``offset`` elements into its buffer)."""
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.standard_normal((1, s, 4, 64)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, s, 2, 64)).astype(np.float32))
    q8, k8, sc = ux.quant_qk(q, k)
    buf = torch.from_numpy(rng.standard_normal(s * 2 * 64 + offset).astype(np.float32))
    v = buf.to(v_dtype)[offset:].view(1, s, 2, 64)
    return q8, k8, sc, v


@pytest.mark.parametrize("causal", [True, False])
def test_k18_i8_bf16_v_routes_to_the_hopper_body(monkeypatch, causal):
    """A bf16 V goes to K1's Hopper int8-QK body, one launch a row-block on
    its plan, counted as ``pfa_flash_tri_i8``, the first plain and every
    later one chained; nothing goes to the mma.sync body."""
    rec = _Launches(monkeypatch)
    q8, k8, sc, v = _payloads(torch.bfloat16)
    o = ux._tri_cuda(q8, k8, v, 64, causal, 0.0, score_scale=sc)
    assert o.dtype == torch.bfloat16 and o.shape == (1, 320, 4, 64)
    assert [c[0] for c in rec.calls] == ["pfa_flash_tri_i8_sm90"] * 5
    assert {c[2] for c in rec.calls} == {"pfa_flash_tri_i8"}
    for i, (_, args, _) in enumerate(rec.calls):
        plan = ux.k18_i8_plan(1, 320, 4, 2, 64, 64 * i, 64, 132)
        # after the five pointers: B, S, Hq, Hkv, D, q_row0, rows, causal,
        # chained, stages, smem, grid
        assert args[5:] == (1, 320, 4, 2, 64, 64 * i, 64, int(causal), int(i > 0),
                            plan.stages, plan.smem, plan.grid)
        assert args[4] == sc.data_ptr()


def test_k18_i8_fp32_v_stays_on_mma_sync(monkeypatch):
    """An fp32 V stays on the s8 mma.sync body, counted as
    ``pfa_flash_tri_i8_fp32``, never on the Hopper body."""
    rec = _Launches(monkeypatch)
    q8, k8, sc, v = _payloads(torch.float32)
    o = ux._tri_cuda(q8, k8, v, 64, True, 0.0, score_scale=sc)
    assert o.dtype == torch.float32
    assert [(c[0], c[2]) for c in rec.calls] == [("pfa_flash_tri", "pfa_flash_tri_i8_fp32")] * 5


def test_k18_i8_unaligned_bf16_base_raises_before_any_launch(monkeypatch):
    """TMA reads 16-byte-aligned bases: a bf16 V two bytes into its buffer
    raises ValueError and nothing launches, nor falls back."""
    rec = _Launches(monkeypatch)
    q8, k8, sc, v = _payloads(torch.bfloat16, offset=1)
    assert v.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte"):
        ux._tri_cuda(q8, k8, v, 64, True, 0.0, score_scale=sc)
    assert rec.calls == []
