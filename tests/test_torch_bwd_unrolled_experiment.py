"""The unrolled-backward experiment against the JAX file.

``flash_bwd_unrolled`` is loaded from
``benchmarks/flash_bwd_unrolled_experiment.py`` with importlib and run on the
CPU under ``pltpu.force_tpu_interpret_mode()``; the same numpy q, k, v, dO,
and JAX's o and lse from its flash forward, go through the port's function
on CPU tensors (the plain versions of K20 and K21).

Tolerance: rel_err_norm 1e-3 on dq, dk and dv. Both sides cast q, k, v and
dO to bf16 and round p and ds to bf16 before the products, accumulating in
fp32; what differs is the order of the fp32 sums, which can flip a bf16
rounding of p or ds (measured: at most 5.4e-5 with fp32 inputs at these
shapes). JAX's kv blocks are multiples of 128 (its kernels tile the (.,
128) lane layout).

K21's bf16 launch plan (``k21_plan``: K4's Hopper body over one key block)
is a pure function, checked here too: its work tiles and grid, its ring
(K4's), the ranges it refuses, and the fold of K21's (B, H, S, D) tensors
into K4's (B H, S, 1, D) layout that its launch relies on. So is K20's
(``k20_plan``: K5's body over one row-block): its work tiles and grid, its
ring (a mirror of K5's ``DqCfg``), the ranges it refuses, and a mirror of
the body's walk (``dq_work`` and the store's range test) through the same
fold, which must store every (b, h, row) of a call exactly once.
"""

import importlib.util
from functools import lru_cache
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from photonic_flash_attention_tpu_torch import experiments
from photonic_flash_attention_tpu_torch.experiments import flash_bwd_unrolled_experiment as bx

BENCHMARKS = Path(__file__).resolve().parent.parent / "benchmarks"
TOL = 1e-3


@lru_cache(maxsize=None)
def jax_bwd():
    spec = importlib.util.spec_from_file_location("_jax_flash_bwd_unrolled_experiment",
                                                  BENCHMARKS / "flash_bwd_unrolled_experiment.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _inputs(seed, b, h, s, d, causal, dtype=jnp.float32):
    """q, k, v, o, lse, dO as numpy in [B, H, S, D] (lse (B, H, S)): o and
    lse from JAX's flash forward, as JAX's ``_prep`` takes them."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (np.asarray(jnp.asarray(rng.standard_normal((b, h, s, d)), dtype))
                   for _ in range(4))
    t = lambda x: jnp.swapaxes(jnp.asarray(x), 1, 2)  # noqa: E731
    o, lse = jax_bwd().flash_attention_with_lse(t(q), t(k), t(v), causal=causal)
    return q, k, v, np.asarray(t(o)), np.asarray(lse), do


def _run_jax(arrays, **kw):
    with pltpu.force_tpu_interpret_mode():
        return [np.asarray(g) for g in jax_bwd().flash_bwd_unrolled(
            *(jnp.asarray(a) for a in arrays), **kw)]


def _torch(arrays):
    return [torch.from_numpy(np.array(a, np.float32)) for a in arrays]


@pytest.mark.parametrize("blocks", [(128, 128), (256, 128), (128, 256)],
                         ids=["b128", "bq256", "bkv256"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_bwd_unrolled_matches_jax(d, causal, blocks):
    arrays = _inputs(1, 1, 2, 256, d, causal)
    kw = dict(sm_scale=d ** -0.5, causal=causal, block_q=blocks[0], block_kv=blocks[1])
    want = _run_jax(arrays, **kw)
    got = experiments.flash_bwd_unrolled(*_torch(arrays), **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert _rel(g.numpy(), w) <= TOL, name


def test_bf16_inputs_match_jax():
    arrays = _inputs(2, 2, 2, 256, 64, True, jnp.bfloat16)
    kw = dict(sm_scale=0.125, causal=True, block_q=128, block_kv=128)
    want = _run_jax(arrays[:3] + (jnp.asarray(arrays[3], jnp.bfloat16), arrays[4],
                                  arrays[5]), **kw)
    got = bx.flash_bwd_unrolled(*(t.to(torch.bfloat16) for t in _torch(arrays[:4])),
                                torch.from_numpy(np.array(arrays[4])),
                                torch.from_numpy(np.asarray(arrays[5], np.float32)).bfloat16(),
                                **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
        assert _rel(g.float().numpy(), np.asarray(w, np.float32)) <= TOL, name


@pytest.mark.parametrize("causal", [False, True])
def test_kernel_wrappers_are_the_plain_pieces_on_the_cpu(causal):
    """K20's and K21's wrappers on CPU tensors give the plain versions' dq
    and (dk, dv), and their blocks only change the launch structure: the
    result agrees across blocks to fp32 summation order."""
    q, k, v, o, lse, do = _torch(_inputs(3, 1, 2, 256, 64, causal))
    di = bx.flash_bwd_di(o, do)
    assert di.shape == (1, 2, 256) and di.is_contiguous()
    kw = dict(sm_scale=0.125, causal=causal)
    whole = bx.flash_bwd_unrolled_plain(q, k, v, o, lse, do, block_q=128, block_kv=64, **kw)
    dq = bx.dq_rowblocks(q, k, v, do, lse, di, block_q=128, block_kv=64, **kw)
    dk, dv = bx.dkv_colblocks(q, k, v, do, lse, di, block_q=128, block_kv=64, **kw)
    for a, b in zip((dq, dk, dv), whole):
        assert torch.equal(a, b)
    other = bx.flash_bwd_unrolled_plain(q, k, v, o, lse, do, block_q=64, block_kv=256, **kw)
    for a, b in zip(other, whole):
        assert bx.C.rel_err_norm(a, b) < 1e-3


def test_jax_drops_the_tail_where_the_port_raises():
    """JAX's grids are ``s // block``: at S 384 with block_q 256, dq comes
    back with 256 rows (and query rows 256-383 add nothing to dk, dv). The
    port raises."""
    arrays = _inputs(4, 1, 2, 384, 64, True)
    kw = dict(sm_scale=0.125, causal=True, block_q=256, block_kv=128)
    dq, dk, dv = _run_jax(arrays, **kw)
    assert dq.shape == (1, 2, 256, 64) and dk.shape == dv.shape == (1, 2, 384, 64)
    full = bx.flash_bwd_unrolled(*_torch(arrays), sm_scale=0.125, causal=True, block_q=128,
                                 block_kv=128)
    assert _rel(dk, full[1].numpy()) > 0.05  # the dropped rows' share of dk
    with pytest.raises(ValueError, match="not a multiple"):
        bx.flash_bwd_unrolled(*_torch(arrays), **kw)
    with pytest.raises(ValueError, match="not a multiple"):
        bx.flash_bwd_unrolled_plain(*_torch(arrays), **kw)


def test_argument_errors():
    q, k, v, o, lse, do = _torch(_inputs(5, 1, 2, 128, 64, False))
    kw = dict(sm_scale=0.125, causal=False, block_q=64, block_kv=64)
    k1, v1 = k[:, :1].contiguous(), v[:, :1].contiguous()
    with pytest.raises(ValueError, match="no GQA"):
        bx.flash_bwd_unrolled(q, k1, v1, o, lse, do, **kw)
    with pytest.raises(ValueError, match="lse must be"):
        bx.flash_bwd_unrolled(q, k, v, o, lse[:, :, :64], do, **kw)
    with pytest.raises(ValueError, match="one shape"):
        bx.flash_bwd_unrolled(q, k, v, o[:, :, :64], lse, do, **kw)
    with pytest.raises(ValueError, match="not a multiple"):
        bx.dq_rowblocks(q, k, v, do, lse, bx.flash_bwd_di(o, do), sm_scale=0.125, causal=False,
                        block_q=96, block_kv=64)
    with pytest.raises(ValueError, match="not a multiple"):
        bx.dkv_colblocks(q, k, v, do, lse, bx.flash_bwd_di(o, do), sm_scale=0.125,
                         causal=False, block_q=64, block_kv=0)


def test_main_runs_on_the_cpu_at_small_shapes():
    rows = bx.main("cpu", parity_shape=(1, 256, 2, 64), parity_blocks=(128, 128),
                   cases=[("g", (1, 256, 2, 64), True)],
                   blocks=[(128, 128), (64, 128), (96, 128)], headline=("g", (128, 128)),
                   fit=(1, 2))
    parity = [r for key, r in rows.items() if key.startswith("parity")]
    assert len(parity) == 6 and all(r["rel_err"] < bx.PARITY_GATE for r in parity)
    assert set(rows) - {k for k in rows if k.startswith("parity")} == {
        "g unrolled bq=128 bkv=128", "g unrolled bq=64 bkv=128"}  # 96 does not divide 256
    head = rows["g unrolled bq=128 bkv=128"]
    assert all(head[key] > 0 for key in ("unrolled_ms", "k45_ms", "k20_ms", "k21_ms"))
    assert head["ratio"] == pytest.approx(head["k45_ms"] / head["unrolled_ms"])
    assert head["launches"] == (2, 2) and "k4_ms" not in head  # K4/K5 alone: the card only
    assert rows["g unrolled bq=64 bkv=128"]["launches"] == (4, 2)
    assert head["flops"] == 2.5 * 4.0 * 2 * 256 * 256 * 64 * 0.5


def test_main_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: main() would run there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bx.main()


def test_exported_with_the_other_experiments():
    assert "flash_bwd_unrolled" in experiments.__all__
    assert experiments.flash_bwd_unrolled is bx.flash_bwd_unrolled
    assert bx.CASES == (("d64 b4 s2048 causal", (4, 2048, 12, 64), True),
                        ("d64 b1 s8192 causal", (1, 8192, 12, 64), True),
                        ("d128 b4 s4096 causal", (4, 4096, 8, 128), True))
    assert bx.BLOCKS == ((512, 512), (256, 512), (512, 256))


# -- K21's bf16 launch on K4's body (csrc/flash_bwd_sm90.cu) ------------------

K21_CASES = [(b, s, h, d, blk) for _, (b, s, h, d), _ in bx.CASES for blk in (256, 512)] + [
    (b, s, h, d, blk) for (b, s, h, d), dtype, blocks in bx.CARD_CHECKS if dtype == torch.bfloat16
    for blk in sorted({bkv for _, bkv in blocks})]


@pytest.mark.parametrize("b, s, h, d, blk", K21_CASES,
                         ids=["b{}s{}h{}d{}-bkv{}".format(*c) for c in K21_CASES])
def test_k21_plan_work_tiles_and_grid(b, s, h, d, blk):
    """Each launch of a call: ceil(rows / 128) B H work tiles (the range's
    128-key blocks, the last holding keys past the range where rows is not
    a multiple of 128), on min(work tiles, SMs) CTAs."""
    for kv_row0 in range(0, s, blk):
        for sms in (132, 7):
            plan = bx.k21_plan(b, s, h, d, kv_row0, blk, sms)
            assert plan.work == -(-blk // 128) * b * h
            assert plan.grid == min(plan.work, sms)


@pytest.mark.parametrize("d", [64, 128])
def test_k21_plan_ring_is_k4s(d):
    """K4's ring (DkvCfg): 4 stages and K/V double-buffered at D 64, 3 at D
    128, in at most the H100's 232,448 bytes of shared memory."""
    plan = bx.k21_plan(1, 256, 1, d, 0, 64)
    assert (plan.stages, plan.smem) == {64: (4, 134240), 128: (3, 232016)}[d]
    assert plan.smem <= bx.SMEM_MAX


@pytest.mark.parametrize("call, match", [
    (lambda: bx.k21_plan(1, 256, 2, 96, 0, 64), "head_dim"),
    (lambda: bx.k21_plan(1, 256, 2, 64, 32, 64), "grid of 64"),
    (lambda: bx.k21_plan(1, 256, 2, 64, 0, 96), "grid of 64"),
    (lambda: bx.k21_plan(1, 256, 2, 64, -64, 64), "grid of 64"),
    (lambda: bx.k21_plan(1, 256, 2, 64, 192, 128), "grid of 64"),
    (lambda: bx.k21_plan(1, 256, 2, 64, 256, 64), "grid of 64"),
    (lambda: bx.k21_plan(1, 256, 2, 64, 0, 0), "grid of 64"),
    (lambda: bx.k21_plan(0, 256, 2, 64, 0, 64), "bad shape"),
], ids=["d96", "row0-off-grid", "rows-off-grid", "row0-neg", "past-s", "row0-at-s", "no-rows",
        "no-batch"])
def test_k21_plan_bad_arguments(call, match):
    with pytest.raises(ValueError, match=match):
        call()


def test_k21_fold_gives_k4_offsets():
    """K21's q, k, v, dO (B, H, S, D) contiguous read through K4's
    (B', S, H', D) indexing with B' = B H and H' = 1, and its lse and di
    (B, H, S) through K4's (B', H', S): every element lands where K21's own
    layout has it (csrc/flash_bwd_sm90.cu: the tensor maps over (D, H', S,
    B'), lse/di at (b' H' + h') S + q, dk/dv stored at ((b' S + key) H' +
    h') D + c)."""
    b, h, s, d = 2, 3, 5, 4
    x = torch.arange(b * h * s * d).view(b, h, s, d)
    v = torch.arange(b * h * s).view(b, h, s)
    flat, vflat = x.flatten(), v.flatten()
    hp = 1
    for bb in range(b):
        for hh in range(h):
            bp = bb * h + hh  # b'; h' = 0
            for key in range(s):
                assert vflat[(bp * hp + 0) * s + key] == v[bb, hh, key]
                for c in range(d):
                    assert flat[((bp * s + key) * hp + 0) * d + c] == x[bb, hh, key, c]


# -- K20's bf16 launch on K5's body (csrc/flash_bwd_sm90.cu) ------------------

K20_CASES = [(b, s, h, d, blk) for _, (b, s, h, d), _ in bx.CASES for blk in (256, 512)] + [
    (b, s, h, d, blk) for (b, s, h, d), dtype, blocks in bx.CARD_CHECKS if dtype == torch.bfloat16
    for blk in sorted({bq for bq, _ in blocks})] + [(2, 384, 3, 64, 192), (1, 320, 2, 128, 320)]


@pytest.mark.parametrize("b, s, h, d, blk", K20_CASES,
                         ids=["b{}s{}h{}d{}-bq{}".format(*c) for c in K20_CASES])
def test_k20_plan_work_tiles_and_grid(b, s, h, d, blk):
    """Each launch of a call: ceil(rows / 128) B H work tiles (the
    row-block's 128-row blocks, the last holding rows past the row-block
    where rows is not a multiple of 128), on min(work tiles, SMs) CTAs."""
    for q_row0 in range(0, s, blk):
        for sms in (132, 7):
            plan = bx.k20_plan(b, s, h, d, q_row0, blk, sms)
            assert plan.work == -(-blk // 128) * b * h
            assert plan.grid == min(plan.work, sms)


def _dq_cfg(d):
    """csrc/flash_bwd_sm90.cu::DqCfg<D, PLAIN> written out: (BKV, QBUF,
    STAGES, SMEM)."""
    fits = lambda n: n + 8 * 12 + 1024 <= 232448  # noqa: E731
    bkv = 64 if d == 128 else 128
    qo, kv = 128 * d * 2, bkv * d * 2
    qbuf = 2 if fits(4 * qo + 4 * kv) else 1
    stages = (4 if fits(2 * qbuf * qo + 8 * kv) else 3 if fits(2 * qbuf * qo + 6 * kv) else 2)
    off_bar = 2 * qbuf * qo + 2 * stages * kv
    return bkv, qbuf, stages, off_bar + 8 * (2 * stages + 2 * qbuf) + 1024


@pytest.mark.parametrize("d", [64, 128])
def test_k20_plan_ring_is_k5s(d):
    """K5's plain ring (DqCfg): 128-key stages at D 64, 64 at D 128, Q and
    dO double-buffered, 4 and 3 stages, within the H100's 232,448 bytes."""
    assert bx._k5_ring(d) == _dq_cfg(d) == {64: (128, 2, 4, 197728),
                                           128: (64, 2, 3, 230480)}[d]
    plan = bx.k20_plan(1, 256, 1, d, 0, 64)
    assert (plan.stages, plan.smem) == _dq_cfg(d)[2:]
    assert plan.smem <= bx.SMEM_MAX


@pytest.mark.parametrize("call, match", [
    (lambda: bx.k20_plan(1, 256, 2, 96, 0, 64), "head_dim"),
    (lambda: bx.k20_plan(1, 256, 2, 64, 32, 64), "grid of 64"),
    (lambda: bx.k20_plan(1, 256, 2, 64, 0, 96), "grid of 64"),
    (lambda: bx.k20_plan(1, 256, 2, 64, -64, 64), "grid of 64"),
    (lambda: bx.k20_plan(1, 256, 2, 64, 192, 128), "grid of 64"),
    (lambda: bx.k20_plan(1, 256, 2, 64, 256, 64), "grid of 64"),
    (lambda: bx.k20_plan(1, 256, 2, 64, 0, 0), "grid of 64"),
    (lambda: bx.k20_plan(0, 256, 2, 64, 0, 64), "bad shape"),
    (lambda: bx.k20_plan(1, 256, 0, 64, 0, 64), "bad shape"),
], ids=["d96", "row0-off-grid", "rows-off-grid", "row0-neg", "past-s", "row0-at-s", "no-rows",
        "no-batch", "no-heads"])
def test_k20_plan_bad_arguments(call, match):
    with pytest.raises(ValueError, match=match):
        call()


def _k20_stored(b, h, s, d, row0, rows, causal, sms=5):
    """A mirror of K20's launch over the folded layout (B' = B H, H' = 1):
    each CTA's snake walk of the plan's work tiles (``dq_work`` under
    ROWBLOCK: heads fastest, then batch rows, then the range's 128-row
    blocks from row0, the last first when causal), each consumer thread's
    two rows, and the store's test (row < range_end); returns the flat
    (b' S + row) H' D offsets of the rows stored."""
    plan = bx.k20_plan(b, s, h, d, row0, rows, sms)
    bp, hp, nqb = b * h, 1, -(-rows // 128)
    stored = []
    for cta in range(plan.grid):
        n = 0
        while n * plan.grid < plan.work:
            t = n * plan.grid + (plan.grid - 1 - cta if n & 1 else cta)
            n += 1
            if t >= plan.work:
                continue
            hh, r = t % hp, t // hp
            bb, i = r % bp, r // bp
            q0 = row0 + (nqb - 1 - i if causal else i) * 128
            for wg in range(2):
                for warp in range(4):
                    for g in range(8):
                        for e in range(2):
                            row = q0 + wg * 64 + warp * 16 + g + 8 * e
                            if row < row0 + rows:
                                stored.append(((bb * s + row) * hp + hh) * d)
    return stored


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s, blk", [(256, 128), (384, 192), (320, 64), (320, 320)],
                         ids=["s256-bq128", "s384-bq192", "s320-bq64", "s320-bq320"])
def test_k20_fold_stores_every_row_once(causal, s, blk):
    """Through the fold, a call's launches (one a row-block, in either
    order) store every (b, h, row) of dq exactly once, at the offset of the
    (B, H, S, D) layout, and no row past a launch's range: rows of a work
    tile past it are another launch's."""
    b, h, d = 2, 3, 64
    x = torch.arange(b * h * s * d).view(b, h, s, d)  # each element its flat offset
    for starts in (range(0, s, blk), reversed(range(0, s, blk))):
        seen = []
        for row0 in starts:
            got = _k20_stored(b, h, s, d, row0, blk, causal)
            rows = {(o // d) % s for o in got}
            assert rows <= set(range(row0, row0 + blk))
            seen += got
        assert sorted(seen) == sorted(int(x[bb, hh, r, 0]) for bb in range(b) for hh in range(h)
                                      for r in range(s))
