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
into K4's (B H, S, 1, D) layout that its launch relies on.
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
