"""The port's flash-forward experiments against the JAX experiment files.

Each JAX function is loaded from ``benchmarks/`` with importlib and run on
the CPU as its own file runs there: ``flash_aug`` and ``flash_pair`` set
``interpret=`` themselves, ``flash_fixedmax`` and ``flash_unrolled`` run
under ``pltpu.force_tpu_interpret_mode()``. The same numpy inputs go
through the port's function on CPU tensors (its plain version).

Tolerances (rel_err_norm): fixed-max (both exp modes), aug and pair in
fp32 1e-5 (the same fp32 arithmetic in another summation order);
``flash_unrolled`` 1e-4 (its body rounds p to bf16, and an fp32 ulp of
difference in p can flip a rounding). JAX's kv blocks are multiples of
128 (its kernels tile the (., 128) lane layout).
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
from photonic_flash_attention_tpu_torch.experiments import _common
from photonic_flash_attention_tpu_torch.experiments import flash_aug_experiment as aug
from photonic_flash_attention_tpu_torch.experiments import flash_fixedmax_experiment as fixedmax
from photonic_flash_attention_tpu_torch.experiments import flash_pair_experiment as pair
from photonic_flash_attention_tpu_torch.experiments import flash_pipeline_experiment as pipeline

BENCHMARKS = Path(__file__).resolve().parent.parent / "benchmarks"
FP32_TOL = 1e-5
UNROLLED_TOL = 1e-4


@lru_cache(maxsize=None)
def jax_module(name: str):
    spec = importlib.util.spec_from_file_location(f"_jax_{name}", BENCHMARKS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("fast_exp", [False, True])
@pytest.mark.parametrize("blocks", [(64, 128), (128, 256)])
def test_flash_fixedmax_matches_jax(causal, fast_exp, blocks):
    q, k, v = _inputs(1, *[(2, 256, 2, 64)] * 3)
    with pltpu.force_tpu_interpret_mode():
        want = jax_module("flash_fixedmax_experiment").flash_fixedmax(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, block_q=blocks[0],
            block_kv=blocks[1], fast_exp=fast_exp)
    got = experiments.flash_fixedmax(*_torch(q, k, v), causal=causal, block_q=blocks[0],
                                     block_kv=blocks[1], fast_exp=fast_exp)
    assert got.dtype == torch.float32 and got.shape == q.shape
    assert _rel(got, want) <= FP32_TOL


def test_fixed_max_bound_matches_jax_prolog():
    q, k = _inputs(2, (2, 256, 3, 64), (2, 256, 3, 64))
    qt, kt = jnp.asarray(q).transpose(0, 2, 1, 3), jnp.asarray(k).transpose(0, 2, 1, 3)
    want = (jnp.linalg.norm(qt, axis=-1)
            * jnp.max(jnp.linalg.norm(kt, axis=-1), axis=-1)[..., None]) * 0.125
    got = fixedmax.fixed_max_bound(*_torch(q, k), 0.125)
    assert got.shape == (2, 3, 256) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    # It bounds every scaled score of its row (Cauchy-Schwarz).
    s = torch.einsum("bqhd,bkhd->bhqk", *_torch(q, k)) * 0.125
    assert bool((s.amax(-1) <= got * (1 + 1e-6)).all())


def test_schraudolph_exp_is_jax_bit_for_bit():
    x = np.concatenate([np.random.default_rng(3).uniform(-100, 2, 100_000),
                        [-np.inf, 0.0, -87.5, 100.0]]).astype(np.float32)
    xi = jnp.clip(jnp.asarray(x) * jnp.float32(12102203.0) + jnp.float32(1064986823.0),
                  jnp.float32(8388608.0), jnp.float32(2139095039.0)).astype(jnp.int32)
    want = np.asarray(jnp.asarray(xi).view(jnp.float32))
    got = fixedmax.schraudolph_exp(torch.from_numpy(x)).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    assert got[-4] == np.float32(2.0 ** -126)  # a masked key: JAX's clip, not 0


@pytest.mark.parametrize("shape_q, skv, blocks", [
    ((2, 256, 2, 64), 256, (64, 128)),
    ((1, 256, 3, 64), 256, (128, 128)),
    ((1, 128, 2, 32), 384, (64, 128)),
])
def test_flash_aug_matches_jax(shape_q, skv, blocks):
    b, sq, h, d = shape_q
    q, k, v = _inputs(4, shape_q, (b, skv, h, d), (b, skv, h, d))
    want = jax_module("flash_aug_experiment").flash_aug(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bq=blocks[0], bkv=blocks[1])
    got = experiments.flash_aug(*_torch(q, k, v), bq=blocks[0], bkv=blocks[1])
    assert _rel(got, want) <= FP32_TOL


@pytest.mark.parametrize("nchain", [2, 4])
@pytest.mark.parametrize("causal_shape", [(1, 512, 2, 64), (2, 256, 2, 64)])
def test_flash_pair_matches_jax(nchain, causal_shape):
    q, k, v = _inputs(5, *[causal_shape] * 3)
    bq = causal_shape[1] // (2 * nchain)
    want = jax_module("flash_pair_experiment").flash_pair(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bq=bq, bkv=128, nchain=nchain)
    got = experiments.flash_pair(*_torch(q, k, v), bq=bq, bkv=128, nchain=nchain)
    assert _rel(got, want) <= FP32_TOL


def test_flash_pair_function_does_not_depend_on_nchain():
    q, k, v = _torch(*_inputs(6, *[(1, 512, 2, 64)] * 3))
    outs = [experiments.flash_pair(q, k, v, bq=64, bkv=128, nchain=n) for n in (1, 2, 4)]
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("heads", [(4, 4), (4, 2), (4, 1)])
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_flash_unrolled_matches_jax(causal, heads, dtype):
    hq, hkv = heads
    q, k, v = _inputs(7, (1, 256, hq, 64), (1, 256, hkv, 64), (1, 256, hkv, 64))
    if dtype == "bfloat16":
        jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
        tq, tk, tv = (t.to(torch.bfloat16) for t in _torch(q, k, v))
    else:
        jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
        tq, tk, tv = _torch(q, k, v)
    with pltpu.force_tpu_interpret_mode():
        want = jax_module("flash_pipeline_experiment").flash_unrolled(
            jq, jk, jv, causal=causal, block_q=64, block_kv=128)
    got = experiments.flash_unrolled(tq, tk, tv, causal=causal, block_q=64, block_kv=128)
    assert got.dtype == tq.dtype
    assert _rel(got.float(), np.asarray(want, np.float32)) <= UNROLLED_TOL


def test_plain_versions_match_the_oracle_loosely():
    """The four functions are attention: each within its dtype's reach of
    the fp32 oracle (flash_unrolled's bf16 body, fast_exp's ~2 % p)."""
    q, k, v = _torch(*_inputs(8, *[(1, 256, 2, 64)] * 3))
    ref = _common.oracle(q, k, v, causal=True)
    assert _common.rel_err_norm(experiments.flash_aug(q, k, v, bq=128, bkv=128), ref) < 1e-5
    assert _common.rel_err_norm(experiments.flash_pair(q, k, v, bq=64, bkv=128), ref) < 1e-5
    assert _common.rel_err_norm(experiments.flash_fixedmax(q, k, v, causal=True, block_q=128,
                                                           block_kv=128), ref) < 1e-5
    fast = experiments.flash_fixedmax(q, k, v, causal=True, block_q=128, block_kv=128,
                                      fast_exp=True)
    assert _common.rel_err_norm(fast, ref) < 5e-2
    assert _common.rel_err_norm(experiments.flash_unrolled(q, k, v, causal=True, block_q=128,
                                                           block_kv=128), ref) < 1e-2


@pytest.mark.parametrize("call", [
    lambda q, k, v: experiments.flash_fixedmax(q, k, v, block_q=96),
    lambda q, k, v: experiments.flash_fixedmax(q, k, v, block_kv=96),
    lambda q, k, v: experiments.flash_aug(q, k, v, bq=96),
    lambda q, k, v: experiments.flash_aug(q, k, v, bkv=96),
    lambda q, k, v: experiments.flash_pair(q, k, v, bq=64, nchain=3),
    lambda q, k, v: experiments.flash_pair(q, k, v, bkv=96),
    lambda q, k, v: experiments.flash_unrolled(q, k, v, block_q=96),
    lambda q, k, v: experiments.flash_unrolled(q, k, v, block_kv=96),
    lambda q, k, v: experiments.flash_chunked(q, k, v, block_q=96),
    lambda q, k, v: experiments.flash_chunked(q, k, v, block_q=128, block_kv=128, unroll=4),
    lambda q, k, v: experiments.flash_triangular(q, k, v, block_q=96),
    lambda q, k, v: experiments.flash_triangular(q, k, v, block_q=128, block_kv=96),
    lambda q, k, v: experiments.flash_tri_i8(q, k, v, block_q=96, block_kv=128),
    lambda q, k, v: experiments.flash_tri_i8(q, k, v, block_q=128, block_kv=96, causal=False),
    lambda q, k, v: experiments.flash_fulltri(q, k, v, block_q=96),
    lambda q, k, v: experiments.flash_fulltri(q, k, v, block_q=128, block_kv=96),
    lambda q, k, v: experiments.flash_segmented(q, k, v, block_q=96, block_kv=96),
], ids=["fixedmax-bq", "fixedmax-bkv", "aug-bq", "aug-bkv", "pair-nchain-bq", "pair-bkv",
        "unrolled-bq", "unrolled-bkv", "chunked-bq", "chunked-span", "tri-bq", "tri-bkv",
        "tri_i8-bq", "tri_i8-bkv", "fulltri-bq", "fulltri-bkv", "segmented-block"])
def test_length_not_a_multiple_of_the_blocks_raises(call):
    q, k, v = _torch(*_inputs(9, *[(1, 256, 2, 64)] * 3))
    with pytest.raises(ValueError, match="multiple"):
        call(q, k, v)


def test_contract_errors():
    q, k, v = _torch(*_inputs(10, *[(1, 256, 2, 128)] * 3))
    with pytest.raises(ValueError, match="d \\+ 1"):
        experiments.flash_aug(q, k, v, bq=128, bkv=128)
    kg, vg = k[:, :, :1], v[:, :, :1]
    for fn in (experiments.flash_fixedmax, experiments.flash_aug, experiments.flash_pair):
        with pytest.raises(ValueError, match="GQA"):
            fn(q, kg.contiguous(), vg.contiguous())
    with pytest.raises(ValueError, match="same length"):
        experiments.flash_unrolled(q, k[:, :128], v[:, :128], block_q=128, block_kv=128)
    with pytest.raises(ValueError, match="nchain"):
        experiments.flash_pair(q, k, v, nchain=0)
    with pytest.raises(ValueError, match="square tiles"):
        experiments.flash_segmented(q, k, v, block_q=128, block_kv=256)
    with pytest.raises(ValueError, match="seg_tiles"):
        experiments.flash_segmented(q, k, v, block_q=128, block_kv=128, seg_tiles=0)
    with pytest.raises(ValueError, match="unroll"):
        experiments.flash_chunked(q, k, v, block_q=128, block_kv=128, unroll=0)


def test_mains_run_on_the_cpu_at_small_shapes():
    rows = fixedmax.main("cpu", cases=[("t", (1, 256, 2, 64), True)], fit=(1, 2),
                         slice_len=256)
    assert rows["t"]["rel_err"] < 1e-5 and rows["t"]["fast_rel_err"] < 5e-2
    assert rows["t"]["flops"] == 4.0 * 2 * 256 * 256 * 64 * 0.5
    rows = aug.main("cpu", parity_shape=(1, 256, 2, 64), cases=[(1, 256, 2, 64)], fit=(1, 2),
                    slice_len=256)
    assert rows["parity"]["rel_err"] < aug.PARITY_GATE and rows["B1 S256"]["aug_ms"] > 0
    rows = pair.main("cpu", parity_shape=(1, 512, 2, 64), cases=[(1, 512, 2, 64)], fit=(1, 2),
                     slice_len=512, sweep=[(128, 128, 2), (128, 128, 3)])
    assert "B1 S512 pair 128x128 x2" in rows and "B1 S512 pair 128x128 x3" not in rows
    rows = pipeline.main("cpu", parity_shape=(1, 256, 2, 64),
                         cases=[("g", (1, 256, 4, 2, 64), True)], fit=(1, 2), slice_len=256)
    assert rows["parity causal=True"]["max_abs_err"] < pipeline.PARITY_GATE
    assert rows["g"]["rel_err"] < 1e-2


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (fixedmax.main, aug.main, pair.main, pipeline.main, *pipeline.VARIANTS.values()):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main()
