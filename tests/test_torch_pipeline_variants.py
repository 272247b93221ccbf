"""The rest of the pipeline experiment against the JAX file: chunked,
triangular, triangular int8-QK, segmented and full-triangle forwards.

Each JAX function is loaded from ``benchmarks/flash_pipeline_experiment.py``
with importlib and run on the CPU under ``pltpu.force_tpu_interpret_mode()``;
the same numpy inputs go through the port's function on CPU tensors (its
plain version; for ``flash_segmented``, K1-with-lse's plain version per
segment).

Tolerances (rel_err_norm): chunked, triangular, int8 triangular and full
triangle 1e-4 on fp32 inputs (the bodies round p to bf16, and an fp32 ulp
of difference in p can flip a rounding); the int8 payloads and the score
scale bit for bit; the logsumexp merge 1e-6 against JAX's formula on the
same arrays; ``flash_segmented`` 1e-2, because K1's plain version keeps p in
fp32 where JAX's unrolled body rounds it to bf16 (measured: 2.8e-3 to
3.3e-3 at these shapes). JAX's kv blocks are multiples of 128 (its kernels
tile the (., 128) lane layout).
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
from photonic_flash_attention_tpu_torch.experiments import flash_pipeline_experiment as pipeline

BENCHMARKS = Path(__file__).resolve().parent.parent / "benchmarks"
UNROLLED_TOL = 1e-4
MERGE_TOL = 1e-6
SEGMENTED_TOL = 1e-2


@lru_cache(maxsize=None)
def jax_pipeline():
    spec = importlib.util.spec_from_file_location("_jax_flash_pipeline_experiment",
                                                  BENCHMARKS / "flash_pipeline_experiment.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(seed, b, s, hq, hkv, d=64):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d))]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _run_jax(name, q, k, v, **kw):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(getattr(jax_pipeline(), name)(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("geom, cfg", [
    ((1, 512, 2, 2), (128, 128, 2)),
    ((1, 256, 4, 2), (64, 128, 2)),
    ((1, 512, 2, 2), (256, 128, 4)),
], ids=["two-chunks", "gqa-bq64", "bq256-u4"])
def test_flash_chunked_matches_jax(causal, geom, cfg):
    q, k, v = _inputs(1, *geom)
    bq, bkv, u = cfg
    want = _run_jax("flash_chunked", q, k, v, causal=causal, block_q=bq, block_kv=bkv, unroll=u)
    got = experiments.flash_chunked(*_torch(q, k, v), causal=causal, block_q=bq, block_kv=bkv,
                                    unroll=u)
    assert got.dtype == torch.float32 and got.shape == q.shape
    assert _rel(got, want) <= UNROLLED_TOL


@pytest.mark.parametrize("geom, blocks", [
    ((1, 512, 2, 2), (128, 128)),
    ((1, 512, 4, 2), (256, 128)),
    ((1, 256, 2, 2), (64, 128)),
], ids=["square", "gqa-bq256", "bq64"])
def test_flash_triangular_matches_jax(geom, blocks):
    q, k, v = _inputs(2, *geom)
    want = _run_jax("flash_triangular", q, k, v, block_q=blocks[0], block_kv=blocks[1])
    got = experiments.flash_triangular(*_torch(q, k, v), block_q=blocks[0], block_kv=blocks[1])
    assert got.shape == q.shape
    assert _rel(got, want) <= UNROLLED_TOL


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_int8_payloads_and_scale_are_jax_bit_for_bit(dtype):
    q, k, _ = _inputs(3, 2, 256, 4, 2)
    q[0, 0, 0, 0] = 2.5 * np.abs(q).max()  # a value on the clip's edge
    if dtype == "bfloat16":
        jq, jk = (jnp.asarray(a, jnp.bfloat16) for a in (q, k))
        tq, tk = (t.to(torch.bfloat16) for t in _torch(q, k))
    else:
        jq, jk = jnp.asarray(q), jnp.asarray(k)
        tq, tk = _torch(q, k)
    jmod = jax_pipeline()
    (wq, wqs), (wk, wks) = jmod._quant_pt(jq), jmod._quant_pt(jk)
    q8, k8, sc = pipeline.quant_qk(tq, tk)
    assert q8.dtype == torch.int8 and np.array_equal(q8.numpy(), np.asarray(wq))
    assert np.array_equal(k8.numpy(), np.asarray(wk))
    want = np.asarray((wqs * wks * 64 ** -0.5).reshape(1).astype(jnp.float32))
    assert sc.shape == (1,) and sc.dtype == torch.float32
    assert np.array_equal(sc.numpy().view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("geom, blocks", [((1, 256, 2, 2), (128, 128)),
                                          ((1, 256, 4, 2), (64, 128))], ids=["square", "gqa"])
def test_flash_tri_i8_matches_jax(causal, geom, blocks):
    q, k, v = _inputs(4, *geom)
    want = _run_jax("flash_tri_i8", q, k, v, causal=causal, block_q=blocks[0],
                    block_kv=blocks[1])
    got = experiments.flash_tri_i8(*_torch(q, k, v), causal=causal, block_q=blocks[0],
                                   block_kv=blocks[1])
    assert got.dtype == torch.float32
    assert _rel(got, want) <= UNROLLED_TOL


def test_flash_tri_i8_bf16_matches_jax():
    q, k, v = _inputs(5, 1, 256, 2, 2)
    with pltpu.force_tpu_interpret_mode():
        want = jax_pipeline().flash_tri_i8(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                                           block_q=128, block_kv=128)
    got = experiments.flash_tri_i8(*(t.to(torch.bfloat16) for t in _torch(q, k, v)),
                                   block_q=128, block_kv=128)
    assert got.dtype == torch.bfloat16
    assert _rel(got.float(), np.asarray(want, np.float32)) <= UNROLLED_TOL


@pytest.mark.parametrize("geom, blocks", [
    ((1, 512, 2, 2), (128, 128)),
    ((1, 256, 4, 2), (64, 128)),
    ((1, 512, 2, 2), (256, 128)),
], ids=["square", "gqa-bq64", "bq256"])
def test_flash_fulltri_matches_jax(geom, blocks):
    q, k, v = _inputs(6, *geom)
    want = _run_jax("flash_fulltri", q, k, v, block_q=blocks[0], block_kv=blocks[1])
    got = experiments.flash_fulltri(*_torch(q, k, v), block_q=blocks[0], block_kv=blocks[1])
    assert _rel(got, want) <= UNROLLED_TOL


def _jax_merge(o_acc, lse_acc, o_i, lse_i):
    """JAX's merge (``flash_segmented``, benchmarks/flash_pipeline_experiment.py
    :756-765) on (B, H, S, D) outputs and (B, H, S) lse."""
    m = jnp.maximum(lse_acc, lse_i)
    m_safe = jnp.where(jnp.isfinite(m), m, 0.0)
    w1 = jnp.where(jnp.isfinite(lse_acc), jnp.exp(lse_acc - m_safe), 0.0)
    w2 = jnp.where(jnp.isfinite(lse_i), jnp.exp(lse_i - m_safe), 0.0)
    den = jnp.where(w1 + w2 == 0.0, 1.0, w1 + w2)
    o = o_acc * (w1 / den)[..., None] + o_i * (w2 / den)[..., None]
    return o, m_safe + jnp.log(den)


def test_lse_merge_matches_jax_formula():
    rng = np.random.default_rng(7)
    b, h, s, d = 2, 3, 64, 16
    o1, o2 = (rng.standard_normal((b, h, s, d)).astype(np.float32) for _ in range(2))
    l1, l2 = (rng.normal(0.0, 3.0, (b, h, s)).astype(np.float32) for _ in range(2))
    l1[0, 0, :8] = -np.inf    # one side empty
    l2[0, 1, 8:16] = -np.inf  # the other side empty
    l1[1, 2, 16:24] = l2[1, 2, 16:24] = -np.inf  # both empty
    o_w, lse_w = _jax_merge(*(jnp.asarray(a) for a in (o1, l1, o2, l2)))
    o_g, lse_g = pipeline.lse_merge(torch.from_numpy(o1).transpose(1, 2),
                                    torch.from_numpy(l1),
                                    torch.from_numpy(o2).transpose(1, 2),
                                    torch.from_numpy(l2))
    assert _rel(o_g.transpose(1, 2), o_w) <= MERGE_TOL
    lse_w = np.asarray(lse_w)
    assert np.array_equal(np.isfinite(lse_g.numpy()), np.isfinite(lse_w))
    fin = np.isfinite(lse_w)
    assert _rel(lse_g.numpy()[fin], lse_w[fin]) <= MERGE_TOL
    assert bool((o_g.transpose(1, 2)[1, 2, 16:24] == 0).all())


@pytest.mark.parametrize("seg_tiles, causal, geom", [
    (1, False, (1, 384, 2, 2)), (1, True, (1, 384, 2, 2)), (2, False, (1, 384, 2, 2)),
    (2, True, (1, 384, 2, 2)), (2, True, (1, 384, 4, 2)),
], ids=["seg1", "seg1-causal", "seg2", "seg2-causal", "seg2-causal-gqa"])
def test_flash_segmented_matches_jax(seg_tiles, causal, geom):
    q, k, v = _inputs(8, *geom)
    want = _run_jax("flash_segmented", q, k, v, causal=causal, block_q=128, block_kv=128,
                    seg_tiles=seg_tiles)
    got = experiments.flash_segmented(*_torch(q, k, v), causal=causal, block_q=128,
                                      block_kv=128, seg_tiles=seg_tiles)
    assert got.dtype == torch.float32 and got.shape == q.shape
    assert _rel(got, want) <= SEGMENTED_TOL


def test_segments_cover_each_row_block_once():
    for causal in (False, True):
        for i in range(9):
            tiles = [t for t0, n, _ in pipeline.segments(i, 9, 4, causal)
                     for t in range(t0, t0 + n)]
            assert tiles == list(range(i + 1 if causal else 9))
            assert all(n <= 4 for _, n, _ in pipeline.segments(i, 9, 4, causal))
    assert pipeline.segments(3, 9, 4, True)[-1] == (3, 1, True)


def test_plain_versions_match_the_oracle_loosely():
    """Each variant is attention: within the bf16 body's reach of the fp32
    oracle (the int8 Q.K within JAX's int8 gate)."""
    q, k, v = _torch(*_inputs(9, 1, 256, 4, 2))
    for causal in (False, True):
        ref = _common.oracle(q, k, v, causal=causal)
        assert _common.rel_err_norm(experiments.flash_chunked(
            q, k, v, causal=causal, block_q=128, block_kv=64, unroll=2), ref) < 1e-2
        assert _common.rel_err_norm(experiments.flash_tri_i8(
            q, k, v, causal=causal, block_q=128, block_kv=128), ref) < 5e-2
        assert _common.rel_err_norm(experiments.flash_segmented(
            q, k, v, causal=causal, block_q=64, block_kv=64, seg_tiles=2), ref) < 1e-5
    ref = _common.oracle(q, k, v, causal=True)
    assert _common.rel_err_norm(experiments.flash_triangular(q, k, v, block_q=128,
                                                             block_kv=64), ref) < 1e-2
    assert _common.rel_err_norm(experiments.flash_fulltri(q, k, v, block_q=64,
                                                          block_kv=128), ref) < 1e-2


def test_chunked_where_jax_drops_tail_keys_the_port_raises():
    """S 640 with 256-key chunks: JAX's grid ``S // (block_kv * unroll)``
    never reads keys 512-639, so every row is off; the port raises."""
    q, k, v = _inputs(10, 1, 640, 2, 2)
    kw = dict(causal=False, block_q=128, block_kv=128, unroll=2)
    dropped = _run_jax("flash_chunked", q, k, v, **kw)
    ref = _common.oracle(*_torch(q, k, v), causal=False).numpy()
    assert float(np.abs(dropped - ref).max()) > 0.1
    with pytest.raises(ValueError, match="multiple"):
        experiments.flash_chunked(*_torch(q, k, v), **kw)


def test_cli_runs_the_named_variant(monkeypatch):
    ran = []
    variants = {"tri": lambda device: ran.append(("tri", device))}
    for argv in (["prog", "tri", "--device", "cpu"], ["prog"]):
        monkeypatch.setattr("sys.argv", argv)
        _common.cli(lambda device: ran.append(("main", device)), "d", variants)
    assert ran == [("tri", "cpu"), ("main", "cuda")]
    assert set(pipeline.VARIANTS) == {"chunked", "tri", "i8", "seg", "fulltri"}


def test_new_mains_run_on_the_cpu_at_small_shapes():
    fit = (1, 2)
    rows = pipeline.main_chunked("cpu", parity_shape=(1, 256, 2, 64),
                                 cases=[("g", (1, 256, 4, 2, 64), True)], fit=fit,
                                 sweep=[(128, 128, 2), (64, 64, 4), (256, 256, 2)], slice_len=256)
    timed = [r for r in rows.values() if "chunked_ms" in r]
    assert len(timed) == 2  # 512-key chunks do not divide 256: skipped, as in JAX
    assert all(r["rel_err"] < 1e-2 and r["chunked_ms"] > 0 for r in timed)
    assert max(r["max_abs_err"] for r in rows.values() if "gate" in r) < pipeline.PARITY_GATE
    rows = pipeline.main_tri("cpu", parity_shape=(1, 256, 2, 64),
                             cases=[("t", (1, 256, 2, 2, 64))], blocks=[(128, 128), (96, 128)],
                             fit=fit, slice_len=256)
    assert set(rows) == {"parity", "t tri bq=128 bkv=128"}  # 96 does not divide 256: skipped
    assert rows["t tri bq=128 bkv=128"]["flops"] == 4.0 * 2 * 256 * 256 * 64 * 0.5
    rows = pipeline.main_i8("cpu", parity_shape=(1, 256, 2, 64),
                            cases=[("n", (1, 256, 4, 2, 64), False)], fit=fit, slice_len=256)
    assert rows["parity"]["rel_err"] < pipeline.I8_PARITY_GATE and rows["n"]["rel_err"] < 5e-2
    assert all(rows["n"][key] > 0 for key in ("tri_i8_ms", "tri_i8_kernel_ms", "k1_ms",
                                               "k1_kernel_ms"))
    rows = pipeline.main_seg("cpu", parity_shape=(1, 512, 2, 64),
                             cases=[("s", (1, 512, 2, 64))], block=128, fit=fit, slice_len=512)
    assert rows["s"]["segmented_ms"] > 0 and rows["s"]["k1_ms"] > 0
    assert rows["s"]["rel_err"] < 1e-2  # bf16 inputs and output
    rows = pipeline.main_fulltri("cpu", parity_shape=(1, 256, 2, 64),
                                 cases=[("f", (1, 256, 4, 2, 64))], fit=fit, slice_len=256)
    assert rows["f"]["rel_err"] < 1e-2 and rows["f"]["fulltri_ms"] > 0
