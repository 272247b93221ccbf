"""Port parity: quantized flash attention (int8 / fp8) and its engine kinds.

The same numpy inputs (seeded) go to the JAX ``ops/flash_fp8.py`` and
``flash_attention_unrolled(int8_qk=True)`` (Pallas in interpret mode on the
CPU) and to the port's ``ops/flash_fp8.py`` / ``ops/flash_unrolled.py``,
which run the plain versions of K1's quantized modes and of K6 on the CPU.

Bounds:
- the quantization helpers: int8 and e4m3 payloads bit-exact, scales equal
  in fp32;
- each plain version against its JAX function at ``block_kv=128`` (the
  port's P requant block): ``rel_err_norm`` <= 1e-5 for fp32 inputs. Both
  sides quantize to the same payloads and requantize P on the same blocks,
  so only exp and the order of fp32 sums differ (measured <= 1e-6). bf16
  inputs and the unrolled int8-QK kind (P rounded to bf16 for P.V, as in
  JAX) <= 5e-4: a 1-ulp exp difference can move a P across a bf16 rounding
  boundary, or a bf16 output across one (measured <= 6.1e-5; max abs
  3.9e-3 on a bf16 output);
- each function at its defaults against the fp32 oracle, under the JAX
  tests' gates (``tests/unit/test_flash_quant.py``): int8 full and K6 int8
  0.03, int8-QK and fp8-QK 0.05, K6 fp8 0.06, outliers 0.06 / 0.1.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photonic_flash_attention_tpu.ops import flash_fp8 as jfp8
from photonic_flash_attention_tpu.ops.flash_unrolled import (
    _quant_per_tensor as jax_quant_per_tensor,
    flash_attention_unrolled as jax_unrolled,
)
from photonic_flash_attention_tpu_torch.config import reset_config
from photonic_flash_attention_tpu_torch.core.engine import AttentionEngine, reset_engine
from photonic_flash_attention_tpu_torch.core.router import AdaptiveRouter, KernelKind
from photonic_flash_attention_tpu_torch.ops import _build, flash_fp8
from photonic_flash_attention_tpu_torch.ops.flash import (
    flash_attention_qk_quant,
    flash_attention_qk_quant_plain,
)
from photonic_flash_attention_tpu_torch.ops.flash_unrolled import (
    _quant_per_tensor,
    flash_attention_unrolled,
    unrolled_supported,
)
from photonic_flash_attention_tpu_torch.ops.reference import attention_reference

from .conftest import rel_err_norm


@pytest.fixture(autouse=True)
def _fresh():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    reset_config()
    reset_engine()
    yield
    reset_config()
    reset_engine()
    torch.set_num_threads(n)


QTYPES = {"int8": (jnp.int8, torch.int8, 127.0), "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn, 448.0)}


def _bits(a) -> np.ndarray:
    """The payload's bytes, for a bit-exact comparison of int8 and e4m3."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy()
    return np.asarray(a).view(np.uint8)


def _x(dtype, seed=0, shape=(2, 200, 3, 64)):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    x[0, 7] *= 50.0  # an outlier token
    x[1, 130:] = 0.0  # an all-zero block: scale 1
    return jnp.asarray(x, dtype), torch.from_numpy(np.array(jnp.asarray(x, dtype), np.float32)).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)


# -- the quantization helpers ------------------------------------------------


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("qname", list(QTYPES))
@pytest.mark.parametrize("helper", ["row_block", "col", "per_tensor"])
def test_quantization_helpers_match_jax_bit_exact(helper, qname, dtype):
    """Payloads bit-exact, scales equal. JAX's helpers take (B, H, S, D)
    with S padded to a block multiple (zeros), the port's (B, S, H, D)."""
    jq, tq, qmax = QTYPES[qname]
    jx, tx = _x(dtype)
    s = tx.shape[1]
    if helper == "row_block":
        jp, js = jfp8._row_block_quantize(
            jnp.pad(jx.transpose(0, 2, 1, 3), ((0, 0), (0, 0), (0, 256 - s), (0, 0))), jq, qmax)
        tp, ts = flash_fp8._row_block_quantize(tx, tq, qmax)
        jp, js = np.asarray(jp)[:, :, :s].transpose(0, 2, 1, 3), np.asarray(js)[:, :, :s]
        assert ts.shape == (2, 3, s)
    elif helper == "col":
        jp, js = jfp8._col_quantize(jx.transpose(0, 2, 1, 3), jq, qmax)
        tp, ts = flash_fp8._col_quantize(tx, tq, qmax)
        jp = np.asarray(jp).transpose(0, 2, 1, 3)
        assert ts.shape == (2, 3, 64)
    else:
        jp, js = jfp8._per_tensor_quant(jx, jq, qmax)
        tp, ts = flash_fp8._per_tensor_quant(tx, tq, qmax)
        assert ts.ndim == 0
    assert tp.dtype == tq
    assert np.array_equal(_bits(tp), _bits(jp))
    assert ts.dtype == torch.float32 and np.array_equal(ts.numpy(), np.asarray(js, np.float32))


def test_unrolled_quant_per_tensor_matches_jax():
    jx, tx = _x(jnp.float32, seed=3)
    jp, js = jax_quant_per_tensor(jx)
    tp, ts = _quant_per_tensor(tx)
    assert np.array_equal(_bits(tp), _bits(jp)) and float(ts) == float(js)


# -- the plain versions against the JAX functions at block_kv=128 -------------


def _quant_fns():
    return {
        "int8qk": (jfp8.flash_attention_int8qk, flash_fp8.flash_attention_int8qk),
        "fp8qk": (jfp8.flash_attention_fp8qk, flash_fp8.flash_attention_fp8qk),
        "int8full": (jfp8.flash_attention_int8full, flash_fp8.flash_attention_int8full),
        "fp8": (jfp8.flash_attention_fp8, flash_fp8.flash_attention_fp8),
        "int8": (jfp8.flash_attention_int8, flash_fp8.flash_attention_int8),
    }


# (B, Sq, Skv, Hq, Hkv, causal, outlier token, dtype)
PARITY_CASES = [
    (1, 200, 333, 4, 2, False, False, "f32"),  # unaligned, GQA
    (2, 256, 256, 4, 4, True, False, "f32"),
    (1, 256, 256, 2, 2, False, True, "f32"),  # a 30x key and a 50x value token
    (1, 128, 384, 4, 2, True, False, "f32"),  # Sq < Skv, causal end-aligned, GQA
    (1, 256, 256, 4, 2, True, False, "bf16"),
]


def _case_id(c):
    b, sq, skv, hq, hkv, causal, outlier, dt = c
    return f"b{b}-q{sq}-kv{skv}-h{hq}/{hkv}-{'causal' if causal else 'full'}{'-outlier' if outlier else ''}-{dt}"


def _qkv(b, sq, skv, hq, hkv, d=64, outlier=False, seed=1):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
    if outlier:
        k[0, 17] *= 30.0
        v[0, 7] *= 50.0
    return q, k, v


def _both(arrays, dt):
    """The same values as JAX arrays and torch tensors of dtype ``dt``."""
    jdt = jnp.bfloat16 if dt == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dt == "bf16" else torch.float32
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


@pytest.mark.parametrize("case", PARITY_CASES, ids=_case_id)
@pytest.mark.parametrize("name", ["int8qk", "fp8qk", "int8full", "fp8", "int8"])
def test_plain_matches_jax_at_block_128(name, case):
    b, sq, skv, hq, hkv, causal, outlier, dt = case
    jf, tf = _quant_fns()[name]
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(b, sq, skv, hq, hkv, outlier=outlier), dt)
    want = jf(jq, jk, jv, causal=causal, block_q=128, block_kv=128)
    got = tf(tq, tk, tv, causal=causal, block_kv=128)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    assert rel_err_norm(got.float().numpy(), np.asarray(want, np.float32)) <= (
        1e-5 if dt == "f32" else 5e-4)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_unrolled_int8_qk_matches_jax(dt, causal):
    """P.V in bf16 with V cast to bf16, output in V's dtype, as the JAX
    unrolled kernel; GQA."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(2, 256, 256, 4, 2, seed=4), dt)
    want = jax_unrolled(jq, jk, jv, causal=causal, int8_qk=True, block_q=128, block_kv=128)
    got = flash_attention_unrolled(tq, tk, tv, causal=causal, int8_qk=True)
    assert got.dtype == tv.dtype
    assert rel_err_norm(got.float().numpy(), np.asarray(want, np.float32)) <= 5e-4
    assert unrolled_supported(256, 64, int8_qk=True) and unrolled_supported(256, 96, int8_qk=True)
    assert not unrolled_supported(256, 129, int8_qk=True)


def test_qk_quant_payload_entry_is_its_plain_version_on_cpu():
    """The payload-level K1 entry takes the plain version for CPU tensors
    and launches nothing."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 64, 96, 2, 1, seed=5))
    q8, k8, sc = flash_fp8._qk_per_tensor(q, k, torch.int8, 127.0, 0.125)
    v8, vs = flash_fp8._col_quantize(v, torch.int8, 127.0)
    before = dict(_build.LAUNCHES)
    got = flash_attention_qk_quant(q8, k8, v8, sc, causal=True, v_scales=vs, out_dtype=torch.float32)
    want = flash_attention_qk_quant_plain(q8, k8, v8, sc, causal=True, v_scales=vs,
                                          out_dtype=torch.float32)
    assert torch.equal(got, want) and dict(_build.LAUNCHES) == before


# -- at the defaults, against the fp32 oracle, under the JAX gates -----------


def _oracle_err(fn, q, k, v, causal=False):
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out = fn(tq, tk, tv, causal=causal)
    ref = attention_reference(tq, tk, tv, causal=causal)[0]
    return rel_err_norm(out.numpy(), ref.numpy())


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("qdtype", ["fp8", "int8"])
@pytest.mark.parametrize(
    "shapes, causal",
    [
        (((2, 256, 4, 64),) * 3, False),
        (((1, 256, 4, 64),) * 3, True),
        (((1, 200, 2, 64), (1, 333, 2, 64), (1, 333, 2, 64)), False),
        (((1, 128, 8, 64), (1, 128, 2, 64), (1, 128, 2, 64)), False),
    ],
    ids=["oracle", "causal", "unaligned", "gqa"],
)
def test_block_quant_within_the_jax_gates(qdtype, shapes, causal, rng):
    q, k, v = (_normal(rng, s) for s in shapes)
    fn = lambda *a, **kw: flash_fp8.flash_attention_quant(*a, qdtype=qdtype, **kw)  # noqa: E731
    assert _oracle_err(fn, q, k, v, causal) < (0.03 if qdtype == "int8" else 0.06)


@pytest.mark.parametrize("qdtype", ["fp8", "int8"])
def test_block_quant_outlier_token(qdtype, rng):
    """Per-row-block scales localize the damage of a 50x value token."""
    q, k, v = (_normal(rng, (1, 256, 2, 64)) for _ in range(3))
    v[0, 7] *= 50.0
    fn = lambda *a, **kw: flash_fp8.flash_attention_quant(*a, qdtype=qdtype, **kw)  # noqa: E731
    assert _oracle_err(fn, q, k, v) < 0.06


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("name, gate", [("int8qk", 0.05), ("fp8qk", 0.05), ("int8full", 0.03)])
def test_per_tensor_kinds_within_the_jax_gates(name, gate, causal, rng):
    q, k, v = (_normal(rng, (2, 384 if name == "int8qk" else 256, 4, 64)) for _ in range(3))
    assert _oracle_err(_quant_fns()[name][1], q, k, v, causal) < gate


@pytest.mark.parametrize("name, gate", [("int8qk", 0.05), ("fp8qk", 0.05), ("int8full", 0.03)])
def test_per_tensor_kinds_gqa_unaligned(name, gate, rng):
    q = _normal(rng, (1, 200, 4, 64))
    k, v = _normal(rng, (1, 333, 2, 64)), _normal(rng, (1, 333, 2, 64))
    assert _oracle_err(_quant_fns()[name][1], q, k, v) < gate


def test_int8full_outlier_key_within_the_reference_gate(rng):
    q, k, v = (_normal(rng, (1, 256, 2, 64)) for _ in range(3))
    k[0, 17] *= 30.0
    assert _oracle_err(flash_fp8.flash_attention_int8full, q, k, v) < 0.1


@pytest.mark.parametrize("name", ["int8qk", "fp8qk", "int8full", "fp8", "int8"])
def test_output_dtypes_follow_jax(name):
    """int8/fp8-QK and int8 full: V's dtype if bf16/fp32, else bf16; K6:
    q's dtype."""
    fn = _quant_fns()[name][1]
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 64, 64, 2, 2, seed=6))
    assert fn(q.bfloat16(), k.bfloat16(), v.bfloat16()).dtype == torch.bfloat16
    assert fn(q, k, v).dtype == torch.float32
    half = fn(q.half(), k.half(), v.half())
    assert half.dtype == (torch.float16 if name in ("fp8", "int8") else torch.bfloat16)


@pytest.mark.parametrize(
    "call, error",
    [
        (lambda q: flash_fp8.flash_attention_int8qk(q.requires_grad_(), q, q), "inference only"),
        (lambda q: flash_fp8.flash_attention_fp8(q, q, q, block_kv=512), "128-key blocks"),
        (lambda q: flash_fp8.flash_attention_int8full(q, q[:, :32], q[:, :32], causal=True),
         "no key"),
        (lambda q: flash_fp8.flash_attention_quant(q, q, q, qdtype="int4"), "qdtype"),
        (lambda q: flash_attention_unrolled(q, q, q, int8_qk=True, k_bias=torch.zeros(1, 64)),
         "not ported"),
    ],
    ids=["grad", "block_kv", "causal_rows_without_keys", "qdtype", "unrolled_int8_k_bias"],
)
def test_contract_errors(call, error):
    q = torch.zeros(1, 64, 2, 64)
    with pytest.raises((ValueError, RuntimeError, NotImplementedError), match=error):
        call(q)


# -- the engine's five quantized kinds through _run ----------------------------


ENGINE_KINDS = {
    "flash_fp8": lambda q, k, v, c: jfp8.flash_attention_fp8(q, k, v, causal=c, block_q=128,
                                                             block_kv=128),
    "flash_fp8qk": lambda q, k, v, c: jfp8.flash_attention_fp8qk(q, k, v, causal=c, block_q=128,
                                                                 block_kv=128),
    "flash_int8qk": lambda q, k, v, c: jfp8.flash_attention_int8qk(q, k, v, causal=c, block_q=128,
                                                                   block_kv=128),
    "flash_int8full": lambda q, k, v, c: jfp8.flash_attention_int8full(q, k, v, causal=c,
                                                                       block_q=128, block_kv=128),
    "flash_unrolled_int8qk": lambda q, k, v, c: jax_unrolled(q, k, v, causal=c, int8_qk=True,
                                                             block_q=128, block_kv=128),
}


@pytest.mark.parametrize("kind", list(ENGINE_KINDS))
def test_engine_runs_each_quant_kind_as_jax(kind):
    """``AttentionEngine._run`` on CPU tensors against the JAX function the
    JAX engine runs for the kind (at block_kv 128), fp32, causal, GQA."""
    eng = AttentionEngine(router=AdaptiveRouter(exploration_rate=0.0, seed=0),
                          enable_fp8=True, enable_int8=True)
    q, k, v = _qkv(2, 256, 256, 4, 2, seed=7)
    out, w = eng._run(KernelKind(kind), *(torch.from_numpy(a) for a in (q, k, v)),
                      None, None, None, True, False)
    want = ENGINE_KINDS[kind](*(jnp.asarray(a) for a in (q, k, v)), True)
    assert w is None and out.dtype == torch.float32
    bound = 5e-4 if kind == "flash_unrolled_int8qk" else 1e-5
    assert rel_err_norm(out.numpy(), np.asarray(want)) <= bound

