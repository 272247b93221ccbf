"""Port parity: relative-position biases and K1's structured-bias entries.

``ops/rel_bias.py`` against the JAX module (buckets exactly, over every
offset in [-4096, 4096]; ALiBi slopes; ``materialize``), and the plain
``flash_attention(rel_bias=...)`` / ``flash_attention(attn_bias=...)``
against the JAX ``flash_attention`` (Pallas in interpret mode) at the
shapes of ``tests/unit/test_flash_relbias.py``: fp32 within 2e-5/2e-5 as
there, bf16 within ``assert_close``'s 2e-2. Then the JAX function's
argument errors, the relative-bias gradients (q, k, v and the T5 table or
the ALiBi slopes) against ``jax.grad`` within 5e-4, and the
``NotImplementedError`` of ``attn_bias`` under autograd (JAX has no
backward there either).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photonic_flash_attention_tpu.ops import rel_bias as jrb
from photonic_flash_attention_tpu.ops.flash import flash_attention as jax_flash
from photonic_flash_attention_tpu_torch.ops import rel_bias as trb
from photonic_flash_attention_tpu_torch.ops.flash import flash_attention
from photonic_flash_attention_tpu_torch.ops.reference import DEFAULT_MASK_VALUE

from .conftest import assert_close

REL = np.arange(-4096, 4097, dtype=np.int32)
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": 2e-5, "bf16": 2e-2}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("bidirectional", [True, False], ids=["bidirectional", "causal"])
def test_buckets_equal_jax_over_every_offset(bidirectional):
    kw = dict(bidirectional=bidirectional, num_buckets=32, max_distance=128)
    want = np.asarray(jrb.relative_position_bucket(jnp.asarray(REL), **kw))
    got = trb.relative_position_bucket(torch.from_numpy(REL), **kw).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(trb.bucket_range(-4096, REL.size, **kw).numpy(), want)
    statics = [trb.static_bucket(int(r), **kw) for r in REL[::37]]
    assert statics == [jrb.static_bucket(int(r), **kw) for r in REL[::37]]


@pytest.mark.parametrize("heads", [8, 12, 16])
def test_alibi_slopes_equal_jax(heads):
    np.testing.assert_array_equal(trb.alibi_slopes(heads).numpy(),
                                  np.asarray(jrb.alibi_slopes(heads)))


def _t5_specs(h=4, bidirectional=True, nb=32, maxd=128, seed=1):
    table = (np.random.default_rng(seed).standard_normal((nb, h)) * 0.5).astype(np.float32)
    return (jrb.T5RelBias(jnp.asarray(table), bidirectional, maxd),
            trb.T5RelBias(torch.from_numpy(table), bidirectional, maxd))


def _alibi_specs(h):
    return jrb.ALiBi(jrb.alibi_slopes(h)), trb.ALiBi(trb.alibi_slopes(h))


@pytest.mark.parametrize("kind, sq, skv, offset", [
    ("t5_bidirectional", 96, 96, None),
    ("t5_causal", 128, 384, None),
    ("t5_causal", 40, 40, 0),
    ("alibi", 100, 300, None),
])
def test_materialize_equals_jax(kind, sq, skv, offset):
    j, t = _alibi_specs(8) if kind == "alibi" else _t5_specs(bidirectional=kind == "t5_bidirectional")
    want = np.asarray(jrb.materialize(j, sq, skv, kv_offset=offset))
    got = trb.materialize(t, sq, skv, kv_offset=offset).numpy()
    assert got.shape == want.shape == (1, j.num_heads, sq, skv)
    np.testing.assert_array_equal(got, want)
    kind_t, tab = trb.bias_table(t)
    assert kind_t == jrb.bias_table(j)[0] and trb.rel_statics(t) == jrb.rel_statics(j)
    np.testing.assert_array_equal(tab.numpy(), np.asarray(jrb.bias_table(j)[1]))


@pytest.mark.parametrize("kind", ["t5_bidirectional", "t5_causal", "alibi"])
def test_bias_from_table_equals_jax(kind):
    j, t = _alibi_specs(8) if kind == "alibi" else _t5_specs(bidirectional=kind == "t5_bidirectional")
    rel = np.random.default_rng(2).integers(-300, 301, (5, 7)).astype(np.int32)
    (jkind, jtab), (tkind, ttab) = jrb.bias_table(j), trb.bias_table(t)
    _, bidir, nb, maxd = jrb.rel_statics(j)
    kw = dict(bidirectional=bidir, num_buckets=nb, max_distance=maxd)
    want = np.asarray(jrb.bias_from_table(jkind, jtab, jnp.asarray(rel), **kw))
    got = trb.bias_from_table(tkind, ttab, torch.from_numpy(rel), **kw).numpy()
    assert got.shape == want.shape == (j.num_heads, 5, 7)
    np.testing.assert_array_equal(got, want)


def _qkv(b=2, s=256, h=4, d=64, skv=None, seed=0):
    rng = np.random.default_rng(seed)
    skv = skv or s
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, d), (b, skv, h, d), (b, skv, h, d))]


def _both(arrs, dtype):
    jdt, tdt = DTYPES[dtype]
    return [jnp.asarray(a, jdt) for a in arrs], [torch.from_numpy(a).to(tdt) for a in arrs]


# (name, dtype, b, s, skv, h, causal, kind): tests/unit/test_flash_relbias.py.
REL_CASES = [
    ("t5_bidirectional", "f32", 2, 256, 256, 4, False, "t5"),
    ("t5_causal", "f32", 2, 256, 256, 4, True, "t5"),
    ("t5_cross_offset", "f32", 2, 128, 384, 4, True, "t5"),
    ("alibi", "f32", 2, 256, 256, 8, True, "alibi"),
    ("t5_causal", "bf16", 2, 256, 256, 4, True, "t5"),
    ("alibi", "bf16", 2, 256, 256, 8, True, "alibi"),
]


@pytest.mark.parametrize("case", REL_CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def test_rel_bias_plain_matches_jax(case):
    _, dtype, b, s, skv, h, causal, kind = case
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(b, s, h, skv=skv), dtype)
    if kind == "t5":
        jspec, tspec = _t5_specs(h, bidirectional=not causal)
        scale = 1.0
    else:
        jspec, tspec = _alibi_specs(h)
        scale = None
    want = jax_flash(jq, jk, jv, causal=causal, sm_scale=scale, rel_bias=jspec,
                     block_q=128, block_kv=128)
    got = flash_attention(tq, tk, tv, causal=causal, sm_scale=scale, rel_bias=tspec)
    assert got.dtype == tq.dtype
    assert_close(got.float().numpy(), np.asarray(want, np.float32), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("hb, real, causal", [(1, False, False), (4, True, True)],
                         ids=["mask_b1", "real_bias_causal"])
def test_attn_bias_plain_matches_jax(hb, real, causal):
    q, k, v = _qkv(2, 256, 4)
    rng = np.random.default_rng(3)
    bias = rng.standard_normal((2, hb, 256, 256)).astype(np.float32) if real else \
        np.zeros((2, hb, 256, 256), np.float32)
    bias[rng.random(bias.shape) < 0.2] = DEFAULT_MASK_VALUE
    bias[..., 0] = 0.0
    (jq, jk, jv), (tq, tk, tv) = _both((q, k, v), "f32")
    want = jax_flash(jq, jk, jv, causal=causal, attn_bias=jnp.asarray(bias),
                     block_q=128, block_kv=128)
    got = flash_attention(tq, tk, tv, causal=causal, attn_bias=torch.from_numpy(bias))
    assert_close(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


def _bad_calls(lib):
    """(kwargs, message) of calls both packages refuse."""
    spec8 = _t5_specs(8)[lib]
    spec4 = _t5_specs(4)[lib]
    arr = (lambda a: jnp.asarray(a)) if lib == 0 else torch.from_numpy
    lens = arr(np.full((2,), 32, np.int32))
    kb = arr(np.zeros((2, 32), np.float32))
    ab = arr(np.zeros((2, 1, 32, 32), np.float32))
    return [
        (dict(rel_bias=spec8), "heads"),
        (dict(attn_bias=ab, kv_lens=lens), "attn_bias cannot be combined"),
        (dict(attn_bias=ab, rel_bias=spec4), "attn_bias cannot be combined"),
        (dict(attn_bias=arr(np.zeros((2, 3, 32, 32), np.float32))), "attn_bias must be"),
        (dict(attn_bias=arr(np.zeros((2, 1, 32, 31), np.float32))), "attn_bias must be"),
        (dict(rel_bias=spec4, k_bias=kb), "cannot be combined with rel_bias"),
    ]


@pytest.mark.parametrize("i", range(6))
def test_argument_errors_as_jax(i):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(2, 32, 4, d=16), "f32")
    jkw, msg = _bad_calls(0)[i]
    tkw, _ = _bad_calls(1)[i]
    with pytest.raises(ValueError, match=msg):
        jax_flash(jq, jk, jv, **jkw)
    with pytest.raises(ValueError, match=msg):
        flash_attention(tq, tk, tv, **tkw)


# (name, b, sq, skv, h, causal, kind): the JAX tests' gradient cases
# (T5 causal, ALiBi slopes) plus T5 bidirectional and the cross offset.
GRAD_CASES = [
    ("t5_bidirectional", 1, 256, 256, 2, False, "t5"),
    ("t5_causal", 1, 256, 256, 2, True, "t5"),
    ("t5_cross_offset", 1, 128, 384, 2, True, "t5"),
    ("alibi", 1, 128, 128, 4, True, "alibi"),
]


@pytest.mark.parametrize("case", GRAD_CASES, ids=lambda c: c[0])
def test_rel_bias_grads_match_jax(case):
    """q, k, v and the T5 table or ALiBi slopes: ``torch.autograd`` through
    the port (K1's relative-bias mode's plain version, the blockwise
    backward, the gather in ``bias_vector``) against ``jax.grad`` of the
    JAX function (Pallas forward in interpret mode, the XLA ``_flash_bwd``),
    5e-4 as the JAX tests (tests/unit/test_flash_relbias.py:131, :169)."""
    import jax

    name, b, sq, skv, h, causal, kind = case
    q, k, v = _qkv(b, sq, h, skv=skv)
    g = np.random.default_rng(5).standard_normal((b, sq, h, 64)).astype(np.float32)
    if kind == "t5":
        jspec, tspec = _t5_specs(h, bidirectional=not causal)
        table, scale = np.array(jspec.table), 1.0
        jmake = lambda t: jrb.T5RelBias(t, not causal, 128)  # noqa: E731
        tmake = lambda t: trb.T5RelBias(t, not causal, 128)  # noqa: E731
    else:
        table, scale = np.array(jrb.alibi_slopes(h)), None
        jmake, tmake = jrb.ALiBi, trb.ALiBi

    def jax_loss(q, k, v, t):
        o = jax_flash(q, k, v, causal=causal, sm_scale=scale, rel_bias=jmake(t),
                      block_q=128, block_kv=128)
        return jnp.sum(o * g)

    want = jax.grad(jax_loss, argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in (q, k, v, table)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, table)]
    out = flash_attention(*leaves[:3], causal=causal, sm_scale=scale, rel_bias=tmake(leaves[3]))
    (out * torch.from_numpy(g)).sum().backward()
    for label, t, w in zip(("dq", "dk", "dv", "d" + ("table" if kind == "t5" else "slopes")),
                           leaves, want):
        assert_close(t.grad.numpy(), np.asarray(w), atol=5e-4, rtol=5e-4, err_msg=label)


@pytest.mark.parametrize("what", ["attn_bias"])
def test_structured_bias_has_no_backward_yet(what):
    """``attn_bias`` is forward only, as in JAX; inference is fine."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 32, 4, d=16))
    kw = dict(attn_bias=torch.zeros(1, 4, 32, 32, requires_grad=True))
    with pytest.raises(NotImplementedError, match="no backward"):
        flash_attention(q, k, v, **kw)
    with pytest.raises(NotImplementedError, match="no backward"):
        flash_attention(q.requires_grad_(), k, v, attn_bias=torch.zeros(1, 4, 32, 32))
    with torch.no_grad():  # inference is fine
        assert torch.isfinite(flash_attention(q, k, v, **kw)).all()
