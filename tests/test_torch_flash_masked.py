"""Port parity: flash attention with the key-padding streams (kv_lens, k_bias).

The same numpy inputs go to the JAX ``flash_attention`` /
``flash_attention_with_lse`` / ``flash_attention_unrolled`` (Pallas in
interpret mode on the CPU) and to the port (the plain version of kernel K1
with its streams, and the plain blockwise masked backward). Every row
keeps key 0 unmasked unless a case says otherwise, so no row's valid keys
are all masked by the bias (where the JAX kernel's result depends on its
tile size).

Bounds: fp32 forward and lse ``rel_err_norm`` <= 1e-5; fp32 gradients
(dq, dk, dv, dk_bias) <= 1e-5, dk_bias <= 1e-4 (a sum over heads and rows
of terms that cancel); bf16 ``assert_close`` (2e-2) on the unrolled route,
whose JAX kernel computes its products in bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photonic_flash_attention_tpu.ops.flash import (
    flash_attention as jax_flash,
    flash_attention_with_lse as jax_flash_lse,
)
from photonic_flash_attention_tpu.ops.flash_unrolled import (
    flash_attention_unrolled as jax_unrolled,
)
from photonic_flash_attention_tpu_torch.ops import _build
from photonic_flash_attention_tpu_torch.ops.flash import (
    flash_attention,
    flash_attention_plain,
    flash_attention_with_lse,
)
from photonic_flash_attention_tpu_torch.ops.flash_unrolled import (
    flash_attention_best,
    flash_attention_unrolled,
)
from photonic_flash_attention_tpu_torch.ops.reference import (
    DEFAULT_MASK_VALUE,
    attention_blockwise,
    attention_reference,
    cdiv,
    round_up,
)

from .conftest import assert_close, rel_err_norm

# (B, Sq, Skv, Hq, Hkv, D, causal)
CASES = [
    (2, 128, 128, 2, 2, 64, False),
    (2, 128, 128, 4, 2, 64, True),
    (2, 64, 192, 2, 2, 64, True),  # Sq < Skv, end-aligned: the chunked-prefill shape
    (3, 100, 100, 2, 1, 128, False),
]


#: The card's edges of the streams and the dense bias
#: (chip_smoke.py::check_k1_edges): (B, Sq, Skv, Hq, Hkv, D, causal, kv_lens)
#: with a length-0 row, and (Skv, Hb, causal) of the dense bias at Sq 129:
#: Skv 301 is the card's cp.async side, 300 its TMA side.
EDGE_STREAM_CASES = [
    (3, 129, 300, 4, 2, 64, True, (300, 0, 129)),
    (2, 300, 300, 4, 4, 128, False, (0, 300)),
]
EDGE_DENSE_CASES = [(skv, hb, hb == 1) for skv in (301, 300) for hb in (1, 4)]


def _case_id(c):
    b, sq, skv, hq, hkv, d, causal = c
    return f"b{b}q{sq}k{skv}h{hq}g{hkv}d{d}{'c' if causal else 'n'}"


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(case, seed=0, lens=True, bias=True):
    """q, k, v, kv_lens (B,) int32 >= 1, k_bias (B, Skv) with ~20% holes;
    key 0 always valid."""
    b, sq, skv, hq, hkv, d, _ = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
    kv_lens = None
    if lens:
        kv_lens = np.array([skv - 37 * i for i in range(b)], np.int32).clip(1, skv)
    k_bias = None
    if bias:
        k_bias = np.where(rng.random((b, skv)) < 0.2, DEFAULT_MASK_VALUE,
                          rng.standard_normal((b, skv))).astype(np.float32)
        k_bias[:, 0] = 0.0
    return q, k, v, kv_lens, k_bias


def _jax(*arrs, dtype=jnp.float32):
    return [None if a is None else jnp.asarray(a, a.dtype if a.dtype == np.int32 else dtype)
            for a in arrs]


def _torch(*arrs, dtype=torch.float32):
    return [None if a is None else torch.from_numpy(a).to(
        torch.int32 if a.dtype == np.int32 else dtype) for a in arrs]


@pytest.mark.parametrize("streams", ["lens", "bias", "both"])
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_flash_with_streams_matches_jax(case, streams):
    causal = case[-1]
    arrs = _inputs(case, lens=streams != "bias", bias=streams != "lens")
    jq, jk, jv, jl, jb = _jax(*arrs)
    tq, tk, tv, tl, tb = _torch(*arrs)
    out = flash_attention(tq, tk, tv, causal=causal, kv_lens=tl, k_bias=tb)
    ref = jax_flash(jq, jk, jv, causal=causal, kv_lens=jl, k_bias=jb)
    assert out.shape == tq.shape and out.dtype == torch.float32
    assert rel_err_norm(out.numpy(), ref) <= 1e-5
    o2, lse = flash_attention_with_lse(tq, tk, tv, causal=causal, kv_lens=tl, k_bias=tb)
    ro, rlse = jax_flash_lse(jq, jk, jv, causal=causal, kv_lens=jl, k_bias=jb)
    assert rel_err_norm(o2.numpy(), ro) <= 1e-5
    assert lse.shape == (case[0], case[3], case[1])
    assert rel_err_norm(lse.numpy(), rlse) <= 1e-5


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_streams_match_the_dense_mask_reference(case):
    """The streams mean the same as the dense boolean key mask (and the
    causal mask) of the reference."""
    causal = case[-1]
    q, k, v, lens, bias = _torch(*_inputs(case, seed=1))
    keep = (torch.arange(k.shape[1])[None] < lens[:, None].long()) & (bias == 0.0)
    hole_free = torch.where(bias == DEFAULT_MASK_VALUE, 0.0, bias)
    out = flash_attention_plain(q, k, v, causal=causal, kv_lens=lens,
                                k_bias=torch.where(keep, hole_free, DEFAULT_MASK_VALUE))
    ref = attention_reference(q, k, v, keep[:, None, None, :], causal=causal)[0]
    assert rel_err_norm(out.numpy(), ref.numpy()) <= 1e-5


def test_zero_length_row_gives_zero_output_and_minus_inf_lse():
    case = (3, 64, 128, 2, 2, 64, False)
    q, k, v, _, bias = _inputs(case, seed=2)
    lens = np.array([128, 0, 50], np.int32)
    tq, tk, tv, tl, tb = _torch(q, k, v, lens, bias)
    o, lse = flash_attention_with_lse(tq, tk, tv, kv_lens=tl, k_bias=tb)
    jq, jk, jv, jl, jb = _jax(q, k, v, lens, bias)
    ro, rlse = jax_flash_lse(jq, jk, jv, kv_lens=jl, k_bias=jb)
    assert torch.all(o[1] == 0.0) and torch.all(torch.isneginf(lse[1]))
    assert np.all(np.isneginf(np.asarray(rlse)[1]))
    live = [0, 2]
    assert rel_err_norm(o.numpy()[live], np.asarray(ro)[live]) <= 1e-5
    assert rel_err_norm(lse.numpy()[live], np.asarray(rlse)[live]) <= 1e-5


@pytest.mark.parametrize("case", EDGE_STREAM_CASES, ids=lambda c: f"q{c[1]}k{c[2]}d{c[5]}lens{c[7]}")
def test_stream_edges_match_jax(case):
    """A length-0 row at ragged lengths, with the key bias: o = 0 and lse =
    -inf there, the other rows as the JAX kernel's."""
    b, sq, skv, hq, hkv, d, causal, lens = case
    q, k, v, _, bias = _inputs(case[:7], seed=7)
    lens = np.array(lens, np.int32)
    o, lse = flash_attention_with_lse(*_torch(q, k, v), causal=causal,
                                      kv_lens=torch.from_numpy(lens), k_bias=torch.from_numpy(bias))
    jq, jk, jv, jl, jb = _jax(q, k, v, lens, bias)
    ro, rlse = jax_flash_lse(jq, jk, jv, causal=causal, kv_lens=jl, k_bias=jb)
    empty, live = lens == 0, lens > 0
    assert torch.all(o[empty] == 0.0) and torch.all(torch.isneginf(lse[empty]))
    assert np.all(np.isneginf(np.asarray(rlse)[empty]))
    assert rel_err_norm(o.numpy()[live], np.asarray(ro)[live]) <= 1e-5
    assert rel_err_norm(lse.numpy()[live], np.asarray(rlse)[live]) <= 1e-5


@pytest.mark.parametrize("skv, hb, causal", EDGE_DENSE_CASES,
                         ids=lambda c: str(c))
def test_dense_bias_edges_match_jax(skv, hb, causal):
    """The dense (B, Hb, Sq, Skv) bias at Sq 129 and Skv 300 / 301, Hb 1 and
    Hq, with mask-value holes (key 0 kept)."""
    q, k, v, _, _ = _inputs((2, 129, skv, 4, 2, 64, causal), seed=8, lens=False, bias=False)
    rng = np.random.default_rng(9)
    bias = rng.standard_normal((2, hb, 129, skv)).astype(np.float32)
    bias[rng.random(bias.shape) < 0.1] = DEFAULT_MASK_VALUE
    bias[..., 0] = 0.0
    got = flash_attention(*_torch(q, k, v), causal=causal, attn_bias=torch.from_numpy(bias))
    want = jax_flash(*_jax(q, k, v), causal=causal, attn_bias=jnp.asarray(bias))
    assert rel_err_norm(got.numpy(), want) <= 1e-5


def test_row_masked_by_bias_alone_averages_its_keys():
    """DEFAULT_MASK_VALUE is finite: a row whose every key carries it
    averages V over those keys (Skv a multiple of the JAX tile, so the JAX
    kernel's tile padding does not enter)."""
    case = (2, 32, 128, 2, 2, 64, False)
    q, k, v, _, bias = _inputs(case, seed=3)
    bias[1] = DEFAULT_MASK_VALUE
    tq, tk, tv, _, tb = _torch(q, k, v, None, bias)
    out = flash_attention(tq, tk, tv, k_bias=tb)
    ref = jax_flash(*_jax(q, k, v), k_bias=jnp.asarray(bias))
    assert torch.isfinite(out).all()
    assert rel_err_norm(out.numpy(), ref) <= 1e-5
    mean_v = tv[1].mean(0)  # (Hkv, D), broadcast over the query rows
    assert rel_err_norm(out[1].numpy(), mean_v.expand_as(out[1]).numpy()) <= 1e-5


@pytest.mark.parametrize("case", [CASES[0], CASES[1]], ids=_case_id)
def test_unrolled_route_with_bias_matches_jax(case):
    """The engine's unrolled kind with its bias stream, bf16 (the JAX
    unrolled kernel runs its products in bf16), JAX tiles of 128."""
    causal = case[-1]
    q, k, v, _, bias = _inputs(case, seed=4, lens=False)
    jq, jk, jv = _jax(q, k, v, dtype=jnp.bfloat16)
    ref = jax_unrolled(jq, jk, jv, causal=causal, k_bias=jnp.asarray(bias),
                       block_q=128, block_kv=128)
    tq, tk, tv = _torch(q, k, v, dtype=torch.bfloat16)
    out = flash_attention_unrolled(tq, tk, tv, causal=causal, k_bias=torch.from_numpy(bias))
    assert out.dtype == torch.bfloat16
    assert_close(out.float().numpy(), np.asarray(ref, np.float32))
    best = flash_attention_best(tq, tk, tv, causal=causal, k_bias=torch.from_numpy(bias))
    assert torch.equal(best, out)


@pytest.mark.parametrize("case", CASES[:3], ids=_case_id)
def test_masked_gradients_match_jax_grad(case):
    """dq, dk, dv and dk_bias of the masked core (the port's plain blockwise
    backward) against ``jax.grad`` of the JAX ``flash_attention``."""
    causal = case[-1]
    q, k, v, lens, bias = _inputs(case, seed=5)
    g = np.random.default_rng(6).standard_normal(q.shape).astype(np.float32)

    def jax_loss(q, k, v, b):
        o = jax_flash(q, k, v, causal=causal, kv_lens=jnp.asarray(lens), k_bias=b)
        return jnp.sum(o * g)

    want = jax.grad(jax_loss, argnums=(0, 1, 2, 3))(*_jax(q, k, v, bias))
    leaves = [t.requires_grad_() for t in _torch(q, k, v, bias)]
    out = flash_attention(leaves[0], leaves[1], leaves[2], causal=causal,
                          kv_lens=torch.from_numpy(lens), k_bias=leaves[3])
    (out * torch.from_numpy(g)).sum().backward()
    for name, t, w in zip(("dq", "dk", "dv", "dk_bias"), leaves, want):
        bound = 1e-4 if name == "dk_bias" else 1e-5
        assert t.grad.shape == t.shape
        assert rel_err_norm(t.grad.numpy(), w) <= bound, name


def test_masked_gradient_without_bias_matches_jax():
    """kv_lens alone: the masked core with a zero bias in JAX."""
    case = CASES[1]
    q, k, v, lens, _ = _inputs(case, seed=7, bias=False)
    want = jax.grad(lambda q, k, v: jnp.sum(jax_flash(
        q, k, v, causal=True, kv_lens=jnp.asarray(lens)) ** 2), argnums=(0, 1, 2))(*_jax(q, k, v))
    leaves = [t.requires_grad_() for t in _torch(q, k, v)]
    out = flash_attention(*leaves, causal=True, kv_lens=torch.from_numpy(lens))
    (out ** 2).sum().backward()
    for t, w in zip(leaves, want):
        assert rel_err_norm(t.grad.numpy(), w) <= 1e-5


@pytest.mark.parametrize("causal", [False, True])
def test_blockwise_reference_matches_the_reference(causal):
    q, k, v, _, _ = _torch(*_inputs((2, 48, 80, 4, 2, 64, causal), seed=8))
    out = attention_blockwise(q, k, v, causal=causal, block_kv=32)
    ref = attention_reference(q, k, v, causal=causal)[0]
    assert rel_err_norm(out.numpy(), ref.numpy()) <= 1e-5
    assert cdiv(80, 32) == 3 and round_up(80, 32) == 96 and round_up(64, 32) == 64


@pytest.mark.parametrize(
    "kwargs, match",
    [
        (dict(kv_lens=torch.ones(3, dtype=torch.int32)), "kv_lens must be shape"),
        (dict(k_bias=torch.zeros(2, 7)), "k_bias must be shape"),
    ],
)
def test_bad_stream_shapes_raise(kwargs, match):
    q = torch.zeros(2, 8, 2, 64)
    with pytest.raises(ValueError, match=match):
        flash_attention(q, q, q, **kwargs)


def test_cpu_streams_never_touch_the_kernel_library():
    q, k, v, lens, bias = _torch(*_inputs(CASES[0], seed=9))
    before = dict(_build.LAUNCHES)
    flash_attention(q, k, v, kv_lens=lens, k_bias=bias)
    assert dict(_build.LAUNCHES) == before
