"""Port parity: sliding-window (local) attention and the backward streams.

The port's ``flash_attention(window=(lo, hi))`` on the CPU (K1's and
K4/K5's plain versions) against the JAX function in interpret mode, blocks
128, on the four cases of ``tests/unit/test_flash_window.py`` (causal
local, bidirectional band, one-sided, cross/decode alignment) plus GQA:
forward 2e-5 and gradients 5e-4 (that file's bounds). K4/K5's plain
version with a window and with dropout against the JAX grid pair
(``flash_attention_bwd_pallas``) in interpret mode, fp32 2e-4; the
blockwise plain backward (the relative-bias and key-stream gradient's)
against it.

Rows with no key in their window (a non-causal window with hi < 0): JAX's
flash averages over the tiles its banded grid happens to visit, which is
not its own dense oracle (the oracle averages over every key); the port
gives o = 0 and lse = -inf there, and agrees with the oracle on every other
row (ROADMAP Queue C).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photonic_flash_attention_tpu.ops.flash import flash_attention as jax_flash
from photonic_flash_attention_tpu.ops.flash_bwd import flash_attention_bwd_pallas
from photonic_flash_attention_tpu.ops.reference import attention_reference as jax_reference
from photonic_flash_attention_tpu_torch.ops.flash import (
    flash_attention,
    flash_attention_bwd_masked_plain,
    flash_attention_with_lse_plain,
)
from photonic_flash_attention_tpu_torch.ops.flash_bwd import flash_attention_bwd_plain


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(b, sq, skv, hq, hkv, d=64, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d), (b, sq, hq, d))]


# (name, B, Sq, Skv, Hq, Hkv, causal, window): the JAX file's cases at its
# shapes (B 2, H 4 there; B 1 here to keep the interpreted backward short).
CASES = [
    ("causal_local", 1, 512, 512, 4, 4, True, (-127, 0)),
    ("bidirectional_band", 1, 512, 512, 4, 4, False, (-64, 64)),
    ("one_sided", 1, 256, 256, 4, 4, True, (-100, None)),
    ("cross_decode_alignment", 1, 128, 384, 4, 4, True, (-127, 0)),
    ("gqa_band", 1, 256, 256, 4, 2, False, (-40, 70)),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_window_forward_and_grads_match_jax(case):
    _, b, sq, skv, hq, hkv, causal, window = case
    q, k, v, g = _arrays(b, sq, skv, hq, hkv)

    def jax_loss(q, k, v):
        o = jax_flash(q, k, v, causal=causal, window=window, block_q=128, block_kv=128)
        return jnp.sum(o * g), o

    (_, want), jgrads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(a) for a in (q, k, v)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = flash_attention(*leaves, causal=causal, window=window)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    for name, t, w in zip("qkv", leaves, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=5e-4, atol=5e-4,
                                   err_msg=f"d{name}")


def test_rows_without_a_key_get_zero():
    """window (-20, -5), not causal: rows 0-4 see no key. The port: o = 0,
    lse = -inf there, JAX's dense oracle elsewhere; JAX's flash: neither
    (it averages the first 128-key tile), which is why the port keeps the
    stated contract."""
    q, k, v, _ = _arrays(1, 256, 256, 2, 2)
    sq = skv = 256
    rel = np.arange(skv)[None] - np.arange(sq)[:, None]
    mask = jnp.asarray((rel >= -20) & (rel <= -5))[None, None]
    oracle, _ = jax_reference(*(jnp.asarray(a) for a in (q, k, v)), mask=mask)
    jax_out = jax_flash(*(jnp.asarray(a) for a in (q, k, v)), window=(-20, -5), block_q=128,
                        block_kv=128)
    out, lse = flash_attention_with_lse_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                              window=(-20, -5))
    got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), window=(-20, -5))
    assert torch.equal(got, out)
    assert (out[:, :5] == 0).all() and torch.isneginf(lse[..., :5]).all()
    assert torch.isfinite(lse[..., 5:]).all()
    np.testing.assert_allclose(out[:, 5:].numpy(), np.asarray(oracle)[:, 5:], rtol=2e-5, atol=2e-5)
    assert np.abs(np.asarray(jax_out)[:, :5] - np.asarray(oracle)[:, :5]).max() > 1e-2
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    flash_attention(*leaves, window=(-20, -5)).sum().backward()
    assert all(torch.isfinite(t.grad).all() for t in leaves)
    assert (leaves[0].grad[:, :5] == 0).all()


def _bhsd(a):
    return jnp.asarray(np.ascontiguousarray(np.asarray(a).transpose(0, 2, 1, 3)))


# (B, Sq, Skv, H, causal, streams): the grid pair's window and seed streams.
BWD_CASES = [
    (1, 256, 256, 2, True, dict(window=(-63, 0))),
    (1, 200, 333, 2, False, dict(window=(-90, 40))),
    (2, 256, 256, 2, True, dict(dropout_rate=0.1, dropout_seed=77)),
    (1, 128, 384, 2, False, dict(dropout_rate=0.5, dropout_seed=2**31 - 2)),
]


@pytest.mark.parametrize("case", BWD_CASES, ids=["window_causal", "window_cross", "dropout",
                                                  "dropout_cross"])
def test_bwd_plain_streams_match_jax_grid_pair(case):
    b, sq, skv, h, causal, streams = case
    q, k, v, do = _arrays(b, sq, skv, h, h)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = flash_attention_with_lse_plain(tq, tk, tv, causal=causal, **streams)
    scale = 64 ** -0.5
    jkw = {}
    if "window" in streams:
        jkw["window"] = (*streams["window"], "inside")
    else:
        jkw = dict(dropout_rate=streams["dropout_rate"],
                   dropout_seed=jnp.asarray([streams["dropout_seed"]], jnp.int32))
    want = flash_attention_bwd_pallas(
        _bhsd(q), _bhsd(k), _bhsd(v), _bhsd(o.numpy()), jnp.asarray(lse.numpy()), _bhsd(do),
        sm_scale=scale, causal=causal, block_q=128, block_kv=128, interpret=True, **jkw)
    got = flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo, sm_scale=scale, causal=causal,
                                    **streams)
    blockwise = flash_attention_bwd_masked_plain(tq, tk, tv, o, lse, tdo, sm_scale=scale,
                                                 causal=causal, block_kv=128, **streams)
    for name, g, bw, w in zip("qkv", got, blockwise, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w).transpose(0, 2, 1, 3), rtol=2e-4,
                                   atol=2e-4, err_msg=f"d{name}")
        np.testing.assert_allclose(bw.numpy(), g.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=f"blockwise d{name}")
