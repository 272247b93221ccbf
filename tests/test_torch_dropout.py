"""Port parity: attention dropout (the positional keep mask, the plain flash
forward and backward with dropout, the fused path, the drop-in layer).

* ``ops/dropout.py::dropout_keep`` equals the JAX package's
  ``ops/pallas_utils.py::dropout_keep`` bit for bit at every position of
  grids with key strides 1, 77, 2048 and 65539, seeds 0, 1, 2**31 - 2, a
  negative one and random ones, rates 0.1, 0.5 and 0.9, and a broadcast
  (batch, head) index.
* The port's ``flash_attention(dropout_rate=, dropout_seed=)`` on the CPU
  (K1's and K4/K5's plain versions) against the JAX function in interpret
  mode: forward norm error 1e-5, gradients 1e-4 (the JAX tests' bounds,
  ``tests/unit/test_attention_dropout.py``), causal and not, GQA, Sq < Skv.
* Argument errors: the same error class and message as JAX's.
* ``dispatch_attention``: the fused and flash paths give the identical
  sample for one seed, and the fused path equals JAX's; the drop-in layer
  drops nothing in eval mode and repeats itself in train mode for a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photonic_flash_attention_tpu.config import get_config as jax_get_config
from photonic_flash_attention_tpu.models.attention import dispatch_attention as jax_dispatch
from photonic_flash_attention_tpu.ops.flash import flash_attention as jax_flash
from photonic_flash_attention_tpu.ops.pallas_utils import dropout_keep as jax_keep
from photonic_flash_attention_tpu.ops.rel_bias import ALiBi as JaxALiBi, alibi_slopes as jax_slopes
from photonic_flash_attention_tpu_torch.config import get_config, reset_config
from photonic_flash_attention_tpu_torch.models.attention import (
    PhotonicFlashAttention,
    dispatch_attention,
)
from photonic_flash_attention_tpu_torch.ops.dropout import dropout_keep, fold_seed
from photonic_flash_attention_tpu_torch.ops.flash import flash_attention
from photonic_flash_attention_tpu_torch.ops.rel_bias import ALiBi, alibi_slopes

from .conftest import rel_err_norm

RATE, SEED = 0.2, 1234


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    reset_config()
    torch.set_num_threads(n)


# -- the keep mask -----------------------------------------------------------

# (rows, kv_stride): every column of the stride, the rows given.
GRIDS = [(300, 1), (200, 77), (40, 2048), (6, 65539)]


@pytest.mark.parametrize("rate", [0.1, 0.5, 0.9])
@pytest.mark.parametrize("rows, stride", GRIDS, ids=[f"stride{s}" for _, s in GRIDS])
def test_dropout_keep_matches_jax_bit_for_bit(rows, stride, rate):
    rng = np.random.default_rng(stride)
    seeds = [0, 1, 2**31 - 2, -7] + rng.integers(0, 2**31 - 1, 2).tolist()
    r = np.arange(rows, dtype=np.int32)[None, None, :, None]
    c = np.arange(stride, dtype=np.int32)[None, None, None, :]
    bh = (np.arange(2, dtype=np.int32)[:, None] * 3 + np.arange(3, dtype=np.int32))[:, :, None, None]
    for seed in seeds:
        want = np.asarray(jax_keep(jnp.int32(seed), jnp.asarray(r), jnp.asarray(c), stride, rate,
                                   bh=jnp.asarray(bh)))
        got = dropout_keep(seed, torch.from_numpy(r), torch.from_numpy(c), stride, rate,
                           bh=torch.from_numpy(bh)).numpy()
        assert want.shape == got.shape == (2, 3, rows, stride)
        assert np.array_equal(got, want), (seed, rate)
    # Without bh (JAX's None = 0) and with a tensor seed.
    want = np.asarray(jax_keep(jnp.int32(5), jnp.asarray(r[0, 0]), jnp.asarray(c[0, 0]), stride, rate))
    got = dropout_keep(torch.tensor([5]), torch.from_numpy(r[0, 0]), torch.from_numpy(c[0, 0]),
                       stride, rate).numpy()
    assert np.array_equal(got, want)


def test_dropout_rate_and_fold_seed():
    rows, cols = torch.arange(512)[:, None], torch.arange(512)[None, :]
    drop = 1.0 - dropout_keep(7, rows, cols, 512, RATE).float().mean().item()
    assert abs(drop - RATE) < 0.01
    a = dropout_keep(7, rows, cols, 512, RATE, bh=0)
    b = dropout_keep(7, rows, cols, 512, RATE, bh=1)
    assert (a != b).float().mean() > 0.2  # i.i.d. per (batch, head)
    seeds = {fold_seed(SEED, i) for i in range(64)}
    assert len(seeds) == 64 and all(0 <= s < 2**31 for s in seeds)
    assert fold_seed(SEED, 3) == fold_seed(SEED, 3) != fold_seed(SEED + 1, 3)


# -- plain flash with dropout against the JAX function ----------------------

# (B, Sq, Skv, Hq, Hkv, causal)
FLASH_CASES = [
    (2, 256, 256, 4, 4, False),
    (2, 256, 256, 4, 4, True),
    (1, 128, 256, 4, 2, True),
    (1, 200, 200, 4, 1, False),
]


def _arrays(b, sq, skv, hq, hkv, seed=0, d=64):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d), (b, sq, hq, d))]


@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "b{}q{}k{}h{}/{}{}".format(
    *c[:5], "c" if c[5] else "n"))
def test_flash_dropout_matches_jax(case):
    *shape, causal = case
    q, k, v, g = _arrays(*shape)
    kw = dict(causal=causal, dropout_rate=RATE, dropout_seed=SEED)

    def jax_loss(q, k, v):
        o = jax_flash(q, k, v, block_q=128, block_kv=128, **kw)
        return jnp.sum(o * g), o

    (_, want), jgrads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(a) for a in (q, k, v)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = flash_attention(*leaves, **kw)
    (out * torch.from_numpy(g)).sum().backward()
    assert rel_err_norm(out.detach().numpy(), want) < 1e-5
    for name, t, w in zip("qkv", leaves, jgrads):
        assert rel_err_norm(t.grad.numpy(), w) < 1e-4, name
    # Without a gradient to take (K1 alone): the same sample.
    with torch.no_grad():
        again = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), **kw)
    assert torch.equal(again, out.detach())


def test_dropout_changes_the_output_and_the_seed_matters():
    q, k, v, _ = (torch.from_numpy(a) for a in _arrays(1, 128, 128, 2, 2))
    plain = flash_attention(q, k, v, causal=True)
    a = flash_attention(q, k, v, causal=True, dropout_rate=RATE, dropout_seed=1)
    b = flash_attention(q, k, v, causal=True, dropout_rate=RATE, dropout_seed=2)
    assert rel_err_norm(a.numpy(), plain.numpy()) > 0.05
    assert rel_err_norm(a.numpy(), b.numpy()) > 0.05


# -- argument errors as JAX's ------------------------------------------------


def _bad_calls(lib):
    """(kwargs, message) of calls both packages refuse with ValueError."""
    arr = jnp.asarray if lib == 0 else torch.from_numpy
    lens = arr(np.full((2,), 32, np.int32))
    kb = arr(np.zeros((2, 32), np.float32))
    ab = arr(np.zeros((2, 1, 32, 32), np.float32))
    alibi = JaxALiBi(slopes=jax_slopes(4)) if lib == 0 else ALiBi(alibi_slopes(4))
    seed = SEED
    return [
        (dict(dropout_rate=1.0, dropout_seed=seed), "dropout_rate must be in"),
        (dict(dropout_rate=0.1), "requires dropout_seed"),
        (dict(dropout_rate=0.1, dropout_seed=seed, kv_lens=lens), "dropout_rate cannot be combined"),
        (dict(dropout_rate=0.1, dropout_seed=seed, k_bias=kb), "dropout_rate cannot be combined"),
        (dict(dropout_rate=0.1, dropout_seed=seed, window=(-4, 0)), "dropout_rate cannot be combined"),
        (dict(dropout_rate=0.1, dropout_seed=seed, rel_bias=alibi), "dropout_rate cannot be combined"),
        (dict(attn_bias=ab, window=(-4, 0)), "attn_bias cannot be combined"),
        (dict(window=(-4, 0), kv_lens=lens), "cannot be combined with rel_bias or window"),
        (dict(window=(-4, 0), rel_bias=alibi), "window cannot be combined with rel_bias"),
    ]


@pytest.mark.parametrize("i", range(9))
def test_argument_errors_as_jax(i):
    q, k, v, _ = _arrays(2, 32, 32, 4, 4, d=16)
    jkw, msg = _bad_calls(0)[i]
    tkw, _ = _bad_calls(1)[i]
    with pytest.raises(ValueError, match=msg):
        jax_flash(*(jnp.asarray(a) for a in (q, k, v)), **jkw)
    with pytest.raises(ValueError, match=msg):
        flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), **tkw)


# -- dispatch and the drop-in layer ------------------------------------------


def test_fused_and_flash_identical_sample():
    """One seed, one sample, whichever branch the dispatch picks; the fused
    branch equals JAX's fused branch (JAX
    ``test_fused_and_flash_identical_sample``)."""
    q, k, v, _ = (torch.from_numpy(a) for a in _arrays(2, 512, 512, 4, 4))
    get_config().update(flash_threshold=64, flash_min_tokens=1)
    o_flash, _ = dispatch_attention(q, k, v, causal=True, dropout_rate=RATE, dropout_seed=SEED)
    get_config().update(flash_threshold=100000)
    o_fused, w = dispatch_attention(q, k, v, causal=True, dropout_rate=RATE, dropout_seed=SEED,
                                    need_weights=True)
    assert rel_err_norm(o_flash.numpy(), o_fused.numpy()) < 1e-5
    jax_get_config().update(flash_threshold=100000)
    want, want_w = jax_dispatch(*(jnp.asarray(t.numpy()) for t in (q, k, v)), causal=True,
                                dropout_rate=RATE, dropout_seed=jnp.asarray([SEED], jnp.int32),
                                need_weights=True)
    assert rel_err_norm(o_fused.numpy(), want) < 1e-5
    assert np.max(np.abs(w.numpy() - np.asarray(want_w))) < 1e-5


def test_layer_dropout_eval_and_train():
    torch.manual_seed(0)
    layer = PhotonicFlashAttention(128, 4, causal=True, attention_dropout=0.3, adaptive=False,
                                   dtype=torch.float32)
    ref = PhotonicFlashAttention(128, 4, causal=True, adaptive=False, dtype=torch.float32)
    ref.load_state_dict(layer.state_dict())
    x = torch.randn(1, 256, 128)
    with torch.no_grad():
        want = ref(x)[0]
        assert torch.equal(layer.eval()(x)[0], want)  # eval: no dropout
        layer.train()
        a, b = layer(x, dropout_seed=9)[0], layer(x, dropout_seed=9)[0]
        torch.manual_seed(3)
        c = layer(x)[0]
        torch.manual_seed(3)
        d = layer(x)[0]
    assert torch.equal(a, b) and torch.equal(c, d)
    assert rel_err_norm(a.numpy(), want.numpy()) > 0.05
    assert rel_err_norm(a.numpy(), c.numpy()) > 0.05


def test_layer_output_dropout_in_train_mode_only():
    torch.manual_seed(0)
    layer = PhotonicFlashAttention(64, 4, dropout_rate=0.5, adaptive=False, dtype=torch.float32)
    x = torch.randn(2, 16, 64)
    with torch.no_grad():
        out = layer.eval()(x)[0]
        dropped = layer.train()(x)[0]
    assert ((dropped == 0) & (out != 0)).float().mean() > 0.3
    kept = dropped != 0
    assert torch.allclose(dropped[kept], 2 * out[kept], rtol=1e-5, atol=1e-6)
