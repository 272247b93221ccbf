"""Port parity: the flash backward and the gradient of flash attention.

The same numpy inputs go to ``photonic_flash_attention_tpu`` (its Pallas
backward kernels in interpret mode on the CPU) and to
``photonic_flash_attention_tpu_torch`` (the plain versions of kernels K4/K5
and K1-with-lse on the CPU):

* ``flash_attention_bwd_plain`` against the grid pair
  (``flash_attention_bwd_pallas``, blocks 128) and the unrolled pair
  (``flash_attention_bwd_unrolled``), fp32, rtol = atol = 2e-4;
* ``torch.autograd.grad`` through the port's ``flash_attention`` against
  ``jax.grad`` through the JAX one: fp32 to 2e-4; bf16 at S1024 (the JAX
  unrolled forward and backward) within relative norm 0.05;
* ``flash_attention_with_lse``: o and the natural-log lse to 1e-4, fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photonic_flash_attention_tpu.ops.flash import (
    flash_attention as jax_flash,
    flash_attention_with_lse as jax_flash_with_lse,
)
from photonic_flash_attention_tpu.ops.flash_bwd import (
    flash_attention_bwd_pallas,
    flash_attention_bwd_unrolled,
)
from photonic_flash_attention_tpu_torch.ops import _build
from photonic_flash_attention_tpu_torch.ops.flash import (
    flash_attention,
    flash_attention_with_lse,
    flash_attention_with_lse_plain,
)
from photonic_flash_attention_tpu_torch.ops.flash_bwd import (
    bwd_unrolled_supported,
    flash_attention_bwd,
    flash_attention_bwd_plain,
)

from .conftest import rel_err_norm

# (B, Sq, Skv, H, D, causal): the cases of the JAX package's own backward
# test; D 128 where it uses 32 (the port's envelope is D in {64, 128}).
BWD_CASES = [
    (2, 256, 256, 4, 64, False),
    (2, 256, 256, 4, 64, True),
    (1, 200, 200, 2, 64, True),
    (1, 256, 384, 2, 64, True),
    (2, 128, 128, 2, 128, False),
]


def _case_id(c):
    return "b{}q{}k{}h{}d{}{}".format(*c[:5], "c" if c[5] else "n")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _residuals(b, sq, skv, h, d, causal, seed=0):
    """fp32 numpy (q, k, v, o, lse, do): q/o/do (B,Sq,H,D), k/v (B,Skv,H,D),
    lse (B,H,Sq); o and lse from the port's plain forward."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((b, sq, h, d), (b, skv, h, d), (b, skv, h, d)))
    do = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    o, lse = flash_attention_with_lse_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=causal
    )
    return q, k, v, o.numpy(), lse.numpy(), do


def _bhsd(a):
    return jnp.asarray(np.ascontiguousarray(a.transpose(0, 2, 1, 3)))


def _check_plain_against(jax_grads, arrays, causal):
    q, k, v, o, lse, do = (torch.from_numpy(a) for a in arrays)
    got = flash_attention_bwd_plain(q, k, v, o, lse, do, sm_scale=q.shape[-1] ** -0.5,
                                    causal=causal)
    for name, g, r in zip("qkv", got, jax_grads):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(
            g.numpy(), np.asarray(r).transpose(0, 2, 1, 3), rtol=2e-4, atol=2e-4,
            err_msg=f"d{name} mismatch",
        )


@pytest.mark.parametrize("case", BWD_CASES, ids=_case_id)
def test_bwd_plain_matches_jax_grid_pair(case):
    *shape, causal = case
    arrays = _residuals(*shape, causal)
    q, k, v, o, lse, do = arrays
    ref = flash_attention_bwd_pallas(
        _bhsd(q), _bhsd(k), _bhsd(v), _bhsd(o), jnp.asarray(lse), _bhsd(do),
        sm_scale=shape[-1] ** -0.5, causal=causal, block_q=128, block_kv=128,
        interpret=True,
    )
    _check_plain_against(ref, arrays, causal)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_bwd_plain_matches_jax_unrolled_pair(causal):
    arrays = _residuals(1, 512, 512, 2, 64, causal, seed=1)
    q, k, v, o, lse, do = arrays
    ref = flash_attention_bwd_unrolled(
        _bhsd(q), _bhsd(k), _bhsd(v), _bhsd(o), jnp.asarray(lse), _bhsd(do),
        sm_scale=64 ** -0.5, causal=causal, interpret=True,
    )
    _check_plain_against(ref, arrays, causal)


def _grads_both(shapes, dtype_pair, causal, seed, loss):
    """(port grads, JAX grads) of ``loss`` over q, k, v: autograd through
    the port's flash_attention, jax.grad through the JAX one."""
    jdt, tdt = dtype_pair
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    leaves = [torch.from_numpy(a).to(tdt).requires_grad_() for a in arrs[:3]]
    port = torch.autograd.grad(
        loss["torch"](flash_attention(*leaves, causal=causal), arrs), leaves
    )
    jax_grads = jax.grad(
        lambda q, k, v: loss["jax"](jax_flash(q, k, v, causal=causal), arrs),
        argnums=(0, 1, 2),
    )(*(jnp.asarray(a, jdt) for a in arrs[:3]))
    for g, leaf in zip(port, leaves):
        assert g.dtype == leaf.dtype and g.shape == leaf.shape
    return port, jax_grads


# sum(o * do): the vector-Jacobian product with a random cotangent.
DOT_LOSS = {
    "torch": lambda o, arrs: (o.float() * torch.from_numpy(arrs[3])).sum(),
    "jax": lambda o, arrs: jnp.sum(o.astype(jnp.float32) * arrs[3]),
}
# sum(o^2), as the JAX package's bf16 gradient test.
SQUARE_LOSS = {
    "torch": lambda o, arrs: (o.float() ** 2).sum(),
    "jax": lambda o, arrs: jnp.sum(o.astype(jnp.float32) ** 2),
}
F32 = (jnp.float32, torch.float32)


@pytest.mark.parametrize(
    "hq, hkv, causal", [(2, 2, True), (2, 2, False), (4, 2, True)],
    ids=["causal", "full", "gqa4to2"],
)
def test_fp32_grads_match_jax(hq, hkv, causal):
    b, s, d = 1, 256, 64
    shapes = ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d), (b, s, hq, d))
    port, ref = _grads_both(shapes, F32, causal, seed=2, loss=DOT_LOSS)
    for name, g, r in zip("qkv", port, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-4, atol=2e-4,
                                   err_msg=f"d{name} mismatch")


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_bf16_grads_match_jax_unrolled(causal):
    """bf16 B1 S1024 H2: the JAX side takes its unrolled forward (with lse)
    and unrolled backward; bf16-scale gate."""
    shapes = ((1, 1024, 2, 64),) * 3
    port, ref = _grads_both(shapes, (jnp.bfloat16, torch.bfloat16), causal, seed=3,
                            loss=SQUARE_LOSS)
    for g, r in zip(port, ref):
        assert rel_err_norm(g.float().numpy(), np.asarray(r, np.float32)) < 0.05


@pytest.mark.parametrize(
    "b, sq, skv, hq, hkv, d, causal",
    [(2, 200, 200, 4, 2, 64, True), (1, 64, 320, 4, 1, 128, False)],
)
def test_flash_attention_with_lse_matches_jax(b, sq, skv, hq, hkv, d, causal):
    rng = np.random.default_rng(4)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d))]
    o, lse = flash_attention_with_lse(*(torch.from_numpy(a) for a in arrs), causal=causal)
    o_ref, lse_ref = jax_flash_with_lse(*(jnp.asarray(a) for a in arrs), causal=causal)
    assert lse.shape == (b, hq, sq) and lse.dtype == torch.float32
    assert np.max(np.abs(o.numpy() - np.asarray(o_ref))) <= 1e-4
    assert np.max(np.abs(lse.numpy() - np.asarray(lse_ref))) <= 1e-4


def test_bf16_grads_come_back_in_bf16():
    q, k, v = (torch.randn(1, 64, 2, 64, dtype=torch.bfloat16, requires_grad=True)
               for _ in range(3))
    out = flash_attention(q, k, v, causal=True)
    grads = torch.autograd.grad(out.float().sum(), (q, k, v))
    assert out.dtype == torch.bfloat16
    assert all(g.dtype == torch.bfloat16 and torch.isfinite(g).all() for g in grads)


def test_cpu_backward_never_touches_the_kernel_library():
    q, k, v = (torch.randn(1, 40, 2, 64, requires_grad=True) for _ in range(3))
    before = dict(_build.LAUNCHES)
    torch.autograd.grad(flash_attention(q, k, v, causal=True).sum(), (q, k, v))
    assert dict(_build.LAUNCHES) == before
    assert _build._lib is None


def test_bwd_unrolled_supported_is_the_kernel_envelope():
    assert bwd_unrolled_supported(200, 64) and bwd_unrolled_supported(8192, 128)
    assert not bwd_unrolled_supported(512, 32)
    assert not bwd_unrolled_supported(0, 64)


def _zeros_bwd(sq=8, skv=8, h=2, d=64, lse_shape=None):
    q, o, do = (torch.zeros(1, sq, h, d) for _ in range(3))
    k, v = torch.zeros(1, skv, h, d), torch.zeros(1, skv, h, d)
    lse = torch.zeros(lse_shape or (1, h, sq))
    return q, k, v, o, lse, do


@pytest.mark.parametrize(
    "kwargs, exc, match",
    [
        (dict(window=(-4, 0, "inside")), NotImplementedError, "B10"),
        (dict(dropout_rate=0.1), NotImplementedError, "B10"),
        (dict(lse_shape=(1, 8, 2)), ValueError, "lse"),
        (dict(sq=16), ValueError, "no key"),
    ],
)
def test_flash_attention_bwd_rejects(kwargs, exc, match):
    shape_kw = {k: v for k, v in kwargs.items() if k in ("sq", "lse_shape")}
    stream_kw = {k: v for k, v in kwargs.items() if k not in shape_kw}
    with pytest.raises(exc, match=match):
        flash_attention_bwd(*_zeros_bwd(**shape_kw), sm_scale=0.125, causal=True, **stream_kw)
