"""Port parity: ``ops/nonlinearity.py`` (kernels K7 and K8) against JAX.

The same numpy inputs (seeded) go to the JAX ``fused_softmax``,
``fused_layer_norm`` and ``fused_rms_norm`` (Pallas in interpret mode on
the CPU) and to the port's, which run the kernels' plain versions on the
CPU. The cases are those of ``tests/unit/test_nonlinearity.py``.

Bounds: fp32 within 1e-6 max-abs (the sums run in another order: measured
<= 7.2e-7 on LayerNorm outputs up to ~4); bf16 within one bf16 ulp of
JAX's output (both compute in fp32 and round once); the norms' gradients
against ``jax.grad`` through JAX's custom VJP within ``rel_err_norm``
1e-5 (both differentiate the same plain reference).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photonic_flash_attention_tpu.ops import nonlinearity as jnl
from photonic_flash_attention_tpu_torch.ops import nonlinearity as tnl

from .conftest import rel_err_norm

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _both(x: np.ndarray, dtype_name: str):
    jdt, tdt = DTYPES[dtype_name]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _assert_matches(got: torch.Tensor, want, dtype_name: str) -> None:
    """fp32: max-abs 1e-6; bf16: within one bf16 ulp of JAX's value."""
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    if dtype_name == "f32":
        assert np.abs(got - want).max() <= 1e-6
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        assert np.all(np.abs(got - want) <= ulp)


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("shape", [(4, 128), (2, 8, 200), (3, 7, 5, 64)])
def test_softmax_matches_jax(shape, dtype_name):
    x = (np.random.default_rng(0).standard_normal(shape) * 3).astype(np.float32)
    jx, tx = _both(x, dtype_name)
    out = tnl.fused_softmax(tx)
    assert out.dtype == tx.dtype
    _assert_matches(out, jnl.fused_softmax(jx), dtype_name)


def test_softmax_extreme_inputs_match_jax():
    x = (np.random.default_rng(1).standard_normal((8, 256)) * 100.0).astype(np.float32)
    jx, tx = _both(x, "f32")
    out = tnl.fused_softmax(tx)
    assert torch.isfinite(out).all()
    _assert_matches(out, jnl.fused_softmax(jx), "f32")


def test_softmax_nonlast_axis_matches_jax():
    x = np.random.default_rng(2).standard_normal((4, 96, 6)).astype(np.float32)
    jx, tx = _both(x, "f32")
    _assert_matches(tnl.fused_softmax(tx, axis=1), jnl.fused_softmax(jx, axis=1), "f32")
    _assert_matches(tnl.fused_softmax(tx, axis=0), jnl.fused_softmax(jx, axis=0), "f32")


def test_softmax_arguments():
    x = torch.zeros(2, 8)
    with pytest.raises(ValueError):
        tnl.fused_softmax(x, block_rows=0)
    # block_rows has no counterpart: any positive value gives the same rows.
    assert torch.equal(tnl.fused_softmax(x, block_rows=8), tnl.fused_softmax(x))
    with pytest.raises(NotImplementedError):
        tnl.fused_softmax(torch.zeros(2, 8, requires_grad=True))
    with torch.no_grad():
        tnl.fused_softmax(torch.zeros(2, 8, requires_grad=True))


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("d", [128, 200, 768])
def test_layer_norm_matches_jax(d, dtype_name):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((6, 5, d)) * 2 + 1).astype(np.float32)
    g = (rng.standard_normal(d) * 0.1 + 1).astype(np.float32)
    b = (rng.standard_normal(d) * 0.1).astype(np.float32)
    (jx, tx), (jg, tg), (jb, tb) = (_both(a, dtype_name) for a in (x, g, b))
    out = tnl.fused_layer_norm(tx, tg, tb)
    assert out.dtype == tx.dtype
    _assert_matches(out, jnl.fused_layer_norm(jx, jg, jb), dtype_name)
    # beta None is zeros, as in JAX.
    _assert_matches(tnl.fused_layer_norm(tx, tg), jnl.fused_layer_norm(jx, jg), dtype_name)


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("d", [128, 512])
def test_rms_norm_matches_jax(d, dtype_name):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, 9, d)).astype(np.float32)
    g = (rng.standard_normal(d) * 0.1 + 1).astype(np.float32)
    (jx, tx), (jg, tg) = (_both(a, dtype_name) for a in (x, g))
    out = tnl.fused_rms_norm(tx, tg)
    assert out.dtype == tx.dtype
    _assert_matches(out, jnl.fused_rms_norm(jx, jg), dtype_name)


def test_layer_norm_grad_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, 256)).astype(np.float32)
    g = (rng.standard_normal(256) * 0.1 + 1).astype(np.float32)
    b = (rng.standard_normal(256) * 0.1).astype(np.float32)
    want = jax.grad(lambda x, g, b: jnp.sum(jnp.square(jnl.fused_layer_norm(x, g, b))),
                    argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, g, b)]
    tnl.fused_layer_norm(*leaves).square().sum().backward()
    for leaf, w in zip(leaves, want):
        assert rel_err_norm(leaf.grad.numpy(), w) <= 1e-5


def test_rms_norm_grad_matches_jax():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 128)).astype(np.float32)
    g = (rng.standard_normal(128) * 0.1 + 1).astype(np.float32)
    want = jax.grad(lambda x, g: jnp.sum(jnp.square(jnl.fused_rms_norm(x, g))),
                    argnums=(0, 1))(jnp.asarray(x), jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, g)]
    tnl.fused_rms_norm(*leaves).square().sum().backward()
    for leaf, w in zip(leaves, want):
        assert rel_err_norm(leaf.grad.numpy(), w) <= 1e-5


def test_norm_grads_in_bf16_keep_the_input_dtypes():
    x = torch.randn(3, 64, dtype=torch.bfloat16, requires_grad=True)
    g = torch.ones(64, dtype=torch.bfloat16, requires_grad=True)
    tnl.fused_layer_norm(x, g).float().sum().backward()
    assert x.grad.dtype == torch.bfloat16 and g.grad.dtype == torch.bfloat16


@pytest.mark.parametrize("kind", list(jnl.NonlinearityType), ids=lambda k: k.value)
def test_dispatcher_matches_jax(kind):
    x = np.random.default_rng(7).standard_normal((4, 128)).astype(np.float32)
    jx, tx = _both(x, "f32")
    for k in (kind, kind.value):  # the enum and its string alias
        tkind = tnl.NonlinearityType(kind.value) if not isinstance(k, str) else k
        out = tnl.apply_nonlinearity(tkind, tx)
        _assert_matches(out, jnl.apply_nonlinearity(k, jx), "f32")


def test_gelu_is_the_tanh_form():
    x = np.linspace(-6, 6, 1001, dtype=np.float32)
    jx, tx = _both(x, "f32")
    _assert_matches(tnl.gelu(tx), jax.nn.gelu(jx), "f32")
    _assert_matches(tnl.gelu(tx), jax.nn.gelu(jx, approximate=True), "f32")


def test_dispatcher_rejects_unknown():
    with pytest.raises(ValueError):
        tnl.apply_nonlinearity("tanh-ish", torch.zeros(2, 128))
