"""Port parity: ``ops/quantization.py`` against JAX.

The same numpy inputs go to the JAX ``quantize`` / ``dequantize`` /
``quantize_kv`` / ``quantization_error`` and to the port's. Bounds: int8
and e4m3 payloads bit-equal and scales equal, along axis 0, 1 and -1, with
a ragged last block and an all-zero block; dequantized values and the
error metrics within 1e-6. The round-trip gates of
``tests/unit/test_quantization.py`` hold for the port too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photonic_flash_attention_tpu.ops import quantization as jq
from photonic_flash_attention_tpu_torch.ops import quantization as tq

QDTYPES = {"int8": (jnp.int8, torch.int8), "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}


def _payload_bits(values) -> np.ndarray:
    if isinstance(values, torch.Tensor):
        return values.view(torch.uint8).numpy()
    return np.asarray(values).view(np.uint8)


def _problem(axis: int, seed: int = 0) -> np.ndarray:
    """(3, 200, 40) with one all-zero block along ``axis`` (block 64)."""
    x = (np.random.default_rng(seed).standard_normal((3, 200, 40)) * 5).astype(np.float32)
    zero = [slice(None)] * 3
    zero[axis] = slice(0, 64) if x.shape[axis] >= 64 else slice(0, 1)
    x[tuple(zero)] = 0.0
    return x


@pytest.mark.parametrize("axis", [0, 1, -1])
@pytest.mark.parametrize("qname", list(QDTYPES))
def test_payloads_and_scales_bit_equal(qname, axis):
    jdt, tdt = QDTYPES[qname]
    x = _problem(axis)
    want = jq.quantize(jnp.asarray(x), jdt, axis=axis, block_size=64)
    got = tq.quantize(torch.from_numpy(x), tdt, axis=axis, block_size=64)
    assert got.values.dtype == tdt and got.axis == want.axis and got.block_size == 64
    assert got.shape == tuple(want.shape) and got.dtype == tdt
    np.testing.assert_array_equal(_payload_bits(got.values), _payload_bits(want.values))
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))
    np.testing.assert_allclose(got.dequantize().numpy(), np.asarray(want.dequantize()),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(tq.dequantize(got, torch.bfloat16).float().numpy(),
                               np.asarray(jq.dequantize(want, jnp.bfloat16), np.float32),
                               rtol=0, atol=0)
    terr = tq.quantization_error(torch.from_numpy(x), got)
    jerr = jq.quantization_error(jnp.asarray(x), want)
    assert set(terr) == set(jerr)
    for key in jerr:
        assert isinstance(terr[key], float)
        assert abs(terr[key] - jerr[key]) <= 1e-6 * max(1.0, abs(jerr[key])), key


@pytest.mark.parametrize("qname", list(QDTYPES))
def test_quantize_kv_matches_jax(qname):
    jdt, tdt = QDTYPES[qname]
    rng = np.random.default_rng(1)
    k = rng.standard_normal((2, 200, 4, 64)).astype(np.float32)
    v = (rng.standard_normal((2, 200, 4, 64)) * 30).astype(np.float32)
    jk, jv = jq.quantize_kv(jnp.asarray(k), jnp.asarray(v), jdt, seq_axis=1, block_size=128)
    tk, tv = tq.quantize_kv(torch.from_numpy(k), torch.from_numpy(v), tdt, seq_axis=1,
                            block_size=128)
    for got, want, src in ((tk, jk, k), (tv, jv, v)):
        assert got.scales.shape == (2, 2, 4, 64)
        np.testing.assert_array_equal(_payload_bits(got.values), _payload_bits(want.values))
        np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))
        assert tq.quantization_error(torch.from_numpy(src), got)["mean_rel_err"] < 0.05


@pytest.mark.parametrize("qname", list(QDTYPES))
def test_round_trip_gates(qname):
    _, tdt = QDTYPES[qname]
    rng = np.random.default_rng(42)
    x = torch.from_numpy(rng.standard_normal((1, 512, 16)).astype(np.float32))
    x[0, 5, 3] = 1000.0  # an outlier stays in its own block
    qt = tq.quantize(x, tdt, axis=1, block_size=128)
    clean = (qt.dequantize()[0, 256:] - x[0, 256:]).abs()
    assert float(clean.max()) < (0.1 if qname == "int8" else 0.3)
    zeros = tq.quantize(torch.zeros(1, 128, 8), tdt, axis=1)
    assert bool((zeros.dequantize() == 0).all()) and bool(torch.isfinite(zeros.scales).all())


def test_arguments():
    with pytest.raises(ValueError):
        tq.quantize(torch.zeros(4, 8), torch.float16)
    with pytest.raises(ValueError):
        tq.quantize(torch.zeros(4, 8), torch.int8, block_size=0)
