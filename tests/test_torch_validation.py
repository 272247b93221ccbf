"""Port parity: the A1 leftovers of ``utils/validation.py`` and
``core/timing.py``.

``validate_block_config``, ``check_finite``, ``pad_to_multiple`` and
``normalize_mask`` take the same numpy-seeded inputs as JAX's: the same
accept/reject verdicts and messages, and bit-equal padded tensors and
broadcast masks. ``default_iters`` gives JAX's CPU triple on the CPU (JAX's
``jax.default_backend()`` is "cpu" here) and the card's fit counts for a
CUDA device.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photonic_flash_attention_tpu.core import timing as jax_timing
from photonic_flash_attention_tpu.utils import validation as jax_val
from photonic_flash_attention_tpu.utils.exceptions import ValidationError as JaxValidationError
from photonic_flash_attention_tpu_torch.core import timing as port_timing
from photonic_flash_attention_tpu_torch.utils import validation as port_val
from photonic_flash_attention_tpu_torch.utils.exceptions import ValidationError


def _verdict(fn, err):
    try:
        fn()
    except err as e:
        return str(e)
    return "ok"


BLOCK_CASES = [(128, 128, 64), (512, 1024, 128), (64, 128, 64), (128, 100, 64), (0, 128, 64),
               (-128, 128, 64), (256, 256, 0), (256, 256, -8), (384, 640, 32)]


@pytest.mark.parametrize("case", BLOCK_CASES, ids=[str(c) for c in BLOCK_CASES])
def test_validate_block_config_as_jax(case):
    port = _verdict(lambda: port_val.validate_block_config(*case), ValidationError)
    ref = _verdict(lambda: jax_val.validate_block_config(*case), JaxValidationError)
    assert port == ref


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
@pytest.mark.parametrize("poison", [None, np.nan, np.inf, -np.inf])
def test_check_finite_as_jax(rng, dtype, poison):
    x = rng.standard_normal((4, 5)).astype(dtype)
    if poison is not None:
        x[2, 3] = poison
    t = torch.from_numpy(x)
    port = _verdict(lambda: port_val.check_finite(t, "q"), ValidationError)
    ref = _verdict(lambda: jax_val.check_finite(jnp.asarray(x), "q"), JaxValidationError)
    assert port == ref
    if poison is None:
        assert port_val.check_finite(t) is t


def test_check_finite_bfloat16():
    x = torch.tensor([1.0, float("nan")], dtype=torch.bfloat16)
    with pytest.raises(ValidationError, match="x contains NaN/Inf"):
        port_val.check_finite(x, "x")
    assert port_val.check_finite(x[:1], "x") is not None


PAD_CASES = [((3, 100, 4), 128, 1), ((3, 128, 4), 128, 1), ((5, 7), 4, 0), ((5, 7), 4, -1),
             ((2, 3, 5, 9), 8, 3), ((1, 1), 3, 0)]


@pytest.mark.parametrize("shape, multiple, axis", PAD_CASES, ids=[str(c) for c in PAD_CASES])
def test_pad_to_multiple_as_jax(rng, shape, multiple, axis):
    x = rng.standard_normal(shape).astype(np.float32)
    padded, size = port_val.pad_to_multiple(torch.from_numpy(x), multiple, axis)
    jpadded, jsize = jax_val.pad_to_multiple(jnp.asarray(x), multiple, axis)
    assert size == jsize
    np.testing.assert_array_equal(padded.numpy(), np.asarray(jpadded))


MASK_SHAPES = [None, (16, 24), (2, 16, 24), (2, 1, 16, 24), (2, 3, 16, 24), (1, 1, 1, 24)]


@pytest.mark.parametrize("shape", MASK_SHAPES, ids=[str(s) for s in MASK_SHAPES])
def test_normalize_mask_as_jax(rng, shape):
    if shape is None:
        assert port_val.normalize_mask(None, 2, 3, 16, 24) is None
        return
    m = rng.random(shape) > 0.3
    out = port_val.normalize_mask(torch.from_numpy(m), 2, 3, 16, 24)
    ref = jax_val.normalize_mask(jnp.asarray(m), 2, 3, 16, 24)
    assert tuple(out.shape) == (2, 3, 16, 24)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_default_iters_by_device():
    assert port_timing.default_iters(torch.device("cpu")) == jax_timing.default_iters()
    assert port_timing.default_iters() == jax_timing.default_iters()  # no card here
    lo, hi, rep = port_timing.default_iters(torch.device("cuda", 0))
    assert (lo, hi, rep) == (2, 10, 5) and lo < hi and rep >= 1
