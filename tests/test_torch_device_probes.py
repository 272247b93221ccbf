"""Port parity: the exp and softmax-stream probes (K11 and K12's plain
versions) and the measure functions on the CPU.

The same numpy inputs go through the JAX kernels in interpret mode
(``photonic_flash_attention_tpu/ops/device_probes.py``) and the port's
wrappers on the CPU (the plain versions). Bounds: the exp chain within
1e-6 abs (exp is rounded differently by XLA and torch, and 16 chained
rounding errors shrink by exp's slope, < 1); the softmax stream within one
bf16 ulp (2^-8 for values in [0.5, 1]): a one-ulp difference in an fp32
exp can round p to the neighbouring bf16 value. Masked and unmasked must
be equal, since the mask never drops a column.
"""

import ast
import inspect
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photonic_flash_attention_tpu.ops import device_probes as jax_dp
from photonic_flash_attention_tpu_torch.ops import device_probes as dp

EXP_BOUND = 1e-6
SOFTMAX_BOUND = 2.0 ** -8


def _pair(shape, seed, lo=0.1, hi=1.0):
    x = np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def test_exp_probe_matches_jax():
    jx, tx = _pair(dp.JAX_EXP_SHAPE, seed=0)
    want = np.asarray(jax_dp.exp_probe(jx, iters=16, interpret=True))
    got = dp.exp_probe(tx, iters=16)
    assert got.shape == (8, 512) and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= EXP_BOUND


@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
def test_softmax_block_probe_matches_jax(masked):
    jx, tx = _pair(dp.JAX_SOFTMAX_SHAPE, seed=1, lo=-2.0, hi=2.0)
    want = np.asarray(jax_dp.softmax_block_probe(jx, iters=8, masked=masked, interpret=True))
    got = dp.softmax_block_probe(tx, iters=8, masked=masked)
    assert got.shape == (8, 512) and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= SOFTMAX_BOUND
    # Every value is a bf16 value (the stream's P -> bf16 cast).
    assert torch.equal(got, got.to(torch.bfloat16).float())


#: Iteration counts at which the output still depends on the input and
#: the count (the exp chain contracts onto 0.567 by ~0.57 a step), none a
#: multiple of K11's unroll of 4. K12's inputs lie in [-8, 1): a row whose
#: max is above 1 collapses to exp(-max) within a few updates, while one
#: whose max is 1 climbs slowly to 1, spread wide at first.
FEW_ITERS = [1, 2, 3, 5, 7]


@pytest.mark.parametrize("iters", FEW_ITERS)
def test_exp_probe_matches_jax_at_few_iterations(iters):
    jx, tx = _pair((16, 512), seed=10 + iters, lo=0.0, hi=4.0)
    want = np.asarray(jax_dp.exp_probe(jx, iters=iters, interpret=True))
    assert np.abs(dp.exp_probe(tx, iters).numpy() - want).max() <= EXP_BOUND
    # The bound tells one count from the next.
    assert np.abs(dp.exp_probe(tx, iters + 1).numpy() - want).max() > 100 * EXP_BOUND


@pytest.mark.parametrize("iters", FEW_ITERS)
@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
def test_softmax_block_probe_matches_jax_at_few_iterations(iters, masked):
    jx, tx = _pair((16, 256), seed=20 + iters, lo=-8.0, hi=1.0)
    want = np.asarray(jax_dp.softmax_block_probe(jx, iters=iters, masked=masked,
                                                 interpret=True))
    assert np.abs(dp.softmax_block_probe(tx, iters, masked).numpy() - want).max() <= SOFTMAX_BOUND
    next_out = dp.softmax_block_probe(tx, iters + 1, masked).numpy()
    assert np.abs(next_out - want).max() > 4 * SOFTMAX_BOUND


@pytest.mark.parametrize("iters", [1, 3, 7])
def test_softmax_block_probe_running_sum(iters):
    """The running sums l (which JAX's probe does not return) against a
    float64 recurrence over the same bf16-rounded stream."""
    _, tx = _pair((12, 128), seed=30 + iters, lo=-8.0, hi=1.0)
    out, l = dp.softmax_block_probe(tx, iters, return_l=True)
    assert torch.equal(out, dp.softmax_block_probe(tx, iters))
    s, m, want = tx.double(), torch.full((12, 1), -1e30, dtype=torch.float64), 0.0
    for _ in range(iters):
        m_next = torch.maximum(m, s.amax(1, keepdim=True))
        p = torch.exp(s - m_next)
        want = torch.exp(m - m_next) * want + p.sum(1, keepdim=True)
        m, s = m_next, p.float().to(torch.bfloat16).double()
    assert l.shape == (8,) and l.dtype == torch.float32
    np.testing.assert_allclose(l.numpy(), want[:8, 0].numpy(), rtol=1e-5)


def test_masked_equals_unmasked():
    _, tx = _pair((40, 256), seed=2, lo=-3.0, hi=3.0)
    assert torch.equal(dp.softmax_block_probe(tx, 5, masked=True),
                       dp.softmax_block_probe(tx, 5, masked=False))


def test_zero_iterations_return_the_input_rows():
    _, tx = _pair((16, 128), seed=3)
    assert torch.equal(dp.exp_probe(tx, 0), tx[:8])
    assert torch.equal(dp.softmax_block_probe(tx, 0), tx[:8])
    assert not dp.softmax_block_probe(tx, 0, return_l=True)[1].any()


def test_argument_errors():
    with pytest.raises(ValueError, match="cols % 128"):
        dp.softmax_block_probe(torch.zeros(16, 100))
    with pytest.raises(ValueError, match="rows >= 8"):
        dp.exp_probe(torch.zeros(4, 128))
    with pytest.raises(ValueError, match="float32"):
        dp.exp_probe(torch.zeros(16, 128, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="iters"):
        dp.softmax_block_probe(torch.zeros(16, 128), iters=-1)


def _jax_return_keys(fn) -> set:
    """The keys of the dict literal JAX's function returns."""
    tree = ast.parse(inspect.getsource(fn).lstrip())
    ret = next(n for n in ast.walk(tree) if isinstance(n, ast.Return) and isinstance(n.value, ast.Dict))
    return {k.value for k in ret.value.keys}


def test_measure_functions_on_the_cpu():
    """Tiny fits of the plain versions by wall clock: finite, positive,
    and measure_softmax_linear with JAX's keys."""
    exp_rate = dp.measure_exp_rate(iters=4, fit=(2, 8), shape=(16, 128), device="cpu")
    masked = dp.measure_softmax_rate(iters=4, fit=(2, 8), shape=(16, 128), device="cpu")
    unmasked = dp.measure_softmax_rate(iters=4, fit=(2, 8), shape=(16, 128), masked=False,
                                       device="cpu")
    for rate in (exp_rate, masked, unmasked):
        assert math.isfinite(rate) and rate > 0
    fit = dp.measure_softmax_linear(fit=(2, 8), shapes=((16, 128, 8), (64, 512, 2)), device="cpu")
    assert set(fit) == _jax_return_keys(jax_dp.measure_softmax_linear)
    assert fit["s_per_elem"] > 0 and fit["fixed_s_per_tile"] >= 0
    assert fit["asymptotic_elems_per_s"] == pytest.approx(1 / fit["s_per_elem"])
    assert [e for e, _ in fit["points"]] == [16 * 128, 64 * 512]


def test_default_shapes_on_the_cpu_are_jax():
    assert dp._shape(None, "exp", True, "cpu", dp.JAX_EXP_SHAPE) == (512, 512)
    assert dp._shape(None, "softmax", True, "cpu", dp.JAX_SOFTMAX_SHAPE) == (128, 512)
    assert dp.JAX_LINEAR_SHAPES == ((32, 512, 4096), (224, 896, 512))
