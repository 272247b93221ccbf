"""Port parity: the HBM read and copy probes (K9 and K10's plain versions).

The same numpy inputs go through the JAX kernels in interpret mode
(``photonic_flash_attention_tpu/ops/hbm_bw.py``) and through the port's
wrappers on the CPU, which run the plain versions. Both are exact: the read
probe returns a slice of its input, the copy its input.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photonic_flash_attention_tpu.ops.hbm_bw import hbm_copy as jax_hbm_copy
from photonic_flash_attention_tpu.ops.hbm_bw import hbm_read_probe as jax_hbm_read_probe
from photonic_flash_attention_tpu_torch.ops import hbm_bw


def _bf16_pair(shape, seed):
    """The same bf16 values as a JAX array and a torch tensor."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * 10
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a.astype(jnp.float32))


@pytest.mark.parametrize("chunks, first_row", [(1, 0), (2, 0), (3, 8192)])
def test_read_probe_matches_jax(chunks, first_row):
    """JAX's (8, 512): the first rows of the last even-indexed chunk."""
    jx, tx = _bf16_pair((chunks * hbm_bw.CHUNK_ROWS, 512), seed=chunks)
    want = _np(jax_hbm_read_probe(jx, interpret=True))
    got = hbm_bw.hbm_read_probe(tx)
    assert got.shape == (8, 512) and got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), want)
    assert hbm_bw.returned_row(tx.shape[0]) == first_row
    np.testing.assert_array_equal(want, _np(tx[first_row:first_row + 8]))


@pytest.mark.parametrize("rows", [100, 4096, 8192])
def test_copy_matches_jax(rows):
    jx, tx = _bf16_pair((rows, 512), seed=rows)
    got = hbm_bw.hbm_copy(tx)
    np.testing.assert_array_equal(_np(got), _np(jax_hbm_copy(jx, interpret=True)))
    assert got.data_ptr() != tx.data_ptr()


def test_argument_errors():
    with pytest.raises(ValueError, match="rows % 4096"):
        hbm_bw.hbm_read_probe(torch.zeros(4000, 512))
    with pytest.raises(ValueError, match="rows, cols"):
        hbm_bw.hbm_read_probe(torch.zeros(4096 * 512))
    with pytest.raises(ValueError, match="rows % 4096"):
        hbm_bw.hbm_copy(torch.zeros(5000, 512))
    with pytest.raises(ValueError, match="non-empty"):
        hbm_bw.hbm_copy(torch.zeros(0, 512))


def test_rates_on_the_cpu_time_the_plain_versions():
    """The rate functions on the CPU: finite and positive (a wall clock of
    the plain versions, not a device figure)."""
    x = torch.ones(hbm_bw.CHUNK_ROWS, 512, dtype=torch.bfloat16)
    for fn in (hbm_bw.hbm_read_bytes_per_s, hbm_bw.hbm_copy_bytes_per_s):
        rate = fn(x, fit=(5, 60), device="cpu")
        assert math.isfinite(rate) and rate > 0, fn.__name__
