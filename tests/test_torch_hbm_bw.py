"""Port parity: the HBM read and copy probes (K9 and K10's plain versions).

The same numpy inputs go through the JAX kernels in interpret mode
(``photonic_flash_attention_tpu/ops/hbm_bw.py``) and through the port's
wrappers on the CPU, which run the plain versions. Both are exact: the read
probe returns a slice of its input, the copy its input. K10's launch plan
(``k10_plan``: its chunks, ring and grid) is a pure function, checked
here too: every chunk falls to exactly one CTA, and the rings the
launcher refuses raise.
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


#: Sizes in bytes: one 16-byte chunk, a chunk and 16 bytes, a size that is
#: not a multiple of the chunk, fewer chunks than SMs, and bench.py's copy.
K10_SIZES = [16, hbm_bw.COPY_CHUNK + 16, 100 * 512 * 4, 131072 * 512 * 2]


@pytest.mark.parametrize("n_bytes", K10_SIZES)
@pytest.mark.parametrize("chunk, stages", [(hbm_bw.COPY_CHUNK, hbm_bw.COPY_STAGES), (16384, 6),
                                           (65536, 2)])
def test_k10_plan_covers_every_chunk_once(n_bytes, chunk, stages):
    """CTA b copies chunks b, b + grid, ... (csrc/probes.cu::hbm_copy_ring;
    one where a CTA takes a chunk): each CTA at least one, together every
    chunk once; the last chunk the rest of the bytes, a multiple of 16."""
    for sms, persistent in ((132, True), (7, True), (132, False)):
        plan = hbm_bw.k10_plan(n_bytes, sms, chunk=chunk, stages=stages, persistent=persistent)
        assert (plan.chunk, plan.stages) == (chunk, stages)
        assert plan.chunks == -(-n_bytes // chunk)
        assert plan.grid == (min(plan.chunks, sms) if persistent else plan.chunks)
        walks = [range(b, plan.chunks, plan.grid) for b in range(plan.grid)]
        assert all(len(w) > 0 for w in walks)
        assert sorted(c for w in walks for c in w) == list(range(plan.chunks))
        last = n_bytes - (plan.chunks - 1) * chunk
        assert 0 < last <= chunk and last % 16 == 0
        assert stages * (chunk + 8) <= hbm_bw.SMEM_MAX


def test_k10_plan_defaults():
    plan = hbm_bw.k10_plan(131072 * 512 * 2)
    assert plan == hbm_bw.K10Plan(32768, 2, 4096, 4096) and not hbm_bw.COPY_PERSISTENT
    assert hbm_bw.k10_plan(131072 * 512 * 2, persistent=True).grid == 132


@pytest.mark.parametrize("kw, match", [
    (dict(n_bytes=0), "multiple of 16 bytes"),
    (dict(n_bytes=24), "multiple of 16 bytes"),
    (dict(n_bytes=4096, chunk=1000), "chunk"),
    (dict(n_bytes=4096, chunk=1 << 20), "chunk"),
    (dict(n_bytes=4096, stages=1), "does not fit"),
    (dict(n_bytes=4096, stages=9, chunk=1024), "does not fit"),
    (dict(n_bytes=4096, stages=8, chunk=32768), "does not fit"),
], ids=["empty", "not-16", "chunk-not-16", "chunk-1mib", "one-stage", "nine-stages",
        "past-smem"])
def test_k10_plan_bad_arguments(kw, match):
    n = kw.pop("n_bytes")
    with pytest.raises(ValueError, match=match):
        hbm_bw.k10_plan(n, **kw)
