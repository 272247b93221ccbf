"""Port parity: the PyTorch flash forward against the JAX package.

The same numpy inputs go to ``photonic_flash_attention_tpu`` (Pallas in
interpret mode on the CPU) and to ``photonic_flash_attention_tpu_torch``
(the plain version of kernel K1 on the CPU). Sequence lengths stay below
512 so the JAX side runs its grid kernel in the input dtype (its unrolled
path computes fp32 inputs in bf16). Tolerances: fp32 max-abs 1e-4; bf16
``assert_close`` (2e-2), as the JAX package's own kernel tests.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photonic_flash_attention_tpu.ops.flash import flash_attention as jax_flash
from photonic_flash_attention_tpu.ops.flash import flash_attention_with_lse as jax_flash_lse
from photonic_flash_attention_tpu.ops.flash_unrolled import (
    flash_attention_best as jax_flash_best,
)
from photonic_flash_attention_tpu.ops.reference import (
    DEFAULT_MASK_VALUE as JAX_MASK_VALUE,
    attention_reference as jax_reference,
)
from photonic_flash_attention_tpu_torch.ops import _build
from photonic_flash_attention_tpu_torch.ops.flash import flash_attention, flash_attention_with_lse
from photonic_flash_attention_tpu_torch.ops.flash_unrolled import (
    flash_attention_best,
    unrolled_supported,
)
from photonic_flash_attention_tpu_torch.ops.reference import (
    DEFAULT_MASK_VALUE,
    attention_reference,
)

from .conftest import assert_close, rel_err_norm

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}

# (B, Sq, Skv, Hq, Hkv, D, causal)
CASES = [
    (1, 16, 16, 4, 4, 64, True),
    (2, 40, 40, 4, 2, 64, True),
    (1, 128, 128, 2, 2, 128, False),
    (1, 40, 128, 4, 2, 128, True),
    (1, 256, 256, 2, 2, 64, True),
    (2, 16, 40, 2, 2, 64, False),
]


#: The card's ragged edges (chip_smoke.py::check_k1_edges): every pair Sq !=
#: Skv of EDGE_LENGTHS, causal (end-aligned) where Sq < Skv (the public
#: entry points refuse causal rows with no key), and GQA 12/4 and 32/8.
EDGE_LENGTHS = (1, 127, 129, 300)
EDGE_CASES = [(2, sq, skv, 4, 2, 64, sq < skv)
              for sq in EDGE_LENGTHS for skv in EDGE_LENGTHS if sq != skv]
EDGE_CASES += [(2, 300, 300, 12, 4, 64, True), (1, 129, 129, 32, 8, 128, True)]


def _case_id(c):
    b, sq, skv, hq, hkv, d, causal = c
    return f"b{b}q{sq}k{skv}h{hq}g{hkv}d{d}{'c' if causal else 'n'}"


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(case, seed=0):
    b, sq, skv, hq, hkv, d, _ = case
    rng = np.random.default_rng(seed)
    shapes = ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d))
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _both(arrs, dtype_name):
    jdt, tdt = DTYPES[dtype_name]
    return (
        [jnp.asarray(a, jdt) for a in arrs],
        [torch.from_numpy(a).to(tdt) for a in arrs],
    )


def _check(port_out, jax_out, dtype_name):
    a = port_out.float().numpy()
    b = np.asarray(jax_out, np.float32)
    if dtype_name == "f32":
        assert np.max(np.abs(a - b)) <= 1e-4
    else:
        assert_close(a, b)


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_flash_attention_matches_jax(case, dtype_name):
    causal = case[-1]
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(case), dtype_name)
    out = flash_attention(tq, tk, tv, causal=causal)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    _check(out, jax_flash(jq, jk, jv, causal=causal), dtype_name)
    _check(out, jax_reference(jq, jk, jv, causal=causal)[0], dtype_name)


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("case", CASES[:4], ids=_case_id)
def test_flash_attention_best_matches_jax(case, dtype_name):
    causal = case[-1]
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(case, seed=1), dtype_name)
    _check(
        flash_attention_best(tq, tk, tv, causal=causal),
        jax_flash_best(jq, jk, jv, causal=causal),
        dtype_name,
    )


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("case", EDGE_CASES, ids=_case_id)
def test_flash_ragged_edges_match_jax(case, dtype_name):
    """Output and lse of the port's plain K1 at the card's edge geometries
    against the JAX kernel in interpret mode: the reference the card's
    kernel is held to there is itself anchored to JAX."""
    causal = case[-1]
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(case, seed=3), dtype_name)
    out, lse = flash_attention_with_lse(tq, tk, tv, causal=causal)
    ref, ref_lse = jax_flash_lse(jq, jk, jv, causal=causal)
    assert out.dtype == tq.dtype and lse.shape == (case[0], case[3], case[1])
    _check(out, ref, dtype_name)
    _check(lse, ref_lse, dtype_name)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_reference_matches_jax_reference(case):
    causal = case[-1]
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(case, seed=2), "f32")
    scale = 0.3
    out = attention_reference(tq, tk, tv, causal=causal, sm_scale=scale)[0]
    ref = jax_reference(jq, jk, jv, causal=causal, sm_scale=scale)[0]
    assert np.max(np.abs(out.numpy() - np.asarray(ref))) <= 1e-5
    assert DEFAULT_MASK_VALUE == JAX_MASK_VALUE


def test_fp32_prefill_stays_fp32():
    """The JAX ``flash_attention_best`` computes fp32 inputs of its unrolled
    envelope (S a multiple of 512) in bf16; the port keeps them fp32."""
    case = (1, 512, 512, 2, 2, 64, True)
    q, k, v = (torch.from_numpy(a) for a in _inputs(case, seed=3))
    ref = attention_reference(q.double(), k.double(), v.double(), causal=True)[0]
    out = flash_attention_best(q, k, v, causal=True)
    assert out.dtype == torch.float32
    assert rel_err_norm(out.numpy(), ref.float().numpy()) < 1e-6
    # What a bf16 computation costs, so the bound above tells the two apart.
    bf = flash_attention_best(q.bfloat16(), k.bfloat16(), v.bfloat16(), causal=True)
    assert rel_err_norm(bf.float().numpy(), ref.float().numpy()) > 1e-3


def test_unrolled_supported_is_the_kernel_envelope():
    assert unrolled_supported(16, 64) and unrolled_supported(1000, 128)
    assert unrolled_supported(512, 32) and unrolled_supported(512, 80)
    assert unrolled_supported(512, 129) and unrolled_supported(512, 256)
    assert not unrolled_supported(512, 257)
    assert not unrolled_supported(512, 129, int8_qk=True)
    assert not unrolled_supported(0, 64)


def test_cpu_path_never_touches_the_kernel_library():
    case = CASES[1]
    q, k, v = (torch.from_numpy(a) for a in _inputs(case))
    before = dict(_build.LAUNCHES)
    flash_attention(q, k, v, causal=True)
    assert dict(_build.LAUNCHES) == before
    assert _build._lib is None


@pytest.mark.parametrize(
    "shapes, causal, match",
    [
        (((1, 8, 3, 64), (1, 8, 2, 64)), False, "GQA"),
        (((1, 16, 2, 64), (1, 8, 2, 64)), True, "no key"),
        (((1, 8, 2, 64), (1, 8, 2, 32)), False, "mismatch"),
    ],
)
def test_flash_attention_rejects_bad_inputs(shapes, causal, match):
    qs, ks = shapes
    with pytest.raises(ValueError, match=match):
        flash_attention(torch.zeros(qs), torch.zeros(ks), torch.zeros(ks), causal=causal)
