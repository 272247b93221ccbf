"""Port parity: ``paged_attention`` (the B14 entry on kernel K3) and
``paged_attention_auto`` against JAX.

The JAX ``paged_attention`` runs its Pallas kernel (``_paged_kernel``) in
interpret mode on the CPU over token-minor pools ``(…, Hkv, P, D, page)``;
the port runs K3's plain version over the same values in its token-major
layout (``to_jax_layout``). The cases are those of
``tests/unit/test_paged_attention.py``: several lengths, one sequence on
one page, a GQA group, rank-5 pools with a layer index equal to rank 4,
int8 pools with per-token scales, and a row of length 0 (0, as the TPU
kernel gives). fp32 within ``rel_err_norm`` 1e-5.

``paged_attention_auto`` on the CPU is the gather (``paged_attention_xla``),
as JAX's non-TPU branch: equal to JAX's within 1e-5, rows of length 0
included, where the gather averages the masked keys and the kernel gives 0
(a deliberate difference of both packages, pinned here).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photonic_flash_attention_tpu.ops.paged import (
    paged_attention as jax_paged_attention,
    paged_attention_auto as jax_paged_auto,
)
from photonic_flash_attention_tpu_torch.ops import _build
from photonic_flash_attention_tpu_torch.ops.paged import (
    paged_attention,
    paged_attention_auto,
    to_jax_layout,
)

from .conftest import rel_err_norm

L, HKV, D, PAGE, NUM_PAGES, PPS = 3, 2, 64, 16, 48, 8


def _problem(kv: str, lengths, hq: int, seed: int = 0):
    """numpy inputs in the JAX layout: rank-5 pools (L, Hkv, P, D, page)."""
    rng = np.random.default_rng(seed)
    shape = (L, HKV, NUM_PAGES, D, PAGE)
    if kv == "int8":
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        ks = rng.uniform(1e-3, 5e-2, shape[:3] + (PAGE,)).astype(np.float32)
        vs = rng.uniform(1e-3, 5e-2, shape[:3] + (PAGE,)).astype(np.float32)
    else:
        k = rng.standard_normal(shape).astype(np.float32)
        v = rng.standard_normal(shape).astype(np.float32)
        ks = vs = None
    b = len(lengths)
    tables = (rng.permutation(NUM_PAGES - 1)[: b * PPS] + 1).reshape(b, PPS).astype(np.int32)
    q = rng.standard_normal((b, hq, D)).astype(np.float32)
    return q, k, v, ks, vs, tables, np.asarray(lengths, np.int32)


def _inputs(kv, lengths, hq, layer):
    """(JAX args, port args); rank 4 (that layer's pools) when ``layer`` is None."""
    q, k, v, ks, vs, tables, lens = _problem(kv, lengths, hq)
    jargs = [q, k, v, lens, tables, ks, vs]
    targs = [q, to_jax_layout(torch.from_numpy(k)).contiguous(),
             to_jax_layout(torch.from_numpy(v)).contiguous(), lens, tables, ks, vs]
    if layer is None:
        for args in (jargs, targs):
            args[1], args[2] = args[1][1], args[2][1]
            if ks is not None:
                args[5], args[6] = args[5][1], args[6][1]
    jargs = [None if a is None else jnp.asarray(a) for a in jargs]
    targs = [None if a is None else torch.as_tensor(a) for a in targs]
    return jargs, targs


CASES = {  # name: (pool, lengths, Hq, layer)
    "oracle": ("f32", [40, 17, 128], 4, None),
    "single_page": ("f32", [7], 4, None),
    "gqa": ("f32", [64, 32], 8, None),
    "rank5": ("f32", [40, 17, 128], 4, 1),
    "int8": ("int8", [40, 17, 128], 4, None),
    "int8_rank5_gqa": ("int8", [100, 1, 33], 8, 2),
    "empty_row": ("f32", [40, 0, 128, 1], 4, None),
}


@pytest.mark.parametrize("name", list(CASES))
def test_paged_attention_matches_jax_kernel(name):
    kv, lengths, hq, layer = CASES[name]
    jargs, targs = _inputs(kv, lengths, hq, layer)
    jl = None if layer is None else jnp.int32(layer)
    want = np.asarray(jax_paged_attention(*jargs, pages_per_block=2, interpret=True, layer=jl))
    before = sum(_build.LAUNCHES.values())
    got = paged_attention(*targs, pages_per_block=2, layer=layer)
    assert sum(_build.LAUNCHES.values()) == before  # the CPU launches nothing
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert rel_err_norm(got.numpy(), want) <= 1e-5
    empty = np.asarray(lengths) == 0
    assert (got.numpy()[empty] == 0).all() and (want[empty] == 0).all()


def test_rank5_equals_rank4():
    jargs, targs = _inputs("int8", [40, 17, 128], 4, 1)
    rank5 = paged_attention(*targs, layer=1)
    _, t4 = _inputs("int8", [40, 17, 128], 4, None)
    assert torch.equal(rank5, paged_attention(*t4))


def test_output_in_q_dtype():
    _, targs = _inputs("f32", [40, 17], 4, None)
    q = targs[0].to(torch.bfloat16)
    out = paged_attention(q, *targs[1:])
    want = paged_attention(q.float(), *targs[1:])
    assert out.dtype == torch.bfloat16 and torch.equal(out, want.to(torch.bfloat16))


def test_arguments():
    _, targs = _inputs("f32", [40, 17], 4, None)
    with pytest.raises(ValueError):
        paged_attention(*targs, pages_per_block=0)
    with pytest.raises(ValueError):
        paged_attention(*targs, layer=0)  # rank-4 pools take no layer
    _, t5 = _inputs("f32", [40, 17], 4, 1)
    with pytest.raises(ValueError):
        paged_attention(*t5)  # rank-5 pools need one


@pytest.mark.parametrize("name", ["oracle", "int8", "empty_row", "int8_rank5_gqa", "rank5"])
def test_paged_attention_auto_matches_jax_cpu_branch(name):
    kv, lengths, hq, layer = CASES[name]
    jargs, targs = _inputs(kv, lengths, hq, layer)
    jl = None if layer is None else jnp.int32(layer)
    want = np.asarray(jax_paged_auto(*jargs, layer=jl))
    got = paged_attention_auto(*targs, layer=layer)
    assert rel_err_norm(got.numpy(), want) <= 1e-5
    empty = np.asarray(lengths) == 0
    if empty.any():
        # The gather averages a row's masked keys; the kernel gives 0.
        assert np.abs(want[empty]).max() > 0
        np.testing.assert_allclose(got.numpy()[empty], want[empty], rtol=0, atol=1e-5)
        assert (paged_attention(*targs, layer=layer).numpy()[empty] == 0).all()
