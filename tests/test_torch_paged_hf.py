"""Port parity: ``paged_attention_hf`` (kernel K3's read-only entry) against JAX.

The JAX ``paged_attention_hf`` runs its Pallas kernel in interpret mode on
the CPU over token-minor pools ``(L, Hkv, P, D, page)``; the port runs the
plain version of K3's hf mode over the same values in its token-major
layout (``to_jax_layout``). Pages are scattered, lengths cross page and
block boundaries, one row is empty.

Bounds: float compute (bf16 or int8 pool) ``rel_err_norm`` <= 1e-5;
``int8_compute`` at the same ``pages_per_block`` <= 1e-3 (the P requant
rounds identically unless an exp differs in its last bit), and <= 3e-2
against the float oracle, the bound of the JAX package's own test.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photonic_flash_attention_tpu.ops.paged import (
    paged_attention_hf as jax_paged_hf,
)
from photonic_flash_attention_tpu_torch.ops import _build
from photonic_flash_attention_tpu_torch.ops.paged import (
    paged_attention_hf,
    paged_attention_xla,
    to_jax_layout,
)

from .conftest import rel_err_norm

L, HKV, D, PAGE, NUM_PAGES, PPS = 2, 2, 64, 16, 60, 8
LENGTHS = [40, 17, 128, 0, 33, 100]  # block 2 pages = 32 tokens: partial, exact, many
B = len(LENGTHS)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(kv: str, hq: int, seed: int = 0):
    """numpy inputs in the JAX layout."""
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
    tables = (rng.permutation(NUM_PAGES - 1)[: B * PPS] + 1).reshape(B, PPS).astype(np.int32)
    q = (rng.standard_normal((B, hq, D)) * 2).astype(np.float32)
    return q, k, v, ks, vs, tables, np.asarray(LENGTHS, np.int32)


def _run_both(kv, hq, layer, int8_compute=None, pages_per_block=2, rank4=False, seed=0):
    q, k, v, ks, vs, tables, lengths = _problem(kv, hq, seed)
    jdt = jnp.int8 if kv == "int8" else jnp.bfloat16
    tdt = torch.int8 if kv == "int8" else torch.bfloat16
    quant = ks is not None
    jk, jv = jnp.asarray(k, jdt), jnp.asarray(v, jdt)
    jks = jnp.asarray(ks) if quant else None
    jvs = jnp.asarray(vs) if quant else None
    tk = to_jax_layout(torch.from_numpy(k)).contiguous().to(tdt)
    tv = to_jax_layout(torch.from_numpy(v)).contiguous().to(tdt)
    tks = torch.from_numpy(ks) if quant else None
    tvs = torch.from_numpy(vs) if quant else None
    kw = dict(pages_per_block=pages_per_block, int8_compute=int8_compute)
    if rank4:
        jk, jv, tk, tv = jk[layer], jv[layer], tk[layer], tv[layer]
        if quant:
            jks, jvs, tks, tvs = jks[layer], jvs[layer], tks[layer], tvs[layer]
        jl = tl = None
    else:
        jl, tl = jnp.asarray([layer], jnp.int32), layer
    want = jax_paged_hf(jnp.asarray(q), jk, jv, jnp.asarray(lengths), jnp.asarray(tables),
                        jks, jvs, layer=jl, **kw)
    got = paged_attention_hf(torch.from_numpy(q), tk, tv, torch.from_numpy(lengths),
                             torch.from_numpy(tables), tks, tvs, layer=tl, **kw)
    oracle = paged_attention_xla(
        torch.from_numpy(q), (tk if rank4 else tk[layer]), (tv if rank4 else tv[layer]),
        torch.from_numpy(lengths), torch.from_numpy(tables),
        None if not quant else (tks if rank4 else tks[layer]),
        None if not quant else (tvs if rank4 else tvs[layer]),
    )
    return got, np.asarray(want, np.float32), oracle


LIVE = [i for i, n in enumerate(LENGTHS) if n]


@pytest.mark.parametrize("hq", [2, 8])
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_float_compute_matches_jax(kv, hq):
    got, want, oracle = _run_both(kv, hq, layer=1, int8_compute=False)
    assert got.shape == (B, hq, D) and got.dtype == torch.float32
    assert rel_err_norm(got.numpy(), want) <= 1e-5
    assert rel_err_norm(got.numpy()[LIVE], oracle.numpy()[LIVE]) <= 1e-5


@pytest.mark.parametrize("pages_per_block", [1, 2, 3])
@pytest.mark.parametrize("hq", [2, 8])
def test_int8_compute_matches_jax(hq, pages_per_block):
    got, want, oracle = _run_both("int8", hq, layer=0, pages_per_block=pages_per_block)
    assert rel_err_norm(got.numpy(), want) <= 1e-3
    assert rel_err_norm(got.numpy()[LIVE], oracle.numpy()[LIVE]) <= 3e-2


def test_int8_compute_is_the_default_for_int8_pools():
    default, _, _ = _run_both("int8", 2, layer=1, seed=3)
    explicit, _, _ = _run_both("int8", 2, layer=1, int8_compute=True, seed=3)
    floats, _, _ = _run_both("int8", 2, layer=1, int8_compute=False, seed=3)
    assert torch.equal(default, explicit) and not torch.equal(default, floats)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_length_zero_rows_give_zero(kv):
    got, want, _ = _run_both(kv, 4, layer=0)
    empty = LENGTHS.index(0)
    assert torch.all(got[empty] == 0.0) and np.all(want[empty] == 0.0)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_rank4_pool_without_layer(kv):
    got, want, _ = _run_both(kv, 4, layer=1, rank4=True)
    assert rel_err_norm(got.numpy(), want) <= (1e-3 if kv == "int8" else 1e-5)


def test_output_takes_q_dtype_and_rejects_bad_calls():
    q, k, v, _, _, tables, lengths = _problem("bf16", 2)
    tk = to_jax_layout(torch.from_numpy(k)).contiguous().bfloat16()
    args = (tk, tk, torch.from_numpy(lengths), torch.from_numpy(tables))
    out = paged_attention_hf(torch.from_numpy(q).bfloat16(), *args, layer=0)
    assert out.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="layer"):
        paged_attention_hf(torch.from_numpy(q), *args)
    with pytest.raises(ValueError, match="int8 pool"):
        paged_attention_hf(torch.from_numpy(q), *args, layer=0, int8_compute=True)


def test_cpu_path_never_touches_the_kernel_library():
    before = dict(_build.LAUNCHES)
    _run_both("int8", 2, layer=0)
    assert dict(_build.LAUNCHES) == before
