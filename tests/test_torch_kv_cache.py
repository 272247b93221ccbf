"""The port's paged KV cache against the JAX package's.

The cases of ``tests/unit/test_kv_cache.py`` run on the port's
``PagedKVCache`` (on the CPU); the same appends, numpy inputs from a seed,
into JAX's cache and the port's must give equal page tables, equal
``gather_kv``, and bit-equal int8 payloads and scales once JAX's
token-minor pools are transposed to the port's token-major layout.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photonic_flash_attention_tpu.core.kv_cache import PagedKVCache as JaxCache
from photonic_flash_attention_tpu_torch.core import kv_cache
from photonic_flash_attention_tpu_torch.core.kv_cache import (
    PagedKVCache,
    get_kv_cache,
    reset_kv_cache,
)
from photonic_flash_attention_tpu_torch.ops.paged import paged_attention_xla
from photonic_flash_attention_tpu_torch.utils.exceptions import KVCacheError

from .conftest import rel_err_norm

H, D, PAGE = 2, 64, 16


def make_cache(num_pages=32, dtype=torch.float32, **kw):
    kw.setdefault("max_pages_per_seq", 16)
    return PagedKVCache(num_pages, PAGE, H, D, dtype=dtype, device="cpu", **kw)


def _normal(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


# -- the cases of tests/unit/test_kv_cache.py ---------------------------------


def test_allocate_free_cycle():
    c = make_cache()
    sid = c.allocate_sequence(40)  # 3 pages
    assert c.get_memory_stats()["pages_used"] == 3
    c.free_sequence(sid)
    assert c.get_memory_stats()["pages_used"] == 0
    assert c.get_memory_stats()["free_count"] == 3


def test_oom_raises_and_counts():
    c = make_cache(num_pages=2)
    c.allocate_sequence(2 * PAGE)
    with pytest.raises(KVCacheError, match="out of pages"):
        c.allocate_sequence(PAGE)
    assert c.get_memory_stats()["oom_events"] == 1


def test_double_allocate_same_id():
    c = make_cache()
    c.allocate_sequence(0, seq_id=7)
    with pytest.raises(KVCacheError):
        c.allocate_sequence(0, seq_id=7)


def test_free_unknown():
    c = make_cache()
    with pytest.raises(KVCacheError):
        c.free_sequence(99)


def test_temporary_context():
    c = make_cache()
    with c.temporary_sequence(PAGE) as sid:
        assert c.get_memory_stats()["pages_used"] == 1
        assert c.sequence_length(sid) == 0
    assert c.get_memory_stats()["pages_used"] == 0


def test_max_pages_per_seq():
    c = make_cache(num_pages=64, max_pages_per_seq=2)
    with pytest.raises(KVCacheError, match="max_pages_per_seq"):
        c.allocate_sequence(3 * PAGE)


@pytest.mark.parametrize("dtype, n", [(torch.bfloat16, 40), (torch.int8, 33)], ids=["bf16", "int8"])
def test_round_trip(rng, dtype, n):
    c = make_cache(dtype=dtype)
    sid = c.allocate_sequence()
    k, v = _normal(rng, n, H, D), _normal(rng, n, H, D)
    c.append(sid, k, v)
    assert c.sequence_length(sid) == n
    kg, vg = c.gather_kv(sid)
    assert kg.shape == (n, H, D) and kg.dtype == torch.float32
    assert rel_err_norm(kg.numpy(), k.numpy()) < 0.02  # bf16 storage / per-token int8
    assert rel_err_norm(vg.numpy(), v.numpy()) < 0.02


def test_incremental_append_decode_style(rng):
    c = make_cache()
    sid = c.allocate_sequence()
    ks = []
    for _ in range(20):  # 20 single-token appends crossing a page edge
        k = _normal(rng, 1, H, D)
        c.append(sid, k, _normal(rng, 1, H, D))
        ks.append(k)
    kg, _ = c.gather_kv(sid)
    np.testing.assert_allclose(kg.numpy(), torch.cat(ks).numpy(), rtol=1e-6)


def test_page_table_shapes():
    c = make_cache()
    s1 = c.allocate_sequence(PAGE)
    s2 = c.allocate_sequence(3 * PAGE)
    lengths, tables = c.page_table([s1, s2])
    assert lengths.shape == (2,) and lengths.dtype == torch.int32
    assert tables.shape == (2, 16) and tables.dtype == torch.int32
    assert int(lengths[0]) == 0  # reserved but not yet written


def test_pages_not_shared_between_sequences():
    c = make_cache()
    s1 = c.allocate_sequence()
    s2 = c.allocate_sequence()
    c.append(s1, torch.ones(PAGE, H, D), torch.ones(PAGE, H, D))
    c.append(s2, -torch.ones(PAGE, H, D), -torch.ones(PAGE, H, D))
    assert float(c.gather_kv(s1)[0].min()) == 1.0
    assert float(c.gather_kv(s2)[0].max()) == -1.0


# -- the same appends into JAX's cache and the port's ---------------------------


@pytest.mark.parametrize("dtype", ["bf16", "int8", "f32"])
def test_appends_equal_jax(dtype):
    jdt, tdt = {"bf16": (jnp.bfloat16, torch.bfloat16), "int8": (jnp.int8, torch.int8),
                "f32": (jnp.float32, torch.float32)}[dtype]
    rng = np.random.default_rng(5)
    jc = JaxCache(24, PAGE, H, D, dtype=jdt, max_pages_per_seq=8)
    tc = PagedKVCache(24, PAGE, H, D, dtype=tdt, max_pages_per_seq=8, device="cpu")
    # Two sequences, a prompt each then single tokens, one freed midway so
    # its pages are handed to a third; a token of zeros (int8 scale 1).
    runs = [(0, 37), (1, 16), (0, 1), (1, 1), (0, 1), ("free", 1), (2, 20), (2, 1), (0, 12)]
    for c in (jc, tc):
        for _ in range(3):
            c.allocate_sequence()
    for sid, n in runs:
        if sid == "free":
            jc.free_sequence(n)
            tc.free_sequence(n)
            continue
        k = rng.standard_normal((n, H, D)).astype(np.float32) * rng.uniform(0.1, 8)
        v = rng.standard_normal((n, H, D)).astype(np.float32)
        k[0, 1] = 0.0
        jc.append(sid, jnp.asarray(k), jnp.asarray(v))
        tc.append(sid, torch.from_numpy(k), torch.from_numpy(v))
    live = [0, 2]
    j_len, j_tab = jc.page_table(live)
    t_len, t_tab = tc.page_table(live)
    np.testing.assert_array_equal(t_len.numpy(), np.asarray(j_len))
    np.testing.assert_array_equal(t_tab.numpy(), np.asarray(j_tab))
    for sid in live:
        for got, want in zip(tc.gather_kv(sid), jc.gather_kv(sid)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # The pools bit for bit, JAX's (H, P, D, page) transposed to (H, P, page, D).
    for got, want in ((tc.k_pages, jc.k_pages), (tc.v_pages, jc.v_pages)):
        want = np.asarray(jnp.swapaxes(want, -1, -2).astype(jnp.float32))
        np.testing.assert_array_equal(got.float().numpy(), want)
    if dtype == "int8":
        for got, want in ((tc.k_scales, jc.k_scales), (tc.v_scales, jc.v_scales)):
            np.testing.assert_array_equal(got.numpy().view(np.int32),
                                          np.asarray(want).view(np.int32))
    ts, js = tc.get_memory_stats(), jc.get_memory_stats()
    assert ts == js


def test_paged_attention_reads_the_cache_tensors(rng):
    """``ops/paged.py::paged_attention_xla`` (K3's oracle) takes the cache's
    pools and page table as they are."""
    c = make_cache(dtype=torch.int8, num_pages=16)
    sids = [c.allocate_sequence() for _ in range(3)]
    for sid, n in zip(sids, (5, 40, 17)):
        c.append(sid, _normal(rng, n, H, D), _normal(rng, n, H, D))
    lengths, tables = c.page_table(sids)
    q = _normal(rng, 3, 2 * H, D)
    o = paged_attention_xla(q, c.k_pages, c.v_pages, lengths, tables, c.k_scales, c.v_scales)
    for b, sid in enumerate(sids):
        k, v = c.gather_kv(sid)
        kk, vv = (x.repeat_interleave(2, dim=1).transpose(0, 1) for x in (k, v))
        p = torch.softmax(q[b, :, None] @ kk.transpose(-1, -2) * D ** -0.5, dim=-1)
        torch.testing.assert_close(o[b], (p @ vv)[:, 0], rtol=1e-5, atol=1e-5)


def test_singleton_and_default_device():
    reset_kv_cache()
    try:
        a = get_kv_cache(device="cpu", num_pages=8)
        assert get_kv_cache() is a and a.num_pages == 8 and a.page_size == 128
    finally:
        reset_kv_cache()
    assert kv_cache._cache_singleton is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PagedKVCache(4, PAGE, H, D)
