"""Port parity at K3's split and page edges, and K3's host-side plan.

K3 on the card cuts each sequence into splits of 256 tokens (16 pages of 16
at the shapes here, ``ops/paged.py::k3_plan``) and merges them in the same
launch; the fused decode writes the new token and attends in one launch.
Its plain versions, which the card tests hold the kernel to, are checked
here against the JAX package's kernels in interpret mode at the lengths
where a split or a page ends: 0, 1, page - 1, page, page + 1, a split's
length - 1, + 0 and + 1, a few splits, a full table. Tolerances as in
``tests/test_torch_paged.py`` (the fused decode: written pools exact or
scales to 1e-6, output 1e-4) and ``tests/test_torch_paged_hf.py`` (int8
compute 1e-3 at the same requant blocks, 3e-2 against the float oracle).
The plan is a pure function of the shapes (no host read of lengths) and is
checked here on its own.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photonic_flash_attention_tpu.ops.paged import (
    paged_attention_hf as jax_paged_hf,
    paged_decode_attention as jax_paged_decode,
)
from photonic_flash_attention_tpu_torch.ops import paged as paged_ops
from photonic_flash_attention_tpu_torch.ops.paged import (
    k3_plan,
    k3_smem,
    paged_attention_hf,
    paged_attention_xla,
    paged_decode_attention,
    to_jax_layout,
)

from .conftest import rel_err_norm

L, HQ, HKV, D, PAGE, PPS = 2, 4, 2, 64, 16, 64
SPLIT = 256  # k3_plan's split at these shapes (checked below)
LENGTHS = [0, 1, PAGE - 1, PAGE, PAGE + 1, SPLIT - 1, SPLIT, SPLIT + 1, 2 * SPLIT + 1,
           PAGE * PPS - 1, PAGE * PPS]
B = len(LENGTHS)
NUM_PAGES = B * PPS + 4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(quantized: bool, seed: int, slot_at_end: bool = True):
    """numpy inputs in the JAX layout: distinct scattered pages per
    sequence, the new token's slot at position lengths[b] - 1 (or, with
    ``slot_at_end`` False, at an earlier position of the sequence), trash
    page 0 for the empty row."""
    rng = np.random.default_rng(seed)
    shape = (L, HKV, NUM_PAGES, D, PAGE)
    if quantized:
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        ks = rng.uniform(1e-3, 5e-2, shape[:3] + (PAGE,)).astype(np.float32)
        vs = rng.uniform(1e-3, 5e-2, shape[:3] + (PAGE,)).astype(np.float32)
    else:
        k = rng.standard_normal(shape).astype(np.float32)
        v = rng.standard_normal(shape).astype(np.float32)
        ks = vs = None
    tables = (rng.permutation(NUM_PAGES - 1)[: B * PPS] + 1).reshape(B, PPS).astype(np.int32)
    slots = np.zeros(B, np.int32)
    for i, n in enumerate(LENGTHS):
        if n:
            pos = n - 1 if slot_at_end else (3 * n) // 7
            slots[i] = tables[i, pos // PAGE] * PAGE + pos % PAGE
    q = rng.standard_normal((B, HQ, D)).astype(np.float32)
    k_new = rng.standard_normal((B, HKV, D)).astype(np.float32)
    v_new = rng.standard_normal((B, HKV, D)).astype(np.float32)
    return dict(q=q, k=k, v=v, ks=ks, vs=vs, tables=tables, slots=slots, k_new=k_new,
                v_new=v_new, lengths=np.asarray(LENGTHS, np.int32))


def _port_pool(a, dtype):
    return to_jax_layout(torch.from_numpy(a)).contiguous().to(dtype)


def _fused_both(kv: str, layer: int, seed: int, slot_at_end: bool = True, token_bias=None,
                sm_scale=None):
    """The JAX fused decode (interpret mode) and the port's
    paged_decode_attention (K2's and K3's plain versions) on the same
    inputs; returns (port output, JAX outputs, port pools)."""
    quantized = kv == "int8"
    p = _problem(quantized, seed, slot_at_end)
    pool_jdt = jnp.int8 if quantized else jnp.bfloat16
    pool_tdt = torch.int8 if quantized else torch.bfloat16
    kw = dict(sm_scale=sm_scale)
    j_out = jax_paged_decode(
        jnp.asarray(p["q"]), jnp.asarray(p["k_new"], jnp.bfloat16),
        jnp.asarray(p["v_new"], jnp.bfloat16), jnp.asarray(p["k"], pool_jdt),
        jnp.asarray(p["v"], pool_jdt), jnp.asarray(p["lengths"]), jnp.asarray(p["tables"]),
        jnp.asarray(p["slots"]), jnp.asarray(layer, jnp.int32),
        jnp.asarray(p["ks"]) if quantized else None, jnp.asarray(p["vs"]) if quantized else None,
        token_bias=None if token_bias is None else jnp.asarray(token_bias), **kw)
    pools = [_port_pool(p["k"], pool_tdt), _port_pool(p["v"], pool_tdt),
             torch.from_numpy(p["ks"]) if quantized else None,
             torch.from_numpy(p["vs"]) if quantized else None]
    out = paged_decode_attention(
        torch.from_numpy(p["q"]), torch.from_numpy(p["k_new"]).bfloat16(),
        torch.from_numpy(p["v_new"]).bfloat16(), pools[0], pools[1],
        torch.from_numpy(p["lengths"]), torch.from_numpy(p["tables"]),
        torch.from_numpy(p["slots"]), layer, pools[2], pools[3],
        token_bias=None if token_bias is None else torch.from_numpy(token_bias), **kw)
    return out, j_out, pools, p


def _check_fused(kv, out, j_out, pools, p, layer):
    for got, want in ((pools[0], j_out[1]), (pools[1], j_out[2])):
        assert np.array_equal(to_jax_layout(got).float().numpy(), np.asarray(want, np.float32))
    if kv == "int8":
        for got, want in ((pools[2], j_out[3]), (pools[3], j_out[4])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)
    j_o = np.asarray(j_out[0])
    if kv == "int8":
        assert rel_err_norm(out.numpy(), j_o) <= 1e-4
    else:
        assert np.max(np.abs(out.numpy() - j_o)) <= 1e-4
    assert np.all(out[0].numpy() == 0.0)  # length 0 -> zeros
    ref = paged_attention_xla(
        torch.from_numpy(p["q"]), pools[0][layer], pools[1][layer],
        torch.from_numpy(p["lengths"]), torch.from_numpy(p["tables"]),
        pools[2][layer] if kv == "int8" else None, pools[3][layer] if kv == "int8" else None)
    assert rel_err_norm(out[1:].numpy(), ref[1:].numpy()) <= 1e-5


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_fused_decode_split_edges_match_jax(kv):
    out, j_out, pools, p = _fused_both(kv, layer=1, seed=0)
    _check_fused(kv, out, j_out, pools, p, layer=1)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_fused_decode_slot_elsewhere_matches_jax(kv):
    """flat_slots[b] at an earlier position than lengths[b] - 1: the output
    is the attend over the written pool, as JAX's write-then-attend."""
    out, j_out, pools, p = _fused_both(kv, layer=0, seed=1, slot_at_end=False)
    _check_fused(kv, out, j_out, pools, p, layer=0)


def test_fused_decode_token_bias_across_splits_matches_jax():
    """T5's decode step: the bias at the token's logical position, rows
    across split ends, sm_scale 1, a bf16 pool."""
    rng = np.random.default_rng(5)
    bias = (rng.standard_normal((B, HKV, PPS * PAGE)) * 2).astype(np.float32)
    out, j_out, pools, p = _fused_both("bf16", layer=1, seed=2, token_bias=bias, sm_scale=1.0)
    for got, want in ((pools[0], j_out[1]), (pools[1], j_out[2])):
        assert np.array_equal(to_jax_layout(got).float().numpy(), np.asarray(want, np.float32))
    assert np.max(np.abs(out.numpy() - np.asarray(j_out[0]))) <= 1e-4
    assert np.all(out[0].numpy() == 0.0)


@pytest.mark.parametrize("pages_per_block", [3, 5])
def test_int8_compute_split_edges_match_jax(pages_per_block):
    """paged_attention_hf's int8 compute with requant blocks of 3 and 5
    pages, which divide neither K3's float split (16 pages) nor the table
    (64 pages): K3 then cuts splits of whole blocks (18 and 20 pages)."""
    p = _problem(True, seed=3)
    layer = 1
    want = jax_paged_hf(
        jnp.asarray(p["q"]), jnp.asarray(p["k"], jnp.int8), jnp.asarray(p["v"], jnp.int8),
        jnp.asarray(p["lengths"]), jnp.asarray(p["tables"]), jnp.asarray(p["ks"]),
        jnp.asarray(p["vs"]), pages_per_block=pages_per_block, layer=jnp.asarray([layer]))
    tk, tv = _port_pool(p["k"], torch.int8), _port_pool(p["v"], torch.int8)
    tks, tvs = torch.from_numpy(p["ks"]), torch.from_numpy(p["vs"])
    lengths, tables = torch.from_numpy(p["lengths"]), torch.from_numpy(p["tables"])
    got = paged_attention_hf(torch.from_numpy(p["q"]), tk, tv, lengths, tables, tks, tvs,
                             pages_per_block=pages_per_block, layer=layer)
    oracle = paged_attention_xla(torch.from_numpy(p["q"]), tk[layer], tv[layer], lengths,
                                 tables, tks[layer], tvs[layer])
    assert rel_err_norm(got.numpy(), np.asarray(want, np.float32)) <= 1e-3
    assert rel_err_norm(got.numpy()[1:], oracle.numpy()[1:]) <= 3e-2
    assert torch.all(got[0] == 0)
    plan = k3_plan(B, HQ, HKV, D, 1, PAGE, PPS, pages_per_block)
    assert plan.split_pages % pages_per_block == 0 and plan.split_pages % 16
    assert plan.block == pages_per_block * PAGE


# -- the plan: a pure function of the shapes ----------------------------------


@pytest.mark.parametrize("elt", [1, 2, 4])
@pytest.mark.parametrize("d", [64, 128])
def test_plan_splits_and_tiles(elt, d):
    plan = k3_plan(B, HQ, HKV, d, elt, PAGE, PPS)
    assert plan.split_pages * PAGE == SPLIT
    assert plan.n_split == -(-PPS // plan.split_pages) == 4
    # A tile is a whole number of pages or a divisor of one, and fills at
    # most one ring stage.
    assert PAGE % plan.tile == 0 or plan.tile % PAGE == 0
    assert 2 * plan.tile * d * elt <= paged_ops._K3_STAGE_BYTES
    assert plan.gcmax == min(2 * elt, 4) and plan.n_gchunk == -(-(HQ // HKV) // plan.gcmax)
    assert plan.block == 0
    assert plan.smem == k3_smem(B, d, elt, plan.gcmax, plan.tile, plan.split_pages, 0)
    assert plan.smem <= paged_ops._K3_SMEM_MAX


@pytest.mark.parametrize("page,pps,split_pages,n_split", [
    (128, 64, 2, 32),   # GPT-2 serving: 256-token splits, most past any length
    (128, 16, 2, 8),    # T5 serving and the engine's kv 2048
    (128, 256, 8, 32),  # 32768 tokens: at most _K3_MAX_SPLITS splits
    (16, 4, 4, 1),      # a table shorter than one split
    (100, 8, 3, 3),     # pages that do not divide 256: rounded up
])
def test_plan_split_arithmetic(page, pps, split_pages, n_split):
    plan = k3_plan(8, 16, 16, 64, 2, page, pps)
    assert (plan.split_pages, plan.n_split) == (split_pages, n_split)
    assert plan.n_split * plan.split_pages >= pps > (plan.n_split - 1) * plan.split_pages
    assert plan.n_split <= paged_ops._K3_MAX_SPLITS


def test_plan_ignores_the_batch_and_group_for_the_split():
    """The split comes from the table alone (no lengths, no batch): every
    call of a serving step gets the same plan."""
    plans = {k3_plan(b, hq, hkv, 64, 1, 128, 64)[:3]
             for b, hq, hkv in [(1, 16, 16), (8, 16, 16), (64, 32, 8)]}
    assert len({(p[1], p[2]) for p in plans}) == 1


def test_plan_int8_compute_splits_are_whole_blocks():
    for ppb in (1, 2, 3, 5, 8, 16, 40):
        plan = k3_plan(8, 16, 16, 64, 1, 128, 64, ppb)
        assert plan.split_pages % ppb == 0 and plan.block == ppb * 128
        assert plan.split_pages * 128 >= paged_ops._K3_SPLIT_TOKENS or plan.n_split == 1


def test_plan_lever_gives_one_split(monkeypatch):
    """The lever that shows what the split buys: one split a sequence."""
    monkeypatch.setattr(paged_ops, "_K3_SPLIT_TOKENS", 1 << 30)
    k3_plan.cache_clear()
    try:
        plan = k3_plan(8, 16, 16, 64, 1, 128, 64)
        assert (plan.split_pages, plan.n_split) == (64, 1)
    finally:
        k3_plan.cache_clear()


def test_plan_head_chunks():
    """G = 1 in one CTA; a group in chunks of 2 (int8), 4 (bf16, fp32)."""
    assert k3_plan(4, 32, 32, 128, 2, 16, 64)[3:5] == (1, 1)
    assert k3_plan(4, 32, 8, 128, 1, 16, 64)[3:5] == (2, 2)
    assert k3_plan(4, 32, 8, 128, 2, 16, 64)[3:5] == (4, 1)
    assert k3_plan(4, 32, 8, 128, 4, 16, 64)[3:5] == (4, 1)
    assert k3_plan(1, 64, 1, 64, 1, 16, 4)[3:5] == (2, 32)


@pytest.mark.parametrize("args,match", [
    ((8, 16, 16, 100, 2, 128, 64), "D in"),
    ((8, 16, 16, 129, 4, 128, 64), "head dim 129"),
    ((8, 144, 2, 64, 2, 128, 64), r"\(Hq/Hkv\)\*D"),
    ((8, 16, 16, 64, 1, 18, 64), "page_size % 4"),
    ((0, 16, 16, 64, 1, 128, 64), "batch"),
    ((8, 16, 16, 64, 1, 128, 64, 4096), "shared memory"),
    ((8, 16, 16, 264, 2, 128, 64), "head dim 264"),
])
def test_plan_rejects_calls_k3_does_not_take(args, match):
    with pytest.raises(ValueError, match=match):
        k3_plan(*args)
