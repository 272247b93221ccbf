"""The port's CUDA kernels against their plain versions, on the GPU.

Every test here carries the ``cuda`` marker and skips without a GPU. The
file imports no JAX, so it also runs on a machine that has none:

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda --noconftest -q

(``--noconftest`` because ``tests/conftest.py`` sets up JAX.) Each kernel
test checks that the wrapper launched its kernel exactly once and that the
result agrees with the plain version on the same inputs: K1 within
``rel_err_norm`` 1e-2 (bf16) or 1e-4 (fp32), K2 bit-exact, K3 within 1e-4
(1e-3 in int8 compute; its fused decode writes the pools bit-exact with
K2's plain version; two launches give the same bits).
The serving engine on the GPU must pick the same greedy tokens as on the
CPU, where it runs the plain versions.

The quantized kernels (K1's int8-QK, fp8-QK and int8-full modes, K6 fp8 and
int8) take the same 8-bit payloads as their plain versions: within 1e-2
for a bf16 output (its rounding) and 2e-3 for fp32 (exp2f against
torch.exp can move a requantized P by one step, and the fp32 sums run in
another order). The public entry points on the card stay under the JAX
tests' gates against the fp32 oracle (int8-full and K6 int8 0.03, int8-QK
and fp8-QK 0.05, K6 fp8 0.06).
"""

import numpy as np
import pytest
import torch

from photonic_flash_attention_tpu_torch.core.serving import ServingEngine
from photonic_flash_attention_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from photonic_flash_attention_tpu_torch.ops import _build
from photonic_flash_attention_tpu_torch.ops import flash_fp8
from photonic_flash_attention_tpu_torch.ops.flash import (
    flash_attention,
    flash_attention_plain,
    flash_attention_with_lse,
    flash_attention_with_lse_plain,
    flash_attention_qk_quant,
    flash_attention_qk_quant_plain,
)
from photonic_flash_attention_tpu_torch.ops.flash_unrolled import flash_attention_unrolled
from photonic_flash_attention_tpu_torch.ops.reference import attention_reference
from photonic_flash_attention_tpu_torch.ops.paged import (
    k3_plan,
    paged_attention_hf,
    paged_attention_hf_plain,
    paged_decode_attend,
    paged_decode_attend_plain,
    paged_decode_attention,
    paged_token_write,
    paged_token_write_plain,
)

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}

# (B, Sq, Skv, Hq, Hkv, D, causal): ragged lengths, GQA, Sq < Skv, both D.
FLASH_CASES = [
    (1, 16, 16, 16, 16, 64, True),
    (2, 40, 40, 4, 2, 64, True),
    (1, 128, 128, 2, 2, 128, False),
    (1, 40, 128, 4, 2, 128, True),
    (1, 1000, 1000, 4, 4, 64, True),
    (2, 16, 40, 2, 2, 64, False),
]


# The bf16 kernel's ragged edges (tests/test_torch_flash.py anchors the
# plain version there to JAX): every pair Sq != Skv of 1, 127, 129, 300,
# causal (end-aligned) where Sq < Skv, at D 64 and 128; GQA 12/4 and 32/8.
EDGE_LENGTHS = (1, 127, 129, 300)
EDGE_CASES = [(2, sq, skv, 4, 2, d, sq < skv)
              for sq in EDGE_LENGTHS for skv in EDGE_LENGTHS if sq != skv for d in (64, 128)]
EDGE_CASES += [(2, 300, 300, 12, 4, 64, True), (1, 513, 513, 32, 8, 128, True)]


def rel_err_norm(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float(torch.linalg.norm(a - b) / max(float(torch.linalg.norm(b)), 1e-9))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernel_matches_plain(case, dtype_name, cuda_device):
    b, sq, skv, hq, hkv, d, causal = case
    rng = np.random.default_rng(0)
    q, k, v = (
        torch.from_numpy(rng.standard_normal(s).astype(np.float32))
        .to(cuda_device, DTYPES[dtype_name])
        for s in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d))
    )
    before = _build.LAUNCHES["pfa_flash_fwd"]
    out = flash_attention(q, k, v, causal=causal)
    ref = flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["pfa_flash_fwd"] == before + 1
    assert out.dtype == q.dtype and torch.isfinite(out).all()
    assert rel_err_norm(out, ref) <= (1e-4 if dtype_name == "f32" else 1e-2)


L, HQ, HKV, D, PAGE, NUM_PAGES, PPS = 2, 4, 2, 64, 16, 24, 4
LENGTHS = [0, 5, 23, 33, 64]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("case", EDGE_CASES)
def test_flash_kernel_edges_match_plain(case, dtype_name, cuda_device):
    """Output and lse at the ragged edges: 1e-2 (bf16) or 1e-4 (fp32)
    rel_err_norm on o, 1e-4 on the lse."""
    b, sq, skv, hq, hkv, d, causal = case
    gen = torch.Generator(device=cuda_device).manual_seed(sq * 1000 + skv)
    q, k, v = (torch.randn(s, generator=gen, device=cuda_device).to(DTYPES[dtype_name])
               for s in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d)))
    before = _build.LAUNCHES["pfa_flash_fwd"]
    out, lse = flash_attention_with_lse(q, k, v, causal=causal)
    ref, ref_lse = flash_attention_with_lse_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["pfa_flash_fwd"] == before + 1
    assert out.dtype == q.dtype and torch.isfinite(out).all() and torch.isfinite(lse).all()
    assert rel_err_norm(out, ref) <= (1e-4 if dtype_name == "f32" else 1e-2)
    assert rel_err_norm(lse, ref_lse) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["f32", "bf16", "int8"])
def test_paged_kernels_match_plain(kv, cuda_device):
    dev, b = cuda_device, len(LENGTHS)
    dt = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}[kv]
    gen = torch.Generator(device=dev).manual_seed(11)
    shape = (L, HKV, NUM_PAGES, PAGE, D)
    if dt == torch.int8:
        pools = [torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=dt)
                 for _ in range(2)]
        pools += [torch.rand(shape[:4], generator=gen, device=dev) * 0.05 + 1e-3
                  for _ in range(2)]
        new_dt = torch.bfloat16
    else:
        pools = [torch.randn(shape, generator=gen, device=dev).to(dt) for _ in range(2)]
        pools += [None, None]
        new_dt = dt
    ref = [t.clone() if t is not None else None for t in pools]
    tables = (torch.randperm(NUM_PAGES - 1, generator=gen, device=dev)[: b * PPS] + 1)
    tables = tables.view(b, PPS).to(torch.int32)
    slots = torch.zeros(b, dtype=torch.int32, device=dev)
    for i, n in enumerate(LENGTHS):
        if n:
            slots[i] = tables[i, (n - 1) // PAGE] * PAGE + (n - 1) % PAGE
    lengths = torch.tensor(LENGTHS, dtype=torch.int32, device=dev)
    k_new, v_new = (torch.randn(b, HKV, D, generator=gen, device=dev).to(new_dt)
                    for _ in range(2))
    q = torch.randn(b, HQ, D, generator=gen, device=dev)

    before = dict(_build.LAUNCHES)
    paged_token_write(k_new, v_new, *pools, slots, 1)
    out = paged_decode_attend(q, pools[0], pools[1], lengths, tables, 1, pools[2], pools[3])
    paged_token_write_plain(k_new, v_new, *ref, slots, 1)
    want = paged_decode_attend_plain(
        q, ref[0], ref[1], lengths, tables, 1, ref[2], ref[3], D ** -0.5
    )
    torch.cuda.synchronize()
    for name in ("pfa_paged_token_write", "pfa_paged_decode_attend"):
        assert _build.LAUNCHES[name] == before.get(name, 0) + 1
    for got, exp in zip(pools, ref):
        if got is not None:
            assert torch.equal(got, exp)
    assert torch.all(out[0] == 0)  # length 0 -> zeros
    assert rel_err_norm(out, want) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_serving_engine_matches_cpu(kv, cuda_device):
    """fp32 GPT-2 with head dim 64 (K1's envelope): the engine on the GPU,
    through K1 and K3's fused decode (the token write and the attend in one
    launch), gives the CPU engine's greedy tokens."""
    cfg = GPT2Config(vocab_size=512, n_positions=128, n_embd=128, n_layer=2,
                     n_head=2, dtype=torch.float32)
    state = GPT2LMHead(cfg, generator=torch.Generator().manual_seed(0)).state_dict()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in (5, 17, 40)]
    kwargs = dict(num_pages=32, page_size=16, max_batch=4, decode_window=4,
                  kv_dtype=torch.int8 if kv == "int8" else torch.float32)
    cpu = ServingEngine(cfg, state, device="cpu", **kwargs).generate(prompts, max_new_tokens=10)
    before = dict(_build.LAUNCHES)
    gpu = ServingEngine(cfg, state, device=cuda_device, **kwargs).generate(
        prompts, max_new_tokens=10
    )
    assert gpu == cpu
    for name in ("pfa_flash_fwd", "pfa_paged_decode_fused"):
        assert _build.LAUNCHES[name] > before.get(name, 0)


# -- K3 (csrc/paged_decode_sm90.cu) at its split and page edges ----------------
#
# Pages of 16 tokens, 64 a sequence (capacity 1024): k3_plan cuts these
# calls into splits of 256 tokens (16 pages), so the lengths below sit on
# both sides of a page end and of a split end. The plain versions run on
# the same card, on the same inputs.

K3_PAGE, K3_PPS = 16, 64


def _k3_lengths(split: int):
    cap = K3_PAGE * K3_PPS
    return [0, 1, K3_PAGE - 1, K3_PAGE, K3_PAGE + 1, split - 1, split, split + 1,
            2 * split + 1, cap - 1, cap]


def _k3_problem(dev, kv: str, hq: int, hkv: int, d: int, lengths, seed: int = 0, L: int = 2,
                page: int = K3_PAGE, pps: int = K3_PPS):
    """Pools (L, Hkv, P, page, D) with scattered, distinct pages per
    sequence, q fp32, the new token's K/V (bf16) and the slot of position
    lengths[b] - 1 (trash page 0 for a length of 0)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    b = len(lengths)
    num_pages = b * pps + 4
    shape = (L, hkv, num_pages, page, d)
    if kv == "int8":
        pools = [torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)
                 for _ in range(2)]
        pools += [torch.rand(shape[:4], generator=gen, device=dev) * 0.05 + 1e-3
                  for _ in range(2)]
    else:
        dt = {"f32": torch.float32, "bf16": torch.bfloat16}[kv]
        pools = [torch.randn(shape, generator=gen, device=dev).to(dt) for _ in range(2)]
        pools += [None, None]
    tables = (torch.randperm(num_pages - 1, generator=gen, device=dev)[: b * pps] + 1)
    tables = tables.view(b, pps).to(torch.int32)
    slots = torch.zeros(b, dtype=torch.int32, device=dev)
    for i, n in enumerate(lengths):
        if n:
            slots[i] = tables[i, (n - 1) // page] * page + (n - 1) % page
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    q = torch.randn(b, hq, d, generator=gen, device=dev)
    k_new, v_new = (torch.randn(b, hkv, d, generator=gen, device=dev).to(torch.bfloat16)
                    for _ in range(2))
    return q, pools, lens, tables, slots, k_new, v_new


def _k3_split(q, pools, tables) -> tuple:
    """(tokens a split, splits a sequence) of k3_plan for this call."""
    b, hq, d = q.shape
    plan = k3_plan(b, hq, pools[0].shape[1], d, pools[0].element_size(), pools[0].shape[3],
                   tables.shape[1])
    return plan.split_pages * pools[0].shape[3], plan.n_split


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("kv", ["f32", "bf16", "int8"])
def test_k3_attend_edges_match_plain(kv, d, cuda_device):
    """The read-only attend at every split and page edge, a row of 0 and a
    full table: within 1e-4 of the plain version, zeros at length 0."""
    lengths = _k3_lengths(256)
    q, pools, lens, tables, *_ = _k3_problem(cuda_device, kv, 4, 2, d, lengths)
    assert _k3_split(q, pools, tables) == (256, 4)
    before = _build.LAUNCHES["pfa_paged_decode_attend"]
    out = paged_decode_attend(q, pools[0], pools[1], lens, tables, 1, pools[2], pools[3])
    want = paged_decode_attend_plain(q, pools[0], pools[1], lens, tables, 1, pools[2], pools[3],
                                     d ** -0.5)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["pfa_paged_decode_attend"] == before + 1
    assert torch.all(out[0] == 0) and torch.isfinite(out).all()
    assert rel_err_norm(out, want) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("slot", ["last", "elsewhere"])
@pytest.mark.parametrize("new_dtype", ["bf16", "f32"])
@pytest.mark.parametrize("kv", ["f32", "bf16", "int8"])
def test_k3_fused_matches_write_then_attend(kv, new_dtype, slot, cuda_device):
    """The fused decode (one pfa_paged_decode_fused launch) against K2's
    plain write then K3's plain attend: pools and scales bit-exact, output
    within 1e-4, zeros at length 0. "elsewhere" writes the token at an
    earlier position of its sequence, not at lengths[b] - 1: the output
    must still be the attend over the written pool."""
    lengths = _k3_lengths(256)
    q, pools, lens, tables, slots, k_new, v_new = _k3_problem(cuda_device, kv, 4, 2, 64,
                                                              lengths, seed=3)
    if slot == "elsewhere":
        for i, n in enumerate(lengths):
            if n > 1:
                p = (3 * n) // 7
                slots[i] = tables[i, p // K3_PAGE] * K3_PAGE + p % K3_PAGE
    if new_dtype == "f32":
        k_new, v_new = k_new.float() * 1.7, v_new.float() * 1.7
    ref = [t.clone() if t is not None else None for t in pools]
    before = _build.LAUNCHES["pfa_paged_decode_fused"]
    out = paged_decode_attention(q, k_new, v_new, pools[0], pools[1], lens, tables, slots, 1,
                                 pools[2], pools[3])
    paged_token_write_plain(k_new, v_new, *ref, slots, 1)
    want = paged_decode_attend_plain(q, ref[0], ref[1], lens, tables, 1, ref[2], ref[3],
                                     64 ** -0.5)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["pfa_paged_decode_fused"] == before + 1
    for got, exp in zip(pools, ref):
        if got is not None:
            assert torch.equal(got, exp)
    assert torch.all(out[0] == 0) and torch.isfinite(out).all()
    assert rel_err_norm(out, want) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["f32", "bf16", "int8"])
def test_k3_gqa_d128_matches_plain(kv, cuda_device):
    """Hq 32 over Hkv 8 at D 128 (head chunks of 2, 4 or 8 query heads a
    CTA by pool type): the attend and the fused decode within 1e-4."""
    lengths = [0, 1, 300, 513, 1000, 1024]
    q, pools, lens, tables, slots, k_new, v_new = _k3_problem(cuda_device, kv, 32, 8, 128,
                                                              lengths, seed=5)
    out = paged_decode_attend(q, pools[0], pools[1], lens, tables, 0, pools[2], pools[3])
    want = paged_decode_attend_plain(q, pools[0], pools[1], lens, tables, 0, pools[2], pools[3],
                                     128 ** -0.5)
    torch.cuda.synchronize()
    assert rel_err_norm(out, want) <= 1e-4 and torch.all(out[0] == 0)
    ref = [t.clone() if t is not None else None for t in pools]
    out = paged_decode_attention(q, k_new, v_new, pools[0], pools[1], lens, tables, slots, 0,
                                 pools[2], pools[3])
    paged_token_write_plain(k_new, v_new, *ref, slots, 0)
    want = paged_decode_attend_plain(q, ref[0], ref[1], lens, tables, 0, ref[2], ref[3],
                                     128 ** -0.5)
    torch.cuda.synchronize()
    for got, exp in zip(pools, ref):
        if got is not None:
            assert torch.equal(got, exp)
    assert rel_err_norm(out, want) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["f32", "bf16", "int8"])
def test_k3_partial_head_chunk_matches_plain(kv, cuda_device):
    """G = 3 (Hq 6 over Hkv 2): a head chunk of 2 and one of 1 (int8), or
    one chunk holding 3 of its 4 heads (bf16, fp32); attend and fused
    decode within 1e-4."""
    lengths = _k3_lengths(256)
    q, pools, lens, tables, slots, k_new, v_new = _k3_problem(cuda_device, kv, 6, 2, 64,
                                                              lengths, seed=17)
    ref = [t.clone() if t is not None else None for t in pools]
    out = paged_decode_attend(q, pools[0], pools[1], lens, tables, 1, pools[2], pools[3])
    want = paged_decode_attend_plain(q, pools[0], pools[1], lens, tables, 1, pools[2], pools[3],
                                     64 ** -0.5)
    torch.cuda.synchronize()
    assert rel_err_norm(out, want) <= 1e-4 and torch.all(out[0] == 0)
    out = paged_decode_attention(q, k_new, v_new, pools[0], pools[1], lens, tables, slots, 1,
                                 pools[2], pools[3])
    paged_token_write_plain(k_new, v_new, *ref, slots, 1)
    want = paged_decode_attend_plain(q, ref[0], ref[1], lens, tables, 1, ref[2], ref[3],
                                     64 ** -0.5)
    torch.cuda.synchronize()
    for got, exp in zip(pools, ref):
        if got is not None:
            assert torch.equal(got, exp)
    assert rel_err_norm(out, want) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_k3_token_bias_across_splits(kv, cuda_device):
    """The token-bias mode with rows across split ends, read-only and fused:
    the bias follows the token's logical position (pages scattered), within
    1e-4 of the plain version."""
    lengths = _k3_lengths(256)
    q, pools, lens, tables, slots, k_new, v_new = _k3_problem(cuda_device, kv, 4, 4, 64,
                                                              lengths, seed=7)
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    bias = torch.randn(len(lengths), 4, K3_PPS * K3_PAGE, generator=gen, device=cuda_device) * 2
    before = _build.LAUNCHES["pfa_paged_decode_attend_tbias"]
    out = paged_decode_attend(q, pools[0], pools[1], lens, tables, 1, pools[2], pools[3],
                              sm_scale=1.0, token_bias=bias)
    want = paged_decode_attend_plain(q, pools[0], pools[1], lens, tables, 1, pools[2], pools[3],
                                     1.0, bias)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["pfa_paged_decode_attend_tbias"] == before + 1
    assert rel_err_norm(out, want) <= 1e-4
    ref = [t.clone() if t is not None else None for t in pools]
    before = _build.LAUNCHES["pfa_paged_decode_fused_tbias"]
    out = paged_decode_attention(q, k_new, v_new, pools[0], pools[1], lens, tables, slots, 1,
                                 pools[2], pools[3], sm_scale=1.0, token_bias=bias)
    paged_token_write_plain(k_new, v_new, *ref, slots, 1)
    want = paged_decode_attend_plain(q, ref[0], ref[1], lens, tables, 1, ref[2], ref[3], 1.0,
                                     bias)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["pfa_paged_decode_fused_tbias"] == before + 1
    assert rel_err_norm(out, want) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("ppb", [1, 3, 5, 8])
def test_k3_int8_compute_matches_plain(ppb, cuda_device):
    """paged_attention_hf's int8 compute at requant blocks of 1, 3, 5 and 8
    pages (3 and 5 divide neither the float split nor the 64-page table):
    within 1e-3 of the plain recurrence over the same blocks."""
    lengths = _k3_lengths(256)
    q, pools, lens, tables, *_ = _k3_problem(cuda_device, "int8", 4, 2, 64, lengths, seed=9)
    before = _build.LAUNCHES["pfa_paged_hf_int8"]
    out = paged_attention_hf(q, pools[0], pools[1], lens, tables, pools[2], pools[3],
                             pages_per_block=ppb, layer=1)
    want = paged_attention_hf_plain(q, pools[0], pools[1], lens, tables, 1, pools[2], pools[3],
                                    64 ** -0.5, ppb, True)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["pfa_paged_hf_int8"] == before + 1
    assert torch.all(out[0] == 0) and torch.isfinite(out).all()
    assert rel_err_norm(out, want) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["attend", "fused", "hf_int8"])
def test_k3_repeat_launches_bit_identical(mode, cuda_device):
    """Two launches on the same inputs give the same bits: the splits merge
    in split order, whichever arrives last."""
    lengths = _k3_lengths(256)
    q, pools, lens, tables, slots, k_new, v_new = _k3_problem(cuda_device, "int8", 4, 2, 64,
                                                              lengths, seed=11)

    def call():
        if mode == "attend":
            return paged_decode_attend(q, pools[0], pools[1], lens, tables, 1, pools[2], pools[3])
        if mode == "fused":
            return paged_decode_attention(q, k_new, v_new, pools[0], pools[1], lens, tables,
                                          slots, 1, pools[2], pools[3])
        return paged_attention_hf(q, pools[0], pools[1], lens, tables, pools[2], pools[3],
                                  pages_per_block=3, layer=1)

    first, second = call(), call()
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_k3_long_row_matches_plain(cuda_device):
    """B1 H32 D128 bf16, one row of 32768 tokens (256 pages of 128): the
    read-only attend and the fused decode within 1e-4."""
    q, pools, lens, tables, slots, k_new, v_new = _k3_problem(
        cuda_device, "bf16", 32, 32, 128, [32768], seed=13, L=1, page=128, pps=256)
    assert _k3_split(q, pools, tables)[1] > 1
    out = paged_decode_attend(q, pools[0], pools[1], lens, tables, 0)
    want = paged_decode_attend_plain(q, pools[0], pools[1], lens, tables, 0, None, None,
                                     128 ** -0.5)
    torch.cuda.synchronize()
    assert rel_err_norm(out, want) <= 1e-4
    ref = [pools[0].clone(), pools[1].clone(), None, None]
    out = paged_decode_attention(q, k_new, v_new, pools[0], pools[1], lens, tables, slots, 0)
    paged_token_write_plain(k_new, v_new, *ref, slots, 0)
    want = paged_decode_attend_plain(q, ref[0], ref[1], lens, tables, 0, None, None, 128 ** -0.5)
    torch.cuda.synchronize()
    assert torch.equal(pools[0], ref[0]) and torch.equal(pools[1], ref[1])
    assert rel_err_norm(out, want) <= 1e-4


@pytest.mark.cuda
def test_k3_plan_smem_matches_kernel(cuda_device):
    """k3_plan's shared-memory count equals the kernel's own layout."""
    lib = _build.lib()
    for b, hq, hkv, d, elt, page, pps, ppb in [(8, 16, 16, 64, 1, 128, 64, None),
                                               (8, 32, 32, 128, 2, 128, 32, None),
                                               (4, 32, 8, 128, 4, 16, 64, None),
                                               (5, 8, 2, 64, 1, 16, 64, 3),
                                               (8, 16, 16, 64, 1, 128, 16, 8)]:
        plan = k3_plan(b, hq, hkv, d, elt, page, pps, ppb)
        assert plan.smem == lib.pfa_paged_k3_smem(b, d, elt, plan.gcmax, int(ppb is not None),
                                                  plan.tile, plan.split_pages, plan.block)


# (B, Sq, Skv, Hq, Hkv, D, causal): unaligned non-causal cross, square
# causal, GQA D 128 with Sq < Skv, a long causal run.
QUANT_CASES = [
    (1, 200, 333, 4, 2, 64, False),
    (2, 256, 256, 4, 4, 64, True),
    (1, 100, 300, 4, 1, 128, True),
    (1, 1000, 1000, 2, 2, 64, True),
]
QUANT_BOUND = {"f32": 2e-3, "bf16": 1e-2}


def _quant_qkv(case, dev, seed=0):
    b, sq, skv, hq, hkv, d, _ = case
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev)
            for s in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d))]


def _quant_calls(mode, q, k, v, causal, out_dtype):
    """(kernel call, plain call, launch counter) of one quantized mode on
    payloads made from fp32 q, k, v by the public functions' own passes."""
    d = q.shape[-1]
    if mode in ("int8qk", "fp8qk", "int8full"):
        qdt, qmax = (torch.float8_e4m3fn, 448.0) if mode == "fp8qk" else (torch.int8, 127.0)
        q8, k8, sc = flash_fp8._qk_per_tensor(q, k, qdt, qmax, d ** -0.5)
        if mode == "int8full":
            vin, vs = flash_fp8._col_quantize(v, torch.int8, 127.0)
        else:
            vin, vs = v.to(torch.bfloat16), None
        kw = dict(causal=causal, v_scales=vs, out_dtype=out_dtype)
        return (lambda: flash_attention_qk_quant(q8, k8, vin, sc, **kw),
                lambda: flash_attention_qk_quant_plain(q8, k8, vin, sc, **kw),
                f"pfa_flash_fwd_{mode}")
    qdt, qmax = flash_fp8._QPARAMS[mode]
    q8, qs = flash_fp8._row_block_quantize(q, qdt, qmax)
    k8, ks = flash_fp8._row_block_quantize(k, qdt, qmax)
    v8, vs = flash_fp8._col_quantize(v, qdt, qmax)
    kw = dict(qdtype=mode, causal=causal, sm_scale=d ** -0.5, out_dtype=out_dtype)
    return (lambda: flash_fp8.flash_attention_block_quant(q8, k8, v8, qs, ks, vs, **kw),
            lambda: flash_fp8.flash_attention_block_quant_plain(q8, k8, v8, qs, ks, vs, **kw),
            f"pfa_flash_quant_{mode}")


def _check_quant(case, mode, out, dev, seed, bound):
    """One quantized mode on the payloads of seed ``seed``: launched once,
    finite, within ``bound`` (rel_err_norm) of its plain version."""
    q, k, v = _quant_qkv(case, dev, seed=seed)
    kernel, plain, counter = _quant_calls(mode, q, k, v, case[-1], DTYPES[out])
    before = _build.LAUNCHES[counter]
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    assert _build.LAUNCHES[counter] == before + 1
    assert got.dtype == DTYPES[out] and torch.isfinite(got).all()
    assert rel_err_norm(got, want) <= bound


@pytest.mark.cuda
@pytest.mark.parametrize("out", list(QUANT_BOUND))
@pytest.mark.parametrize("mode", ["int8qk", "fp8qk", "int8full"])
@pytest.mark.parametrize("case", QUANT_CASES)
def test_flash_quant_modes_match_plain(case, mode, out, cuda_device):
    """K1's quantized modes against their plain version on the same payloads."""
    _check_quant(case, mode, out, cuda_device, 0, QUANT_BOUND[out])


@pytest.mark.cuda
@pytest.mark.parametrize("out", list(QUANT_BOUND))
@pytest.mark.parametrize("qdtype", ["fp8", "int8"])
@pytest.mark.parametrize("case", QUANT_CASES)
def test_flash_block_quant_matches_plain(case, qdtype, out, cuda_device):
    """K6 against its plain version on the same block-quantized payloads."""
    _check_quant(case, qdtype, out, cuda_device, 1, QUANT_BOUND[out])


# The quantized body's edges (csrc/flash_quant_sm90.cu): every pair Sq !=
# Skv of EDGE_LENGTHS at D 64 and 128, causal (end-aligned) and not where
# Sq < Skv; ragged last 128-key blocks, query blocks of 1 to 128 rows, and
# causal rows that see no key of their last block (every key of that block
# masked: a row always sees key 0, since causal Sq > Skv is refused); GQA
# 12/4 and 32/8.
QUANT_EDGE_CASES = [(1, sq, skv, 4, 2, d, causal)
                    for sq in EDGE_LENGTHS for skv in EDGE_LENGTHS if sq != skv
                    for d in (64, 128) for causal in ((False, True) if sq < skv else (False,))]
QUANT_EDGE_CASES += [(2, 300, 300, 12, 4, 64, True), (1, 513, 513, 32, 8, 128, True)]
#: Kernel against plain version on the same payloads, bf16 and fp32 output.
QUANT_PLAIN_BOUND = 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("out", list(DTYPES))
@pytest.mark.parametrize("mode", ["int8qk", "fp8qk", "int8full", "fp8", "int8"])
@pytest.mark.parametrize("case", QUANT_EDGE_CASES)
def test_quant_body_edges_match_plain(case, mode, out, cuda_device):
    """Every quantized mode of the Hopper body at its edges against its
    plain version on the same payloads."""
    _check_quant(case, mode, out, cuda_device, 3, QUANT_PLAIN_BOUND)


@pytest.mark.cuda
def test_quant_body_refuses_unaligned(cuda_device):
    """The quantized body reads by TMA: a base that is not 16-byte aligned
    raises on the card and names the limit (no fallback)."""
    q, k, v = _quant_qkv((1, 64, 64, 2, 2, 64, False), cuda_device)
    q8, k8, sc = flash_fp8._qk_per_tensor(q, k, torch.int8, 127.0, 0.125)
    shifted = torch.empty(q8.numel() + 1, dtype=torch.int8, device=cuda_device)[1:].view(q8.shape)
    shifted.copy_(q8)
    with pytest.raises(ValueError, match="16-byte-aligned"):
        flash_attention_qk_quant(shifted, k8, v.to(torch.bfloat16), sc)


QUANT_ENTRIES = {  # name: (function, launch counter, gate against the fp32 oracle)
    "int8qk": (flash_fp8.flash_attention_int8qk, "pfa_flash_fwd_int8qk", 0.05),
    "fp8qk": (flash_fp8.flash_attention_fp8qk, "pfa_flash_fwd_fp8qk", 0.05),
    "int8full": (flash_fp8.flash_attention_int8full, "pfa_flash_fwd_int8full", 0.03),
    "fp8": (flash_fp8.flash_attention_fp8, "pfa_flash_quant_fp8", 0.06),
    "int8": (flash_fp8.flash_attention_int8, "pfa_flash_quant_int8", 0.03),
    "unrolled_int8qk": (lambda q, k, v, **kw: flash_attention_unrolled(q, k, v, int8_qk=True, **kw),
                        "pfa_flash_fwd_int8qk", 0.05),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(QUANT_ENTRIES))
def test_quant_entry_points_on_the_card(name, cuda_device):
    """The public quantized functions on bf16 inputs (B2 S256 H4 D64 causal,
    the JAX tests' shape): under the JAX gate against the fp32 oracle, and
    within 1e-2 of the same call on the CPU (the plain versions)."""
    fn, counter, gate = QUANT_ENTRIES[name]
    q, k, v = (t.to(torch.bfloat16) for t in _quant_qkv((2, 256, 256, 4, 4, 64, True), cuda_device, 2))
    before = _build.LAUNCHES[counter]
    with torch.no_grad():
        got = fn(q, k, v, causal=True)
        cpu = fn(q.cpu(), k.cpu(), v.cpu(), causal=True)
    oracle = attention_reference(q.float(), k.float(), v.float(), causal=True)[0]
    torch.cuda.synchronize()
    assert _build.LAUNCHES[counter] == before + 1
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    assert rel_err_norm(got, oracle) < gate
    assert rel_err_norm(got.cpu(), cpu) <= 1e-2
