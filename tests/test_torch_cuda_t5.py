"""K1's structured-bias modes, K3's token-bias mode and T5 serving, on the GPU.

Every test here carries the ``cuda`` marker and skips without a GPU. The
file imports no JAX, so it also runs on a machine that has none:

    python -m pytest tests/test_torch_cuda_t5.py -m cuda --noconftest -q

Each kernel mode is held against its plain version on the same inputs, and
its wrapper must launch it exactly once: K1's relative-bias (T5 buckets,
ALiBi) and dense-bias modes within ``rel_err_norm`` 1e-2 for bf16 and 1e-4
for fp32, K3's token-bias mode within 1e-4 (fp32 scores over bf16, int8 and
fp32 pools). A narrow T5 (d_kv 64, 2+2 layers, fp32) served on the GPU
through K1, K2 and K3 must pick the CPU engine's greedy tokens.
"""

import dataclasses

import numpy as np
import pytest
import torch

from photonic_flash_attention_tpu_torch.core.serving import ServingEngine
from photonic_flash_attention_tpu_torch.models.t5 import T5Config, T5ForConditionalGeneration
from photonic_flash_attention_tpu_torch.ops import _build
from photonic_flash_attention_tpu_torch.ops.flash import flash_attention, flash_attention_plain
from photonic_flash_attention_tpu_torch.ops.paged import (
    paged_decode_attend,
    paged_decode_attend_plain,
    fit_token_bias,
)
from photonic_flash_attention_tpu_torch.ops.reference import DEFAULT_MASK_VALUE
from photonic_flash_attention_tpu_torch.ops.rel_bias import ALiBi, T5RelBias, alibi_slopes

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
BOUND = {"f32": 1e-4, "bf16": 1e-2}


def rel_err_norm(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float(torch.linalg.norm(a - b) / max(float(torch.linalg.norm(b)), 1e-9))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _qkv(b, sq, skv, hq, hkv, d, dtype, dev, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(s, generator=gen, device=dev).to(dtype)
            for s in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d))]


# (B, Sq, Skv, Hq, Hkv, D, causal, kind): T5 both directions, Sq < Skv
# (sequence-end alignment), ragged lengths, GQA, D 128, ALiBi.
REL_CASES = [
    (2, 200, 200, 4, 4, 64, False, "t5"),
    (2, 200, 200, 4, 4, 64, True, "t5"),
    (1, 100, 333, 4, 2, 128, True, "t5"),
    (1, 70, 300, 2, 2, 64, False, "t5"),
    (2, 256, 256, 8, 8, 64, True, "alibi"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("case", REL_CASES)
def test_flash_rel_bias_mode_matches_plain(case, dtype_name, cuda_device):
    b, sq, skv, hq, hkv, d, causal, kind = case
    q, k, v = _qkv(b, sq, skv, hq, hkv, d, DTYPES[dtype_name], cuda_device)
    if kind == "t5":
        gen = torch.Generator(device=cuda_device).manual_seed(1)
        table = torch.randn(32, hq, generator=gen, device=cuda_device) * 0.5
        spec, counter, scale = T5RelBias(table, bidirectional=not causal), "pfa_flash_fwd_relbias", 1.0
    else:
        spec, counter, scale = ALiBi(alibi_slopes(hq).to(cuda_device)), "pfa_flash_fwd_alibi", None
    before = _build.LAUNCHES[counter]
    out = flash_attention(q, k, v, causal=causal, sm_scale=scale, rel_bias=spec)
    ref = flash_attention_plain(q, k, v, causal=causal, sm_scale=scale, rel_bias=spec)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[counter] == before + 1
    assert out.dtype == q.dtype and torch.isfinite(out).all()
    assert rel_err_norm(out, ref) <= BOUND[dtype_name]


# (B, Sq, Skv, Hq, Hkv, D, causal, Hb, real-valued?)
DENSE_CASES = [
    (2, 200, 200, 4, 4, 64, False, 1, False),
    (2, 200, 200, 4, 2, 64, True, 4, True),
    (1, 100, 300, 4, 4, 128, True, 1, False),
    (2, 64, 129, 2, 2, 128, False, 2, True),
    # The bf16 kernel's edges: Skv 301 stages the bias by cp.async, Skv 300
    # by TMA (its row pitch a multiple of 16 bytes); Hb 1 and Hq.
    (2, 129, 301, 4, 2, 64, True, 1, True),
    (2, 129, 301, 4, 2, 128, False, 4, True),
    (2, 129, 300, 4, 2, 64, False, 4, True),
    (2, 129, 300, 4, 2, 128, True, 1, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("case", DENSE_CASES)
def test_flash_dense_bias_mode_matches_plain(case, dtype_name, cuda_device):
    b, sq, skv, hq, hkv, d, causal, hb, real = case
    q, k, v = _qkv(b, sq, skv, hq, hkv, d, DTYPES[dtype_name], cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    bias = torch.randn(b, hb, sq, skv, generator=gen, device=cuda_device) if real else \
        torch.zeros(b, hb, sq, skv, device=cuda_device)
    holes = torch.rand(b, hb, sq, skv, generator=gen, device=cuda_device) < 0.2
    bias = torch.where(holes, torch.full_like(bias, DEFAULT_MASK_VALUE), bias)
    bias[..., 0] = 0.0
    if not causal:
        bias[0, :, 3] = DEFAULT_MASK_VALUE  # a row masked by the bias alone averages
    before = _build.LAUNCHES["pfa_flash_fwd_densebias"]
    out = flash_attention(q, k, v, causal=causal, attn_bias=bias)
    ref = flash_attention_plain(q, k, v, causal=causal, attn_bias=bias)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["pfa_flash_fwd_densebias"] == before + 1
    assert torch.isfinite(out).all()
    assert rel_err_norm(out, ref) <= BOUND[dtype_name]


L, H, D, PAGE, NUM_PAGES, PPS = 2, 4, 64, 16, 24, 4
LENGTHS = [0, 1, 23, 33, 64]


@pytest.mark.cuda
@pytest.mark.parametrize("bias_len", [PPS * PAGE, 40, 100])
@pytest.mark.parametrize("kv", ["f32", "bf16", "int8"])
def test_paged_token_bias_mode_matches_plain(kv, bias_len, cuda_device):
    """K3's token-bias mode over a pool whose pages are not in logical
    order: the bias follows the token's position, not its slot."""
    dev, b = cuda_device, len(LENGTHS)
    dt = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}[kv]
    gen = torch.Generator(device=dev).manual_seed(5)
    shape = (L, H, NUM_PAGES, PAGE, D)
    if dt == torch.int8:
        k = torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=dt)
        v = torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=dt)
        ks, vs = (torch.rand(shape[:4], generator=gen, device=dev) * 0.05 + 1e-3 for _ in range(2))
    else:
        k, v = (torch.randn(shape, generator=gen, device=dev).to(dt) for _ in range(2))
        ks = vs = None
    tables = (torch.randperm(NUM_PAGES - 1, generator=gen, device=dev)[: b * PPS] + 1)
    tables = tables.view(b, PPS).to(torch.int32)
    lengths = torch.tensor(LENGTHS, dtype=torch.int32, device=dev)
    q = torch.randn(b, H, D, generator=gen, device=dev)
    bias = torch.randn(b, H, bias_len, generator=gen, device=dev) * 2.0
    before = _build.LAUNCHES["pfa_paged_decode_attend_tbias"]
    out = paged_decode_attend(q, k, v, lengths, tables, 1, ks, vs, sm_scale=1.0, token_bias=bias)
    want = paged_decode_attend_plain(q, k, v, lengths, tables, 1, ks, vs, 1.0,
                                     fit_token_bias(bias, b, H, PPS * PAGE))
    torch.cuda.synchronize()
    assert _build.LAUNCHES["pfa_paged_decode_attend_tbias"] == before + 1
    assert torch.all(out[0] == 0)  # length 0 -> zeros
    assert rel_err_norm(out, want) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_t5_serving_engine_matches_cpu(kv, cuda_device):
    """fp32 T5 with d_kv 64 (K1's envelope), 2+2 layers: the engine on the
    GPU (K1's relative-bias mode in no path here: the serving encoder is
    plain; K3's fused decode with the token bias every decode step) gives the CPU
    engine's greedy tokens; the dense model on the GPU (encoder at 512
    tokens, K1's relative-bias mode) gives the CPU model's logits."""
    cfg = dataclasses.replace(T5Config.tiny(), d_model=128, d_kv=64, num_heads=2,
                              dtype=torch.float32)
    model = T5ForConditionalGeneration(cfg, generator=torch.Generator().manual_seed(0))
    state = model.state_dict()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, cfg.vocab_size, n).tolist() for n in (5, 17, 40)]
    kwargs = dict(num_pages=32, page_size=16, max_batch=4, decode_window=4, enc_max_len=64,
                  kv_dtype=torch.int8 if kv == "int8" else torch.float32)
    cpu = ServingEngine(cfg, state, device="cpu", **kwargs).generate(prompts, max_new_tokens=10)
    before = dict(_build.LAUNCHES)
    gpu = ServingEngine(cfg, state, device=cuda_device, **kwargs).generate(
        prompts, max_new_tokens=10)
    assert gpu == cpu
    assert _build.LAUNCHES["pfa_paged_decode_fused_tbias"] > before.get(
        "pfa_paged_decode_fused_tbias", 0)

    ids = torch.from_numpy(rng.integers(2, cfg.vocab_size, (1, 512)))
    dec = torch.from_numpy(rng.integers(2, cfg.vocab_size, (1, 24)))
    with torch.no_grad():
        want = model(ids, dec)
        before = _build.LAUNCHES["pfa_flash_fwd_relbias"]
        got = model.to(cuda_device)(ids.to(cuda_device), dec.to(cuda_device))
    assert _build.LAUNCHES["pfa_flash_fwd_relbias"] == before + cfg.num_layers
    assert rel_err_norm(got.cpu(), want) <= 1e-4
