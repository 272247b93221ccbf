"""The slice-3 kernel modes and the attention engine, on the GPU.

Every test here carries the ``cuda`` marker and skips without a GPU. The
file imports no JAX, so it also runs on a machine that has none:

    python -m pytest tests/test_torch_cuda_engine.py -m cuda --noconftest -q

K1 with the key-padding streams against its plain version (``rel_err_norm``
1e-2 bf16, 1e-4 fp32, lse 1e-4, zero rows for length 0); K3's
``paged_attention_hf`` against its plain version (float compute 1e-4, int8
compute 1e-3); the engine's kinds on the card against the fp32 fused
oracle (bf16 1e-2), each launching its kernel; chunked prefill on the card
against the CPU engine's tokens.
"""

import numpy as np
import pytest
import torch

from photonic_flash_attention_tpu_torch.config import get_config, reset_config
from photonic_flash_attention_tpu_torch.core.engine import AttentionEngine
from photonic_flash_attention_tpu_torch.core.router import AdaptiveRouter
from photonic_flash_attention_tpu_torch.core.serving import ServingEngine
from photonic_flash_attention_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from photonic_flash_attention_tpu_torch.ops import _build
from photonic_flash_attention_tpu_torch.ops.flash import (
    flash_attention_with_lse,
    flash_attention_with_lse_plain,
)
from photonic_flash_attention_tpu_torch.ops.fused import fused_attention
from photonic_flash_attention_tpu_torch.ops.paged import (
    paged_attention_hf,
    paged_attention_hf_plain,
)
from photonic_flash_attention_tpu_torch.ops.reference import DEFAULT_MASK_VALUE


def rel_err_norm(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float(torch.linalg.norm(a - b) / max(float(torch.linalg.norm(b)), 1e-9))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("causal", [False, True])
def test_k1_streams_match_plain(cuda_device, dtype, causal):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    b, sq, skv, hq, hkv, d = 3, 96, 200, 4, 2, 64
    q, k, v = (torch.randn(b, s, h, d, device=cuda_device, generator=gen).to(dtype)
               for s, h in ((sq, hq), (skv, hkv), (skv, hkv)))
    lens = torch.tensor([200, 0, 77], dtype=torch.int32, device=cuda_device)
    bias = torch.randn(b, skv, device=cuda_device, generator=gen)
    bias[:, 1::7] = DEFAULT_MASK_VALUE
    bias[:, 0] = 0.0
    before = _build.LAUNCHES["pfa_flash_fwd_streams"]
    o, lse = flash_attention_with_lse(q, k, v, causal=causal, kv_lens=lens, k_bias=bias)
    ro, rlse = flash_attention_with_lse_plain(q, k, v, causal=causal, kv_lens=lens, k_bias=bias)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["pfa_flash_fwd_streams"] == before + 1
    assert rel_err_norm(o, ro) <= (1e-2 if dtype == torch.bfloat16 else 1e-4)
    assert torch.all(o[1] == 0) and torch.all(torch.isneginf(lse[1]))
    live = torch.isfinite(rlse)
    assert rel_err_norm(lse[live], rlse[live]) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8_compute"])
def test_k3_paged_hf_matches_plain(cuda_device, int8):
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    L, hkv, pages, page, d, hq = 2, 2, 60, 16, 64, 8
    shape = (L, hkv, pages, page, d)
    if int8:
        k, v = (torch.randint(-127, 128, shape, device=cuda_device, generator=gen,
                              dtype=torch.int8) for _ in range(2))
        ks, vs = (torch.rand(shape[:4], device=cuda_device, generator=gen) * 0.05 + 1e-3
                  for _ in range(2))
    else:
        k, v = (torch.randn(shape, device=cuda_device, generator=gen).to(torch.bfloat16)
                for _ in range(2))
        ks = vs = None
    lengths = torch.tensor([40, 17, 128, 0, 33], dtype=torch.int32, device=cuda_device)
    tables = (torch.randperm(pages - 1, device=cuda_device, generator=gen)[:5 * 8] + 1)
    tables = tables.view(5, 8).to(torch.int32)
    q = torch.randn(5, hq, d, device=cuda_device, generator=gen)
    name = "pfa_paged_hf_int8" if int8 else "pfa_paged_hf"
    before = _build.LAUNCHES[name]
    out = paged_attention_hf(q, k, v, lengths, tables, ks, vs, pages_per_block=2, layer=1)
    ref = paged_attention_hf_plain(q, k, v, lengths, tables, 1, ks, vs, d ** -0.5, 2, int8)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[name] == before + 1
    assert rel_err_norm(out, ref) <= (1e-3 if int8 else 1e-4)
    assert torch.all(out[3] == 0)


@pytest.mark.cuda
def test_engine_kinds_on_the_card(cuda_device):
    """Each kind the heuristic picks runs on the card through its kernel and
    agrees with the fp32 fused oracle."""
    reset_config()
    get_config().update(auto_kernel_selection=False)
    eng = AttentionEngine(router=AdaptiveRouter(exploration_rate=0.0, seed=0))
    gen = torch.Generator(device=cuda_device).manual_seed(2)

    def qkv(b, sq, skv):
        return [torch.randn(b, s, 8, 64, device=cuda_device, generator=gen).to(torch.bfloat16)
                for s in (sq, skv, skv)]

    keep = torch.arange(1024, device=cuda_device)[None] < torch.tensor(
        [[1024], [600]], device=cuda_device)
    cases = [  # (inputs, mask, kv_lens, kind, kernel counter)
        (qkv(2, 1024, 1024), None, None, "flash_unrolled", "pfa_flash_fwd"),
        (qkv(2, 1024, 1024), keep[:, None, None, :], None, "flash_unrolled", "pfa_flash_fwd_streams"),
        (qkv(2, 1, 1024), None, torch.tensor([1024, 300], dtype=torch.int32, device=cuda_device),
         "paged_decode", "pfa_paged_hf"),
        (qkv(2, 128, 128), None, None, "fused", None),
    ]
    try:
        for (q, k, v), mask, lens, kind, counter in cases:
            before = dict(_build.LAUNCHES)
            out, _ = eng(q, k, v, mask, causal=kind != "paged_decode", kv_lens=lens)
            assert eng.last_kernel_used == kind
            if counter:
                assert _build.LAUNCHES[counter] == before.get(counter, 0) + 1
            dense = mask
            if lens is not None:
                dense = (torch.arange(k.shape[1], device=cuda_device)[None] < lens[:, None])[:, None, None, :]
            ref, _ = fused_attention(q.float(), k.float(), v.float(), dense,
                                     causal=kind != "paged_decode")
            assert rel_err_norm(out, ref) <= 1e-2
        assert eng.get_performance_stats()["failures"] == {}
        assert eng.board_power_w and eng.last_energy_mj > 0
    finally:
        reset_config()


@pytest.mark.cuda
def test_chunked_prefill_on_the_card_matches_cpu(cuda_device):
    cfg = GPT2Config(vocab_size=512, n_positions=256, n_embd=128, n_layer=2, n_head=2,
                     dtype=torch.float32)
    state = GPT2LMHead(cfg, generator=torch.Generator().manual_seed(0)).state_dict()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in (70, 9, 33)]
    kwargs = dict(num_pages=40, page_size=16, max_batch=3, decode_window=4,
                  kv_dtype=torch.float32, prefill_chunk=32)
    cpu = ServingEngine(cfg, state, device="cpu", **kwargs).generate(prompts, max_new_tokens=8)
    before = _build.LAUNCHES["pfa_flash_fwd_streams"]
    gpu = ServingEngine(cfg, state, device=cuda_device, **kwargs).generate(prompts, max_new_tokens=8)
    assert gpu == cpu
    # 3 + 2 chunks of 32 over 2 layers.
    assert _build.LAUNCHES["pfa_flash_fwd_streams"] - before == 2 * 5
