"""Durable serving on the GPU: the paged KV cache through K3, and serving
checkpoints, against the CPU.

Every test here carries the ``cuda`` marker and skips without a GPU. The
file imports no JAX, so it also runs on a machine that has none:

    python -m pytest tests/test_torch_cuda_durable.py -m cuda --noconftest -q

A ``PagedKVCache`` on the card holds the CPU cache's pools bit for bit
after the same appends, K3 (``paged_attention``) reads its tensors within
1e-3 of the plain version (the bound ``chip_smoke.py`` holds K3 to), and
``save_kv_cache``/``restore_kv_cache`` are bit-exact on the card; a GPT-2
served on the card, saved mid-generation and restored (on the card, and
on the CPU) gives the CPU engine's greedy tokens.
"""

import numpy as np
import pytest
import torch

from photonic_flash_attention_tpu_torch.core.checkpoint import restore_kv_cache, save_kv_cache
from photonic_flash_attention_tpu_torch.core.kv_cache import PagedKVCache
from photonic_flash_attention_tpu_torch.core.serving import ServingEngine
from photonic_flash_attention_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from photonic_flash_attention_tpu_torch.ops import _build
from photonic_flash_attention_tpu_torch.ops import paged as paged_ops

K3_BOUND = 1e-3


def rel_err_norm(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float(torch.linalg.norm(a - b) / max(float(torch.linalg.norm(b)), 1e-9))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _filled_caches(dtype, d, lengths, device, seed=0):
    """The same appends (a prompt run, then four single tokens a sequence)
    into a cache on ``device`` and one on the CPU."""
    rng = np.random.default_rng(seed)
    hkv, page = 4, 16
    num_pages = sum(-(-(n + 4) // page) for n in lengths) + 4
    caches = [PagedKVCache(num_pages, page, hkv, d, dtype=dtype, max_pages_per_seq=64,
                           device=dev) for dev in (device, "cpu")]
    sids = [[c.allocate_sequence() for _ in lengths] for c in caches]
    for i, n in enumerate(lengths):
        for run in (n, 1, 1, 1, 1):
            k = torch.from_numpy(rng.standard_normal((run, hkv, d)).astype(np.float32))
            v = torch.from_numpy(rng.standard_normal((run, hkv, d)).astype(np.float32))
            for c, s in zip(caches, sids):
                c.append(s[i], k, v)
    return caches, sids[0]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16], ids=["int8", "bf16"])
@pytest.mark.parametrize("d", [64, 128])
def test_kv_cache_through_k3(dtype, d, cuda_device, tmp_path):
    lengths = (17, 1, 100, 300)
    (gpu, cpu), sids = _filled_caches(dtype, d, lengths, cuda_device)
    for name in ("k_pages", "v_pages", "k_scales", "v_scales"):
        a, b = getattr(gpu, name), getattr(cpu, name)
        assert (a is None and b is None) or torch.equal(a.cpu(), b), name
    lengths_t, tables = gpu.page_table(sids)
    q = torch.randn(len(sids), 8, d, device=cuda_device,
                    generator=torch.Generator(device=cuda_device).manual_seed(1))
    before = _build.LAUNCHES["pfa_paged_attention"]
    out = paged_ops.paged_attention(q, gpu.k_pages, gpu.v_pages, lengths_t, tables,
                                    gpu.k_scales, gpu.v_scales)
    assert _build.LAUNCHES["pfa_paged_attention"] == before + 1
    k5, v5, ks5, vs5, lyr = paged_ops._hf_layout(gpu.k_pages, gpu.v_pages, gpu.k_scales,
                                                 gpu.v_scales, None)
    plain = paged_ops.paged_decode_attend_plain(q, k5, v5, lengths_t, tables, lyr, ks5, vs5,
                                                d ** -0.5)
    assert rel_err_norm(out, plain) <= K3_BOUND

    path = str(tmp_path / "kv")
    save_kv_cache(gpu, path)
    back = restore_kv_cache(path, device=cuda_device)
    assert back.k_pages.device.type == "cuda"
    for name in ("k_pages", "v_pages", "k_scales", "v_scales"):
        a, b = getattr(gpu, name), getattr(back, name)
        assert (a is None and b is None) or torch.equal(a, b), name
    for sid in sids:
        for got, want in zip(back.gather_kv(sid), cpu.gather_kv(sid)):
            assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_gpt2_save_restore_on_the_card_matches_cpu(cuda_device, tmp_path):
    cfg = GPT2Config(vocab_size=512, n_positions=128, n_embd=128, n_layer=2, n_head=2,
                     dtype=torch.float32)
    state = GPT2LMHead(cfg, generator=torch.Generator().manual_seed(0)).state_dict()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in (5, 17, 40)]
    kwargs = dict(num_pages=32, page_size=16, max_batch=2, decode_window=4, kv_dtype=torch.int8)
    want = ServingEngine(cfg, state, device="cpu", **kwargs).generate(prompts, max_new_tokens=10)

    eng = ServingEngine(cfg, state, device=cuda_device, **kwargs)
    assert eng.status()["allocator"] == "NativePageAllocator"
    assert eng.status()["scheduler"] == "NativeRequestScheduler"
    sids = [eng.submit(p, 10) for p in prompts]
    eng.step()
    eng.step()
    path = str(tmp_path / "ckpt")
    eng.save(path)
    for device in (cuda_device, torch.device("cpu")):
        eng2 = ServingEngine.restore(path, cfg, state, device=device)
        while not all(eng2._sequences[s].done for s in sids):
            assert eng2.step() > 0
        assert [eng2._sequences[s].tokens[len(p):] for s, p in zip(sids, prompts)] == want
