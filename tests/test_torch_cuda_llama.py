"""Llama serving and the BERT encoder on the GPU, against the CPU.

Every test here carries the ``cuda`` marker and skips without a GPU. The
file imports no JAX, so it also runs on a machine that has none:

    python -m pytest tests/test_torch_cuda_llama.py -m cuda --noconftest -q

A narrow fp32 Llama (head_dim 64, 4 query heads over 2 KV heads) served
on the GPU through K1 (prefill, and its key-bias stream for chunks) and
K3's fused decode must pick the CPU engine's greedy tokens, whole and
chunked, over fp32 and int8 pools; a narrow fp32 BERT at S 512 with a
padded batch runs K1's key streams once a layer and matches the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

from photonic_flash_attention_tpu_torch.core.serving import ServingEngine
from photonic_flash_attention_tpu_torch.models.bert import BertConfig, BertModel
from photonic_flash_attention_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from photonic_flash_attention_tpu_torch.ops import _build


def rel_err_norm(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float(torch.linalg.norm(a - b) / max(float(torch.linalg.norm(b)), 1e-9))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["f32", "int8"])
@pytest.mark.parametrize("chunk", [None, 32], ids=["whole", "chunked"])
def test_llama_serving_engine_matches_cpu(kv, chunk, cuda_device):
    cfg = dataclasses.replace(LlamaConfig.tiny(), hidden_size=256, num_attention_heads=4,
                              num_key_value_heads=2, dtype=torch.float32)
    assert cfg.head_dim == 64
    state = LlamaForCausalLM(cfg, generator=torch.Generator().manual_seed(0),
                             device="cpu").state_dict()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in (5, 40, 100)]
    kwargs = dict(num_pages=64, page_size=16, max_batch=4, decode_window=4, prefill_chunk=chunk,
                  kv_dtype=torch.int8 if kv == "int8" else torch.float32)
    cpu = ServingEngine(cfg, state, device="cpu", **kwargs).generate(prompts, max_new_tokens=10)
    before = dict(_build.LAUNCHES)
    gpu = ServingEngine(cfg, state, device=cuda_device, **kwargs).generate(
        prompts, max_new_tokens=10)
    assert gpu == cpu
    launched = {k: n - before.get(k, 0) for k, n in _build.LAUNCHES.items()}
    assert launched.get("pfa_paged_decode_fused", 0) >= cfg.num_hidden_layers * 9
    if chunk:
        assert launched.get("pfa_flash_fwd_streams", 0) == cfg.num_hidden_layers * (2 + 4)
    else:
        assert launched.get("pfa_flash_fwd", 0) == cfg.num_hidden_layers * len(prompts)


@pytest.mark.cuda
def test_bert_padded_batch_matches_cpu(cuda_device):
    cfg = dataclasses.replace(BertConfig.tiny(), hidden_size=256, num_attention_heads=4,
                              max_position_embeddings=512, dtype=torch.float32)
    model = BertModel(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(1)
    lengths = np.array([512, 300, 17, 128])
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 512)))
    mask = torch.from_numpy((np.arange(512)[None] < lengths[:, None]).astype(np.int64))
    types = torch.zeros_like(ids)
    types[:, 256:] = 1
    with torch.no_grad():
        want, want_pool = model(ids, mask, types)
        before = _build.LAUNCHES["pfa_flash_fwd_streams"]
        got, got_pool = model.to(cuda_device)(*(t.to(cuda_device) for t in (ids, mask, types)))
    assert _build.LAUNCHES["pfa_flash_fwd_streams"] == before + cfg.num_hidden_layers
    keep = mask.bool()
    assert rel_err_norm(got.cpu()[keep], want[keep]) <= 1e-4
    assert rel_err_norm(got_pool.cpu(), want_pool) <= 1e-4
