"""K1's window and dropout streams, its relative-bias lse, K4/K5's window and
dropout streams, and training with dropout and T5 gradients, on the GPU.

Every test here carries the ``cuda`` marker and skips without a GPU. The
file imports no JAX, so it also runs on a machine that has none:

    python -m pytest tests/test_torch_cuda_streams.py -m cuda --noconftest -q

Each kernel mode is held against its plain version on the same inputs
(the dropout masks are exact, so only the kernels' own rounding differs)
and its wrapper must launch it under the mode's counter: ``rel_err_norm``
1e-2 for bf16 and 1e-4 for fp32, lse 1e-4. GPT-2 with ``attn_pdrop`` and
T5 take a training step on the GPU against the same step on the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

from photonic_flash_attention_tpu_torch.config import get_config, reset_config
from photonic_flash_attention_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from photonic_flash_attention_tpu_torch.models.t5 import T5Config, T5ForConditionalGeneration
from photonic_flash_attention_tpu_torch.ops import _build
from photonic_flash_attention_tpu_torch.ops import flash as flash_ops
from photonic_flash_attention_tpu_torch.ops.flash import flash_attention, flash_attention_with_lse_plain
from photonic_flash_attention_tpu_torch.ops.flash_bwd import (
    flash_attention_bwd,
    flash_attention_bwd_plain,
)
from photonic_flash_attention_tpu_torch.ops.reference import DEFAULT_MASK_VALUE
from photonic_flash_attention_tpu_torch.ops.rel_bias import ALiBi, T5RelBias, alibi_slopes
from photonic_flash_attention_tpu_torch.training import Trainer, synthetic_lm_batches

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
BOUND = {"f32": 1e-4, "bf16": 1e-2}


def rel_err_norm(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float(torch.linalg.norm(a - b) / max(float(torch.linalg.norm(b)), 1e-9))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(b, sq, skv, hq, hkv, d, dtype, dev, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(s, generator=gen, device=dev).to(dtype)
            for s in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d), (b, sq, hq, d))]


# (B, Sq, Skv, Hq, Hkv, D, causal, streams)
STREAM_CASES = [
    (2, 300, 300, 4, 4, 64, True, dict(window=(-63, 0))),
    (2, 256, 256, 4, 2, 128, False, dict(window=(-40, 70))),
    (1, 200, 333, 4, 4, 64, True, dict(window=(-100, None))),
    (1, 128, 128, 2, 2, 64, False, dict(window=(-20, -5))),  # rows without a key
    (2, 300, 300, 4, 4, 64, True, dict(dropout_rate=0.1, dropout_seed=7)),
    (2, 200, 333, 4, 2, 128, False, dict(dropout_rate=0.3, dropout_seed=2**31 - 2)),
    (1, 100, 300, 4, 1, 64, True, dict(dropout_rate=0.5, dropout_seed=3)),
]


# The bf16 kernel's stream edges, (B, Sq, Skv, Hq, Hkv, D, causal, streams):
# a lens row of 0 (o = 0, lse = -inf), window rows with no key at ragged
# lengths, dropout at 0.1 against the plain version fed the same seed.
EDGE_STREAM_CASES = [
    (3, 129, 300, 4, 2, 64, True, dict(kv_lens=(300, 0, 129))),
    (2, 300, 300, 4, 4, 128, False, dict(kv_lens=(0, 300), k_bias=True)),
    (2, 300, 300, 4, 4, 64, False, dict(window=(-20, -5))),
    (2, 129, 300, 4, 2, 128, True, dict(window=(-40, 0))),
    (2, 300, 300, 4, 2, 64, True, dict(dropout_rate=0.1, dropout_seed=77)),
    (1, 129, 301, 8, 8, 128, False, dict(dropout_rate=0.1, dropout_seed=5)),
]


def _mode(streams) -> str:
    return "dropout" if "dropout_rate" in streams else "window"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("case", STREAM_CASES)
def test_flash_fwd_streams_match_plain(case, dtype_name, cuda_device):
    b, sq, skv, hq, hkv, d, causal, streams = case
    q, k, v, _ = _qkv(b, sq, skv, hq, hkv, d, DTYPES[dtype_name], cuda_device)
    counter = f"pfa_flash_fwd_{_mode(streams)}"
    before = _build.LAUNCHES[counter]
    out = flash_attention(q, k, v, causal=causal, **streams)
    ref, lse = flash_attention_with_lse_plain(q, k, v, causal=causal, **streams)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[counter] == before + 1
    assert torch.isfinite(out).all() and rel_err_norm(out, ref) <= BOUND[dtype_name]
    empty = torch.isneginf(lse).transpose(1, 2)  # (B, Sq, Hq): rows with no key
    assert (out[empty] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("case", EDGE_STREAM_CASES)
def test_flash_fwd_stream_edges_match_plain(case, dtype_name, cuda_device):
    """Output and lse of K1's streams at the edges, each launch under its
    mode's counter; rows with no key give o = 0 and lse = -inf."""
    b, sq, skv, hq, hkv, d, causal, streams = case
    q, k, v, _ = _qkv(b, sq, skv, hq, hkv, d, DTYPES[dtype_name], cuda_device, seed=sq + skv)
    kw = {key: val for key, val in streams.items() if key not in ("kv_lens", "k_bias")}
    if "kv_lens" in streams:
        kw["kv_lens"] = torch.tensor(streams["kv_lens"], dtype=torch.int32, device=cuda_device)
        counter = "pfa_flash_fwd_streams"
        if streams.get("k_bias"):
            gen = torch.Generator(device=cuda_device).manual_seed(3)
            bias = torch.randn(b, skv, generator=gen, device=cuda_device)
            bias[torch.rand(b, skv, generator=gen, device=cuda_device) < 0.1] = DEFAULT_MASK_VALUE
            bias[:, 0] = 0.0
            kw["k_bias"] = bias
    else:
        counter = f"pfa_flash_fwd_{_mode(streams)}"
    before = _build.LAUNCHES[counter]
    out, lse = flash_ops._flash_fwd_cuda(q, k, v, causal, d ** -0.5, True, **kw)
    ref, ref_lse = flash_attention_with_lse_plain(q, k, v, causal=causal, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[counter] == before + 1
    assert torch.isfinite(out).all() and rel_err_norm(out, ref) <= BOUND[dtype_name]
    live = torch.isfinite(ref_lse)
    assert torch.equal(torch.isneginf(lse), torch.isneginf(ref_lse))
    assert rel_err_norm(lse[live], ref_lse[live]) <= 1e-4
    empty = ~live.transpose(1, 2)  # (B, Sq, Hq): rows with no key
    assert (out[empty] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("case", STREAM_CASES)
def test_flash_bwd_streams_match_plain(case, dtype_name, cuda_device):
    b, sq, skv, hq, hkv, d, causal, streams = case
    q, k, v, do = _qkv(b, sq, skv, hq, hq, d, DTYPES[dtype_name], cuda_device, seed=1)
    o, lse = flash_attention_with_lse_plain(q, k, v, causal=causal, **streams)
    before = dict(_build.LAUNCHES)
    kw = dict(sm_scale=d ** -0.5, causal=causal, **streams)
    got = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    for name in ("pfa_flash_bwd_dkv", "pfa_flash_bwd_dq"):
        counter = f"{name}_{_mode(streams)}"
        assert _build.LAUNCHES[counter] == before.get(counter, 0) + 1
    for g, w in zip(got, want):
        assert torch.isfinite(g).all() and rel_err_norm(g, w) <= BOUND[dtype_name]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("case", STREAM_CASES[:3] + STREAM_CASES[4:])
def test_stream_grads_match_cpu(case, dtype_name, cuda_device):
    """Autograd through flash_attention with a window or dropout: K1, K4
    and K5 with the GQA repeat and group sum, against the CPU plain run."""
    b, sq, skv, hq, hkv, d, causal, streams = case
    host = [t.cpu() for t in _qkv(b, sq, skv, hq, hkv, d, DTYPES[dtype_name], cuda_device, seed=2)]

    def grads(device):
        q, k, v = (t.to(device).requires_grad_() for t in host[:3])
        out = flash_attention(q, k, v, causal=causal, **streams)
        return torch.autograd.grad(out, (q, k, v), host[3].to(device))

    gpu = grads(cuda_device)
    for g, c in zip(gpu, grads("cpu")):
        assert rel_err_norm(g.cpu(), c) <= BOUND[dtype_name]


REL_CASES = [(2, 300, 300, 4, 4, 64, False, "t5"), (1, 100, 333, 4, 2, 128, True, "t5"),
             (2, 256, 256, 4, 4, 64, True, "alibi")]


def _spec(kind, hq, causal, dev, requires_grad=False):
    if kind == "t5":
        table = torch.randn(32, hq, generator=torch.Generator().manual_seed(1)) * 0.5
        return T5RelBias(table.to(dev).requires_grad_(requires_grad), not causal), 1.0
    return ALiBi(alibi_slopes(hq).to(dev).requires_grad_(requires_grad)), None


@pytest.mark.cuda
@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("case", REL_CASES)
def test_rel_bias_lse_matches_plain(case, dtype_name, cuda_device):
    b, sq, skv, hq, hkv, d, causal, kind = case
    q, k, v, _ = _qkv(b, sq, skv, hq, hkv, d, DTYPES[dtype_name], cuda_device)
    spec, scale = _spec(kind, hq, causal, cuda_device)
    vec = flash_ops._rel_vector(spec, sq, skv)
    counter = "pfa_flash_fwd_relbias" if kind == "t5" else "pfa_flash_fwd_alibi"
    before = _build.LAUNCHES[f"{counter}_lse"]
    o, lse = flash_ops._flash_fwd_bias_cuda(q, k, v, causal, scale or d ** -0.5, counter, vec=vec,
                                            save_lse=True)
    o_ref, lse_ref = flash_attention_with_lse_plain(
        q, k, v, causal=causal, sm_scale=scale, bias=flash_ops.vector_bias(vec, sq, skv))
    torch.cuda.synchronize()
    assert _build.LAUNCHES[f"{counter}_lse"] == before + 1
    assert lse.shape == (b, hq, sq) and rel_err_norm(lse, lse_ref) <= 1e-4
    assert rel_err_norm(o, o_ref) <= BOUND[dtype_name]


@pytest.mark.cuda
@pytest.mark.parametrize("case", REL_CASES)
def test_rel_bias_grads_match_cpu(case, cuda_device):
    """q, k, v and the table or slopes through K1's relative-bias mode and
    the blockwise backward on the GPU, fp32, against the CPU run."""
    b, sq, skv, hq, hkv, d, causal, kind = case
    host = [t.cpu() for t in _qkv(b, sq, skv, hq, hkv, d, torch.float32, cuda_device, seed=3)]

    def grads(device):
        q, k, v = (t.to(device).requires_grad_() for t in host[:3])
        spec, scale = _spec(kind, hq, causal, device, requires_grad=True)
        table = spec.table if kind == "t5" else spec.slopes
        out = flash_attention(q, k, v, causal=causal, sm_scale=scale, rel_bias=spec)
        return torch.autograd.grad(out, (q, k, v, table), host[3].to(device))

    for g, c in zip(grads(cuda_device), grads("cpu")):
        assert rel_err_norm(g.cpu(), c) <= BOUND["f32"]


@pytest.mark.cuda
def test_dropout_trainer_step_matches_cpu(cuda_device):
    """One AdamW step of a fp32 GPT-2 with attn_pdrop 0.1 (head dim 64,
    S 256, flash route forced) through Trainer(dropout_rng=...) on the GPU
    (K1, K4, K5 with the dropout stream) against the same step on the CPU:
    the same seeds, so the same masks."""
    cfg = dataclasses.replace(GPT2Config.tiny(), n_head=2, attn_pdrop=0.1, dtype=torch.float32)
    state = GPT2LMHead(cfg, generator=torch.Generator().manual_seed(0)).state_dict()
    batch = next(synthetic_lm_batches(batch=2, seq=256, vocab=cfg.vocab_size, seed=0))
    get_config().update(flash_threshold=0, flash_min_tokens=0)
    try:
        runs = {}
        for device in ("cpu", "cuda"):
            model = GPT2LMHead(cfg).to(device)
            model.load_state_dict(state)
            trainer = Trainer(model, torch.optim.AdamW(model.parameters(), lr=1e-4),
                              dropout_rng=torch.Generator().manual_seed(5))
            before = dict(_build.LAUNCHES)
            _, metrics = trainer.train_step(trainer.init_state(), batch)
            for name in ("pfa_flash_fwd_dropout", "pfa_flash_bwd_dkv_dropout",
                         "pfa_flash_bwd_dq_dropout"):
                launched = _build.LAUNCHES[name] - before.get(name, 0)
                assert launched == (cfg.n_layer if device == "cuda" else 0)
            runs[device] = (float(metrics["loss"]),
                            {n: p.grad.cpu() for n, p in model.named_parameters()})
    finally:
        reset_config()
    (loss_c, grads_c), (loss_g, grads_g) = runs["cpu"], runs["cuda"]
    assert abs(loss_g - loss_c) <= 1e-4 * abs(loss_c)
    for name, g in grads_c.items():
        if name.endswith("attn.k_proj.bias"):  # zero in exact arithmetic
            continue
        assert rel_err_norm(grads_g[name], g) <= 1e-3, name


@pytest.mark.cuda
def test_t5_grads_match_cpu(cuda_device):
    """A narrow fp32 T5 (d_kv 64, 2+2 layers, S 256/128, flash route):
    the gradient of every parameter, both rel_embedding tables included,
    on the GPU (K1's relative-bias mode with lse, the blockwise backward,
    K1/K4/K5 for the cross-attention) against the CPU."""
    cfg = dataclasses.replace(T5Config.tiny(), d_model=128, d_kv=64, num_heads=2,
                              dtype=torch.float32)
    state = T5ForConditionalGeneration(cfg, generator=torch.Generator().manual_seed(0)).state_dict()
    rng = np.random.default_rng(0)
    enc, dec = (torch.from_numpy(rng.integers(2, cfg.vocab_size, (2, n))) for n in (256, 128))
    get_config().update(flash_threshold=64, flash_min_tokens=1)
    try:
        grads = {}
        for device in ("cpu", "cuda"):
            model = T5ForConditionalGeneration(cfg).to(device)
            model.load_state_dict(state)
            before = _build.LAUNCHES["pfa_flash_fwd_relbias_lse"]
            logits = model(enc.to(device), dec.to(device))
            (logits.float() ** 2).mean().backward()
            launched = _build.LAUNCHES["pfa_flash_fwd_relbias_lse"] - before
            assert launched == (4 if device == "cuda" else 0)
            grads[device] = {n: p.grad.cpu() for n, p in model.named_parameters()}
    finally:
        reset_config()
    for name, g in grads["cpu"].items():
        assert rel_err_norm(grads["cuda"][name], g) <= 1e-3, name
