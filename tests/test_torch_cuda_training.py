"""The port's training path on the GPU: K1's lse, K4/K5 and a Trainer step.

Every test here carries the ``cuda`` marker and skips without a GPU. The
file imports no JAX, so it also runs on a machine that has none:

    python -m pytest tests/test_torch_cuda_training.py -m cuda --noconftest -q

Each kernel test checks that the wrapper launched its kernel exactly once
and that the result agrees with the plain version on the same inputs,
within ``rel_err_norm`` 1e-2 (bf16) or 1e-4 (fp32). A ``Trainer`` step of a
small GPT-2 on the GPU (through K1, K4 and K5) must give the CPU step's
loss and gradients within the bf16 gate (5e-2).
"""

import dataclasses

import numpy as np
import pytest
import torch

from photonic_flash_attention_tpu_torch.config import get_config, reset_config
from photonic_flash_attention_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from photonic_flash_attention_tpu_torch.ops import _build
from photonic_flash_attention_tpu_torch.ops.flash import (
    flash_attention,
    flash_attention_with_lse,
    flash_attention_with_lse_plain,
)
from photonic_flash_attention_tpu_torch.ops.flash_bwd import (
    flash_attention_bwd,
    flash_attention_bwd_plain,
)
from photonic_flash_attention_tpu_torch.training import Trainer, synthetic_lm_batches

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
BOUND = {"f32": 1e-4, "bf16": 1e-2}

# (B, Sq, Skv, H, D, causal): aligned, unaligned, Sq < Skv, both D.
BWD_CASES = [
    (2, 256, 256, 4, 64, False),
    (2, 256, 256, 4, 64, True),
    (1, 200, 200, 2, 64, True),
    (1, 256, 384, 2, 64, True),
    (1, 256, 256, 2, 128, False),
    (1, 100, 300, 2, 128, True),
]


def rel_err_norm(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float(torch.linalg.norm(a - b) / max(float(torch.linalg.norm(b)), 1e-9))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, shape, device, dtype):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("case", BWD_CASES)
def test_flash_bwd_kernels_match_plain(case, dtype_name, cuda_device):
    b, sq, skv, h, d, causal = case
    dt, rng = DTYPES[dtype_name], np.random.default_rng(0)
    q = _randn(rng, (b, sq, h, d), cuda_device, dt)
    k, v = (_randn(rng, (b, skv, h, d), cuda_device, dt) for _ in range(2))
    do = _randn(rng, (b, sq, h, d), cuda_device, dt)
    scale = d ** -0.5
    o, lse = flash_attention_with_lse_plain(q, k, v, causal=causal)
    before = dict(_build.LAUNCHES)
    got = flash_attention_bwd(q, k, v, o, lse, do, sm_scale=scale, causal=causal)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, sm_scale=scale, causal=causal)
    torch.cuda.synchronize()
    for name in ("pfa_flash_bwd_dkv", "pfa_flash_bwd_dq"):
        assert _build.LAUNCHES[name] == before.get(name, 0) + 1
    for g, w in zip(got, want):
        assert g.dtype == dt and torch.isfinite(g).all()
        assert rel_err_norm(g, w) <= BOUND[dtype_name]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("case", [(2, 200, 200, 4, 2, 64, True), (1, 64, 320, 4, 1, 128, False)])
def test_flash_lse_matches_plain(case, dtype_name, cuda_device):
    b, sq, skv, hq, hkv, d, causal = case
    dt, rng = DTYPES[dtype_name], np.random.default_rng(1)
    q = _randn(rng, (b, sq, hq, d), cuda_device, dt)
    k, v = (_randn(rng, (b, skv, hkv, d), cuda_device, dt) for _ in range(2))
    before = _build.LAUNCHES["pfa_flash_fwd"]
    o, lse = flash_attention_with_lse(q, k, v, causal=causal)
    o_ref, lse_ref = flash_attention_with_lse_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["pfa_flash_fwd"] == before + 1
    assert lse.shape == (b, hq, sq) and lse.dtype == torch.float32
    assert rel_err_norm(lse, lse_ref) <= 1e-4
    assert rel_err_norm(o, o_ref) <= BOUND[dtype_name]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype_name", list(DTYPES))
def test_flash_attention_gqa_grads_match_cpu(dtype_name, cuda_device):
    """Autograd through flash_attention: K1 + K4/K5 with the GQA repeat
    and group sum on the GPU, against the plain versions on the CPU."""
    dt, rng = DTYPES[dtype_name], np.random.default_rng(2)
    shapes = ((2, 300, 4, 64), (2, 300, 2, 64), (2, 300, 2, 64), (2, 300, 4, 64))
    host = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dt) for s in shapes]

    def grads(device):
        q, k, v = (t.to(device).requires_grad_() for t in host[:3])
        out = flash_attention(q, k, v, causal=True)
        return torch.autograd.grad(out, (q, k, v), host[3].to(device))

    before = dict(_build.LAUNCHES)
    gpu = grads(cuda_device)
    torch.cuda.synchronize()
    for name in ("pfa_flash_fwd", "pfa_flash_bwd_dkv", "pfa_flash_bwd_dq"):
        assert _build.LAUNCHES[name] == before.get(name, 0) + 1
    for g, c, t in zip(gpu, grads("cpu"), host[:3]):
        assert g.dtype == dt and g.shape == t.shape
        assert rel_err_norm(g.cpu(), c) <= BOUND[dtype_name]


@pytest.mark.cuda
def test_trainer_step_matches_cpu(cuda_device):
    """One AdamW step of a bf16 GPT-2 (head dim 64, S 256, flash route
    forced by the config) on the GPU against the same step on the CPU."""
    cfg = dataclasses.replace(GPT2Config.tiny(), n_head=2)
    state = GPT2LMHead(cfg, generator=torch.Generator().manual_seed(0)).state_dict()
    batch = next(synthetic_lm_batches(batch=2, seq=256, vocab=cfg.vocab_size, seed=0))
    get_config().update(flash_threshold=0, flash_min_tokens=0)
    try:
        runs = {}
        for device in ("cpu", "cuda"):
            model = GPT2LMHead(cfg).to(device)
            model.load_state_dict(state)
            trainer = Trainer(model, torch.optim.AdamW(model.parameters(), lr=1e-4,
                                                       weight_decay=1e-4))
            before = dict(_build.LAUNCHES)
            _, metrics = trainer.train_step(trainer.init_state(), batch)
            for name in ("pfa_flash_fwd", "pfa_flash_bwd_dkv", "pfa_flash_bwd_dq"):
                launched = _build.LAUNCHES[name] - before.get(name, 0)
                assert launched == (cfg.n_layer if device == "cuda" else 0)
            runs[device] = (float(metrics["loss"]),
                            {n: p.grad.cpu() for n, p in model.named_parameters()})
    finally:
        reset_config()
    (loss_c, grads_c), (loss_g, grads_g) = runs["cpu"], runs["cuda"]
    assert abs(loss_g - loss_c) <= 1e-2 * abs(loss_c)
    flat_c = torch.cat([g.flatten() for g in grads_c.values()])
    flat_g = torch.cat([grads_g[n].flatten() for n in grads_c])
    assert rel_err_norm(flat_g, flat_c) <= 5e-2
    for i in range(cfg.n_layer):
        name = f"h.{i}.attn.q_proj.weight"
        assert rel_err_norm(grads_g[name], grads_c[name]) <= 5e-2
