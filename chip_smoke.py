"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

Run from the repository root:

    python3 chip_smoke.py

Phases (each prints its lines; any failure raises and exits non-zero):

1. device: CUDA must be available (there is no CPU path);
2. build: compile the port's kernels (csrc/*.cu) with nvcc;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the serving and training paths give it, with kernel and
   plain times: K1 (flash forward, and its lse), K2/K3 (paged decode),
   K4/K5 (flash backward);
4. serving path: GPT-2 medium (random weights, seed 0) served through
   ``ServingEngine.generate`` with an int8 paged KV cache; every kernel's
   launch count must grow; the first step must agree with the dense model;
5. training path: GPT-2 medium (random weights, seed 0) takes AdamW steps
   through ``Trainer.train_step`` at B8 S1024 on one fixed batch; the loss
   must fall, K1/K4/K5 must launch once per layer and step; the gradient of
   the first 4 layers of the same weights must agree with a CPU run.

The last lines are the card's name and power limit, the per-kernel JSON
summary and, last of all, ``{"ok": true, "device": {...}}``. The script
imports nothing of JAX. ``--profile DIR`` adds a torch.profiler breakdown
of three single training steps (device activity only: busy time, idle
share of each step's wall time, time by kernel group) and writes the
traces and a per-kernel table into DIR.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import statistics
import subprocess
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from photonic_flash_attention_tpu_torch.ops import _build
from photonic_flash_attention_tpu_torch.ops import flash as flash_ops
from photonic_flash_attention_tpu_torch.ops import flash_bwd as bwd_ops
from photonic_flash_attention_tpu_torch.ops import paged as paged_ops

SOURCES = {
    "pfa_flash_fwd": "photonic_flash_attention_tpu_torch/csrc/flash_fwd.cu",
    "pfa_paged_token_write": "photonic_flash_attention_tpu_torch/csrc/paged_decode.cu",
    "pfa_paged_decode_attend": "photonic_flash_attention_tpu_torch/csrc/paged_decode.cu",
    "pfa_flash_bwd_dkv": "photonic_flash_attention_tpu_torch/csrc/flash_bwd.cu",
    "pfa_flash_bwd_dq": "photonic_flash_attention_tpu_torch/csrc/flash_bwd.cu",
}
REPLACES = {
    "pfa_flash_fwd": "photonic_flash_attention_tpu/ops/flash.py:59, "
                     "photonic_flash_attention_tpu/ops/flash_unrolled.py:144",
    "pfa_paged_token_write": "photonic_flash_attention_tpu/ops/paged.py:407",
    "pfa_paged_decode_attend": "photonic_flash_attention_tpu/ops/paged.py:407",
    "pfa_flash_bwd_dkv": "photonic_flash_attention_tpu/ops/flash_bwd.py:167, "
                         "photonic_flash_attention_tpu/ops/flash_bwd.py:609",
    "pfa_flash_bwd_dq": "photonic_flash_attention_tpu/ops/flash_bwd.py:248, "
                        "photonic_flash_attention_tpu/ops/flash_bwd.py:569",
}
TIMED_RUNS = 20


def rel_err_norm(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float(torch.linalg.norm(a - b) / max(float(torch.linalg.norm(b)), 1e-9))


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def median_ms(fn, runs: int = TIMED_RUNS, warmup: int = 3) -> float:
    """Median CUDA-event time of ``fn`` over ``runs`` launches."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: chip_smoke.py runs only on a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    path = _build.build()
    _build.lib()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {path.name}", flush=True)


def check_flash(results: dict) -> None:
    """K1 against its plain version: causal bf16 at the prefill shapes,
    plus the rest of its contract (fp32, D=128, GQA, Sq < Skv)."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = [  # (B, Sq, Skv, Hq, Hkv, D, dtype, causal, bound)
        (1, 16, 16, 16, 16, 64, torch.bfloat16, True, 1e-2),
        (1, 128, 128, 16, 16, 64, torch.bfloat16, True, 1e-2),
        (1, 512, 512, 16, 16, 64, torch.bfloat16, True, 1e-2),
        (1, 1024, 1024, 16, 16, 64, torch.bfloat16, True, 1e-2),
        (4, 2048, 2048, 12, 12, 64, torch.bfloat16, True, 1e-2),
        (2, 40, 100, 4, 2, 128, torch.bfloat16, True, 1e-2),
        (2, 100, 100, 4, 2, 128, torch.bfloat16, False, 1e-2),
        (2, 40, 100, 4, 2, 64, torch.float32, True, 1e-4),
        (2, 256, 256, 4, 4, 128, torch.float32, False, 1e-4),
    ]
    worst = 0.0
    for b, sq, skv, hq, hkv, d, dtype, causal, bound in cases:
        q = torch.randn(b, sq, hq, d, device="cuda", generator=gen).to(dtype)
        k = torch.randn(b, skv, hkv, d, device="cuda", generator=gen).to(dtype)
        v = torch.randn(b, skv, hkv, d, device="cuda", generator=gen).to(dtype)
        out = flash_ops.flash_attention(q, k, v, causal=causal)
        ref = flash_ops.flash_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = rel_err_norm(out, ref)
        worst = max(worst, max_abs_err(out, ref))
        line = (f"K1 flash_fwd B{b} Sq{sq} Skv{skv} H{hq}/{hkv} D{d} {str(dtype)[6:]} "
                f"causal={causal}: rel_err_norm {err:.3e} (bound {bound})")
        if err > bound or not torch.isfinite(out).all():
            raise AssertionError(line)
        if dtype == torch.bfloat16 and causal and hq == hkv:
            ms = median_ms(lambda: flash_ops.flash_attention(q, k, v, causal=True))
            plain = median_ms(lambda: flash_ops.flash_attention_plain(q, k, v, causal=True))
            line += f" | kernel {ms:.4f} ms, plain {plain:.4f} ms"
            results["pfa_flash_fwd"].update(ms=ms, plain_ms=plain)  # last: B4 S2048
        print(line, flush=True)
    results["pfa_flash_fwd"]["max_abs_err"] = worst


def _serving_pools(dtype, gen, L=24, hkv=16, num_pages=256, page=128, d=64):
    shape = (L, hkv, num_pages, page, d)
    if dtype == torch.int8:
        k = torch.randint(-127, 128, shape, device="cuda", generator=gen, dtype=torch.int8)
        v = torch.randint(-127, 128, shape, device="cuda", generator=gen, dtype=torch.int8)
        ks = torch.rand(shape[:4], device="cuda", generator=gen) * 0.05 + 1e-3
        vs = torch.rand(shape[:4], device="cuda", generator=gen) * 0.05 + 1e-3
        return k, v, ks, vs
    k = torch.randn(shape, device="cuda", generator=gen).to(dtype)
    v = torch.randn(shape, device="cuda", generator=gen).to(dtype)
    return k, v, None, None


def check_token_write(results: dict) -> None:
    """K2 against its plain version: bit-exact pools and scales."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    b, hkv, d, page, layer = 8, 16, 64, 128, 5
    # 7 sequences on distinct pages, one empty slot writing to trash page 0.
    slots = torch.tensor([0] + [p * page + (13 * p) % page for p in (3, 9, 40, 77, 120, 200, 255)],
                         dtype=torch.int32, device="cuda")
    for pool_dtype in (torch.int8, torch.bfloat16):
        k_new = torch.randn(b, hkv, d, device="cuda", generator=gen).to(torch.bfloat16)
        v_new = torch.randn(b, hkv, d, device="cuda", generator=gen).to(torch.bfloat16)
        k_new[3, 2] = 0.0  # an all-zero token takes scale 1
        pools = _serving_pools(pool_dtype, gen)
        ref = [p.clone() if p is not None else None for p in pools]
        paged_ops.paged_token_write(k_new, v_new, *pools, slots, layer)
        paged_ops.paged_token_write_plain(k_new, v_new, *ref, slots, layer)
        torch.cuda.synchronize()
        for name, got, want in zip(("k", "v", "k_scales", "v_scales"), pools, ref):
            if got is not None and not torch.equal(got, want):
                bad = got != want
                raise AssertionError(
                    f"K2 {pool_dtype}: {name} differs from the plain version at "
                    f"{int(bad.sum())} entries, max |diff| "
                    f"{float((got.float() - want.float()).abs().max())}"
                )
        err = max(max_abs_err(got[layer], want[layer])
                  for got, want in zip(pools, ref) if got is not None)
        ms = median_ms(lambda: paged_ops.paged_token_write(k_new, v_new, *pools, slots, layer))
        plain = median_ms(
            lambda: paged_ops.paged_token_write_plain(k_new, v_new, *ref, slots, layer)
        )
        print(f"K2 paged_token_write B{b} Hkv{hkv} D{d} page{page} pool {str(pool_dtype)[6:]}: "
              f"bit-exact | kernel {ms:.4f} ms, plain {plain:.4f} ms", flush=True)
        if pool_dtype == torch.int8:
            results["pfa_paged_token_write"].update(ms=ms, plain_ms=plain, max_abs_err=err)


def check_decode_attend(results: dict) -> None:
    """K3 against its plain version on an int8 pool, lengths mixed with 0."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    b, hq, d, page, pps, layer = 8, 16, 64, 128, 64, 7
    k, v, ks, vs = _serving_pools(torch.int8, gen)
    lengths = torch.tensor([0, 1, 17, 128, 129, 700, 1000, 2000], dtype=torch.int32, device="cuda")
    perm = torch.randperm(255, device="cuda", generator=gen)[: b * 16] + 1
    tables = torch.zeros(b, pps, dtype=torch.int32, device="cuda")
    tables[:, :16] = perm.view(b, 16).to(torch.int32)
    q = torch.randn(b, hq, d, device="cuda", generator=gen)
    out = paged_ops.paged_decode_attend(q, k, v, lengths, tables, layer, ks, vs)
    ref = paged_ops.paged_decode_attend_plain(q, k, v, lengths, tables, layer, ks, vs, d ** -0.5)
    torch.cuda.synchronize()
    err = rel_err_norm(out, ref)
    line = (f"K3 paged_decode_attend B{b} H{hq} D{d} page{page} int8 lengths "
            f"{lengths.tolist()}: rel_err_norm {err:.3e} (bound 1e-3)")
    if err > 1e-3 or not torch.isfinite(out).all() or out[0].abs().max() != 0:
        raise AssertionError(line)
    ms = median_ms(lambda: paged_ops.paged_decode_attend(q, k, v, lengths, tables, layer, ks, vs))
    plain = median_ms(lambda: paged_ops.paged_decode_attend_plain(
        q, k, v, lengths, tables, layer, ks, vs, d ** -0.5))
    print(f"{line} | kernel {ms:.4f} ms, plain {plain:.4f} ms", flush=True)
    results["pfa_paged_decode_attend"].update(ms=ms, plain_ms=plain, max_abs_err=max_abs_err(out, ref))


def check_flash_lse() -> None:
    """K1's lse output against the plain lse (natural log, fp32)."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    cases = [  # (B, Sq, Skv, Hq, Hkv, D, dtype, causal)
        (8, 1024, 1024, 16, 16, 64, torch.bfloat16, True),
        (2, 200, 200, 4, 2, 64, torch.float32, True),
        (1, 64, 320, 4, 1, 128, torch.float32, False),
    ]
    for b, sq, skv, hq, hkv, d, dtype, causal in cases:
        q = torch.randn(b, sq, hq, d, device="cuda", generator=gen).to(dtype)
        k = torch.randn(b, skv, hkv, d, device="cuda", generator=gen).to(dtype)
        v = torch.randn(b, skv, hkv, d, device="cuda", generator=gen).to(dtype)
        _, lse = flash_ops.flash_attention_with_lse(q, k, v, causal=causal)
        _, ref = flash_ops.flash_attention_with_lse_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = rel_err_norm(lse, ref)
        line = (f"K1 lse B{b} Sq{sq} Skv{skv} H{hq}/{hkv} D{d} {str(dtype)[6:]} "
                f"causal={causal}: rel_err_norm {err:.3e} (bound 1e-4)")
        if err > 1e-4 or not torch.isfinite(lse).all() or lse.shape != (b, hq, sq):
            raise AssertionError(line)
        print(line, flush=True)


def _plain_grads(q, k, v, do, causal):
    """The plain backward on the plain forward's residuals, with the GQA
    repeat and group sum of ``ops/flash.py``."""
    group = q.shape[2] // k.shape[2]
    k_in, v_in = (t.repeat_interleave(group, dim=2) for t in (k, v))
    o, lse = flash_ops.flash_attention_with_lse_plain(q, k, v, causal=causal)
    dq, dk, dv = bwd_ops.flash_attention_bwd_plain(
        q, k_in, v_in, o, lse, do, sm_scale=q.shape[-1] ** -0.5, causal=causal)
    b, skv, hkv, d = k.shape
    dk = dk.float().view(b, skv, hkv, group, d).sum(3)
    dv = dv.float().view(b, skv, hkv, group, d).sum(3)
    return (dq, dk, dv), (o, lse)


def check_flash_bwd(results: dict) -> None:
    """K4 (dK/dV) and K5 (dQ) against the plain backward on the same
    inputs: the training shapes timed, then the rest of the contract
    (unaligned S, Sq < Skv, GQA through flash_attention's autograd,
    D 128, fp32)."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [  # (B, Sq, Skv, Hq, Hkv, D, dtype, causal)
        (8, 1024, 1024, 16, 16, 64, bf16, True),
        (4, 2048, 2048, 12, 12, 64, bf16, True),
        (2, 200, 200, 4, 4, 64, bf16, True),
        (2, 256, 384, 4, 4, 64, bf16, True),
        (2, 512, 512, 4, 2, 64, bf16, True),
        (2, 512, 512, 4, 4, 128, bf16, False),
        (2, 256, 256, 4, 4, 64, f32, True),
        (2, 200, 200, 4, 2, 64, f32, True),
        (2, 256, 256, 4, 4, 128, f32, False),
    ]
    worst = {"pfa_flash_bwd_dkv": 0.0, "pfa_flash_bwd_dq": 0.0}
    for b, sq, skv, hq, hkv, d, dtype, causal in cases:
        q = torch.randn(b, sq, hq, d, device="cuda", generator=gen).to(dtype)
        k = torch.randn(b, skv, hkv, d, device="cuda", generator=gen).to(dtype)
        v = torch.randn(b, skv, hkv, d, device="cuda", generator=gen).to(dtype)
        do = torch.randn(b, sq, hq, d, device="cuda", generator=gen).to(dtype)
        want, (o, lse) = _plain_grads(q, k, v, do, causal)
        if hq != hkv:  # through the autograd Function: K1, K4, K5
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            out = flash_ops.flash_attention(*leaves, causal=causal)
            got = torch.autograd.grad(out, leaves, do)
        else:
            got = bwd_ops.flash_attention_bwd(q, k, v, o, lse, do,
                                              sm_scale=d ** -0.5, causal=causal)
        torch.cuda.synchronize()
        bound = 1e-2 if dtype == bf16 else 1e-4
        errs = [rel_err_norm(g, w) for g, w in zip(got, want)]
        line = (f"K4/K5 flash_bwd B{b} Sq{sq} Skv{skv} H{hq}/{hkv} D{d} {str(dtype)[6:]} "
                f"causal={causal}{' (autograd, GQA)' if hq != hkv else ''}: rel_err_norm "
                f"dq {errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e} (bound {bound})")
        if max(errs) > bound or not all(torch.isfinite(g).all() for g in got):
            raise AssertionError(line)
        worst["pfa_flash_bwd_dq"] = max(worst["pfa_flash_bwd_dq"], max_abs_err(got[0], want[0]))
        worst["pfa_flash_bwd_dkv"] = max(worst["pfa_flash_bwd_dkv"],
                                         max_abs_err(got[1], want[1]), max_abs_err(got[2], want[2]))
        if dtype == bf16 and causal and hq == hkv and sq >= 1024:
            di = bwd_ops.flash_bwd_di(o, do)
            kw = dict(sm_scale=d ** -0.5, causal=True)
            ms_dkv = median_ms(lambda: bwd_ops.flash_bwd_dkv(q, k, v, do, lse, di, **kw))
            ms_dq = median_ms(lambda: bwd_ops.flash_bwd_dq(q, k, v, do, lse, di, **kw))
            plain = median_ms(lambda: bwd_ops.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw))
            line += (f" | K4 {ms_dkv:.4f} ms, K5 {ms_dq:.4f} ms, plain backward "
                     f"(dq, dk, dv) {plain:.4f} ms")
            # last: B4 S2048
            results["pfa_flash_bwd_dkv"].update(ms=ms_dkv, plain_ms=plain)
            results["pfa_flash_bwd_dq"].update(ms=ms_dq, plain_ms=plain)
        print(line, flush=True)
    for name, err in worst.items():
        results[name]["max_abs_err"] = err


def phase_kernels() -> dict:
    results = {name: {} for name in SOURCES}
    check_flash(results)
    check_flash_lse()
    check_token_write(results)
    check_decode_attend(results)
    check_flash_bwd(results)
    return results


PROMPT_LENS = (17, 64, 100, 128, 256, 300, 512, 700)
NEW_TOKENS = 33


def phase_serving(smi: str) -> dict:
    from photonic_flash_attention_tpu_torch.core.serving import ServingEngine
    from photonic_flash_attention_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    from photonic_flash_attention_tpu_torch.models.gpt2_serving import (
        KVPages, prefill_step, prepare_params,
    )

    cfg = GPT2Config.medium()
    t0 = time.perf_counter()
    model = GPT2LMHead(cfg, generator=torch.Generator().manual_seed(0))
    print(f"main path: GPT-2 medium init {time.perf_counter() - t0:.1f} s "
          f"({sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params)", flush=True)
    engine = ServingEngine(
        cfg, model.state_dict(), device="cuda", num_pages=256, page_size=128,
        max_batch=8, kv_dtype=torch.int8, decode_window=32,
    )
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in PROMPT_LENS]
    engine.generate([p[:8] for p in prompts[:2]], max_new_tokens=2)  # warm-up
    torch.cuda.synchronize()
    engine.reset_performance_stats()

    _build.reset_launches()
    t0 = time.perf_counter()
    outs = engine.generate(prompts, max_new_tokens=NEW_TOKENS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)

    for p, o in zip(prompts, outs):
        if len(o) != NEW_TOKENS or not all(0 <= t < cfg.vocab_size for t in o):
            raise AssertionError(f"prompt of {len(p)} tokens: bad output {o}")
    need = {
        "pfa_flash_fwd": cfg.n_layer * len(prompts),
        "pfa_paged_token_write": cfg.n_layer * (NEW_TOKENS - 1),
        "pfa_paged_decode_attend": cfg.n_layer * (NEW_TOKENS - 1),
    }
    for name, n in need.items():
        got = launches.get(name, 0)
        if got < n or (name == "pfa_flash_fwd" and got != n):
            raise AssertionError(f"{name}: {got} launches in the main path, expected {n}")
    stats = engine.get_performance_stats()
    print(f"main path: {len(prompts)} requests x {NEW_TOKENS} tokens in {wall:.2f} s; "
          f"launches {launches}", flush=True)
    print(f"main path: decode {stats['decode_tokens']} tokens at "
          f"{stats['decode_tokens_per_s']:.1f} tokens/s, prefill {stats['prefill_tokens']} "
          f"tokens at {stats['prefill_tokens_per_s']:.1f} tokens/s ({smi})", flush=True)

    # First step: the serving prefill's logits for prompt 0 against the
    # dense forward of the same weights, both on the card.
    params = prepare_params(model.state_dict(), cfg, "cuda")
    n0 = len(prompts[0])
    s_pad = max(16, 1 << (n0 - 1).bit_length())
    ids = torch.zeros(1, s_pad, dtype=torch.long, device="cuda")
    ids[0, :n0] = torch.tensor(prompts[0], device="cuda")
    pages = KVPages.create(cfg, 4, 128, torch.int8, "cuda")
    slots = torch.arange(s_pad, dtype=torch.int32, device="cuda")[None] + 128
    slots[0, n0:] = 0
    logits = prefill_step(params, cfg, ids, torch.tensor([n0], device="cuda"),
                          pages, slots, True)
    with torch.no_grad():
        dense = model.to("cuda")(ids[:, :n0])[0, -1].float()
    err = rel_err_norm(logits[0], dense)
    line = f"main path: prefill logits vs dense forward rel_err_norm {err:.3e} (bound 5e-2)"
    if err > 5e-2:
        raise AssertionError(line)
    print(line, flush=True)
    return launches


TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, CHECK_LAYERS = 8, 1024, 5, 4
TRAIN_KERNELS = ("pfa_flash_fwd", "pfa_flash_bwd_dkv", "pfa_flash_bwd_dq")


def _lm_grads(model, batch) -> dict:
    from photonic_flash_attention_tpu_torch.training.trainer import lm_loss

    model.zero_grad(set_to_none=True)
    lm_loss(model, batch).backward()
    return {n: p.grad.float().cpu() for n, p in model.named_parameters()}


def check_train_grads(cfg, state: dict, batch: dict) -> None:
    """One step's gradient of the first CHECK_LAYERS layers of the weights
    at B1: bf16 on the card (K1, K4, K5) against fp32 on the CPU (the
    plain versions), the bf16-scale gate 5e-2."""
    from photonic_flash_attention_tpu_torch.config import get_config, reset_config
    from photonic_flash_attention_tpu_torch.models.gpt2 import GPT2LMHead

    cut = dataclasses.replace(cfg, n_layer=CHECK_LAYERS)
    one = {k: torch.as_tensor(v[:1]) for k, v in batch.items()}
    # B1 S1024 is below flash_min_tokens: lower it so both runs take the
    # flash route (kernels on the card, plain versions on the CPU).
    get_config().update(flash_min_tokens=TRAIN_SEQ)
    grads = {}
    for device, dtype in (("cpu", torch.float32), ("cuda", cfg.dtype)):
        model = GPT2LMHead(dataclasses.replace(cut, dtype=dtype))
        model.load_state_dict(state)
        before = dict(_build.LAUNCHES)
        grads[device] = _lm_grads(model.to(device), {k: v.to(device) for k, v in one.items()})
        if device == "cuda":
            for name in TRAIN_KERNELS:
                if _build.LAUNCHES[name] - before.get(name, 0) != CHECK_LAYERS:
                    raise AssertionError(f"gradient check: {name} not launched per layer")
    reset_config()
    flat = {d: torch.cat([g.flatten() for g in gs.values()]) for d, gs in grads.items()}
    errs = {"all": rel_err_norm(flat["cuda"], flat["cpu"])}
    for i in range(CHECK_LAYERS):
        name = f"h.{i}.attn.q_proj.weight"
        errs[name] = rel_err_norm(grads["cuda"][name], grads["cpu"][name])
    line = (f"training path: gradient of GPT-2 widths {cfg.n_embd}/{cfg.n_head} heads, first "
            f"{CHECK_LAYERS} layers, B1 S{TRAIN_SEQ}, card bf16 vs CPU fp32 plain: "
            + ", ".join(f"{n} {e:.3e}" for n, e in errs.items()) + " (bound 5e-2)")
    if max(errs.values()) > 5e-2 or not torch.isfinite(flat["cuda"]).all():
        raise AssertionError(line)
    print(line, flush=True)


KERNEL_GROUPS = (  # (group, substrings of the CUDA kernel names)
    ("K1 flash forward", ("flash_fwd",)),
    ("K4 flash dK/dV", ("bwd_dkv",)),
    ("K5 flash dQ", ("bwd_dq",)),
    ("matmul (cuBLAS)", ("gemm", "cutlass", "nvjet", "xmma")),
    ("AdamW (multi-tensor)", ("multi_tensor",)),
    ("softmax / cross entropy", ("SoftMax", "softmax")),
    ("layer norm", ("layer_norm", "LayerNorm", "GammaBeta")),
    ("reductions", ("reduce_kernel",)),
    ("elementwise and copies", ("elementwise", "copy", "fill", "Memcpy", "Memset")),
)
PROFILED_STEPS = 3
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, reach = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end > reach:
            busy += end - max(start, reach)
            reach = end
    return busy


def profile_train_step(trainer, state, batch, out_dir: Path) -> None:
    """torch.profiler (device activity only) over PROFILED_STEPS single
    training steps. For each: the step's own wall time (host clock, card
    synchronized before and after), the device's busy time (union of its
    kernel and copy intervals in the trace) and the span from the first
    device event to the last. Idle share = 1 - busy / wall, per step."""
    from torch.profiler import ProfilerActivity, profile

    out_dir.mkdir(parents=True, exist_ok=True)
    groups = collections.Counter()
    by_kernel = collections.Counter()
    idle = []
    for i in range(PROFILED_STEPS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            trainer.train_step(state, batch)
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0)
        trace = out_dir / f"train_step_trace_{i}.json"
        prof.export_chrome_trace(str(trace))
        events = [e for e in json.loads(trace.read_text())["traceEvents"]
                  if e.get("cat") in DEVICE_CATEGORIES and "dur" in e]
        if not events:
            raise AssertionError("profile: the trace holds no device events")
        spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events]
        busy = _busy_us(spans)
        span = max(e for _, e in spans) - min(s for s, _ in spans)
        idle.append(1 - busy / wall_us)
        print(f"profile: step {i}: wall {wall_us / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms, "
              f"first-to-last device event {span / 1e3:.3f} ms, idle {100 * idle[-1]:.1f}% of "
              f"the wall ({len(events)} device events)", flush=True)
        for e in events:
            name = e["name"]
            by_kernel[name] += float(e["dur"]) / 1e3 / PROFILED_STEPS
            group = next((g for g, keys in KERNEL_GROUPS if any(k in name for k in keys)), "other")
            groups[group] += float(e["dur"]) / 1e3 / PROFILED_STEPS
    total = sum(groups.values())
    lines = [f"profile: idle share over {PROFILED_STEPS} profiled steps "
             f"{100 * min(idle):.1f}% .. {100 * max(idle):.1f}%; mean device time by group "
             f"(sum {total:.3f} ms):"]
    lines += [f"profile:   {g}: {t:.3f} ms ({100 * t / total:.1f}%)"
              for g, t in groups.most_common()]
    print("\n".join(lines), flush=True)
    table = [f"{t:10.3f} ms  {name}" for name, t in by_kernel.most_common(80)]
    (out_dir / "train_step_profile.txt").write_text("\n".join(lines + [""] + table) + "\n")


def phase_training(smi: str, profile_dir: Optional[str] = None) -> dict:
    """GPT-2 medium (the JAX training bench's B8 S512 model), at S1024."""
    from photonic_flash_attention_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    from photonic_flash_attention_tpu_torch.training import Trainer, synthetic_lm_batches

    cfg = GPT2Config.medium()
    model = GPT2LMHead(cfg, generator=torch.Generator().manual_seed(0))
    first_layers = {k: v.clone() for k, v in model.state_dict().items()
                    if not k.startswith("h.") or int(k.split(".")[1]) < CHECK_LAYERS}
    model.to("cuda")
    # optax.adamw(1e-4)'s defaults (torch's default weight decay is 1e-2).
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)
    trainer = Trainer(model, opt)
    state = trainer.init_state()
    batch = next(synthetic_lm_batches(batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                                      vocab=cfg.vocab_size, seed=0))
    state, _ = trainer.train_step(state, batch)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    _build.reset_launches()
    losses, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, metrics = trainer.train_step(state, batch)
        losses.append(float(metrics["loss"]))  # synchronizes
        step_ms.append(1e3 * (time.perf_counter() - t0))
    launches = dict(_build.LAUNCHES)

    need = cfg.n_layer * TRAIN_STEPS
    for name in TRAIN_KERNELS:
        if launches.get(name, 0) != need:
            raise AssertionError(f"{name}: {launches.get(name, 0)} launches in the "
                                 f"training path, expected {need}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"training path: loss did not fall over {TRAIN_STEPS} steps: {losses}")
    wall = sum(step_ms) / 1e3
    tokens = TRAIN_STEPS * TRAIN_BATCH * TRAIN_SEQ
    print(f"training path: GPT-2 medium B{TRAIN_BATCH} S{TRAIN_SEQ}, {TRAIN_STEPS} AdamW steps "
          f"in {wall:.3f} s, {tokens / wall:.1f} tokens/s, step ms "
          f"{[round(t, 3) for t in step_ms]} (median {statistics.median(step_ms):.3f}), "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({smi}); "
          f"losses {[round(x, 4) for x in losses]}; launches {launches}", flush=True)
    if profile_dir:
        profile_train_step(trainer, state, batch, Path(profile_dir))
    del trainer, opt, model, state
    torch.cuda.empty_cache()
    check_train_grads(cfg, first_layers, batch)
    return launches


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", metavar="DIR",
                        help="also profile one training step; write the table into DIR")
    args = parser.parse_args()
    smi = phase_device()
    phase_build()
    results = phase_kernels()
    launches = collections.Counter(phase_serving(smi))
    launches.update(phase_training(smi, args.profile))
    kernels = [
        {
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches.get(name, 0),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
        }
        for name, r in results.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
