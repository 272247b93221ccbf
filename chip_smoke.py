"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

Run from the repository root:

    python3 chip_smoke.py

Phases (each prints its lines; any failure raises and exits non-zero):

1. device: CUDA must be available (there is no CPU path);
2. build: compile the port's kernels (csrc/*.cu) with nvcc;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the serving path gives it, with kernel and plain times;
4. main path: GPT-2 medium (random weights, seed 0) served through
   ``ServingEngine.generate`` with an int8 paged KV cache; every kernel's
   launch count must grow; the first step must agree with the dense model.

The last two lines are the per-kernel JSON summary and, last of all,
``{"ok": true, "device": {...}}``. The script imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time

import numpy as np
import torch

from photonic_flash_attention_tpu_torch.ops import _build
from photonic_flash_attention_tpu_torch.ops import flash as flash_ops
from photonic_flash_attention_tpu_torch.ops import paged as paged_ops

SOURCES = {
    "pfa_flash_fwd": "photonic_flash_attention_tpu_torch/csrc/flash_fwd.cu",
    "pfa_paged_token_write": "photonic_flash_attention_tpu_torch/csrc/paged_decode.cu",
    "pfa_paged_decode_attend": "photonic_flash_attention_tpu_torch/csrc/paged_decode.cu",
}
REPLACES = {
    "pfa_flash_fwd": "photonic_flash_attention_tpu/ops/flash.py:59",
    "pfa_paged_token_write": "photonic_flash_attention_tpu/ops/paged.py:407",
    "pfa_paged_decode_attend": "photonic_flash_attention_tpu/ops/paged.py:407",
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


def phase_kernels() -> dict:
    results = {name: {} for name in SOURCES}
    check_flash(results)
    check_token_write(results)
    check_decode_attend(results)
    return results


PROMPT_LENS = (17, 64, 100, 128, 256, 300, 512, 700)
NEW_TOKENS = 33


def phase_main_path(smi: str) -> dict:
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


def main() -> None:
    smi = phase_device()
    phase_build()
    results = phase_kernels()
    launches = phase_main_path(smi)
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
