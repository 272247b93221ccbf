"""Command-line interface: benchmark / calibrate / serve-bench / device-info.

Port of ``photonic_flash_attention_tpu/cli.py`` with the same subcommands,
defaults and JSON keys, on one CUDA GPU:

* ``benchmark`` — sweep batch x seq (default {128..4096} x {1, 2, 4, 8},
  width 768, 12 heads, bf16) through ``AttentionEngine`` after a warm-up;
  latency stats, tokens/s and the kind the engine chose per row.
* ``calibrate`` — random patterns through the quantized functions (K1's
  fp8-QK, int8-QK and int8-full modes, the unrolled int8-QK entry, K6 fp8
  and int8), error against the fp32 oracle, the same gates (0.1, and 0.05
  for the per-tensor modes), and the tensor round trip of
  ``ops.quantization``. The numpy draws are JAX's, in JAX's order. On the
  card V is fed in bf16 (K1's quantized modes take bf16 V there) and the
  oracle sees the same bf16 values; on the CPU V stays fp32. The report
  says which (``v_dtype``).
* ``serve-bench`` — GPT-2 (tiny, small, medium) with zero weights through
  ``ServingEngine`` with a bf16 and an int8 paged KV cache: prefill time,
  decode ms per step and tokens/s of a second (steady) pass.
* ``device-info`` — the CUDA devices, their memory and the config.

``--device`` (default ``cuda``) stands where JAX reads ``JAX_PLATFORMS``:
``cpu`` runs the plain versions of the kernels (the tests use it); ``cuda``
without a GPU raises. JAX's XLA compile cache has no counterpart here.

Run as ``pfa-torch <command>`` or
``python -m photonic_flash_attention_tpu_torch.cli <command>``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .config import get_config
from .utils.logging import get_logger, setup_logging

logger = get_logger("cli")


def _device(args: argparse.Namespace) -> torch.device:
    """The device a command runs on; ``cuda`` without a GPU raises."""
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA GPU and none is available; "
                           "pass --device cpu to run the plain versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"--device must be cuda or cpu, got {args.device}")
    return dev


def _backend(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def benchmark(args: argparse.Namespace) -> int:
    """Sweep the engine over the benchmark grid."""
    from .core.engine import AttentionEngine
    from .core.router import AdaptiveRouter

    dev = _device(args)
    seqs = args.seq_lengths or [128, 256, 512, 1024, 2048, 4096]
    batches = args.batch_sizes or [1, 2, 4, 8]
    d_model, heads = args.embed_dim, args.num_heads
    head_dim = d_model // heads
    rng = np.random.default_rng(0)
    eng = AttentionEngine(router=AdaptiveRouter(exploration_rate=0.0, seed=0))

    def bf16(shape):
        return torch.from_numpy(rng.standard_normal(shape)).to(device=dev, dtype=torch.bfloat16)

    results: List[Dict[str, Any]] = []
    for seq in seqs:
        for batch in batches:
            shape = (batch, seq, heads, head_dim)
            q, k, v = bf16(shape), bf16(shape), bf16(shape)
            # Warm-up: the engine measures every eligible kind here.
            for _ in range(args.warmup):
                eng(q, k, v, causal=args.causal)
            lat = []
            for _ in range(args.iterations):
                t0 = time.perf_counter()
                eng(q, k, v, causal=args.causal)
                _sync(dev)
                lat.append((time.perf_counter() - t0) * 1e3)
            mean = statistics.mean(lat)
            energy = eng.last_energy_mj
            row = {
                "batch_size": batch,
                "seq_length": seq,
                "latency_ms": {
                    "mean": round(mean, 3),
                    "std": round(statistics.pstdev(lat), 3),
                    "min": round(min(lat), 3),
                    "max": round(max(lat), 3),
                },
                "tokens_per_second": round(batch * seq / (mean / 1e3), 1),
                "kernel_used": eng.last_kernel_used,
                "energy_mj": None if energy is None else round(energy, 3),
            }
            results.append(row)
            print(
                f"b={batch:<3d} s={seq:<5d} {mean:8.3f} ms  "
                f"{row['tokens_per_second']:>12,.0f} tok/s  [{eng.last_kernel_used}]"
            )

    payload = {
        "benchmark": "attention_engine",
        "config": {
            "embed_dim": d_model,
            "num_heads": heads,
            "causal": args.causal,
            "iterations": args.iterations,
            "backend": _backend(dev),
        },
        "engine_stats": eng.get_performance_stats(),
        "results": results,
    }
    if args.output:
        with open(args.output, "w") as f:
            json.dump(payload, f, indent=1, default=str)
        print(f"wrote {args.output}")
    return 0


def _attn_rel_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    num = float(torch.linalg.norm((out - ref).float()))
    den = float(torch.linalg.norm(ref.float()))
    return num / max(den, 1e-9)


def calibrate(args: argparse.Namespace) -> int:
    """Quantization error sweep: every quantized function the router can
    prefer, against the fp32 oracle."""
    from .ops.flash_fp8 import (
        flash_attention_fp8qk,
        flash_attention_int8full,
        flash_attention_int8qk,
        flash_attention_quant,
    )
    from .ops.flash_unrolled import flash_attention_unrolled
    from .ops.quantization import quantization_error, quantize
    from .ops.reference import attention_reference

    dev = _device(args)
    v_dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    rng = np.random.default_rng(args.seed)
    report: Dict[str, Any] = {"modes": {}, "patterns": args.patterns,
                              "v_dtype": str(v_dtype).replace("torch.", "")}

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    def pattern(scale: float):
        """q, k, v (1, 256, 4, 64) in JAX's draw order; V in ``v_dtype``."""
        q = f32(rng.standard_normal((1, 256, 4, 64)))
        k = f32(rng.standard_normal((1, 256, 4, 64)))
        v = f32(rng.standard_normal((1, 256, 4, 64)) * scale).to(v_dtype)
        ref, _ = attention_reference(q, k, v.float())
        return q, k, v, ref

    kernel_variants = {
        "fp8qk": lambda q, k, v: flash_attention_fp8qk(q, k, v, block_kv=128),
        "int8qk": lambda q, k, v: flash_attention_int8qk(q, k, v, block_kv=128),
        "int8full": lambda q, k, v: flash_attention_int8full(q, k, v, block_kv=128),
        "unrolled_int8qk": lambda q, k, v: flash_attention_unrolled(q, k, v, int8_qk=True),
    }
    with torch.no_grad():
        for mode, kernel in kernel_variants.items():
            attn_errs = []
            for _ in range(args.patterns):
                scale = 10.0 ** rng.uniform(-1, 1)
                q, k, v, ref = pattern(scale)
                attn_errs.append(_attn_rel_err(kernel(q, k, v), ref))
            report["modes"][mode] = {
                "attention_rel_err_mean": float(np.mean(attn_errs)),
                "attention_rel_err_max": float(np.max(attn_errs)),
                "passes_reference_gate": bool(np.max(attn_errs) < 0.1),
                "passes_internal_gate": bool(np.max(attn_errs) < 0.05),
            }
            m = report["modes"][mode]
            print(
                f"{mode}: attention rel-err mean {m['attention_rel_err_mean']:.4f} "
                f"max {m['attention_rel_err_max']:.4f}  "
                f"gate(<0.1): {'PASS' if m['passes_reference_gate'] else 'FAIL'}  "
                f"internal(<0.05): {'PASS' if m['passes_internal_gate'] else 'FAIL'}"
            )

        for mode, qdtype in (("fp8", torch.float8_e4m3fn), ("int8", torch.int8)):
            tensor_errs, attn_errs = [], []
            for _ in range(args.patterns):
                scale = 10.0 ** rng.uniform(-1, 1)
                x = f32(rng.standard_normal((4, 256, 64)) * scale)
                qt = quantize(x, qdtype, axis=1, block_size=128)
                tensor_errs.append(quantization_error(x, qt)["mean_rel_err"])
                q, k, v, ref = pattern(scale)
                out = flash_attention_quant(q, k, v, qdtype=mode, block_kv=128)
                attn_errs.append(_attn_rel_err(out, ref))
            report["modes"][mode] = {
                "tensor_mean_rel_err": float(np.mean(tensor_errs)),
                "tensor_accuracy": float(1.0 - np.mean(tensor_errs)),
                "attention_rel_err_mean": float(np.mean(attn_errs)),
                "attention_rel_err_max": float(np.max(attn_errs)),
                "passes_reference_gate": bool(np.max(attn_errs) < 0.1),
            }
            m = report["modes"][mode]
            print(
                f"{mode}: tensor acc {m['tensor_accuracy']:.4f}  "
                f"attention rel-err mean {m['attention_rel_err_mean']:.4f} "
                f"max {m['attention_rel_err_max']:.4f}  "
                f"gate(<0.1): {'PASS' if m['passes_reference_gate'] else 'FAIL'}"
            )

    if args.output:
        with open(args.output, "w") as f:
            json.dump(report, f, indent=1)
        print(f"wrote {args.output}")
    return 0 if all(m["passes_reference_gate"] for m in report["modes"].values()) else 1


def _zero_state(cfg, dev: torch.device) -> Dict[str, torch.Tensor]:
    """A GPT-2 state_dict of zeros (decode cost does not depend on the
    weights); the module is built on the meta device, so nothing is drawn."""
    from .models.gpt2 import GPT2LMHead

    with torch.device("meta"):
        model = GPT2LMHead(cfg)
    return {name: torch.zeros(t.shape, dtype=t.dtype, device=dev)
            for name, t in model.state_dict().items()}


def serve_bench(args: argparse.Namespace) -> int:
    """Continuous-batching decode benchmark: GPT-2 over a paged KV cache,
    bf16 against int8 KV."""
    from .core.serving import ServingEngine
    from .models.gpt2 import GPT2Config

    dev = _device(args)
    cfg = {
        "tiny": GPT2Config.tiny,
        "small": GPT2Config.small,
        "medium": GPT2Config.medium,
    }[args.model]()
    state = _zero_state(cfg, dev)

    rng = np.random.default_rng(0)
    report: Dict[str, Any] = {"model": args.model, "config": vars(args), "modes": {}}
    for mode, kv_dtype in (("bf16", torch.bfloat16), ("int8", torch.int8)):
        if args.kv_dtype not in ("both", mode):
            continue
        pages_per_seq = max(4, -(-(args.prompt_len + args.new_tokens) // args.page_size))
        num_pages = args.num_pages or args.batch * pages_per_seq + 8
        prompts = [
            [int(t) for t in rng.integers(0, cfg.vocab_size, args.prompt_len)]
            for _ in range(args.batch)
        ]

        eng = ServingEngine(
            cfg,
            state,
            device=dev,
            kv_dtype=kv_dtype,
            max_batch=args.batch,
            num_pages=num_pages,
            page_size=args.page_size,
            max_pages_per_seq=pages_per_seq,
            decode_window=args.decode_window,
            prefill_chunk=args.prefill_chunk,
            temperature=args.temperature,
            top_k=args.top_k,
            seed=args.sample_seed,
        )

        def one_pass():
            """Full generate pass; returns (prefill_s, decode_s, stats)."""
            eng.reset_performance_stats()
            for p in prompts:
                eng.submit(p, args.new_tokens)
            t0 = time.perf_counter()
            eng.step()  # admission + all prefills (+ the first decode window)
            _sync(dev)
            t_prefill = time.perf_counter() - t0
            t0 = time.perf_counter()
            while eng.step() > 0:
                pass
            _sync(dev)
            t_decode = time.perf_counter() - t0
            return t_prefill, t_decode, eng.get_performance_stats()

        # Pass 1 pays the kernels' first launches, the allocator's growth
        # and, on the card, the decode graphs' captures (the engine keeps
        # them, as JAX keeps its compiled windows); pass 2 is the steady
        # state reported.
        one_pass()
        t_prefill, t_decode, st = one_pass()
        dec_s = max(st["decode_steps"], 1)
        row = {
            "prefill_s": round(t_prefill, 4),
            "decode_wall_s": round(t_decode, 4),
            "decode_ms_per_step": round(
                st["decode_tokens"] / max(st["decode_tokens_per_s"], 1e-9) / dec_s * 1e3, 3
            ),
            **st,
        }
        report["modes"][mode] = row
        print(
            f"{mode}: prefill {t_prefill * 1e3:8.1f} ms   decode "
            f"{row['decode_ms_per_step']:7.2f} ms/step   "
            f"{row['decode_tokens_per_s']:>10,.0f} tok/s"
        )
    if args.kv_dtype == "both" and "bf16" in report["modes"] and "int8" in report["modes"]:
        sp = (report["modes"]["bf16"]["decode_ms_per_step"]
              / max(report["modes"]["int8"]["decode_ms_per_step"], 1e-9))
        report["int8_decode_speedup"] = round(sp, 3)
        print(f"int8 KV decode speedup: {sp:.2f}x")
    if args.output:
        with open(args.output, "w") as f:
            json.dump(report, f, indent=1, default=str)
        print(f"wrote {args.output}")
    return 0


def device_info(args: argparse.Namespace) -> int:
    """Device and memory report."""
    from .utils.monitoring import device_memory_stats

    dev = _device(args)
    cfg = get_config()
    devices = []
    if dev.type == "cuda":
        for i in range(torch.cuda.device_count()):
            devices.append({
                "id": i,
                "platform": "gpu",
                "device_kind": torch.cuda.get_device_name(i),
                "process_index": 0,
                **{k: v for k, v in device_memory_stats(torch.device("cuda", i)).items()
                   if k not in ("platform", "device")},
            })
    else:
        devices.append({"id": 0, "platform": "cpu", "device_kind": "cpu", "process_index": 0})
    payload = {
        "backend": "gpu" if dev.type == "cuda" else "cpu",
        "device_count": len(devices),
        "process_count": 1,
        "devices": devices,
        "config": cfg.to_dict(),
    }
    if args.json:
        print(json.dumps(payload, indent=1, default=str))
    else:
        print(f"backend: {payload['backend']}  devices: {payload['device_count']}")
        for d in devices:
            mem = ""
            if d.get("bytes_limit"):
                mem = f"  hbm {d.get('bytes_in_use', 0) / 1e9:.2f}/{d['bytes_limit'] / 1e9:.1f} GB"
            print(f"  [{d['id']}] {d['device_kind']}{mem}")
        print(f"router: flash_threshold={cfg.flash_threshold} quant={cfg.quant_mode}")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="pfa-torch", description="CUDA attention engine CLI")
    parser.add_argument("--log-level", default=None)
    sub = parser.add_subparsers(dest="command", required=True)
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="cuda (the default; raises without a GPU) or cpu")

    b = sub.add_parser("benchmark", parents=[common], help="latency/throughput sweep")
    b.add_argument("--seq-lengths", type=int, nargs="+", default=None)
    b.add_argument("--batch-sizes", type=int, nargs="+", default=None)
    b.add_argument("--embed-dim", type=int, default=768)
    b.add_argument("--num-heads", type=int, default=12)
    b.add_argument("--iterations", type=int, default=10)
    b.add_argument("--warmup", type=int, default=3)
    b.add_argument("--causal", action="store_true")
    b.add_argument("--output", "-o", default=None)
    b.set_defaults(fn=benchmark)

    c = sub.add_parser("calibrate", parents=[common], help="quantization error sweep")
    c.add_argument("--patterns", type=int, default=8)
    c.add_argument("--seed", type=int, default=0)
    c.add_argument("--output", "-o", default=None)
    c.set_defaults(fn=calibrate)

    s = sub.add_parser("serve-bench", parents=[common], help="paged-KV decode benchmark")
    s.add_argument("--model", choices=("tiny", "small", "medium"), default="small")
    s.add_argument("--batch", type=int, default=8)
    s.add_argument("--prompt-len", type=int, default=128)
    s.add_argument("--new-tokens", type=int, default=64)
    # None = auto-size: batch * pages-per-seq + slack.
    s.add_argument("--num-pages", type=int, default=None)
    s.add_argument("--page-size", type=int, default=128)
    s.add_argument("--kv-dtype", choices=("bf16", "int8", "both"), default="both")
    # Decode steps per host round-trip.
    s.add_argument("--decode-window", type=int, default=16)
    # Chunked prefill: page-aligned chunk size (None = single-shot).
    s.add_argument("--prefill-chunk", type=int, default=None)
    # Sampling: temperature 0 = greedy; top-k 0 = no truncation.
    s.add_argument("--temperature", type=float, default=0.0)
    s.add_argument("--top-k", type=int, default=0)
    s.add_argument("--sample-seed", type=int, default=0)
    s.add_argument("--output", "-o", default=None)
    s.set_defaults(fn=serve_bench)

    d = sub.add_parser("device-info", parents=[common], help="device / memory report")
    d.add_argument("--json", action="store_true")
    d.set_defaults(fn=device_info)

    args = parser.parse_args(argv)
    setup_logging(level=args.log_level)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
