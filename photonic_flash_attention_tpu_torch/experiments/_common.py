"""What the experiment modules share: argument checks, the blockwise
online-softmax plain version, timing, the oracle and the command line.

The JAX files each carry their own copy of ``_timed``/``bench`` (a scan of
chained calls, two-point linear fit); the port times with
``core/timing.py::fit_seconds``: on the card a CUDA graph of n calls, on
the CPU wall clock.
"""

from __future__ import annotations

import argparse
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..core.timing import fit_seconds
from ..ops.reference import DEFAULT_MASK_VALUE, attention_reference, repeat_kv

#: JAX's ``NEG_INF`` of the pipeline experiment (its mask and initial max).
NEG_INF = -1e30


def resolve_device(device: Optional[str]) -> torch.device:
    """The device a ``main`` runs on: the card unless the caller asks for
    the CPU; the card must exist then."""
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass device='cpu' for the plain versions")
    return dev


def check_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, gqa: bool = False,
              same_len: bool = True) -> None:
    """q (B, Sq, H, D), k/v (B, Skv, Hkv, D) on one device in one dtype;
    Hkv == H unless ``gqa`` (then H % Hkv == 0); Skv == Sq if ``same_len``."""
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"expected q (B,S,H,D) and k/v (B,S,Hkv,D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"batch/head_dim mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}")
    if same_len and k.shape[1] != s:
        raise ValueError(f"q and k/v need the same length, got {s} and {k.shape[1]}")
    hkv = k.shape[2]
    if gqa and h % hkv:
        raise ValueError(f"GQA: Hq % Hkv must be 0, got Hq {h}, Hkv {hkv}")
    if not gqa and hkv != h:
        raise ValueError(f"no GQA: Hkv must equal H, got H {h}, Hkv {hkv}")
    if not (q.dtype == k.dtype == v.dtype) or not (q.device == k.device == v.device):
        raise ValueError(f"q/k/v differ in dtype or device: {q.dtype}/{k.dtype}/{v.dtype}, "
                         f"{q.device}/{k.device}/{v.device}")


def check_blocks(length: int, block: int, name: str) -> None:
    """JAX's grid ``length // block`` leaves a ragged tail uncomputed; the
    port raises instead."""
    if block <= 0 or length % block:
        raise ValueError(f"{name}: length {length} is not a multiple of the block {block}")


def check_card(q: torch.Tensor, dtypes: Tuple[torch.dtype, ...], head_dims: Tuple[int, ...],
               kernel: str, *tensors: torch.Tensor) -> None:
    """What a card kernel takes: dtype, head dim, contiguous inputs."""
    if q.dtype not in dtypes:
        raise ValueError(f"{kernel} takes {dtypes} on the card, got {q.dtype}")
    if q.shape[-1] not in head_dims:
        raise ValueError(f"{kernel} takes head_dim in {head_dims} on the card, got {q.shape[-1]}")
    for t in (q, *tensors):
        if not t.is_contiguous():
            raise ValueError(f"{kernel} needs contiguous inputs")


def check_aligned(name: str, *tensors: torch.Tensor) -> None:
    """TMA reads 16-byte-aligned bases: the Hopper bodies refuse others."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name} needs 16-byte-aligned inputs on its Hopper body; one "
                             f"starts at {t.data_ptr():#x}")


def on_device(q: torch.Tensor, cuda: Callable[[], torch.Tensor],
              cpu: Callable[[], torch.Tensor]) -> torch.Tensor:
    """``cuda()`` for CUDA tensors, ``cpu()`` for CPU tensors."""
    if q.device.type == "cuda":
        return cuda()
    if q.device.type == "cpu":
        return cpu()
    raise ValueError(f"unsupported device {q.device}")


def online_plain(q, k, v, *, bq: int, bkv: int, causal: bool, scale,
                 scale_q_in_dtype: bool = False, bf16_body: bool = False,
                 mask_value: float = DEFAULT_MASK_VALUE, skip_dead: bool = True,
                 m_init: float = float("-inf"), l_from_cast_p: bool = False) -> torch.Tensor:
    """The experiments' blockwise online softmax in plain PyTorch, block by
    block as the TPU grid walks it: q blocks of ``bq`` rows, kv blocks of
    ``bkv`` keys in order; per block s = q.k^T (fp32), the causal mask
    ``col <= row`` (top-left) at ``mask_value``, m_next = max(m, rowmax),
    p = exp(s - m_next), alpha = exp(m - m_next), l = alpha l + sum p, acc =
    alpha acc + p.astype(v.dtype) V; out = acc / l (l == 0 -> 1) in q's
    dtype. Options, per experiment: ``scale_q_in_dtype`` scales q in its
    dtype before the product (aug, pair) instead of the scores after it;
    ``bf16_body`` casts q, k, v and p to bf16 (pipeline); ``skip_dead``
    skips kv blocks wholly above a q block's diagonal (the pipeline runs
    them, a no-op once m is finite); ``l_from_cast_p`` sums p after its
    cast to V's dtype (aug, whose l comes out of the P.V product).
    ``scale`` may be a (1,) fp32 tensor on q's device (the triangular
    int8 experiment's device scalar; q and k then hold int8 values, exact in
    bf16 and in the fp32 product)."""
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    qt = q.transpose(1, 2)
    kt = repeat_kv(k, h // hkv).transpose(1, 2)
    vt = repeat_kv(v, h // hkv).transpose(1, 2)
    pv_dtype = torch.bfloat16 if bf16_body else v.dtype
    if bf16_body:
        qt, kt, vt = qt.to(torch.bfloat16), kt.to(torch.bfloat16), vt.to(torch.bfloat16)
    if scale_q_in_dtype:
        qt = qt * torch.tensor(scale, dtype=qt.dtype, device=qt.device)
    out = torch.empty(b, h, sq, d, dtype=torch.float32, device=q.device)
    for qi in range(sq // bq):
        r0 = qi * bq
        qb = qt[:, :, r0:r0 + bq].float()
        m = torch.full((b, h, bq, 1), m_init, dtype=torch.float32, device=q.device)
        l = torch.zeros(b, h, bq, 1, dtype=torch.float32, device=q.device)
        acc = torch.zeros(b, h, bq, d, dtype=torch.float32, device=q.device)
        for ki in range(skv // bkv):
            c0 = ki * bkv
            if causal and skip_dead and c0 > r0 + bq - 1:
                continue
            s = qb @ kt[:, :, c0:c0 + bkv].float().transpose(-1, -2)
            if not scale_q_in_dtype:
                s = s * scale
            if causal:
                row = torch.arange(r0, r0 + bq, device=q.device)[:, None]
                col = torch.arange(c0, c0 + bkv, device=q.device)[None, :]
                s = torch.where(col <= row, s, torch.tensor(mask_value, device=q.device))
            m_next = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_next)
            alpha = torch.exp(m - m_next)
            pc = p.to(pv_dtype)
            l = alpha * l + (pc.float() if l_from_cast_p else p).sum(dim=-1, keepdim=True)
            acc = acc * alpha + pc.float() @ vt[:, :, c0:c0 + bkv].float()
            m = m_next
        out[:, :, r0:r0 + bq] = acc * torch.where(l == 0.0, torch.ones_like(l), 1.0 / l)
    return out.to(q.dtype).transpose(1, 2)


def rel_err_norm(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float(torch.linalg.norm(a - b) / max(float(torch.linalg.norm(b)), 1e-30))


def oracle(q, k, v, *, causal: bool) -> torch.Tensor:
    """The fp32 reference (``ops/reference.py``) on square shapes, where its
    end-aligned causal mask is the experiments' ``col <= row``."""
    return attention_reference(q.float(), k.float(), v.float(), causal=causal)[0]


def timed_ms(fn: Callable[[], object], device: torch.device, fit: Tuple[int, int]) -> float:
    """Milliseconds of one ``fn()`` by the two-point fit (``fit_seconds``)."""
    return fit_seconds(fn, fit, device) * 1e3


def attention_flops(b: int, s: int, h: int, d: int, causal: bool) -> float:
    """The experiments' count: 4 B H S^2 D, halved when causal."""
    return 4.0 * b * h * s * s * d * (0.5 if causal else 1.0)


def normal(rng: np.random.Generator, shape, dtype: torch.dtype, device) -> torch.Tensor:
    """Standard normal values from ``rng`` (numpy, as JAX's mains draw
    them), in ``dtype`` on ``device``."""
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return x.to(device=device, dtype=dtype)


def work_dtype(device: torch.device) -> torch.dtype:
    """The dtype of the small parity cases: fp32 on the CPU (as JAX's), bf16
    on the card, the only dtype K13-K15 take there."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32


def cli(main: Callable, description: str, variants: Optional[Dict[str, Callable]] = None) -> None:
    """``python -m ...experiments.<name> [variant] [--device cpu|cuda]``:
    ``main``, or the main of the named variant (JAX's ``sys.argv[1]``)."""
    parser = argparse.ArgumentParser(description=description)
    if variants:
        parser.add_argument("variant", nargs="?", choices=sorted(variants),
                            help="run this variant's main instead of the file's first")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="the card (default) or the plain versions on the CPU")
    args = parser.parse_args()
    (variants[args.variant] if variants and args.variant else main)(device=args.device)
