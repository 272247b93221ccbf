"""Fixed-max flash attention (VFA's precomputed row bound): kernel K13.

Port of ``benchmarks/flash_fixedmax_experiment.py``. With an upper bound M
of each query row's scaled scores, the online softmax loses its running
max, its alpha and its accumulator rescale:

    p = exp(s - M);  l += sum(p);  acc += p @ V;   out = acc / l

and the final division cancels the uniform exp(m_true - M), exactly while
M - m_true stays inside fp32's exp range (~87; the bound is not clamped).
M is Cauchy-Schwarz, scale * ||q_row|| * max_j ||k_j||, computed in fp32
plain PyTorch (:func:`fixed_max_bound`; XLA in JAX). ``fast_exp`` swaps
the exp for the Schraudolph bit trick with JAX's constants, clip included
(a masked key gives 2^-126, not 0).

* :func:`flash_fixedmax` computes the bound and launches K13
  (:func:`fixedmax_kernel`) for CUDA tensors, bf16 and D in {64, 128}
  (fp32 on the card raises: JAX's fp32 dots run bf16 passes on the TPU),
  and runs :func:`flash_fixedmax_plain` for CPU tensors. K13 is the
  experiments' Hopper body (``csrc/flash_experiments_sm90.cu``,
  ``flash_fixedmax_sm90``: TMA ring, ``wgmma``, warp-specialised, on K1's
  persistent grid) with the fixed-max step, entered by
  ``pfa_flash_fixedmax_sm90`` with
  :func:`~.flash_pipeline_experiment.k13_plan` (K16's plan) and counted as
  ``pfa_flash_fixedmax``, or ``pfa_flash_fixedmax_fast`` in ``fast_exp``
  mode. It takes 16-byte-aligned bases, sm_scale > 0 and S <= 65536.
* ``block_q``/``block_kv`` are JAX's TPU tiles: the plain version walks
  them, the card kernel its own (128-row work tiles, key tiles of K1's
  width). A length that is not a multiple of them raises (JAX's grid
  would leave the tail uncomputed).
* q/k/v (B, S, H, D), no GQA; the causal mask is ``col <= row``
  (top-left), which for these square shapes is K1's.

``main`` is the counterpart of JAX's: three geometries, each timed against
K1 (``ops/flash.py::flash_attention``), with the error of both exp modes
against the fp32 oracle on a (1, 1024) slice.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import _build
from ..ops.flash import flash_attention
from ..ops.reference import DEFAULT_MASK_VALUE, softmax_scale
from . import _common as C
from . import flash_pipeline_experiment as ux

__all__ = ["fixed_max_bound", "fixedmax_kernel", "flash_fixedmax", "flash_fixedmax_plain", "main",
           "schraudolph_exp"]

#: JAX's geometries: (name, (B, S, H, D), causal).
CASES = (
    ("b4_s2048_h12_d64_causal", (4, 2048, 12, 64), True),
    ("b1_s8192_h12_d64_causal", (1, 8192, 12, 64), True),
    ("b1_s8192_h12_d64_nc", (1, 8192, 12, 64), False),
)
#: JAX's fit counts (``bench(iters=(8, 40))``).
FIT = (8, 40)
CARD_HEAD_DIMS = (64, 128)


def schraudolph_exp(x: torch.Tensor) -> torch.Tensor:
    """JAX's Schraudolph exp of fp32 ``x``: int32(clip(x * 12102203 +
    1064986823, 2^23, 2139095039)) read as fp32 (the constants round to
    fp32 as jnp.float32 rounds them)."""
    y = torch.clamp(x * 12102203.0 + 1064986823.0, 8388608.0, 2139095039.0)
    return y.to(torch.int32).view(torch.float32)


def fixed_max_bound(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """(B, H, S) fp32: scale * ||q_row||_2 * max_j ||k_j||_2 per (b, h),
    the prolog of JAX's ``flash_fixedmax``."""
    qn = torch.linalg.vector_norm(q, dim=-1, dtype=torch.float32).transpose(1, 2)  # (B, H, S)
    kmax = torch.linalg.vector_norm(k, dim=-1, dtype=torch.float32).amax(dim=1)  # (B, H)
    return ((qn * kmax[..., None]) * scale).contiguous()


def _check(q, k, v, block_q: int, block_kv: int) -> None:
    C.check_qkv(q, k, v)
    C.check_blocks(q.shape[1], block_q, "block_q")
    C.check_blocks(q.shape[1], block_kv, "block_kv")


def flash_fixedmax_plain(q, k, v, *, causal: bool = False, sm_scale: Optional[float] = None,
                         block_q: int = 512, block_kv: int = 512,
                         fast_exp: bool = False) -> torch.Tensor:
    """K13's plain version, JAX's blocks and arithmetic: s = q.k^T * scale
    per (block_q, block_kv) block, blocks wholly above the diagonal skipped,
    masked scores at ``DEFAULT_MASK_VALUE``, x = s - M, p = exp(x) (or
    :func:`schraudolph_exp`), l += sum p, acc += p.astype(v.dtype) V; out = acc / l
    (l == 0 -> 1) in q's dtype."""
    _check(q, k, v, block_q, block_kv)
    b, s, h, d = q.shape
    scale = softmax_scale(d, sm_scale)
    fm = fixed_max_bound(q, k, scale)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    out = torch.empty(b, h, s, d, dtype=torch.float32, device=q.device)
    for qi in range(s // block_q):
        r0 = qi * block_q
        qb = qt[:, :, r0:r0 + block_q].float()
        l = torch.zeros(b, h, block_q, 1, dtype=torch.float32, device=q.device)
        acc = torch.zeros(b, h, block_q, d, dtype=torch.float32, device=q.device)
        for ki in range(s // block_kv):
            c0 = ki * block_kv
            if causal and c0 > r0 + block_q - 1:
                continue
            sc = (qb @ kt[:, :, c0:c0 + block_kv].float().transpose(-1, -2)) * scale
            if causal:
                row = torch.arange(r0, r0 + block_q, device=q.device)[:, None]
                col = torch.arange(c0, c0 + block_kv, device=q.device)[None, :]
                sc = torch.where(col <= row, sc, torch.tensor(DEFAULT_MASK_VALUE, device=q.device))
            x = sc - fm[:, :, r0:r0 + block_q, None]
            p = schraudolph_exp(x) if fast_exp else torch.exp(x)
            l = l + p.sum(dim=-1, keepdim=True)
            acc = acc + p.to(v.dtype).float() @ vt[:, :, c0:c0 + block_kv].float()
        out[:, :, r0:r0 + block_q] = acc * torch.where(l == 0.0, torch.ones_like(l), 1.0 / l)
    return out.to(q.dtype).transpose(1, 2)


def fixedmax_kernel(q, k, v, fm: torch.Tensor, *, causal: bool, sm_scale: float,
                    fast_exp: bool) -> torch.Tensor:
    """K13 alone on CUDA tensors, given the bound ``fm`` (B, H, S) fp32 of
    :func:`fixed_max_bound` (the kernel's time without the prolog's): one
    launch of the Hopper body by :func:`~.flash_pipeline_experiment.k13_plan`."""
    name = "K13 pfa_flash_fixedmax"
    C.check_card(q, (torch.bfloat16,), CARD_HEAD_DIMS, name, k, v, fm)
    b, s, h, d = q.shape
    if fm.dtype != torch.float32 or tuple(fm.shape) != (b, h, s):
        raise ValueError(f"fm must be ({b}, {h}, {s}) fp32, got {tuple(fm.shape)} {fm.dtype}")
    ux._check_sm90(name, sm_scale, q, k, v)
    plan = ux.k13_plan(b, s, h, d, causal, ux._sms(q.device))
    o = torch.empty_like(q)
    _build.launch("pfa_flash_fixedmax_sm90", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  o.data_ptr(), fm.data_ptr(), b, s, h, d, float(sm_scale), int(causal),
                  int(fast_exp), plan.tile_keys, plan.stages, plan.smem, plan.grid,
                  ux._c_walk(plan.walk),
                  count_as="pfa_flash_fixedmax_fast" if fast_exp else "pfa_flash_fixedmax")
    return o


def flash_fixedmax(q, k, v, *, causal: bool = False, sm_scale: Optional[float] = None,
                   block_q: int = 512, block_kv: int = 512, fast_exp: bool = False
                   ) -> torch.Tensor:
    """q/k/v (B, S, H, D) -> (B, S, H, D) in q's dtype. K13 on the card,
    :func:`flash_fixedmax_plain` on the CPU."""
    _check(q, k, v, block_q, block_kv)
    scale = softmax_scale(q.shape[-1], sm_scale)
    return C.on_device(
        q,
        lambda: fixedmax_kernel(q, k, v, fixed_max_bound(q, k, scale), causal=causal,
                                sm_scale=scale, fast_exp=fast_exp),
        lambda: flash_fixedmax_plain(q, k, v, causal=causal, sm_scale=sm_scale, block_q=block_q,
                                     block_kv=block_kv, fast_exp=fast_exp),
    )


def main(device: Optional[str] = None, *, cases: Sequence = CASES,
         fit: Tuple[int, int] = FIT, slice_len: int = 1024) -> Dict[str, dict]:
    """JAX's ``main``: per geometry (bf16 inputs from numpy seed 0) the
    error of both exp modes against the fp32 oracle on the first batch row
    and ``slice_len`` positions (fp32 on the CPU, bf16 on the card), then
    fixed-max, fast_exp (their prolog included, as JAX times them) and K1
    timed; on the card also K13 alone in both modes, the bound
    precomputed. Returns the rows by name."""
    dev = C.resolve_device(device)
    rng = np.random.default_rng(0)
    rows = {}
    for name, (b, s, h, d), causal in cases:
        q, k, v = (C.normal(rng, (b, s, h, d), torch.bfloat16, dev) for _ in range(3))
        qs, ks, vs = (x[:1, :slice_len].to(C.work_dtype(dev)) for x in (q, k, v))
        ref = C.oracle(qs, ks, vs, causal=causal)
        blk = min(512, slice_len)
        err = C.rel_err_norm(flash_fixedmax(qs, ks, vs, causal=causal, block_q=blk,
                                            block_kv=blk), ref)
        err_f = C.rel_err_norm(flash_fixedmax(qs, ks, vs, causal=causal, block_q=blk,
                                              block_kv=blk, fast_exp=True), ref)
        blk = min(512, s)
        t_fixed = C.timed_ms(lambda: flash_fixedmax(q, k, v, causal=causal, block_q=blk,
                                                    block_kv=blk), dev, fit)
        t_fast = C.timed_ms(lambda: flash_fixedmax(q, k, v, causal=causal, block_q=blk,
                                                   block_kv=blk, fast_exp=True), dev, fit)
        t_base = C.timed_ms(lambda: flash_attention(q, k, v, causal=causal), dev, fit)
        flops = C.attention_flops(b, s, h, d, causal)
        rows[name] = {"shape": (b, s, h, h, d), "causal": causal, "fixedmax_ms": t_fixed,
                      "fast_exp_ms": t_fast, "k1_ms": t_base, "flops": flops,
                      "rel_err": err, "fast_rel_err": err_f}
        line = (f"{name} ({dev.type}): fixedmax {t_fixed:.4f} ms ({flops / t_fixed / 1e9:.1f} "
                f"TF/s) fastexp {t_fast:.4f} ms ({flops / t_fast / 1e9:.1f}) vs flash (K1) "
                f"{t_base:.4f} ms ({flops / t_base / 1e9:.1f})  rel-err {err:.2e} fast-err "
                f"{err_f:.2e}")
        if dev.type == "cuda":  # K13 alone, the bound precomputed (the prolog is plain torch)
            fm = fixed_max_bound(q, k, d ** -0.5)
            for key, fast in (("kernel_ms", False), ("fast_kernel_ms", True)):
                rows[name][key] = C.timed_ms(
                    lambda: fixedmax_kernel(q, k, v, fm, causal=causal, sm_scale=d ** -0.5,
                                            fast_exp=fast), dev, fit)
            line += (f"; kernel alone {rows[name]['kernel_ms']:.4f} ms, fastexp "
                     f"{rows[name]['fast_kernel_ms']:.4f} ms")
        print(line, flush=True)
    return rows


if __name__ == "__main__":
    C.cli(main, __doc__.splitlines()[0])
