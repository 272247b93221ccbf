"""The row sum folded into the P.V product (augmented V): kernel K14.

Port of ``benchmarks/flash_aug_experiment.py``. V is augmented with a ones
column, so one P.V product yields [P V | l], with l the sum of p after its
cast to V's dtype; the per-tile l reduction leaves the FP32 pipe for the
matrix unit. The online max and alpha stay. Causal only (``col <= row``,
top-left; K1's diagonal for square shapes), no GQA, d + 1 <= 128.

* :func:`flash_aug` launches K14 (``csrc/flash_experiments_sm90.cu``,
  ``pfa_flash_aug_sm90``, counted as ``pfa_flash_aug``) for CUDA tensors,
  bf16 and D = 64 only, and runs :func:`flash_aug_plain` for CPU tensors.
  K14 is K16's Hopper body (TMA ring, ``wgmma``, a producer warp and two
  consumer warpgroups of 64 rows, 128-key tiles, the Q.K^T-ahead overlap,
  the ping-pong; :func:`~.flash_pipeline_experiment.k14_plan`) with the
  row sum moved onto the tensor cores: after each tile's P.V one more
  ``wgmma`` of N = 8 multiplies the same bf16 P by a constant 16 x 8 block
  whose column 0 is ones, written once into shared memory (JAX pads V to
  the MXU's 128 lanes; no augmented copy of V goes through device memory
  here). Its accumulator, rescaled by alpha with O, holds l; the softmax
  loses its FADD into l. q is not scaled in bf16 first as JAX does: at D 64
  the scale is 2^-3, exact in bf16, so folding it into the exponent is the
  same function. Sq and Skv may differ; bases must be 16-byte aligned.
  What bounds it on the H100 is K1's work: the tensor cores (26.1 us at
  B4 S2048 H12 causal) and, at D 64, the softmax's FP32 and MUFU stream
  beside them (41.1 us, K1's composite ceiling); the ones product trades
  one FADD a score of that stream for 1/8 more P.V on the tensor cores.
* ``bq``/``bkv`` are JAX's TPU tiles: the plain version walks them, the
  card kernel its own 128 x 128 tiles; lengths that are not multiples of
  them raise.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import _build
from ..ops.flash import flash_attention
from . import _common as C
from . import flash_pipeline_experiment as ux

__all__ = ["flash_aug", "flash_aug_plain", "main"]

#: JAX's parity case (q = k = v, fp32) and its gate.
PARITY_SHAPE = (1, 2048, 2, 64)
PARITY_GATE = 3e-3
#: On the card the parity case runs in bf16 (K14's dtype), under K1's bf16
#: bound.
CARD_PARITY_GATE = 1e-2
#: JAX's timed geometries (B, S, H, D), causal.
CASES = ((4, 2048, 12, 64), (1, 8192, 12, 64))
FIT = (20, 120)
NUM_LANES = 128


def _check(q, k, v, bq: int, bkv: int) -> None:
    C.check_qkv(q, k, v, same_len=False)
    if q.shape[-1] + 1 > NUM_LANES:
        raise ValueError(f"flash_aug needs d + 1 <= {NUM_LANES} (the ones column), "
                         f"got d {q.shape[-1]}")
    C.check_blocks(q.shape[1], bq, "bq")
    C.check_blocks(k.shape[1], bkv, "bkv")


def flash_aug_plain(q, k, v, *, bq: int = 512, bkv: int = 512) -> torch.Tensor:
    """K14's plain version on JAX's blocks: q scaled by d^-0.5 in its
    dtype, the causal online softmax, l = the sum of p cast to V's dtype
    (the ones column's product), out = acc / l."""
    _check(q, k, v, bq, bkv)
    return C.online_plain(q, k, v, bq=bq, bkv=bkv, causal=True, scale=q.shape[-1] ** -0.5,
                          scale_q_in_dtype=True, l_from_cast_p=True)


def _aug_cuda(q, k, v) -> torch.Tensor:
    name = "K14 pfa_flash_aug"
    C.check_card(q, (torch.bfloat16,), (64,), name, k, v)
    b, sq, h, d = q.shape
    skv, scale = k.shape[1], d ** -0.5
    ux._check_sm90(name, scale, q, k, v)
    plan = ux.k14_plan(b, sq, skv, h, ux._sms(q.device))
    o = torch.empty_like(q)
    _build.launch("pfa_flash_aug_sm90", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  o.data_ptr(), b, sq, skv, h, d, float(scale), plan.tile_keys, plan.stages,
                  plan.smem, plan.grid, ux._c_walk(plan.walk), count_as="pfa_flash_aug")
    return o


def flash_aug(q, k, v, *, bq: int = 512, bkv: int = 512) -> torch.Tensor:
    """q (B, Sq, H, D), k/v (B, Skv, H, D) -> (B, Sq, H, D), causal. K14 on
    the card, :func:`flash_aug_plain` on the CPU."""
    _check(q, k, v, bq, bkv)
    return C.on_device(q, lambda: _aug_cuda(q, k, v),
                       lambda: flash_aug_plain(q, k, v, bq=bq, bkv=bkv))


def main(device: Optional[str] = None, *, parity_shape=PARITY_SHAPE, cases: Sequence = CASES,
         fit: Tuple[int, int] = FIT, slice_len: int = 1024) -> Dict[str, dict]:
    """JAX's ``main``: the parity case q = k = v against the fp32 oracle
    (fp32 under JAX's 3e-3 on the CPU, bf16 under 1e-2 on the card), then
    per geometry K1 and flash_aug timed, with flash_aug's error against the
    oracle on a (1, ``slice_len``) slice. Returns the rows by name."""
    dev = C.resolve_device(device)
    rng = np.random.default_rng(0)
    gate = CARD_PARITY_GATE if dev.type == "cuda" else PARITY_GATE
    x = C.normal(rng, parity_shape, C.work_dtype(dev), dev)
    blk = min(512, parity_shape[1])
    err = C.rel_err_norm(flash_aug(x, x, x, bq=blk, bkv=blk), C.oracle(x, x, x, causal=True))
    print(f"parity ({dev.type}, {str(x.dtype)[6:]}) rel_err={err:.2e} (gate {gate})", flush=True)
    if not err < gate:
        raise AssertionError(f"flash_aug parity rel_err {err:.3e} >= {gate}")
    rows = {"parity": {"rel_err": err, "gate": gate}}
    for b, s, h, d in cases:
        q, k, v = (C.normal(rng, (b, s, h, d), torch.bfloat16, dev) for _ in range(3))
        qs, ks, vs = (t[:1, :slice_len].to(C.work_dtype(dev)) for t in (q, k, v))
        blk = min(512, slice_len)
        err = C.rel_err_norm(flash_aug(qs, ks, vs, bq=blk, bkv=blk),
                             C.oracle(qs, ks, vs, causal=True))
        fl = C.attention_flops(b, s, h, d, True)
        blk = min(512, s)
        t0 = C.timed_ms(lambda: flash_attention(q, k, v, causal=True), dev, fit)
        t = C.timed_ms(lambda: flash_aug(q, k, v, bq=blk, bkv=blk), dev, fit)
        name = f"B{b} S{s}"
        rows[name] = {"shape": (b, s, h, h, d), "causal": True, "aug_ms": t, "k1_ms": t0,
                      "flops": fl, "rel_err": err}
        print(f"{name} ({dev.type}) baseline (K1): {t0:.4f} ms {fl / t0 / 1e9:.1f} TFLOP/s | "
              f"aug: {t:.4f} ms {fl / t / 1e9:.1f} TFLOP/s, rel-err {err:.2e}", flush=True)
    return rows


if __name__ == "__main__":
    C.cli(main, __doc__.splitlines()[0])
