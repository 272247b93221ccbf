"""Independent query chains against one staged K/V tile: kernel K15.

Port of ``benchmarks/flash_pair_experiment.py``. ``nchain`` q blocks run
their own online softmax against the same K/V tile of a step: independent
dataflow chains, so one chain's exps can overlap another's products, and
one K/V fill serves ``nchain`` blocks. Each chain computes plain flash
attention: causal only (``col <= row``, top-left; K1's diagonal for square
shapes), no GQA, Sq % (nchain * bq) == 0.

* :func:`flash_pair` launches K15 (``csrc/flash_experiments_sm90.cu``,
  ``pfa_flash_pair_sm90``, counted as ``pfa_flash_pair``) for CUDA tensors,
  bf16 and D = 64, with nchain in :data:`CARD_NCHAINS`, and runs
  :func:`flash_pair_plain` for CPU tensors. On the card a chain is a
  consumer warpgroup of 64 rows and a work tile ``nchain`` of them, on the
  experiments' Hopper body (a producer warp issuing TMA loads into an
  mbarrier ring, ``wgmma``, a persistent grid;
  :func:`~.flash_pipeline_experiment.k15_plan`): one TMA fill of a K/V tile
  serves every chain, the chains take turns at the tensor cores round robin
  (FA3's ping-pong over ``nchain`` warpgroups), so one chain's exps run
  beside another's products, and each chain stops at its own diagonal while
  still taking its turns. nchain 1 is one consumer warpgroup with no turns:
  the control the experiments are read against besides K1. Sq and Skv may
  differ; bases must be 16-byte aligned. What bounds it on the H100 is
  K1's work (the tensor cores, and at D 64 the softmax stream beside
  them); more chains put more warpgroups' exps beside the products, and
  the registers a thread can keep set how many: 128-key tiles at nchain
  1-3, 64-key tiles at 4 (a CTA of 640 threads leaves a consumer 112).
* ``bq``/``bkv`` are JAX's TPU tiles: the plain version walks them, the
  card kernel 64-row chains and its own key tiles
  (``K15_TILE_KEYS``); lengths that are not multiples of them raise.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import _build
from ..ops.flash import flash_attention
from . import _common as C
from . import flash_pipeline_experiment as ux

__all__ = ["flash_pair", "flash_pair_plain", "main"]

#: The chain counts K15 takes on the card: each compiles with no spill and
#: no stack (``nvcc -Xptxas -v``) under its setmaxnreg share (csrc/
#: flash_experiments_sm90.cu, ``PAIR_CONSUMER_REGS``).
CARD_NCHAINS = tuple(ux.K15_TILE_KEYS)
#: A length at each nchain whose last work tile of 64 nchain rows holds
#: fewer rows than chains (chains past Sq, and chains that pass their
#: diagonal before the last).
RAGGED_LENGTHS = {1: 96, 2: 192, 3: 288, 4: 320}
PARITY_SHAPE = (1, 2048, 2, 64)
PARITY_GATE = 3e-3
CARD_PARITY_GATE = 1e-2
CASES = ((4, 2048, 12, 64), (1, 8192, 12, 64))
#: JAX's sweep: (bq, bkv, nchain).
SWEEP = ((512, 512, 2), (512, 512, 4), (256, 512, 4), (256, 256, 4), (512, 512, 3))
FIT = (20, 120)


def pair_case(s: int, nchain: int) -> Tuple[int, int]:
    """A length and JAX block that ``nchain`` takes, for the card's checks
    and timings: S with the largest block of 512 ... 16 that divides it
    nchain times over, else the longest length below S that nchain x 128
    divides (2048 -> 1920 at nchain 3), with block 128."""
    for blk in (512, 256, 128, 64, 32, 16):
        if s % (nchain * blk) == 0:
            return s, blk
    return s - s % (nchain * 128), 128


def _check(q, k, v, bq: int, bkv: int, nchain: int) -> None:
    C.check_qkv(q, k, v, same_len=False)
    if nchain < 1:
        raise ValueError(f"nchain must be >= 1, got {nchain}")
    C.check_blocks(q.shape[1], nchain * bq, "nchain * bq")
    C.check_blocks(k.shape[1], bkv, "bkv")


def flash_pair_plain(q, k, v, *, bq: int = 512, bkv: int = 512, nchain: int = 2
                     ) -> torch.Tensor:
    """K15's plain version: each chain is plain causal flash over JAX's
    blocks (q scaled by d^-0.5 in its dtype, l the fp32 sum of p), so the
    function does not depend on ``nchain`` beyond its divisibility check."""
    _check(q, k, v, bq, bkv, nchain)
    return C.online_plain(q, k, v, bq=bq, bkv=bkv, causal=True, scale=q.shape[-1] ** -0.5,
                          scale_q_in_dtype=True)


def _pair_cuda(q, k, v, nchain: int) -> torch.Tensor:
    name = "K15 pfa_flash_pair"
    C.check_card(q, (torch.bfloat16,), (64,), name, k, v)
    if nchain not in CARD_NCHAINS:
        raise ValueError(f"{name} takes nchain in {CARD_NCHAINS} on the card, got {nchain}")
    b, sq, h, d = q.shape
    skv, scale = k.shape[1], d ** -0.5
    ux._check_sm90(name, scale, q, k, v)
    plan = ux.k15_plan(b, sq, skv, h, nchain, ux._sms(q.device))
    o = torch.empty_like(q)
    _build.launch("pfa_flash_pair_sm90", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  o.data_ptr(), b, sq, skv, h, d, float(scale), int(nchain), plan.tile_keys,
                  plan.stages, plan.smem, plan.grid, ux._c_walk(plan.walk),
                  count_as="pfa_flash_pair")
    return o


def flash_pair(q, k, v, *, bq: int = 512, bkv: int = 512, nchain: int = 2) -> torch.Tensor:
    """q (B, Sq, H, D), k/v (B, Skv, H, D) -> (B, Sq, H, D), causal. K15 on
    the card, :func:`flash_pair_plain` on the CPU."""
    _check(q, k, v, bq, bkv, nchain)
    return C.on_device(q, lambda: _pair_cuda(q, k, v, nchain),
                       lambda: flash_pair_plain(q, k, v, bq=bq, bkv=bkv, nchain=nchain))


def main(device: Optional[str] = None, *, parity_shape=PARITY_SHAPE, cases: Sequence = CASES,
         sweep: Optional[Sequence] = None, fit: Tuple[int, int] = FIT,
         slice_len: int = 1024) -> Dict[str, dict]:
    """JAX's ``main``: the parity case q = k = v against the fp32 oracle
    (fp32 under 3e-3 on the CPU, bf16 under 1e-2 on the card), then per
    geometry K1 and each (bq, bkv, nchain) of ``sweep`` timed, with the
    error against the oracle on a (1, ``slice_len``) slice. The default
    sweep is JAX's on the CPU; on the card, where the blocks are the
    kernel's own, one run per nchain in :data:`CARD_NCHAINS`. A case whose
    S is not a multiple of nchain * bq is skipped with a line (JAX's grid
    leaves its tail rows uncomputed)."""
    dev = C.resolve_device(device)
    if sweep is None:
        sweep = tuple((512, 512, n) for n in CARD_NCHAINS) if dev.type == "cuda" else SWEEP
    rng = np.random.default_rng(0)
    gate = CARD_PARITY_GATE if dev.type == "cuda" else PARITY_GATE
    x = C.normal(rng, parity_shape, C.work_dtype(dev), dev)
    blk = min(512, parity_shape[1] // 2)
    err = C.rel_err_norm(flash_pair(x, x, x, bq=blk, bkv=blk), C.oracle(x, x, x, causal=True))
    print(f"parity ({dev.type}, {str(x.dtype)[6:]}) rel_err={err:.2e} (gate {gate})", flush=True)
    if not err < gate:
        raise AssertionError(f"flash_pair parity rel_err {err:.3e} >= {gate}")
    rows = {"parity": {"rel_err": err, "gate": gate}}
    for b, s, h, d in cases:
        q, k, v = (C.normal(rng, (b, s, h, d), torch.bfloat16, dev) for _ in range(3))
        fl = C.attention_flops(b, s, h, d, True)
        t0 = C.timed_ms(lambda: flash_attention(q, k, v, causal=True), dev, fit)
        print(f"B{b} S{s} ({dev.type}) baseline (K1): {t0:.4f} ms {fl / t0 / 1e9:.1f} TFLOP/s",
              flush=True)
        for bq, bkv, nc in sweep:
            bq, bkv = min(bq, s // nc), min(bkv, s)
            name = f"B{b} S{s} pair {bq}x{bkv} x{nc}"
            if s % (nc * bq):  # JAX's grid would leave the tail rows uncomputed
                print(f"{name} ({dev.type}): skipped, S {s} is not a multiple of nchain * bq "
                      f"{nc * bq}", flush=True)
                continue
            sl = min(slice_len, s) // (nc * 128) * nc * 128  # a slice the chains divide
            qs, ks, vs = (t[:1, :sl].to(C.work_dtype(dev)) for t in (q, k, v))
            err = C.rel_err_norm(flash_pair(qs, ks, vs, bq=128, bkv=128, nchain=nc),
                                 C.oracle(qs, ks, vs, causal=True))
            t = C.timed_ms(lambda: flash_pair(q, k, v, bq=bq, bkv=bkv, nchain=nc), dev, fit)
            rows[name] = {"shape": (b, s, h, h, d), "causal": True, "nchain": nc, "pair_ms": t,
                          "k1_ms": t0, "flops": fl, "rel_err": err}
            print(f"{name} ({dev.type}): {t:.4f} ms {fl / t / 1e9:.1f} TFLOP/s, rel-err "
                  f"{err:.2e}", flush=True)
    return rows


if __name__ == "__main__":
    C.cli(main, __doc__.splitlines()[0])
