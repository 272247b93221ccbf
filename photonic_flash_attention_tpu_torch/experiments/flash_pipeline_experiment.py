"""The KV loop pipelined so QK(j+1) overlaps softmax(j): kernel K16.

Port of ``benchmarks/flash_pipeline_experiment.py::flash_unrolled`` (its
``_kernel``). On the TPU the whole KV loop is unrolled in one body, so the
scheduler may interleave the products of tile j+1 with the softmax of tile
j. On the card K16 (``csrc/flash_experiments.cu``, ``pfa_flash_pipelined``)
issues QK(j+1) into a second score fragment before the softmax of tile j
and double-buffers K/V with ``cp.async``: the mma.sync form of FA3's
intra-warpgroup overlap. JAX keeps a head's whole K/V in VMEM, a VMEM
choice that does not carry over.

Contract (JAX's): q (B, S, Hq, D), k/v (B, S, Hkv, D), square, GQA (q head
h reads kv head h // (Hq/Hkv)), causal (``col <= row``, top-left; K1's
diagonal for square shapes) or not; q, k, v are cast to bf16 in the body
and p to bf16 before P.V, fp32 accumulate; output in q's dtype. On the card
D in {64, 128}, bf16 or fp32 inputs (fp32 converted on load).
``block_q``/``block_kv`` are JAX's TPU tiles: the plain version walks them,
the card kernel its own 64 x 64 tiles; lengths that are not multiples of
them raise.

Not here: the file's other variants, ``_kernel_chunked``, ``_kernel_tri``,
``_kernel_tri_i8`` and ``_kernel_fulltri`` (the next slice; ROADMAP Queue B).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import _build
from ..ops.flash import flash_attention
from ..ops.reference import softmax_scale
from . import _common as C

__all__ = ["flash_unrolled", "flash_unrolled_plain", "main"]

#: JAX's parity case and gate (max abs against ``flash_attention``).
PARITY_SHAPE = (1, 1024, 2, 64)
PARITY_GATE = 3e-2
#: JAX's perf cases: (name, (B, S, Hq, Hkv, D), causal).
CASES = (
    ("bf16 d64 b1 s8192 noncausal", (1, 8192, 12, 12, 64), False),
    ("bf16 d64 b4 s2048 causal", (4, 2048, 12, 12, 64), True),
    ("bf16 d128gqa b4 s4096 causal", (4, 4096, 32, 8, 128), True),
    ("bf16 d128gqa b4 s4096 noncausal", (4, 4096, 32, 8, 128), False),
)
CARD_DTYPES = (torch.bfloat16, torch.float32)
CARD_HEAD_DIMS = (64, 128)


def _check(q, k, v, block_q: int, block_kv: int) -> None:
    C.check_qkv(q, k, v, gqa=True)
    C.check_blocks(q.shape[1], block_q, "block_q")
    C.check_blocks(q.shape[1], block_kv, "block_kv")


def flash_unrolled_plain(q, k, v, *, block_q: int = 512, block_kv: int = 512,
                         causal: bool = False, sm_scale: Optional[float] = None
                         ) -> torch.Tensor:
    """K16's plain version on JAX's blocks: q, k, v in bf16, s = q.k^T *
    scale (fp32), masked at -1e30, the running max from -1e30, p to bf16
    for P.V; every kv block visited, as JAX's body does."""
    _check(q, k, v, block_q, block_kv)
    return C.online_plain(q, k, v, bq=block_q, bkv=block_kv, causal=causal,
                          scale=softmax_scale(q.shape[-1], sm_scale), bf16_body=True,
                          mask_value=C.NEG_INF, skip_dead=False, m_init=C.NEG_INF)


def _unrolled_cuda(q, k, v, causal: bool, scale: float) -> torch.Tensor:
    C.check_card(q, CARD_DTYPES, CARD_HEAD_DIMS, "K16 pfa_flash_pipelined", k, v)
    b, s, hq, d = q.shape
    o = torch.empty_like(q)
    _build.launch("pfa_flash_pipelined", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  o.data_ptr(), b, s, hq, k.shape[2], d, float(scale), int(causal),
                  _build.DTYPE_CODES[q.dtype])
    return o


def flash_unrolled(q, k, v, *, block_q: int = 512, block_kv: int = 512, causal: bool = False,
                   sm_scale: Optional[float] = None) -> torch.Tensor:
    """(B, S, Hq, D) flash forward. K16 on the card,
    :func:`flash_unrolled_plain` on the CPU."""
    _check(q, k, v, block_q, block_kv)
    scale = softmax_scale(q.shape[-1], sm_scale)
    return C.on_device(
        q,
        lambda: _unrolled_cuda(q, k, v, causal, scale),
        lambda: flash_unrolled_plain(q, k, v, block_q=block_q, block_kv=block_kv, causal=causal,
                                     sm_scale=sm_scale),
    )


def _fit(flops: float, device: torch.device) -> Tuple[int, int]:
    """JAX's window sizing: ~60 ms at 60 TFLOP/s, at least 30 calls; a
    single pair of calls on the CPU."""
    if device.type != "cuda":
        return (1, 2)
    hi = max(30, int(60.0 / (flops / 60e12 * 1e3)))
    return (hi // 10, hi)


def main(device: Optional[str] = None, *, parity_shape=PARITY_SHAPE, cases: Sequence = CASES,
         fit: Optional[Tuple[int, int]] = None, slice_len: int = 1024) -> Dict[str, dict]:
    """JAX's ``main``: parity (bf16 q, k, v) against the port's
    ``flash_attention`` (K1) under max abs 3e-2, causal and not; then each
    perf case timed against K1, with the error against the fp32 oracle on a
    (1, ``slice_len``) slice. Returns the rows by name."""
    dev = C.resolve_device(device)
    rng = np.random.default_rng(0)
    print("== parity ==", flush=True)
    q, k, v = (C.normal(rng, parity_shape, torch.bfloat16, dev) for _ in range(3))
    rows = {}
    blk = min(512, parity_shape[1])
    for causal in (False, True):
        a = flash_unrolled(q, k, v, causal=causal, block_q=blk, block_kv=blk)
        r = flash_attention(q, k, v, causal=causal)
        err = float((a.float() - r.float()).abs().max())
        print(f"causal={causal}: max abs err {err:.2e}", flush=True)
        if not err < PARITY_GATE:
            raise AssertionError(f"flash_unrolled parity causal={causal}: {err:.3e}")
        rows[f"parity causal={causal}"] = {"max_abs_err": err, "gate": PARITY_GATE}
    print("== perf ==", flush=True)
    for name, (b, s, hq, hkv, d), causal in cases:
        qq = C.normal(rng, (b, s, hq, d), torch.bfloat16, dev)
        kk, vv = (C.normal(rng, (b, s, hkv, d), torch.bfloat16, dev) for _ in range(2))
        fl = C.attention_flops(b, s, hq, d, causal)
        it = fit or _fit(fl, dev)
        blk = min(512, s)
        sl = min(slice_len, s)
        qs, ks, vs = (t[:1, :sl] for t in (qq, kk, vv))
        err = C.rel_err_norm(flash_unrolled(qs, ks, vs, causal=causal, block_q=min(512, sl),
                                            block_kv=min(512, sl)),
                             C.oracle(qs, ks, vs, causal=causal))
        t_new = C.timed_ms(lambda: flash_unrolled(qq, kk, vv, causal=causal, block_q=blk,
                                                  block_kv=blk), dev, it)
        t_ref = C.timed_ms(lambda: flash_attention(qq, kk, vv, causal=causal), dev, it)
        rows[name] = {"shape": (b, s, hq, hkv, d), "causal": causal, "unrolled_ms": t_new,
                      "k1_ms": t_ref, "flops": fl, "rel_err": err}
        print(f"{name} ({dev.type}): unrolled {t_new:.4f} ms ({fl / t_new / 1e9:.1f} TF) vs "
              f"grid (K1) {t_ref:.4f} ms ({fl / t_ref / 1e9:.1f} TF) -> {t_ref / t_new:.2f}x, "
              f"rel-err {err:.2e}", flush=True)
    return rows


if __name__ == "__main__":
    C.cli(main, __doc__.splitlines()[0])
