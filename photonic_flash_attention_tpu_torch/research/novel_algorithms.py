"""Research attention algorithms + benchmark harness.

The rebirth of reference research/novel_algorithms.py:33-1631 — three
novel attention mechanisms and a benchmark framework:

* ``QuantumInspiredAttention`` (reference PhotonicQuantumAttention
  :65-354): complex-amplitude projections, interference scores = squared
  modulus of the complex inner product, cross-head phase mixing (the
  reference's "entanglement gates"), amplitude-squared normalization.
* ``SpectralAttention`` (reference MultiDimensionalSpectralAttention
  :357-669): rfft along the sequence, learnable spectral filters,
  attention among retained low-frequency modes (O(S log S + K^2)),
  inverse transform + residual fusion.
* ``HierarchicalAttention`` (reference AdaptiveHierarchicalAttention
  :671-1000): multi-resolution pooling pyramid, per-level attention,
  learned top-down combination.
* ``ResearchBenchmark`` (reference NovelAlgorithmBenchmarkFramework
  :1002-1590): latency / output-stability / quality scoring with a
  markdown report.

Port of ``photonic_flash_attention_tpu/research/novel_algorithms.py``. The
Flax modules become ``nn.Module``s with the same parameter names (a Flax
``Dense`` named ``q_re`` is the ``nn.Linear`` ``q_re``; ``head_mix`` and
``spectral_filter`` are parameters), so ``models/from_jax.py::
research_params_from_jax`` carries Flax params across. Their attention is
the port's ``ops/fused.py::fused_attention``, plain PyTorch, where JAX
leaves ``fused_attention`` to XLA. Two shapes are fixed at construction
where Flax sizes them at its first call: ``spectral_filter`` holds
``num_modes`` rows, of which a call uses the first ``min(num_modes,
S // 2 + 1)`` (a Flax filter of fewer rows loads into the first rows, the
rest ones, Flax's initial value), and ``level_gate`` has ``num_levels``
outputs, of which a call uses one per level its pyramid reaches.

``ResearchBenchmark`` runs on the card unless given ``device="cpu"``: the
modules are made from a seeded generator, and each call is timed between
``torch.cuda.synchronize`` calls, where JAX jits and blocks.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.fused import fused_attention


class QuantumInspiredAttention(nn.Module):
    """Interference-based attention over complex amplitude encodings.

    Scores are |<q|k>|^2 for complex q, k. ``entangle=True`` mixes phases
    across heads with a learned rotation (orthogonal at init) before
    scoring.
    """

    def __init__(self, embed_dim: int, num_heads: int, entangle: bool = True) -> None:
        super().__init__()
        self.embed_dim, self.num_heads, self.entangle = embed_dim, num_heads, entangle
        for name in ("q_re", "q_im", "k_re", "k_im", "v", "out"):
            self.add_module(name, nn.Linear(embed_dim, embed_dim))
        if entangle:
            self.head_mix = nn.Parameter(nn.init.orthogonal_(torch.empty(num_heads, num_heads)))

    def forward(self, x: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        b, s, e = x.shape
        h = self.num_heads
        d = e // h
        q_re = self.q_re(x).reshape(b, s, h, d)
        q_im = self.q_im(x).reshape(b, s, h, d)
        k_re = self.k_re(x).reshape(b, s, h, d)
        k_im = self.k_im(x).reshape(b, s, h, d)
        v = self.v(x).reshape(b, s, h, d)
        if self.entangle:
            q_re = torch.einsum("bshd,hg->bsgd", q_re, self.head_mix)
            q_im = torch.einsum("bshd,hg->bsgd", q_im, self.head_mix)
        # complex inner product: re = qr.kr + qi.ki ; im = qr.ki - qi.kr
        re = (torch.einsum("bqhd,bkhd->bhqk", q_re, k_re)
              + torch.einsum("bqhd,bkhd->bhqk", q_im, k_im))
        im = (torch.einsum("bqhd,bkhd->bhqk", q_re, k_im)
              - torch.einsum("bqhd,bkhd->bhqk", q_im, k_re))
        intensity = (re**2 + im**2) / d  # |<q|k>|^2, the measured power
        weights = intensity / (intensity.sum(dim=-1, keepdim=True) + 1e-9)
        out = torch.einsum("bhqk,bkhd->bqhd", weights, v).reshape(b, s, e)
        return self.out(out)


class SpectralAttention(nn.Module):
    """Attention among retained frequency modes (O(S log S + K^2))."""

    def __init__(self, embed_dim: int, num_heads: int, num_modes: int = 64) -> None:
        super().__init__()
        self.embed_dim, self.num_heads, self.num_modes = embed_dim, num_heads, num_modes
        self.spectral_filter = nn.Parameter(torch.ones(num_modes, embed_dim))
        self.mode_proj = nn.Linear(2 * embed_dim, embed_dim)
        self.re_proj = nn.Linear(embed_dim, embed_dim)
        self.im_proj = nn.Linear(embed_dim, embed_dim)
        self.fusion_gate = nn.Linear(embed_dim, embed_dim)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # A Flax filter made at a short sequence holds fewer rows.
        key = prefix + "spectral_filter"
        filt = state_dict.get(key)
        if filt is not None and filt.shape[0] < self.num_modes:
            rest = torch.ones(self.num_modes - filt.shape[0], filt.shape[1], dtype=filt.dtype)
            state_dict[key] = torch.cat([filt, rest.to(filt.device)])
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        b, s, e = x.shape
        k = min(self.num_modes, s // 2 + 1)
        xf = torch.fft.rfft(x.float(), dim=1)  # (B, S//2+1, E) complex
        modes = xf[:, :k] * self.spectral_filter[:k]
        feats = self.mode_proj(torch.cat([modes.real, modes.imag], dim=-1))  # (B, K, E)
        heads = feats.reshape(b, k, self.num_heads, e // self.num_heads)
        attn_out, _ = fused_attention(heads, heads, heads)
        attn_out = attn_out.reshape(b, k, e)
        new_modes = (modes + torch.complex(self.re_proj(attn_out), self.im_proj(attn_out)))
        pad = torch.zeros(b, xf.shape[1] - k, e, dtype=torch.complex64, device=x.device)
        y = torch.fft.irfft(torch.cat([new_modes.to(torch.complex64), pad], dim=1), n=s, dim=1)
        return x + torch.sigmoid(self.fusion_gate(x)) * y.to(x.dtype)


class HierarchicalAttention(nn.Module):
    """Multi-resolution pyramid attention with top-down combination."""

    def __init__(self, embed_dim: int, num_heads: int, num_levels: int = 3) -> None:
        super().__init__()
        self.embed_dim, self.num_heads, self.num_levels = embed_dim, num_heads, num_levels
        for lvl in range(num_levels):
            self.add_module(f"qkv_{lvl}", nn.Linear(embed_dim, 3 * embed_dim))
        self.level_gate = nn.Linear(embed_dim, num_levels)
        self.out = nn.Linear(embed_dim, embed_dim)

    def forward(self, x: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        b, s, e = x.shape
        h, d = self.num_heads, e // self.num_heads
        levels = []
        cur = x
        for _ in range(self.num_levels):
            levels.append(cur)
            if cur.shape[1] <= 2:
                break
            sl = cur.shape[1] - cur.shape[1] % 2  # strided mean-pool by 2
            cur = cur[:, :sl].reshape(b, sl // 2, 2, e).mean(dim=2)

        outs = []
        for lvl, feats in enumerate(levels):
            q, k, v = getattr(self, f"qkv_{lvl}")(feats).split(e, dim=-1)
            sl = feats.shape[1]
            o, _ = fused_attention(q.reshape(b, sl, h, d), k.reshape(b, sl, h, d),
                                   v.reshape(b, sl, h, d))
            o = o.reshape(b, sl, e)
            if sl != s:  # upsample back to full resolution (repeat)
                o = o.repeat_interleave(-(-s // sl), dim=1)[:, :s]
            outs.append(o)

        stacked = torch.stack(outs, dim=-1)  # (B, S, E, L)
        n = len(outs)
        gates = F.linear(x, self.level_gate.weight[:n], self.level_gate.bias[:n]).softmax(dim=-1)
        combined = torch.einsum("bsel,bsl->bse", stacked, gates)
        return self.out(combined)


# ---------------------------------------------------------------------------
# Benchmark framework
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AlgorithmResult:
    name: str
    latency_ms: float
    output_norm: float
    stability: float  # 1 - rel-std across repeated runs
    finite: bool

    def score(self) -> float:
        lat_term = 1.0 / (1.0 + self.latency_ms / 10.0)
        return (0.5 * lat_term + 0.5 * self.stability) * (1.0 if self.finite else 0.0)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ResearchBenchmark:
    """Compare attention variants (reference :1002-1590)."""

    def __init__(self, batch: int = 2, seq: int = 256, embed: int = 256, heads: int = 8,
                 device: Union[str, torch.device] = "cuda"):
        self.batch, self.seq, self.embed, self.heads = batch, seq, embed, heads
        self.device = torch.device(device)

    def default_algorithms(self, seed: int = 0) -> Dict[str, nn.Module]:
        """The three modules, initialised from ``seed`` (CPU generator)."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            return {
                "quantum_inspired": QuantumInspiredAttention(self.embed, self.heads),
                "spectral": SpectralAttention(self.embed, self.heads),
                "hierarchical": HierarchicalAttention(self.embed, self.heads),
            }

    @torch.no_grad()
    def run(
        self,
        algorithms: Optional[Dict[str, nn.Module]] = None,
        iters: int = 3,
        seed: int = 0,
    ) -> List[AlgorithmResult]:
        """Each module on one numpy-seeded input (B, S, E) fp32: a warm-up
        call, then ``iters`` timed calls; mean latency, mean output norm,
        its stability and whether the last output is finite."""
        algorithms = algorithms or self.default_algorithms(seed)
        rng = np.random.default_rng(seed)
        x = torch.from_numpy(
            rng.standard_normal((self.batch, self.seq, self.embed)).astype(np.float32)
        ).to(self.device)
        results = []
        for name, mod in algorithms.items():
            mod = mod.to(self.device)
            out = mod(x)
            _sync(self.device)
            lats, norms = [], []
            for _ in range(iters):
                t0 = time.perf_counter()
                out = mod(x)
                _sync(self.device)
                lats.append((time.perf_counter() - t0) * 1e3)
                norms.append(float(torch.linalg.vector_norm(out.float())))
            stability = 1.0 - float(np.std(norms) / (np.mean(norms) + 1e-9))
            results.append(
                AlgorithmResult(
                    name=name,
                    latency_ms=float(np.mean(lats)),
                    output_norm=float(np.mean(norms)),
                    stability=stability,
                    finite=bool(torch.isfinite(out).all()),
                )
            )
        return results

    @staticmethod
    def markdown_report(results: Sequence[AlgorithmResult]) -> str:
        lines = [
            "# Novel attention benchmark",
            "",
            "| algorithm | latency (ms) | stability | finite | score |",
            "|---|---|---|---|---|",
        ]
        for r in sorted(results, key=lambda r: -r.score()):
            lines.append(
                f"| {r.name} | {r.latency_ms:.2f} | {r.stability:.4f} | "
                f"{'yes' if r.finite else 'NO'} | {r.score():.3f} |"
            )
        return "\n".join(lines)
