"""GPT-2 (dense forward): the weights' home, the training model and the
serving path's oracle.

Port of ``photonic_flash_attention_tpu/models/gpt2.py`` (``GPT2Config``,
``GPT2LMHead``): learned positions, pre-LayerNorm blocks, tanh GELU, tied
LM head. Parameters are float32 as in Flax; the forward computes in
``cfg.dtype`` (LayerNorm statistics in float32), and gradients reach the
float32 parameters through those casts, as Flax's fp32 master weights.
Attention goes through ``models/attention.py::dispatch_attention``, as the
JAX blocks do with ``adaptive=False``. Initialisation follows the
Flax initialisers (``wte`` N(0, 0.02), ``wpe`` N(0, 0.01), Dense kernels
lecun-normal, biases 0, LayerNorm 1/0) drawn from an explicit
``torch.Generator``; the numbers differ from JAX's, so tests load JAX
weights through ``models/from_jax.py`` instead.

Submodule names follow the Flax tree (``h.{i}.attn.q_proj`` is
``h/block/attn/q_proj`` at layer i); ``nn.Linear.weight`` is the Flax
kernel transposed.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .attention import PhotonicFlashAttention, dense


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    layer_norm_epsilon: float = 1e-5
    #: dropout on attention probabilities (HF attn_pdrop), train mode only;
    #: training with a value above 0 raises until ROADMAP A10.
    attn_pdrop: float = 0.0
    dtype: torch.dtype = torch.bfloat16

    @classmethod
    def small(cls) -> "GPT2Config":
        return cls()

    @classmethod
    def medium(cls) -> "GPT2Config":
        return cls(n_embd=1024, n_layer=24, n_head=16)

    @classmethod
    def large(cls) -> "GPT2Config":
        return cls(n_embd=1280, n_layer=36, n_head=20)

    @classmethod
    def tiny(cls) -> "GPT2Config":
        """For tests."""
        return cls(vocab_size=1024, n_positions=256, n_embd=128, n_layer=2, n_head=4)


def layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """LayerNorm in float32, output in x's dtype (Flax LayerNorm(dtype=...))."""
    y = F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias, ln.eps)
    return y.to(x.dtype)


class MLP(nn.Module):
    def __init__(self, cfg: GPT2Config) -> None:
        super().__init__()
        self.c_fc = nn.Linear(cfg.n_embd, 4 * cfg.n_embd)
        self.c_proj = nn.Linear(4 * cfg.n_embd, cfg.n_embd)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(F.gelu(dense(x, self.c_fc), approximate="tanh"), self.c_proj)


class Block(nn.Module):
    def __init__(self, cfg: GPT2Config) -> None:
        super().__init__()
        eps = cfg.layer_norm_epsilon
        self.ln_1 = nn.LayerNorm(cfg.n_embd, eps=eps)
        self.attn = PhotonicFlashAttention(
            cfg.n_embd, cfg.n_head, causal=True, attention_dropout=cfg.attn_pdrop,
            dtype=cfg.dtype,
        )
        self.ln_2 = nn.LayerNorm(cfg.n_embd, eps=eps)
        self.mlp = MLP(cfg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(layer_norm(x, self.ln_1))[0]
        return x + self.mlp(layer_norm(x, self.ln_2))


class GPT2LMHead(nn.Module):
    """GPT-2 with tied-embedding LM head. Input: (B, S) token ids; output
    (B, S, V) logits in ``cfg.dtype``."""

    def __init__(
        self, cfg: GPT2Config, *, generator: Optional[torch.Generator] = None
    ) -> None:
        super().__init__()
        self.config = cfg
        self.wte = nn.Parameter(torch.empty(cfg.vocab_size, cfg.n_embd))
        self.wpe = nn.Parameter(torch.empty(cfg.n_positions, cfg.n_embd))
        self.h = nn.ModuleList(Block(cfg) for _ in range(cfg.n_layer))
        self.ln_f = nn.LayerNorm(cfg.n_embd, eps=cfg.layer_norm_epsilon)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Flax's initialisers, drawn from ``generator`` (on the parameters'
        device)."""
        nn.init.normal_(self.wte, std=0.02, generator=generator)
        nn.init.normal_(self.wpe, std=0.01, generator=generator)
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                # lecun_normal: truncated normal at +-2 std, variance 1/fan_in.
                std = math.sqrt(1.0 / mod.in_features) / 0.87962566103423978
                nn.init.trunc_normal_(
                    mod.weight, std=std, a=-2 * std, b=2 * std, generator=generator
                )
                nn.init.zeros_(mod.bias)
            elif isinstance(mod, nn.LayerNorm):
                nn.init.ones_(mod.weight)
                nn.init.zeros_(mod.bias)

    def forward(
        self, input_ids: torch.Tensor, positions: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        dt = self.config.dtype
        if positions is None:
            positions = torch.arange(input_ids.shape[1], device=input_ids.device)[None]
        x = self.wte.to(dt)[input_ids] + self.wpe.to(dt)[positions]
        for block in self.h:
            x = block(x)
        x = layer_norm(x, self.ln_f)
        return x @ self.wte.to(dt).T
