"""GPT-2 (dense forward): the weights' home, the training model and the
serving path's oracle.

Port of ``photonic_flash_attention_tpu/models/gpt2.py`` (``GPT2Config``,
``GPT2LMHead``): learned positions, pre-LayerNorm blocks, tanh GELU, tied
LM head. Parameters are float32 as in Flax; the forward computes in
``cfg.dtype`` (LayerNorm statistics in float32), and gradients reach the
float32 parameters through those casts, as Flax's fp32 master weights.
Attention goes through ``models/attention.py::dispatch_attention``, as the
JAX blocks do with ``adaptive=False``. In train mode with ``attn_pdrop``
the attention probabilities are dropped (K1's and K4/K5's dropout streams
on the flash route): the forward takes one ``dropout_seed`` (or draws one
from torch's default generator) and gives layer i the seed
``fold_seed(dropout_seed, i)``, so a recomputed forward draws the same
masks; Flax's per-layer ``make_rng`` streams are not reproduced (the masks
equal JAX's for equal seeds, the seed schedule is the port's). Initialisation follows the
Flax initialisers (``wte`` N(0, 0.02), ``wpe`` N(0, 0.01), Dense kernels
lecun-normal, biases 0, LayerNorm 1/0) drawn from an explicit
``torch.Generator``; the numbers differ from JAX's, so tests load JAX
weights through ``models/from_jax.py`` instead.

Submodule names follow the Flax tree (``h.{i}.attn.q_proj`` is
``h/block/attn/q_proj`` at layer i); ``nn.Linear.weight`` is the Flax
kernel transposed. ``transfer_hf_gpt2`` carries an HF (torch) GPT-2's
weights across; ``load_hf_gpt2`` needs a download and is not called by any
test.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..ops.dropout import fold_seed
from ..parallel import collectives as C
from ..parallel.mesh import PartitionSpec
from .attention import PhotonicFlashAttention, dense, model_device


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    layer_norm_epsilon: float = 1e-5
    #: dropout on attention probabilities (HF attn_pdrop), train mode only.
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

    def forward(self, x: torch.Tensor, group=None) -> torch.Tensor:
        """``group``: ``c_fc`` holds this rank's columns and ``c_proj`` its
        rows (Megatron's f before, g after)."""
        if group is not None:
            x = C.copy_to(x, group)
        m = F.gelu(dense(x, self.c_fc, group), approximate="tanh")
        return dense(m, self.c_proj, group, row=True)


class Block(nn.Module):
    def __init__(self, cfg: GPT2Config) -> None:
        super().__init__()
        eps = cfg.layer_norm_epsilon
        self.ln_1 = nn.LayerNorm(cfg.n_embd, eps=eps)
        self.attn = PhotonicFlashAttention(
            cfg.n_embd, cfg.n_head, causal=True, attention_dropout=cfg.attn_pdrop,
            adaptive=False, dtype=cfg.dtype,
        )
        self.ln_2 = nn.LayerNorm(cfg.n_embd, eps=eps)
        self.mlp = MLP(cfg)

    def forward(self, x: torch.Tensor, dropout_seed: Optional[int] = None,
                group=None) -> torch.Tensor:
        x = x + self.attn(layer_norm(x, self.ln_1), dropout_seed=dropout_seed, tp_group=group)[0]
        return x + self.mlp(layer_norm(x, self.ln_2), group)


class GPT2LMHead(nn.Module):
    """GPT-2 with tied-embedding LM head. Input: (B, S) token ids; output
    (B, S, V) logits in ``cfg.dtype``.

    After :meth:`tensor_parallel` the same forward runs on this rank's
    shards, as :func:`param_sharding_rules` places them over a model axis's
    process group: each block on the rank's heads and MLP columns between
    Megatron's f (``parallel/collectives.py::copy_to``) and g (an
    all-reduce after ``out_proj`` and after ``c_proj``), ``wte``'s n_embd
    shard all-gathered once a forward, where XLA gathers it for the lookup
    and the tied head. The logits are the same on every rank of the group.
    Train-mode attention dropout then draws its mask over the rank's local
    head indices, so its sample differs from the unsharded model's."""

    def __init__(
        self, cfg: GPT2Config, *, generator: Optional[torch.Generator] = None
    ) -> None:
        super().__init__()
        self.config = cfg
        self.wte = nn.Parameter(torch.empty(cfg.vocab_size, cfg.n_embd))
        self.wpe = nn.Parameter(torch.empty(cfg.n_positions, cfg.n_embd))
        self.h = nn.ModuleList(Block(cfg) for _ in range(cfg.n_layer))
        self.ln_f = nn.LayerNorm(cfg.n_embd, eps=cfg.layer_norm_epsilon)
        self.tp_group = None
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
        self, input_ids: torch.Tensor, positions: Optional[torch.Tensor] = None,
        *, dropout_seed: Optional[int] = None,
    ) -> torch.Tensor:
        """``dropout_seed``: the base seed of a train-mode forward's
        attention dropout (ignored in eval mode or without ``attn_pdrop``)."""
        dt = self.config.dtype
        group = self.tp_group
        wte = self.wte
        if group is not None and wte.shape[1] != self.config.n_embd:
            wte = C.gather(wte, 1, group)
        if positions is None:
            positions = torch.arange(input_ids.shape[1], device=input_ids.device)[None]
        x = wte.to(dt)[input_ids] + self.wpe.to(dt)[positions]
        drop = self.training and self.config.attn_pdrop > 0.0
        if drop and dropout_seed is None:
            dropout_seed = int(torch.randint(0, 2**31 - 1, (1,)))
        for i, block in enumerate(self.h):
            x = block(x, fold_seed(dropout_seed, i) if drop else None, group)
        x = layer_norm(x, self.ln_f)
        return x @ wte.to(dt).T

    def tensor_parallel(self, group, specs: Mapping[str, Any], model_axis: str) -> None:
        """Make the forward tensor parallel over ``group`` (the process
        group of the mesh's ``model_axis``), before the caller cuts each
        parameter to its shard by ``specs``, which must be
        :func:`param_sharding_rules`' layout; the heads must divide over
        the group."""
        rules = param_sharding_rules(self.state_dict(), (None, model_axis))
        if {n: tuple(specs.get(n, ())) for n in rules} != {n: tuple(r) for n, r in rules.items()}:
            raise ValueError("tensor-parallel GPT-2 needs the layout of "
                             "models.gpt2.param_sharding_rules")
        n = dist.get_world_size(group)
        if self.config.n_head % n:
            raise ValueError(f"n_head ({self.config.n_head}) must divide over the model axis ({n})")
        self.tp_group = group


# ---------------------------------------------------------------------------
# Tensor parallelism
# ---------------------------------------------------------------------------


def param_sharding_rules(params: Mapping[str, Any],
                         mesh_axes: Tuple[str, str] = ("data", "model")) -> Dict[str, PartitionSpec]:
    """A :class:`~..parallel.mesh.PartitionSpec` for each parameter of a
    ``GPT2LMHead`` state_dict (JAX ``param_sharding_rules``,
    ``models/gpt2.py:159``): q/k/v and ``c_fc`` column-parallel (heads and
    the MLP's hidden units on ``model``), ``out_proj`` and ``c_proj``
    row-parallel, ``wte`` sharded on n_embd; biases, LayerNorms and ``wpe``
    replicated. ``nn.Linear.weight`` is the Flax kernel transposed, so a
    column-parallel weight shards its dim 0 where JAX's kernel shards its
    last."""
    _, model = mesh_axes

    def rule(name: str, leaf) -> PartitionSpec:
        if leaf.ndim < 2:
            return PartitionSpec()
        if any(name.endswith(f"{p}.weight") for p in ("q_proj", "k_proj", "v_proj", "c_fc")):
            return PartitionSpec(model, None)
        if name.endswith("out_proj.weight") or name.endswith("c_proj.weight"):
            return PartitionSpec(None, model)
        if name == "wte":
            return PartitionSpec(None, model)
        return PartitionSpec()

    return {name: rule(name, leaf) for name, leaf in params.items()}


# ---------------------------------------------------------------------------
# HF weight transfer
# ---------------------------------------------------------------------------


def transfer_hf_gpt2(hf: Any, dtype: torch.dtype = torch.bfloat16, device: Any = "cuda"
                     ) -> Tuple[GPT2LMHead, Dict[str, torch.Tensor], GPT2Config]:
    """An HF (torch) ``GPT2LMHeadModel`` or bare ``GPT2Model`` (its keys
    are given the ``transformer.`` prefix) -> (the port's ``GPT2LMHead``
    with its weights on ``device``, the card by default, its state_dict,
    the config). HF's ``Conv1D`` keeps
    (in, out) kernels with Q, K and V side by side in ``c_attn``: split on
    the output axis and transposed to ``nn.Linear``'s (out, in)."""
    sd = {k: v.detach().float().cpu() for k, v in hf.state_dict().items()}
    if not any(k.startswith("transformer.") for k in sd):
        sd = {f"transformer.{k}": v for k, v in sd.items()}
    hf_cfg = hf.config
    cfg = GPT2Config(vocab_size=hf_cfg.vocab_size, n_positions=hf_cfg.n_positions,
                     n_embd=hf_cfg.n_embd, n_layer=hf_cfg.n_layer, n_head=hf_cfg.n_head,
                     layer_norm_epsilon=hf_cfg.layer_norm_epsilon, dtype=dtype)
    out = {"wte": sd["transformer.wte.weight"], "wpe": sd["transformer.wpe.weight"]}
    for wb in ("weight", "bias"):
        out[f"ln_f.{wb}"] = sd[f"transformer.ln_f.{wb}"]
        for i in range(cfg.n_layer):
            src, dst = f"transformer.h.{i}.", f"h.{i}."
            for ln in ("ln_1", "ln_2"):
                out[f"{dst}{ln}.{wb}"] = sd[f"{src}{ln}.{wb}"]
            convs = {f"attn.{name}": part for name, part in zip(
                ("q_proj", "k_proj", "v_proj"), sd[f"{src}attn.c_attn.{wb}"].chunk(3, dim=-1))}
            convs["attn.out_proj"] = sd[f"{src}attn.c_proj.{wb}"]
            for name in ("c_fc", "c_proj"):
                convs[f"mlp.{name}"] = sd[f"{src}mlp.{name}.{wb}"]
            for name, x in convs.items():
                out[f"{dst}{name}.{wb}"] = x.T.contiguous() if wb == "weight" else x.contiguous()
    model = GPT2LMHead(cfg)
    model.load_state_dict(out)
    model.to(model_device(device))
    return model, model.state_dict(), cfg


def load_hf_gpt2(model_name: str = "gpt2", dtype: torch.dtype = torch.bfloat16,
                 device: Any = "cuda"):
    """Load HF GPT-2 weights into the port (downloads: no test calls it)."""
    from transformers import GPT2LMHeadModel

    return transfer_hf_gpt2(GPT2LMHeadModel.from_pretrained(model_name), dtype, device)
