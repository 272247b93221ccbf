"""Llama (dense forward), in PyTorch.

Port of ``photonic_flash_attention_tpu/models/llama.py``: ``LlamaConfig``
(Llama-2-7B by default, ``tiny``), ``RMSNorm`` (fp32 statistics, the
fp32 scale multiplied before the cast), ``rope_cos_sin`` / ``apply_rope``
(HF's half-split rotation, fp32 cos/sin, the result cast back to x's
dtype), ``LlamaAttention`` (bias-free projections, grouped-query heads,
causal, through ``models/attention.py::dispatch_attention``: K1's native
GQA on the flash path), ``LlamaMLP`` (SiLU gate times up), ``LlamaLayer``
(pre-norm) and ``LlamaForCausalLM`` (tied or untied LM head), plus
``transfer_hf_llama`` from an HF (torch) model.

``LlamaForCausalLM.tensor_parallel`` makes the forward tensor parallel
over a model axis's process group, as JAX's ``Trainer`` shards the model by
``llama_param_sharding_rules`` under GSPMD: each rank holds its query and
KV heads and its MLP columns between Megatron's f and g
(``parallel/collectives.py``), the embedding's hidden-size shard gathered
once a forward and the untied head's vocabulary shard gathered on the
logits. Where GSPMD would pad a dimension that does not divide over the
axis, the port raises.

The model is made on the card unless the caller passes another
``device`` (the tests pass ``"cpu"``), ``transfer_hf_llama``'s too.
Parameters are float32 unless ``param_dtype`` says otherwise (a
Llama-2-7B on the card is made in bf16: 13.5 GB where fp32 takes 27);
the forward computes in ``cfg.dtype``. Submodule names follow the Flax
tree (``layers.{i}.attn.q_proj`` is ``layers/layer/attn/q_proj`` at
layer i); ``nn.Linear.weight`` is the Flax kernel transposed,
``RMSNorm.weight`` the Flax ``scale`` and ``lm_head.weight`` the Flax
``lm_head`` transposed (``models/from_jax.py::llama_params_from_jax``).
Initialisation follows the Flax initialisers (``embed_tokens`` and
``lm_head`` N(0, 0.02), Dense kernels lecun-normal, norms 1) drawn from
an explicit ``torch.Generator`` on the parameters' device.
``load_hf_llama`` needs a download and is not called by any test.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..parallel import collectives as C
from ..parallel.mesh import PartitionSpec, require_layout
from .attention import dense, dispatch_attention, model_device


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-6
    tie_word_embeddings: bool = False
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def llama2_7b(cls) -> "LlamaConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "LlamaConfig":
        """For tests (GQA: 8 q heads over 2 kv heads)."""
        return cls(vocab_size=512, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
                   num_attention_heads=8, num_key_value_heads=2, max_position_embeddings=256)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float, dtype: torch.dtype) -> torch.Tensor:
    """RMS norm in fp32, the scale multiplied in fp32, cast to ``dtype``."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight).to(dtype)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6, dtype: torch.dtype = torch.bfloat16, *,
                 device: Any = None, param_dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=param_dtype))
        self.eps = eps
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, self.eps, self.dtype)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S) int positions -> cos, sin (B, S, head_dim) fp32 in HF's layout
    (the frequencies repeated over the two halves)."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                             device=positions.device) / head_dim))
    angles = positions.float()[..., None] * inv_freq  # (B, S, D/2)
    emb = torch.cat([angles, angles], dim=-1)
    return emb.cos(), emb.sin()


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """HF's half-split rotation of x (B, S, H, D) in fp32, cast back to x's
    dtype; the result is a new contiguous tensor (K1 takes it as it is)."""
    half = x.shape[-1] // 2
    xf = x.float()
    rotated = torch.cat([-xf[..., half:], xf[..., :half]], dim=-1)
    return (xf * cos[:, :, None] + rotated * sin[:, :, None]).to(x.dtype)


def _norm(cfg: LlamaConfig, factory: Dict[str, Any]) -> RMSNorm:
    return RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.dtype, device=factory["device"],
                   param_dtype=factory["dtype"])


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, **factory) -> None:
        super().__init__()
        self.config = cfg
        hd = cfg.head_dim
        e = cfg.hidden_size
        self.q_proj = nn.Linear(e, cfg.num_attention_heads * hd, bias=False, **factory)
        self.k_proj = nn.Linear(e, cfg.num_key_value_heads * hd, bias=False, **factory)
        self.v_proj = nn.Linear(e, cfg.num_key_value_heads * hd, bias=False, **factory)
        self.o_proj = nn.Linear(cfg.num_attention_heads * hd, e, bias=False, **factory)

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                mask: Optional[torch.Tensor] = None, group=None) -> torch.Tensor:
        """``group``: q/k/v hold this rank's heads (the head counts are read
        from their shapes) and ``o_proj`` its input columns. The GQA groups
        are contiguous, so rank r's query heads attend over rank r's KV
        heads."""
        b, s, _ = x.shape
        hd = self.config.head_dim
        if group is not None:
            x = C.copy_to(x, group)
        q = apply_rope(dense(x, self.q_proj, group).reshape(b, s, -1, hd), cos, sin)
        k = apply_rope(dense(x, self.k_proj, group).reshape(b, s, -1, hd), cos, sin)
        v = dense(x, self.v_proj, group).reshape(b, s, -1, hd)
        out, _ = dispatch_attention(q, k, v, mask, causal=True)
        return dense(out.reshape(b, s, -1), self.o_proj, group, row=True)


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, **factory) -> None:
        super().__init__()
        e, m = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = nn.Linear(e, m, bias=False, **factory)
        self.up_proj = nn.Linear(e, m, bias=False, **factory)
        self.down_proj = nn.Linear(m, e, bias=False, **factory)

    def forward(self, x: torch.Tensor, group=None) -> torch.Tensor:
        """``group``: gate and up hold this rank's columns, down its rows."""
        if group is not None:
            x = C.copy_to(x, group)
        m = F.silu(dense(x, self.gate_proj, group)) * dense(x, self.up_proj, group)
        return dense(m, self.down_proj, group, row=True)


class LlamaLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, **factory) -> None:
        super().__init__()
        self.input_ln = _norm(cfg, factory)
        self.attn = LlamaAttention(cfg, **factory)
        self.post_attn_ln = _norm(cfg, factory)
        self.mlp = LlamaMLP(cfg, **factory)

    def forward(self, x, cos, sin, mask=None, group=None) -> torch.Tensor:
        x = x + self.attn(self.input_ln(x), cos, sin, mask, group)
        return x + self.mlp(self.post_attn_ln(x), group)


class LlamaForCausalLM(nn.Module):
    """Llama with its LM head. Input: (B, S) token ids; output (B, S, V)
    logits in ``cfg.dtype``. ``device`` (the card by default) and
    ``param_dtype`` place and type the parameters as they are made (no copy
    on the CPU first).

    After :meth:`tensor_parallel` the same forward runs on this rank's
    shards, as :func:`llama_param_sharding_rules` places them over a model
    axis's process group: each layer takes Megatron's f
    (``parallel/collectives.py::copy_to``) before q/k/v and before
    gate/up and g (an all-reduce) after ``o_proj`` and after
    ``down_proj``; ``embed_tokens``' hidden-size shard is all-gathered once
    a forward (for the lookup and the tied head); the untied ``lm_head``
    computes the rank's vocabulary block of the logits, which are
    all-gathered. RMSNorm weights stay replicated. The logits are the same
    on every rank of the group."""

    def __init__(self, cfg: LlamaConfig, *, generator: Optional[torch.Generator] = None,
                 device: Any = "cuda", param_dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.config = cfg
        factory = dict(device=model_device(device), dtype=param_dtype)
        self.embed_tokens = nn.Parameter(torch.empty(cfg.vocab_size, cfg.hidden_size, **factory))
        self.layers = nn.ModuleList(LlamaLayer(cfg, **factory)
                                    for _ in range(cfg.num_hidden_layers))
        self.norm = _norm(cfg, factory)
        self.lm_head = (None if cfg.tie_word_embeddings
                        else nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False, **factory))
        self.tp_group = None
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Flax's initialisers, drawn from ``generator`` (on the parameters'
        device) in fp32 one tensor at a time, then cast to the parameters'
        dtype."""

        def draw(param: torch.Tensor, fill) -> None:
            w = torch.empty(param.shape, dtype=torch.float32, device=param.device)
            fill(w)
            param.copy_(w)

        draw(self.embed_tokens, lambda w: nn.init.normal_(w, std=0.02, generator=generator))
        if self.lm_head is not None:
            draw(self.lm_head.weight, lambda w: nn.init.normal_(w, std=0.02, generator=generator))
        for mod in self.modules():
            if isinstance(mod, nn.Linear) and mod is not self.lm_head:
                # lecun_normal: truncated normal at +-2 std, variance 1/fan_in.
                std = math.sqrt(1.0 / mod.in_features) / 0.87962566103423978
                draw(mod.weight, lambda w: nn.init.trunc_normal_(
                    w, std=std, a=-2 * std, b=2 * std, generator=generator))
            elif isinstance(mod, RMSNorm):
                nn.init.ones_(mod.weight)

    def forward(self, input_ids: torch.Tensor, *, positions: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``attention_mask`` (B, S), 1 = keep: becomes the (B, 1, S, S)
        keep mask of every layer (the fused path, as in JAX)."""
        cfg = self.config
        b, s = input_ids.shape
        if positions is None:
            positions = torch.arange(s, device=input_ids.device)[None].expand(b, s)
        mask = None
        if attention_mask is not None:
            mask = attention_mask.to(torch.bool)[:, None, None, :].expand(b, 1, s, s)
        cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
        group = self.tp_group
        embed = self.embed_tokens
        if group is not None and embed.shape[1] != cfg.hidden_size:
            embed = C.gather(embed, 1, group)
        embed = embed.to(cfg.dtype)
        x = embed[input_ids]
        for layer in self.layers:
            x = layer(x, cos, sin, mask, group)
        x = self.norm(x)
        if self.lm_head is None:
            return x @ embed.T
        if group is None or self.lm_head.weight.shape[0] == cfg.vocab_size:
            return dense(x, self.lm_head)
        return C.gather(dense(C.copy_to(x, group), self.lm_head, group), x.ndim - 1, group)

    def tensor_parallel(self, group, specs: Mapping[str, Any], model_axis: str) -> None:
        """Make the forward tensor parallel over ``group`` (the process
        group of the mesh's ``model_axis``), before the caller cuts each
        parameter to its shard by ``specs``, which must be
        :func:`llama_param_sharding_rules`' layout. The query and KV heads,
        the intermediate size and (untied) the vocabulary must divide over
        the group: nothing is padded or quietly replicated."""
        require_layout(specs, llama_param_sharding_rules(self.state_dict(), (None, model_axis)),
                       "models.llama.llama_param_sharding_rules")
        cfg = self.config
        sizes = {"num_attention_heads": cfg.num_attention_heads,
                 "num_key_value_heads": cfg.num_key_value_heads,
                 "intermediate_size": cfg.intermediate_size}
        if not cfg.tie_word_embeddings:
            sizes["vocab_size"] = cfg.vocab_size
        n = dist.get_world_size(group)
        for name, size in sizes.items():
            if size % n:
                raise ValueError(f"{name} ({size}) must divide over the model axis ({n})")
        self.tp_group = group


# ---------------------------------------------------------------------------
# HF weight transfer
# ---------------------------------------------------------------------------


def llama_param_sharding_rules(params: Mapping[str, Any],
                               mesh_axes: Tuple[str, str] = ("data", "model")
                               ) -> Dict[str, PartitionSpec]:
    """A :class:`~..parallel.mesh.PartitionSpec` for each parameter of a
    ``LlamaForCausalLM`` state_dict (JAX ``llama_param_sharding_rules``,
    ``models/llama.py:223``): q/k/v, gate and up column-parallel, o and down
    row-parallel, ``embed_tokens`` sharded on the hidden size and the
    untied ``lm_head`` on the vocabulary; norms replicated. Weights are the
    Flax kernels transposed (``lm_head.weight`` is (V, H)), so their specs
    are JAX's reversed."""
    _, model = mesh_axes

    def rule(name: str, leaf) -> PartitionSpec:
        if leaf.ndim < 2:
            return PartitionSpec()
        if any(name.endswith(f"{p}.weight")
               for p in ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj", "lm_head")):
            return PartitionSpec(model, None)
        if name.endswith("o_proj.weight") or name.endswith("down_proj.weight"):
            return PartitionSpec(None, model)
        if name.endswith("embed_tokens"):
            return PartitionSpec(None, model)
        return PartitionSpec()

    return {name: rule(name, leaf) for name, leaf in params.items()}


def transfer_hf_llama(hf_model: Any, dtype: torch.dtype = torch.bfloat16, device: Any = "cuda"
                      ) -> Tuple[LlamaForCausalLM, Dict[str, torch.Tensor], LlamaConfig]:
    """An HF (torch) ``LlamaForCausalLM`` or bare ``LlamaModel`` -> (the
    port's ``LlamaForCausalLM`` with its weights on ``device``, the card by
    default, its state_dict, the config). Keys without the ``model.`` prefix (a bare model)
    are given it; without an ``lm_head.weight`` (or with ``tie_word_embeddings``) the
    head is tied to the embedding. HF's (out, in) Linear weights are the
    port's as they are."""
    sd = {k: v.detach().float().cpu() for k, v in hf_model.state_dict().items()}
    if not any(k.startswith("model.") for k in sd):
        sd = {f"model.{k}": v for k, v in sd.items()}
    hf_cfg = hf_model.config
    tie = bool(getattr(hf_cfg, "tie_word_embeddings", False))
    has_head = "lm_head.weight" in sd
    cfg = LlamaConfig(
        vocab_size=hf_cfg.vocab_size,
        hidden_size=hf_cfg.hidden_size,
        intermediate_size=hf_cfg.intermediate_size,
        num_hidden_layers=hf_cfg.num_hidden_layers,
        num_attention_heads=hf_cfg.num_attention_heads,
        num_key_value_heads=getattr(hf_cfg, "num_key_value_heads", hf_cfg.num_attention_heads),
        max_position_embeddings=hf_cfg.max_position_embeddings,
        rope_theta=getattr(hf_cfg, "rope_theta", 10000.0),
        rms_norm_eps=hf_cfg.rms_norm_eps,
        tie_word_embeddings=tie or not has_head,
        dtype=dtype,
    )
    out = {"embed_tokens": sd["model.embed_tokens.weight"], "norm.weight": sd["model.norm.weight"]}
    for i in range(cfg.num_hidden_layers):
        src, dst = f"model.layers.{i}.", f"layers.{i}."
        out[dst + "input_ln.weight"] = sd[src + "input_layernorm.weight"]
        out[dst + "post_attn_ln.weight"] = sd[src + "post_attention_layernorm.weight"]
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            out[f"{dst}attn.{name}.weight"] = sd[f"{src}self_attn.{name}.weight"]
        for name in ("gate_proj", "up_proj", "down_proj"):
            out[f"{dst}mlp.{name}.weight"] = sd[f"{src}mlp.{name}.weight"]
    if not cfg.tie_word_embeddings:
        out["lm_head.weight"] = sd["lm_head.weight"]
    model = LlamaForCausalLM(cfg, device=device)
    model.load_state_dict(out)
    return model, model.state_dict(), cfg


def load_hf_llama(model_name: str, dtype: torch.dtype = torch.bfloat16, device: Any = "cuda"):
    """Load HF Llama weights into the port (downloads: no test calls it)."""
    from transformers import AutoModelForCausalLM

    return transfer_hf_llama(AutoModelForCausalLM.from_pretrained(model_name), dtype, device)
