"""T5 encoder-decoder (dense forward), in PyTorch.

Port of ``photonic_flash_attention_tpu/models/t5.py``: ``T5Config``
(tiny/small/base/large), ``T5LayerNorm`` (RMS, fp32 statistics, the scale
multiplied in fp32 before the cast), ``T5RelativeBias`` (the learned
(num_buckets, H) table), ``T5Attention`` (bias-free projections, unscaled
scores, inner width ``num_heads * d_kv``), ``T5FeedForward`` (relu or
gated gelu with ``approximate="none"``), ``T5Block``, ``T5Stack``,
``T5Model`` and ``T5ForConditionalGeneration`` (tied head scaled by
``d_model ** -0.5``), and ``transfer_hf_t5`` from an HF (torch) model.

Attention routes as in JAX: an unmasked stack ships the raw table into its
self-attention, which at ``sq >= flash_threshold`` runs
``flash_attention(rel_bias=...)`` (K1's relative-bias mode; no
``flash_min_tokens`` test here) and otherwise the materialised bias
through ``dispatch_attention(bias=...)`` (the fused path); a masked stack
builds the dense bias once and takes ``dispatch_attention`` with the mask;
cross-attention takes plain ``dispatch_attention``. Every route is
differentiable: on the relative-bias flash route the gradient reaches the
``rel_embedding`` table through ``ops/flash.py::_FlashAttentionRelFn``, so
T5 trains through ``training.Trainer`` with a seq2seq ``loss_fn``.

Parameters are float32; the forward computes in ``cfg.dtype``. The JAX
stacks run under ``nn.scan``; here blocks are a ``ModuleList`` whose
names follow the Flax tree (``encoder.blocks.{i}.self_attn.q`` is
``encoder/blocks/block/self_attn/q`` at layer i), ``nn.Linear.weight`` is
the Flax kernel transposed and ``T5LayerNorm.weight`` the Flax ``scale``
(``models/from_jax.py::t5_params_from_jax``). Initialisation follows the
Flax initialisers (``shared`` N(0, 1), ``rel_embedding`` N(0, 0.02), Dense
kernels lecun-normal, norms 1) drawn from an explicit ``torch.Generator``.
``load_hf_t5`` needs a download and is not called by any test.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import get_config
from ..ops.flash import flash_attention
from ..ops.rel_bias import T5RelBias, materialize
from .attention import dense, dispatch_attention, model_device


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 512
    d_kv: int = 64
    d_ff: int = 2048
    num_layers: int = 6
    num_decoder_layers: int = 6
    num_heads: int = 8
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    feed_forward_proj: str = "relu"  # "relu" (v1.0) | "gated-gelu" (v1.1)
    tie_word_embeddings: bool = True
    dtype: torch.dtype = torch.bfloat16

    @classmethod
    def small(cls) -> "T5Config":
        return cls()

    @classmethod
    def base(cls) -> "T5Config":
        return cls(d_model=768, d_ff=3072, num_layers=12, num_decoder_layers=12, num_heads=12)

    @classmethod
    def large(cls) -> "T5Config":
        return cls(d_model=1024, d_ff=4096, num_layers=24, num_decoder_layers=24, num_heads=16)

    @classmethod
    def tiny(cls) -> "T5Config":
        """For tests."""
        return cls(vocab_size=512, d_model=64, d_kv=16, d_ff=128, num_layers=2,
                   num_decoder_layers=2, num_heads=4)


class T5LayerNorm(nn.Module):
    """RMS norm: no mean subtraction, no bias; variance in fp32, the scale
    multiplied in fp32, then cast to ``dtype``."""

    def __init__(self, d_model: int, eps: float = 1e-6, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d_model))
        self.eps = eps
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var = (xf * xf).mean(-1, keepdim=True)
        return (xf * torch.rsqrt(var + self.eps) * self.weight).to(self.dtype)


class T5RelativeBias(nn.Module):
    """The learned (num_buckets, num_heads) bias table: the raw table for
    K1's relative-bias mode, or the dense (1, H, Sq, Skv) bias in
    ``cfg.dtype`` (rel = col - row)."""

    def __init__(self, cfg: T5Config, bidirectional: bool):
        super().__init__()
        self.config = cfg
        self.bidirectional = bidirectional
        self.rel_embedding = nn.Parameter(
            torch.empty(cfg.relative_attention_num_buckets, cfg.num_heads))

    def forward(self, sq: int, skv: int, as_table: bool = False) -> torch.Tensor:
        if as_table:
            return self.rel_embedding
        spec = T5RelBias(self.rel_embedding, self.bidirectional,
                         self.config.relative_attention_max_distance)
        return materialize(spec, sq, skv, kv_offset=0).to(self.config.dtype)


class T5Attention(nn.Module):
    """T5 attention: no projection bias, unscaled scores, optional additive
    position bias. With ``kernel_bias`` the ``bias`` argument is the raw
    table, which K1 turns into the bias itself (no dense (H, Sq, Skv)
    tensor) when the call is unmasked and at least ``flash_threshold``
    long."""

    def __init__(self, cfg: T5Config, causal: bool = False):
        super().__init__()
        self.config = cfg
        self.causal = causal
        inner = cfg.num_heads * cfg.d_kv
        self.q = nn.Linear(cfg.d_model, inner, bias=False)
        self.k = nn.Linear(cfg.d_model, inner, bias=False)
        self.v = nn.Linear(cfg.d_model, inner, bias=False)
        self.o = nn.Linear(inner, cfg.d_model, bias=False)

    def forward(
        self,
        x: torch.Tensor,
        kv: Optional[torch.Tensor] = None,
        mask: Optional[torch.Tensor] = None,
        bias: Optional[torch.Tensor] = None,
        kernel_bias: bool = False,
    ) -> torch.Tensor:
        cfg = self.config
        kv = x if kv is None else kv
        b, sq, _ = x.shape
        skv = kv.shape[1]
        h, d = cfg.num_heads, cfg.d_kv
        q = dense(x, self.q).reshape(b, sq, h, d)
        k = dense(kv, self.k).reshape(b, skv, h, d)
        v = dense(kv, self.v).reshape(b, skv, h, d)
        if kernel_bias and bias is not None:
            spec = T5RelBias(bias, bidirectional=not self.causal,
                             max_distance=cfg.relative_attention_max_distance)
            if mask is None and sq >= get_config().flash_threshold:
                out = flash_attention(q, k, v, causal=self.causal, sm_scale=1.0, rel_bias=spec)
            else:
                dense_bias = materialize(spec, sq, skv).to(cfg.dtype)
                out, _ = dispatch_attention(q, k, v, mask, bias=dense_bias, causal=self.causal,
                                            sm_scale=1.0)
        else:
            out, _ = dispatch_attention(q, k, v, mask, bias=bias, causal=self.causal, sm_scale=1.0)
        return dense(out.reshape(b, sq, h * d), self.o)


class T5FeedForward(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.gated = cfg.feed_forward_proj == "gated-gelu"
        if self.gated:
            self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
            self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        else:
            self.wi = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.gated:
            h = F.gelu(dense(x, self.wi_0), approximate="none") * dense(x, self.wi_1)
        else:
            h = F.relu(dense(x, self.wi))
        return dense(h, self.wo)


class T5Block(nn.Module):
    """Pre-norm block: self-attention, (cross-attention), feed-forward,
    each residual."""

    def __init__(self, cfg: T5Config, is_decoder: bool = False):
        super().__init__()
        self.is_decoder = is_decoder
        ln = lambda: T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon, cfg.dtype)  # noqa: E731
        self.self_attn = T5Attention(cfg, causal=is_decoder)
        self.self_attn_ln = ln()
        if is_decoder:
            self.cross_attn = T5Attention(cfg, causal=False)
            self.cross_attn_ln = ln()
        self.ffn = T5FeedForward(cfg)
        self.ffn_ln = ln()

    def forward(self, x, self_bias, self_mask, enc_out=None, enc_mask=None, kernel_bias=False):
        x = x + self.self_attn(self.self_attn_ln(x), mask=self_mask, bias=self_bias,
                               kernel_bias=kernel_bias)
        if self.is_decoder:
            x = x + self.cross_attn(self.cross_attn_ln(x), kv=enc_out, mask=enc_mask)
        return x + self.ffn(self.ffn_ln(x))


class T5Stack(nn.Module):
    """Encoder or decoder stack with the stack-level relative bias."""

    def __init__(self, cfg: T5Config, is_decoder: bool = False):
        super().__init__()
        n_layers = cfg.num_decoder_layers if is_decoder else cfg.num_layers
        self.rel_bias = T5RelativeBias(cfg, bidirectional=not is_decoder)
        self.blocks = nn.ModuleList(T5Block(cfg, is_decoder) for _ in range(n_layers))
        self.final_ln = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon, cfg.dtype)

    def forward(self, x, self_mask=None, enc_out=None, enc_mask=None) -> torch.Tensor:
        s = x.shape[1]
        # Unmasked stacks ship the raw table into each layer (K1 rebuilds
        # the bias); masked stacks take the dense bias on the fused path.
        kernel_bias = self_mask is None
        bias = self.rel_bias(s, s, as_table=kernel_bias)
        for block in self.blocks:
            x = block(x, bias, self_mask, enc_out, enc_mask, kernel_bias)
        return self.final_ln(x)


def _padding_mask(attention_mask: Optional[torch.Tensor], sq: int) -> Optional[torch.Tensor]:
    if attention_mask is None:
        return None
    keep = attention_mask.to(torch.bool)[:, None, None, :]
    return keep.expand(attention_mask.shape[0], 1, sq, attention_mask.shape[1])


class T5Model(nn.Module):
    """Encoder-decoder T5 without the LM head: decoder hidden states."""

    def __init__(self, cfg: T5Config, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = cfg
        self.shared = nn.Parameter(torch.empty(cfg.vocab_size, cfg.d_model))
        self.encoder = T5Stack(cfg, is_decoder=False)
        self.decoder = T5Stack(cfg, is_decoder=True)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Flax's initialisers, drawn from ``generator`` (on the parameters'
        device)."""
        nn.init.normal_(self.shared, std=1.0, generator=generator)
        for mod in self.modules():
            if isinstance(mod, T5RelativeBias):
                nn.init.normal_(mod.rel_embedding, std=0.02, generator=generator)
            elif isinstance(mod, nn.Linear):
                # lecun_normal: truncated normal at +-2 std, variance 1/fan_in.
                std = math.sqrt(1.0 / mod.in_features) / 0.87962566103423978
                nn.init.trunc_normal_(mod.weight, std=std, a=-2 * std, b=2 * std,
                                      generator=generator)
            elif isinstance(mod, T5LayerNorm):
                nn.init.ones_(mod.weight)

    def embed(self, ids: torch.Tensor) -> torch.Tensor:
        return self.shared.to(self.config.dtype)[ids]

    def encode(self, input_ids, attention_mask=None) -> torch.Tensor:
        x = self.embed(input_ids)
        return self.encoder(x, self_mask=_padding_mask(attention_mask, x.shape[1]))

    def decode(self, decoder_input_ids, enc_out, attention_mask=None,
               decoder_attention_mask=None) -> torch.Tensor:
        sq = decoder_input_ids.shape[1]
        x = self.embed(decoder_input_ids)
        return self.decoder(x, self_mask=_padding_mask(decoder_attention_mask, sq),
                            enc_out=enc_out, enc_mask=_padding_mask(attention_mask, sq))

    def forward(self, input_ids, decoder_input_ids, attention_mask=None,
                decoder_attention_mask=None) -> torch.Tensor:
        enc = self.encode(input_ids, attention_mask)
        return self.decode(decoder_input_ids, enc, attention_mask, decoder_attention_mask)


class T5ForConditionalGeneration(nn.Module):
    """T5 with the tied LM head (hidden states scaled by d_model**-0.5 when
    tied, the HF/T5 v1.0 convention): (B, Sd, V) logits in ``cfg.dtype``."""

    def __init__(self, cfg: T5Config, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = cfg
        self.model = T5Model(cfg, generator=generator)

    def forward(self, input_ids, decoder_input_ids, attention_mask=None,
                decoder_attention_mask=None) -> torch.Tensor:
        cfg = self.config
        h = self.model(input_ids, decoder_input_ids, attention_mask, decoder_attention_mask)
        if cfg.tie_word_embeddings:
            # JAX multiplies by the scale rounded to h's dtype.
            h = h * torch.tensor(cfg.d_model ** -0.5, dtype=h.dtype, device=h.device)
        return h @ self.model.shared.to(cfg.dtype).T


# ---------------------------------------------------------------------------
# HF weight transfer
# ---------------------------------------------------------------------------


def transfer_hf_t5(hf_model: Any, dtype: torch.dtype = torch.bfloat16, device: Any = "cuda"
                   ) -> Tuple[nn.Module, Dict[str, torch.Tensor], T5Config]:
    """An HF (torch) ``T5Model`` / ``T5ForConditionalGeneration`` -> (the
    port's model of the same kind with its weights on ``device``, the card
    by default, its state_dict, the config). HF's (out, in) Linear weights are the port's as they are; the
    layer-0 ``relative_attention_bias`` becomes the stack's table; the
    layer norms' weights map by name."""
    sd = {k: v.detach().float().cpu() for k, v in hf_model.state_dict().items()}
    hf_cfg = hf_model.config
    ff_proj = getattr(hf_cfg, "feed_forward_proj", "relu")
    cfg = T5Config(
        vocab_size=hf_cfg.vocab_size,
        d_model=hf_cfg.d_model,
        d_kv=hf_cfg.d_kv,
        d_ff=hf_cfg.d_ff,
        num_layers=hf_cfg.num_layers,
        num_decoder_layers=getattr(hf_cfg, "num_decoder_layers", hf_cfg.num_layers),
        num_heads=hf_cfg.num_heads,
        relative_attention_num_buckets=hf_cfg.relative_attention_num_buckets,
        relative_attention_max_distance=getattr(hf_cfg, "relative_attention_max_distance", 128),
        layer_norm_epsilon=hf_cfg.layer_norm_epsilon,
        feed_forward_proj="gated-gelu" if "gated" in ff_proj else "relu",
        tie_word_embeddings=getattr(hf_cfg, "tie_word_embeddings", True),
        dtype=dtype,
    )
    lm = type(hf_model).__name__.endswith("ForConditionalGeneration")
    pre = "model." if lm else ""
    out = {f"{pre}shared": sd["shared.weight"]}

    def attn(dst: str, src: str) -> None:
        for name in ("q", "k", "v", "o"):
            out[f"{dst}.{name}.weight"] = sd[f"{src}.{name}.weight"]

    for stack, n_layers, is_dec in (("encoder", cfg.num_layers, False),
                                    ("decoder", cfg.num_decoder_layers, True)):
        out[f"{pre}{stack}.rel_bias.rel_embedding"] = sd[
            f"{stack}.block.0.layer.0.SelfAttention.relative_attention_bias.weight"]
        out[f"{pre}{stack}.final_ln.weight"] = sd[f"{stack}.final_layer_norm.weight"]
        for i in range(n_layers):
            src, dst = f"{stack}.block.{i}.layer", f"{pre}{stack}.blocks.{i}"
            attn(f"{dst}.self_attn", f"{src}.0.SelfAttention")
            out[f"{dst}.self_attn_ln.weight"] = sd[f"{src}.0.layer_norm.weight"]
            ffn = 1
            if is_dec:
                attn(f"{dst}.cross_attn", f"{src}.1.EncDecAttention")
                out[f"{dst}.cross_attn_ln.weight"] = sd[f"{src}.1.layer_norm.weight"]
                ffn = 2
            names = ("wi_0", "wi_1", "wo") if cfg.feed_forward_proj == "gated-gelu" else ("wi", "wo")
            for name in names:
                out[f"{dst}.ffn.{name}.weight"] = sd[f"{src}.{ffn}.DenseReluDense.{name}.weight"]
            out[f"{dst}.ffn_ln.weight"] = sd[f"{src}.{ffn}.layer_norm.weight"]
    model = T5ForConditionalGeneration(cfg) if lm else T5Model(cfg)
    model.load_state_dict(out)
    model.to(model_device(device))
    return model, model.state_dict(), cfg


def load_hf_t5(model_name: str = "t5-small", dtype: torch.dtype = torch.bfloat16,
               device: Any = "cuda"):
    """Load HF T5 weights into the port (downloads: no test calls it)."""
    from transformers import T5ForConditionalGeneration as HFT5

    return transfer_hf_t5(HFT5.from_pretrained(model_name), dtype, device)
