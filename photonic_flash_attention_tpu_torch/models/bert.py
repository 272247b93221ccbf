"""BERT encoder (dense forward), in PyTorch.

Port of ``photonic_flash_attention_tpu/models/bert.py``: ``BertConfig``
(bert-base by default; ``tiny`` for tests), ``BertEmbeddings`` (word,
position and token-type tables, LayerNorm in fp32), the post-LN
``BertLayer`` (attention on ``PhotonicFlashAttention(causal=False,
adaptive=False)``, add and LayerNorm, the exact (erf) GELU feed-forward,
add and LayerNorm) and ``BertModel`` (the HF tanh pooler over the [CLS]
position), plus ``transfer_hf_bert`` from an HF (torch) model.

A padding mask (HF convention, 1 = attend) becomes the flash kernel's
per-row key lengths and per-key bias
(``models/attention.py::padding_mask_to_lens_bias``), so a padded batch
stays on K1's key streams (the dense-mask fused path only below
``flash_threshold``), as in JAX.

The model is made on the card unless the caller passes another
``device`` (the tests pass ``"cpu"``), ``transfer_hf_bert``'s too.
Parameters are float32; the forward computes in ``cfg.dtype`` (LayerNorm
statistics in float32, as Flax's). The JAX encoder runs under
``nn.scan``; here the layers are a ``ModuleList`` whose names follow the
Flax tree (``encoder.{i}.attention.q_proj`` is
``encoder/layer/attention/q_proj`` at layer i;
``models/from_jax.py::bert_params_from_jax``). Initialisation follows
the Flax initialisers (tables N(0, 0.02), Dense kernels lecun-normal,
biases 0, LayerNorm 1/0) drawn from an explicit ``torch.Generator``.
``load_hf_bert`` needs a download and is not called by any test.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .attention import PhotonicFlashAttention, dense, model_device, padding_mask_to_lens_bias
from .gpt2 import layer_norm


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    dtype: torch.dtype = torch.bfloat16

    @classmethod
    def tiny(cls) -> "BertConfig":
        """For tests."""
        return cls(vocab_size=512, hidden_size=128, num_hidden_layers=2, num_attention_heads=4,
                   intermediate_size=256, max_position_embeddings=128)


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig) -> None:
        super().__init__()
        self.config = cfg
        e = cfg.hidden_size
        self.word_embeddings = nn.Parameter(torch.empty(cfg.vocab_size, e))
        self.position_embeddings = nn.Parameter(torch.empty(cfg.max_position_embeddings, e))
        self.token_type_embeddings = nn.Parameter(torch.empty(cfg.type_vocab_size, e))
        self.LayerNorm = nn.LayerNorm(e, eps=cfg.layer_norm_eps)

    def forward(self, input_ids: torch.Tensor, token_type_ids: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        s = input_ids.shape[1]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        positions = torch.arange(s, device=input_ids.device)[None]
        x = (self.word_embeddings[input_ids] + self.position_embeddings[positions]
             + self.token_type_embeddings[token_type_ids])
        return layer_norm(x, self.LayerNorm).to(self.config.dtype)


class BertLayer(nn.Module):
    """Post-LN encoder block (attention -> add & norm -> FFN -> add & norm)."""

    def __init__(self, cfg: BertConfig) -> None:
        super().__init__()
        e, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.attention = PhotonicFlashAttention(e, cfg.num_attention_heads, causal=False,
                                                adaptive=False, dtype=cfg.dtype)
        self.attention_ln = nn.LayerNorm(e, eps=eps)
        self.intermediate = nn.Linear(e, cfg.intermediate_size)
        self.output = nn.Linear(cfg.intermediate_size, e)
        self.output_ln = nn.LayerNorm(e, eps=eps)

    def forward(self, x: torch.Tensor, kv_lens: Optional[torch.Tensor] = None,
                k_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        attn, _ = self.attention(x, kv_lens=kv_lens, k_bias=k_bias)
        x = layer_norm(x + attn, self.attention_ln)
        h = F.gelu(dense(x, self.intermediate))  # BERT's exact (erf) GELU
        return layer_norm(x + dense(h, self.output), self.output_ln)


class BertModel(nn.Module):
    """BERT encoder. Input: (B, S) token ids. Returns (sequence output
    (B, S, H), pooled output (B, H) or None without the pooler), both in
    ``cfg.dtype``. Made on ``device``, the card by default."""

    def __init__(self, cfg: BertConfig, *, add_pooler: bool = True,
                 generator: Optional[torch.Generator] = None, device: Any = "cuda") -> None:
        super().__init__()
        self.config = cfg
        with model_device(device):
            self.embeddings = BertEmbeddings(cfg)
            self.encoder = nn.ModuleList(BertLayer(cfg) for _ in range(cfg.num_hidden_layers))
            self.pooler = nn.Linear(cfg.hidden_size, cfg.hidden_size) if add_pooler else None
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Flax's initialisers, drawn from ``generator`` (on the parameters'
        device)."""
        emb = self.embeddings
        for table in (emb.word_embeddings, emb.position_embeddings, emb.token_type_embeddings):
            nn.init.normal_(table, std=0.02, generator=generator)
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                # lecun_normal: truncated normal at +-2 std, variance 1/fan_in.
                std = math.sqrt(1.0 / mod.in_features) / 0.87962566103423978
                nn.init.trunc_normal_(mod.weight, std=std, a=-2 * std, b=2 * std,
                                      generator=generator)
                nn.init.zeros_(mod.bias)
            elif isinstance(mod, nn.LayerNorm):
                nn.init.ones_(mod.weight)
                nn.init.zeros_(mod.bias)

    def forward(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None,
                token_type_ids: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        x = self.embeddings(input_ids, token_type_ids)
        kv_lens = k_bias = None
        if attention_mask is not None:
            kv_lens, k_bias = padding_mask_to_lens_bias(attention_mask.to(torch.bool))
        for layer in self.encoder:
            x = layer(x, kv_lens, k_bias)
        pooled = None if self.pooler is None else torch.tanh(dense(x[:, 0], self.pooler))
        return x, pooled


# ---------------------------------------------------------------------------
# HF weight transfer
# ---------------------------------------------------------------------------


def transfer_hf_bert(hf_model: Any, dtype: torch.dtype = torch.bfloat16, device: Any = "cuda"
                     ) -> Tuple[BertModel, Dict[str, torch.Tensor], BertConfig]:
    """An HF (torch) ``BertModel`` (or a task model wrapping one as
    ``.bert``) -> (the port's ``BertModel`` with its weights on ``device``,
    the card by default, its state_dict, the config). The separate query/key/value projections map
    one to one; HF's (out, in) Linear weights are the port's as they are.
    Without HF's pooler the port's model has none."""
    hf = getattr(hf_model, "bert", hf_model)
    sd = {k: v.detach().float().cpu() for k, v in hf.state_dict().items()}
    hf_cfg = hf.config
    cfg = BertConfig(
        vocab_size=hf_cfg.vocab_size,
        hidden_size=hf_cfg.hidden_size,
        num_hidden_layers=hf_cfg.num_hidden_layers,
        num_attention_heads=hf_cfg.num_attention_heads,
        intermediate_size=hf_cfg.intermediate_size,
        max_position_embeddings=hf_cfg.max_position_embeddings,
        type_vocab_size=hf_cfg.type_vocab_size,
        layer_norm_eps=hf_cfg.layer_norm_eps,
        dtype=dtype,
    )
    out = {f"embeddings.{t}": sd[f"embeddings.{t}.weight"]
           for t in ("word_embeddings", "position_embeddings", "token_type_embeddings")}
    for wb in ("weight", "bias"):
        out[f"embeddings.LayerNorm.{wb}"] = sd[f"embeddings.LayerNorm.{wb}"]
        for i in range(cfg.num_hidden_layers):
            src, dst = f"encoder.layer.{i}.", f"encoder.{i}."
            for name, hf_name in (("q_proj", "self.query"), ("k_proj", "self.key"),
                                  ("v_proj", "self.value"), ("out_proj", "output.dense")):
                out[f"{dst}attention.{name}.{wb}"] = sd[f"{src}attention.{hf_name}.{wb}"]
            out[f"{dst}attention_ln.{wb}"] = sd[f"{src}attention.output.LayerNorm.{wb}"]
            out[f"{dst}intermediate.{wb}"] = sd[f"{src}intermediate.dense.{wb}"]
            out[f"{dst}output.{wb}"] = sd[f"{src}output.dense.{wb}"]
            out[f"{dst}output_ln.{wb}"] = sd[f"{src}output.LayerNorm.{wb}"]
    has_pooler = "pooler.dense.weight" in sd
    if has_pooler:
        out["pooler.weight"] = sd["pooler.dense.weight"]
        out["pooler.bias"] = sd["pooler.dense.bias"]
    model = BertModel(cfg, add_pooler=has_pooler, device=device)
    model.load_state_dict(out)
    return model, model.state_dict(), cfg


def load_hf_bert(model_name: str = "bert-base-uncased", dtype: torch.dtype = torch.bfloat16,
                 device: Any = "cuda"):
    """Load HF BERT weights into the port (downloads: no test calls it)."""
    from transformers import BertModel as HFBertModel

    return transfer_hf_bert(HFBertModel.from_pretrained(model_name), dtype, device)
