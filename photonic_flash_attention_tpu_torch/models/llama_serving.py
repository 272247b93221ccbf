"""Llama serving steps over the paged KV pool (PyTorch).

Port of ``photonic_flash_attention_tpu/models/llama_serving.py``, in the
form of ``models/gpt2_serving.py`` (eager, no grad, the pool updated IN
PLACE, the steps returning only the logits, weights cast once by
:func:`prepare_params`), with the family's differences:

* RMSNorm, bias-free projections, the SwiGLU MLP;
* rotary embeddings on q and k inside each step at the tokens' absolute
  positions (never clamped: RoPE has no table to overrun); K is stored in
  the pool after the rotation, so the history a chunk gathers needs none;
* a GQA-sized pool: ``KVPages`` with ``num_key_value_heads`` heads of
  ``head_dim``, token-major (L, Hkv, P, page, D) as every pool of the
  port (JAX's Llama pool is token-minor (L, Hkv, P, D, page)); K1 and K3
  read the query-head groups natively.

Kernels: the prefill runs K1 (``flash_attention_best``), a chunk K1 with
its key-bias stream over [paged history || chunk], and the decode K3's
fused write + attend (``pfa_paged_decode_fused``) once a layer a step,
with the query in fp32 as JAX hands it over.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import torch
import torch.nn.functional as F

from ..ops.flash_unrolled import flash_attention_best
from ..ops.paged import paged_decode_attention
from .gpt2_serving import KVPages, _attend_chunk, _chunk_key_bias, _decode_write, _last_valid
from .llama import LlamaConfig, apply_rope, rms_norm, rope_cos_sin

_DENSE = {
    "q_proj": "attn", "k_proj": "attn", "v_proj": "attn", "o_proj": "attn",
    "gate_proj": "mlp", "up_proj": "mlp", "down_proj": "mlp",
}


def create_llama_pages(
    cfg: LlamaConfig, num_pages: int, page_size: int, dtype: torch.dtype = torch.bfloat16,
    device: Any = "cuda",
) -> KVPages:
    """The pool of Hkv heads (not Hq): the KV memory GQA saves."""
    return KVPages.zeros(cfg.num_hidden_layers, cfg.num_key_value_heads, num_pages, page_size,
                         cfg.head_dim, dtype, device)


def prepare_params(
    state_dict: Mapping[str, torch.Tensor], cfg: LlamaConfig, device: Any
) -> Dict[str, Any]:
    """``LlamaForCausalLM`` state_dict -> serving weights on ``device``:
    embeddings, dense weights and the untied head in ``cfg.dtype``, the
    norms' scales in float32. A weight already in its dtype on ``device``
    is the state_dict's tensor itself, not a copy."""

    def w(name, dtype=cfg.dtype):
        return state_dict[name].to(device=device, dtype=dtype)

    layers = []
    for i in range(cfg.num_hidden_layers):
        pre = f"layers.{i}."
        layer = {ln: w(f"{pre}{ln}.weight", torch.float32) for ln in ("input_ln", "post_attn_ln")}
        for name, group in _DENSE.items():
            layer[name] = w(f"{pre}{group}.{name}.weight")
        layers.append(layer)
    params = {"embed_tokens": w("embed_tokens"), "norm": w("norm.weight", torch.float32),
              "layers": layers}
    if not cfg.tie_word_embeddings and "lm_head.weight" in state_dict:
        params["lm_head"] = w("lm_head.weight")
    return params


def _lm_head(x: torch.Tensor, params: Dict[str, Any]) -> torch.Tensor:
    if "lm_head" in params:
        return F.linear(x, params["lm_head"]).float()
    return (x @ params["embed_tokens"].T).float()


def _mlp(x: torch.Tensor, p: Dict[str, Any], eps: float) -> torch.Tensor:
    h2 = rms_norm(x, p["post_attn_ln"], eps, x.dtype)
    gate = F.silu(F.linear(h2, p["gate_proj"]))
    return x + F.linear(gate * F.linear(h2, p["up_proj"]), p["down_proj"])


def _qkv(h: torch.Tensor, p: Dict[str, Any], cfg: LlamaConfig, cos, sin):
    """(B, S, E) -> q (B, S, Hq, D) and k (B, S, Hkv, D) rotated, v."""
    b, s, _ = h.shape
    hq, hkv, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    q = apply_rope(F.linear(h, p["q_proj"]).reshape(b, s, hq, d), cos, sin)
    k = apply_rope(F.linear(h, p["k_proj"]).reshape(b, s, hkv, d), cos, sin)
    v = F.linear(h, p["v_proj"]).reshape(b, s, hkv, d)
    return q, k, v


@torch.no_grad()
def llama_prefill_step(
    params: Dict[str, Any],
    cfg: LlamaConfig,
    input_ids: torch.Tensor,  # (B, S) right-padded
    prompt_lengths: torch.Tensor,  # (B,)
    pages: KVPages,
    flat_slots: torch.Tensor,  # (B, S) int32 flat page slots (trash past len)
    quantized: bool,
) -> torch.Tensor:
    """Prompt forward + cache fill (pool updated in place). Returns the
    last real token's logits (B, V) float32."""
    b, s = input_ids.shape
    hq, hkv, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    eps = cfg.rms_norm_eps
    device = input_ids.device
    positions = torch.arange(s, device=device)[None].expand(b, s)
    cos, sin = rope_cos_sin(positions, d, cfg.rope_theta)
    x = params["embed_tokens"][input_ids.long()]
    slots = flat_slots.reshape(b * s)
    for lyr, p in enumerate(params["layers"]):
        q, k, v = _qkv(rms_norm(x, p["input_ln"], eps, x.dtype), p, cfg, cos, sin)
        _decode_write(pages, k.reshape(b * s, hkv, d), v.reshape(b * s, hkv, d), slots, lyr)
        attn = flash_attention_best(q, k, v, causal=True).reshape(b, s, hq * d)
        x = _mlp(x + F.linear(attn, p["o_proj"]), p, eps)
    x = rms_norm(x, params["norm"], eps, x.dtype)
    return _lm_head(_last_valid(x, prompt_lengths), params)


@torch.no_grad()
def llama_decode_step(
    params: Dict[str, Any],
    cfg: LlamaConfig,
    input_ids: torch.Tensor,  # (B,) current token per sequence
    positions: torch.Tensor,  # (B,) position of that token
    pages: KVPages,
    flat_slots: torch.Tensor,  # (B,) int32 flat slot for the new token
    lengths: torch.Tensor,  # (B,) int32 cache length AFTER this token
    page_tables: torch.Tensor,  # (B, pages_per_seq) int32
    quantized: bool,
) -> torch.Tensor:
    """One decode token per sequence (pool updated in place): per layer
    ONE K3 launch writes the token's K/V and attends over the pages.
    Returns logits (B, V) float32."""
    b = input_ids.shape[0]
    hq, d = cfg.num_attention_heads, cfg.head_dim
    eps = cfg.rms_norm_eps
    cos, sin = rope_cos_sin(positions.to(input_ids.device)[:, None], d, cfg.rope_theta)
    x = params["embed_tokens"][input_ids.long()][:, None]  # (B, 1, E)
    for lyr, p in enumerate(params["layers"]):
        q, k, v = _qkv(rms_norm(x, p["input_ln"], eps, x.dtype), p, cfg, cos, sin)
        attn = paged_decode_attention(
            q[:, 0].float(), k[:, 0], v[:, 0], pages.k, pages.v, lengths, page_tables,
            flat_slots, lyr,
            pages.k_scales if quantized else None,
            pages.v_scales if quantized else None,
        )
        attn = attn.reshape(b, 1, hq * d).to(x.dtype)
        x = _mlp(x + F.linear(attn, p["o_proj"]), p, eps)
    x = rms_norm(x[:, 0], params["norm"], eps, x.dtype)
    return _lm_head(x, params)


@torch.no_grad()
def llama_prefill_chunk_step(
    params: Dict[str, Any],
    cfg: LlamaConfig,
    input_ids: torch.Tensor,  # (B, C) chunk tokens, right-padded
    chunk_start: torch.Tensor,  # (B,) global position of chunk token 0
    chunk_lens: torch.Tensor,  # (B,) valid tokens in this chunk
    pages: KVPages,
    flat_slots: torch.Tensor,  # (B, C) int32 flat page slots (trash past the chunk)
    page_tables: torch.Tensor,  # (B, pages_per_seq) int32
    quantized: bool,
    s_hist: int,  # history window in tokens, a multiple of the page size
) -> torch.Tensor:
    """One chunk of a chunked Llama prefill (JAX ``llama_prefill_chunk_step``),
    pool updated in place: the chunk's q and k rotated at their absolute
    positions, then per layer ONE K1 call over [history || chunk], the
    history gathered from the pool (stored after RoPE, so rotated already;
    Hkv heads) and the per-key bias killing the history past
    ``chunk_start`` and the chunk's padding. Returns the last valid chunk
    token's logits (B, V) float32."""
    b, c = input_ids.shape
    hq, d = cfg.num_attention_heads, cfg.head_dim
    eps = cfg.rms_norm_eps
    device = input_ids.device
    n_hist_pages = s_hist // pages.k.shape[3]
    chunk_start = chunk_start.to(device).long()
    chunk_lens = chunk_lens.to(device).long()
    positions = chunk_start[:, None] + torch.arange(c, device=device)[None]
    cos, sin = rope_cos_sin(positions, d, cfg.rope_theta)
    x = params["embed_tokens"][input_ids.long()]
    k_bias = _chunk_key_bias(chunk_start, chunk_lens, s_hist, c)
    slots = flat_slots.reshape(b * c)
    for lyr, p in enumerate(params["layers"]):
        q, k, v = _qkv(rms_norm(x, p["input_ln"], eps, x.dtype), p, cfg, cos, sin)
        attn = _attend_chunk(pages, page_tables, lyr, n_hist_pages, q, k, v, slots, k_bias)
        x = _mlp(x + F.linear(attn.reshape(b, c, hq * d), p["o_proj"]), p, eps)
    x = rms_norm(x, params["norm"], eps, x.dtype)
    return _lm_head(_last_valid(x, chunk_lens), params)
