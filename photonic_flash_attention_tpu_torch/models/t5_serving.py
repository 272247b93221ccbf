"""T5 (encoder-decoder) serving steps over the paged KV pool (PyTorch).

Port of ``photonic_flash_attention_tpu/models/t5_serving.py``:

* :func:`t5_prefill_step` — one encoder forward over the (right-padded)
  prompt, with dense fp32 scores, the relative bias and the padding mask
  (plain XLA in JAX, plain PyTorch here); the decoder's cross-attention
  K/V of every layer pinned into the request's serving slot; then the
  decoder start token (0) through :func:`_t5_decode_core`;
* :func:`t5_decode_step` — one decoder token per slot: paged
  self-attention through K2 and K3's token-bias mode (the T5 relative
  bias of every cached position, ``sm_scale`` 1), then dense
  cross-attention over the slot's pinned K/V.

JAX threads the pool through ``lax.scan`` and returns it; here both steps
loop over layers in Python and update the pages IN PLACE, so they return
only the logits. The decode batch is slot-ordered: row b reads the cross
buffers of slot b. The RMS norm here casts before it multiplies by the
scale (JAX ``_rms``), unlike ``models/t5.py::T5LayerNorm``; each is ported
as it is, and the serving logits are held to this module's own oracle.

Layout (all layers in one tensor):
  k/v: (L, H, num_pages, page_size, D) token-major (see ``ops/paged.py``),
  k_scales/v_scales: (L, H, num_pages, page_size) fp32 for int8 pools,
  cross_k/cross_v: (L, max_batch, H, enc_max_len, D) in ``cfg.dtype``
  (JAX: token-minor (L, max_batch, H, D, enc_max_len)),
  enc_len: (max_batch,) int32.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional

import torch
import torch.nn.functional as F

from ..ops.paged import paged_decode_attention
from ..ops.reference import DEFAULT_MASK_VALUE
from ..ops.rel_bias import T5RelBias, bias_vector, materialize
from .t5 import T5Config

DECODER_START_TOKEN_ID = 0  # T5 convention: the pad token starts decoding


@dataclasses.dataclass
class T5Pages:
    """Decoder self-attention pools plus pinned per-slot cross-KV buffers."""

    k: torch.Tensor  # (L, H, P, page, D)
    v: torch.Tensor
    k_scales: Optional[torch.Tensor]  # (L, H, P, page) or None
    v_scales: Optional[torch.Tensor]
    cross_k: torch.Tensor  # (L, max_batch, H, enc_max_len, D)
    cross_v: torch.Tensor
    enc_len: torch.Tensor  # (max_batch,) int32


def create_t5_pages(
    cfg: T5Config,
    num_pages: int,
    page_size: int,
    dtype: torch.dtype = torch.bfloat16,
    *,
    max_batch: int = 8,
    enc_max_len: int = 512,
    device: Any = "cuda",
) -> T5Pages:
    """Zeroed pools (scales 1 for int8) and cross buffers on ``device``."""
    L, H, D = cfg.num_decoder_layers, cfg.num_heads, cfg.d_kv
    shape = (L, H, num_pages, page_size, D)
    quant = dtype == torch.int8
    cross = (L, max_batch, H, enc_max_len, D)
    return T5Pages(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        k_scales=torch.ones(shape[:4], device=device) if quant else None,
        v_scales=torch.ones(shape[:4], device=device) if quant else None,
        cross_k=torch.zeros(cross, dtype=cfg.dtype, device=device),
        cross_v=torch.zeros(cross, dtype=cfg.dtype, device=device),
        enc_len=torch.zeros(max_batch, dtype=torch.int32, device=device),
    )


def prepare_params(state_dict: Mapping[str, torch.Tensor], cfg: T5Config, device: Any) -> Dict:
    """``T5ForConditionalGeneration`` state_dict -> serving weights on
    ``device``, cast once: embeddings, dense weights and norm scales in
    ``cfg.dtype`` (JAX casts them inside every step), the relative-bias
    tables in float32. Also the tied head's ``d_model ** -0.5`` as a
    ``cfg.dtype`` scalar on ``device`` (the step multiplies by it, as JAX
    does, with no host copy a step) and ``dec_bias_vectors``, the decoder
    self-attention bias vector of each page-table capacity, filled at its
    first step and kept with the weights (a CUDA graph of the step reads
    it)."""

    def w(name, dtype=cfg.dtype):
        return state_dict[f"model.{name}"].to(device=device, dtype=dtype)

    ffn = ("wi_0", "wi_1", "wo") if cfg.feed_forward_proj == "gated-gelu" else ("wi", "wo")

    def layers(stack: str, n: int, decoder: bool) -> List[Dict]:
        out = []
        for i in range(n):
            pre = f"{stack}.blocks.{i}."
            attns = ("self_attn", "cross_attn") if decoder else ("self_attn",)
            layer = {a: {x: w(f"{pre}{a}.{x}.weight") for x in "qkvo"} for a in attns}
            for ln in attns + ("ffn",):
                layer[f"{ln}_ln"] = w(f"{pre}{ln}_ln.weight")
            layer["ffn"] = {x: w(f"{pre}ffn.{x}.weight") for x in ffn}
            out.append(layer)
        return out

    return {
        "shared": w("shared"),
        "encoder": layers("encoder", cfg.num_layers, False),
        "decoder": layers("decoder", cfg.num_decoder_layers, True),
        "enc_table": w("encoder.rel_bias.rel_embedding", torch.float32),
        "dec_table": w("decoder.rel_bias.rel_embedding", torch.float32),
        "enc_final_ln": w("encoder.final_ln.weight"),
        "dec_final_ln": w("decoder.final_ln.weight"),
        "logit_scale": torch.tensor(cfg.d_model ** -0.5, dtype=cfg.dtype, device=device),
        "dec_bias_vectors": {},
    }


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """JAX ``_rms``: normalise in fp32, cast to x's dtype, then scale."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale


def _ffn(x: torch.Tensor, p: Dict, cfg: T5Config) -> torch.Tensor:
    h = _rms(x, p["ffn_ln"], cfg.layer_norm_epsilon)
    m = p["ffn"]
    if cfg.feed_forward_proj == "gated-gelu":
        inner = F.gelu(F.linear(h, m["wi_0"]), approximate="none") * F.linear(h, m["wi_1"])
    else:
        inner = F.relu(F.linear(h, m["wi"]))
    return x + F.linear(inner, m["wo"])


def _encoder_forward(params: Dict, cfg: T5Config, enc_ids: torch.Tensor,
                     enc_len: torch.Tensor) -> torch.Tensor:
    """Bidirectional encoder with dense fp32 scores, the relative bias and
    the padding mask (unscaled scores)."""
    b, s = enc_ids.shape
    H, D, eps = cfg.num_heads, cfg.d_kv, cfg.layer_norm_epsilon
    x = params["shared"][enc_ids.long()]
    spec = T5RelBias(params["enc_table"], True, cfg.relative_attention_max_distance)
    bias = materialize(spec, s, s, kv_offset=0)  # (1, H, S, S) fp32
    keep = torch.arange(s, device=x.device)[None] < enc_len.to(x.device)[:, None]
    bias = bias + torch.where(keep, 0.0, DEFAULT_MASK_VALUE)[:, None, None, :]
    for p in params["encoder"]:
        h = _rms(x, p["self_attn_ln"], eps)
        a = p["self_attn"]
        q, k, v = (F.linear(h, a[n]).reshape(b, s, H, D) for n in "qkv")
        sc = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) + bias
        w = torch.softmax(sc, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", w, v.float()).to(x.dtype).reshape(b, s, H * D)
        x = _ffn(x + F.linear(out, a["o"]), p, cfg)
    return _rms(x, params["enc_final_ln"], eps)


def _decode_bias(params: Dict, cfg: T5Config, positions: torch.Tensor, s_cap: int) -> torch.Tensor:
    """(B, H, S_cap) fp32 decoder self-attention bias of every potential key
    position k for the query at ``positions[b]``: table[bucket(k - pos)],
    a gather of one (H, 2 S_cap - 1) vector over rel = -(S_cap-1) .. S_cap-1
    (built at the first step of each S_cap, kept in ``params``)."""
    vec = params["dec_bias_vectors"].get(s_cap)
    if vec is None:
        spec = T5RelBias(params["dec_table"], False, cfg.relative_attention_max_distance)
        vec = params["dec_bias_vectors"][s_cap] = bias_vector(spec, -(s_cap - 1), 2 * s_cap - 1)
    k_pos = torch.arange(s_cap, device=vec.device)
    idx = (k_pos[None] - positions.to(vec.device).long()[:, None] + s_cap - 1).clamp(0, 2 * s_cap - 2)
    return vec[:, idx].permute(1, 0, 2).contiguous()


def _t5_decode_core(
    params: Dict,
    cfg: T5Config,
    input_ids: torch.Tensor,  # (B,)
    positions: torch.Tensor,  # (B,) decoder position of the consumed token
    pages: T5Pages,
    flat_slots: torch.Tensor,  # (B,) int32
    lengths: torch.Tensor,  # (B,) int32 decoder length INCLUDING the current token
    page_tables: torch.Tensor,  # (B, pages_per_seq) int32
    quantized: bool,
    cross_rows: Optional[torch.Tensor] = None,  # (B,) slot per row; None: rows 0..B-1
) -> torch.Tensor:
    b = input_ids.shape[0]
    H, D, eps = cfg.num_heads, cfg.d_kv, cfg.layer_norm_epsilon
    s_cap = page_tables.shape[1] * pages.k.shape[3]
    x = params["shared"][input_ids.long()]  # (B, E)
    self_bias = _decode_bias(params, cfg, positions, s_cap)
    rows = slice(0, b) if cross_rows is None else cross_rows.long()
    enc_len = pages.enc_len[rows]
    s_enc = pages.cross_k.shape[3]
    enc_keep = torch.arange(s_enc, device=x.device)[None] < enc_len[:, None]
    for lyr, p in enumerate(params["decoder"]):
        # Paged self-attention: K2 writes the token, K3 attends with the bias.
        h = _rms(x, p["self_attn_ln"], eps)
        a = p["self_attn"]
        q, k, v = (F.linear(h, a[n]).reshape(b, H, D) for n in "qkv")
        attn = paged_decode_attention(
            q.float(), k, v, pages.k, pages.v, lengths, page_tables, flat_slots, lyr,
            pages.k_scales if quantized else None, pages.v_scales if quantized else None,
            sm_scale=1.0, token_bias=self_bias,
        )
        x = x + F.linear(attn.reshape(b, H * D).to(x.dtype), a["o"])
        # Dense cross-attention over the slot's pinned encoder K/V.
        h2 = _rms(x, p["cross_attn_ln"], eps)
        c = p["cross_attn"]
        q2 = F.linear(h2, c["q"]).reshape(b, H, D).float()
        ck, cv = pages.cross_k[lyr][rows], pages.cross_v[lyr][rows]  # (B, H, S_enc, D)
        s2 = torch.einsum("bhd,bhsd->bhs", q2, ck.float())
        s2 = s2.masked_fill(~enc_keep[:, None], DEFAULT_MASK_VALUE)
        out2 = torch.einsum("bhs,bhsd->bhd", torch.softmax(s2, dim=-1), cv.float())
        x = x + F.linear(out2.reshape(b, H * D).to(x.dtype), c["o"])
        x = _ffn(x, p, cfg)
    x = _rms(x, params["dec_final_ln"], eps)
    if cfg.tie_word_embeddings:
        x = x * params["logit_scale"]
    return (x @ params["shared"].T).float()


@torch.no_grad()
def t5_prefill_step(
    params: Dict,
    cfg: T5Config,
    enc_ids: torch.Tensor,  # (1, S_pad) right-padded encoder prompt
    enc_len: torch.Tensor,  # (1,)
    pages: T5Pages,
    dec0_slot: torch.Tensor,  # (1,) int32 flat page slot of decoder token 0
    dec_tables: torch.Tensor,  # (1, pages_per_seq) int32
    quantized: bool,
    slot: int,  # serving slot row of the cross buffers
) -> torch.Tensor:
    """Encoder forward, cross-KV pin into ``slot``, decoder start-token
    step; pages updated in place. Returns the logits (1, V) float32 after
    consuming DECODER_START_TOKEN_ID: the first generated token's
    distribution."""
    H, D = cfg.num_heads, cfg.d_kv
    enc_out = _encoder_forward(params, cfg, enc_ids, enc_len)[0]  # (S, E)
    s = enc_out.shape[0]
    s_enc = pages.cross_k.shape[3]
    if s > s_enc:
        raise ValueError(f"encoder prompt ({s}) exceeds enc_max_len ({s_enc})")
    for lyr, p in enumerate(params["decoder"]):
        c = p["cross_attn"]
        for buf, name in ((pages.cross_k, "k"), (pages.cross_v, "v")):
            kv = F.linear(enc_out, c[name]).reshape(s, H, D).transpose(0, 1)  # (H, S, D)
            buf[lyr, slot, :, :s] = kv
            buf[lyr, slot, :, s:] = 0
    pages.enc_len[slot] = enc_len.reshape(())
    dev = enc_ids.device
    return _t5_decode_core(
        params, cfg,
        torch.full((1,), DECODER_START_TOKEN_ID, dtype=torch.long, device=dev),
        torch.zeros(1, dtype=torch.long, device=dev),  # decoder position 0
        pages, dec0_slot.to(torch.int32),
        torch.ones(1, dtype=torch.int32, device=dev),  # decoder length 1
        dec_tables, quantized,
        torch.tensor([slot], device=dev),
    )


@torch.no_grad()
def t5_decode_step(
    params: Dict,
    cfg: T5Config,
    input_ids: torch.Tensor,  # (B,)
    positions: torch.Tensor,  # (B,) decoder position of the consumed token
    pages: T5Pages,
    flat_slots: torch.Tensor,  # (B,) int32
    lengths: torch.Tensor,  # (B,) int32 decoder length INCLUDING the current token
    page_tables: torch.Tensor,  # (B, pages_per_seq) int32
    quantized: bool,
) -> torch.Tensor:
    """One decoder token per slot (pages updated in place); row b reads the
    cross buffers of slot b. Returns logits (B, V) float32."""
    return _t5_decode_core(params, cfg, input_ids, positions, pages, flat_slots, lengths,
                           page_tables, quantized)
