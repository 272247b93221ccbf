"""GPT-2 serving steps over the paged KV pool (PyTorch).

Port of ``photonic_flash_attention_tpu/models/gpt2_serving.py``:

* :func:`prefill_step` — full-prompt forward with the flash forward (K1),
  writing every token's K/V into the sequence's pages (plain-torch scatter,
  as the JAX package leaves it to XLA);
* :func:`prefill_chunk_step` — one chunk of a chunked prefill: the chunk's
  queries over [paged history || chunk] in one K1 call with the per-key
  bias stream;
* :func:`decode_step` — one token per sequence: QKV projection, then per
  layer the paged token write (K2) and paged decode attention (K3).

JAX threads the pool through ``lax.scan`` as a carry and returns it; here
both steps are a Python loop over layers and update the pool IN PLACE, so
they return only the logits.

Tensor-parallel serving (JAX ``tp_axis``): with ``tp_group`` (the process
group of the mesh's model axis) each step runs on this rank's shards as
:func:`serving_param_specs` and :func:`serving_pages_specs` place them:
the rank's heads of q/k/v and of the pool (int8 scales included), its
columns of ``c_fc``, its rows of ``out_proj`` and ``c_proj``, whose
partial sums are all-reduced (two all-reduces a layer; the replicated
bias enters the partial sum on the group's first rank, so one rank
computes exactly the unsharded step). The residual stream, the logits and
so the sampled tokens are the same on every rank.

The per-token int8 quantization (the JAX ``_quant_tokens``) is
``ops/paged.py::_quant_token_write``.

Pool layout (all layers in one tensor), token-major for 16-byte loads
along D (see ``ops/paged.py``):
  k/v: (L, Hkv, num_pages, page_size, D)
  k_scales/v_scales: (L, Hkv, num_pages, page_size) fp32 (int8 pools)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.flash import flash_attention
from ..ops.flash_unrolled import flash_attention_best
from ..ops.paged import paged_decode_attention, paged_token_write_plain
from ..ops.reference import DEFAULT_MASK_VALUE
from ..parallel import collectives as C
from ..parallel.mesh import PartitionSpec, shard_tensor
from .gpt2 import GPT2Config

#: dense layer -> its parent module in the GPT2LMHead state_dict.
_DENSE = {
    "q_proj": "attn", "k_proj": "attn", "v_proj": "attn", "out_proj": "attn",
    "c_fc": "mlp", "c_proj": "mlp",
}


@dataclasses.dataclass
class KVPages:
    """Device-side paged KV store for all layers."""

    k: torch.Tensor  # (L, Hkv, P, page, D)
    v: torch.Tensor
    k_scales: Optional[torch.Tensor]  # (L, Hkv, P, page) or None
    v_scales: Optional[torch.Tensor]

    @property
    def quantized(self) -> bool:
        return self.k_scales is not None

    @staticmethod
    def create(
        cfg: GPT2Config, num_pages: int, page_size: int,
        dtype: torch.dtype = torch.bfloat16, device: Any = "cuda",
    ) -> "KVPages":
        return KVPages.zeros(cfg.n_layer, cfg.n_head, num_pages, page_size,
                             cfg.n_embd // cfg.n_head, dtype, device)

    @staticmethod
    def zeros(
        n_layer: int, n_kv_heads: int, num_pages: int, page_size: int, head_dim: int,
        dtype: torch.dtype = torch.bfloat16, device: Any = "cuda",
    ) -> "KVPages":
        """Zeroed pools of any family (int8 pools: scales 1)."""
        shape = (n_layer, n_kv_heads, num_pages, page_size, head_dim)
        quant = dtype == torch.int8
        sshape = shape[:4]
        return KVPages(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
            k_scales=torch.ones(sshape, device=device) if quant else None,
            v_scales=torch.ones(sshape, device=device) if quant else None,
        )


def prepare_params(
    state_dict: Mapping[str, torch.Tensor], cfg: GPT2Config, device: Any
) -> Dict[str, Any]:
    """``GPT2LMHead`` state_dict -> serving weights on ``device``, cast once:
    embeddings and dense weights in ``cfg.dtype`` (the JAX step casts them
    inside every call), LayerNorm parameters in float32."""

    def w(name, dtype=cfg.dtype):
        return state_dict[name].to(device=device, dtype=dtype)

    layers = []
    for i in range(cfg.n_layer):
        pre = f"h.{i}."
        layer = {
            ln: (w(f"{pre}{ln}.weight", torch.float32), w(f"{pre}{ln}.bias", torch.float32))
            for ln in ("ln_1", "ln_2")
        }
        for name, group in _DENSE.items():
            layer[name] = (w(f"{pre}{group}.{name}.weight"), w(f"{pre}{group}.{name}.bias"))
        layers.append(layer)
    return {
        "wte": w("wte"),
        "wpe": w("wpe"),
        "ln_f": (w("ln_f.weight", torch.float32), w("ln_f.bias", torch.float32)),
        "layers": layers,
    }


def _layer_norm(x: torch.Tensor, wb: Tuple[torch.Tensor, torch.Tensor], eps: float):
    """Float32 LayerNorm, cast back to x's dtype (as the JAX ``_layer_norm``)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    return ((xf - mean) * torch.rsqrt(var + eps) * wb[0] + wb[1]).to(x.dtype)


def _dense(x: torch.Tensor, wb: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    return F.linear(x, wb[0], wb[1])


def _local_heads(params: Dict[str, Any], d: int) -> int:
    """Heads this rank holds: all of them, or its shard under TP."""
    return params["layers"][0]["q_proj"][0].shape[0] // d


def _decode_write(pages: KVPages, kh, vh, flat_slots, lyr: int) -> None:
    """Token write into the full multi-layer pool, in place: the plain
    scatter (``index_put_``) that the JAX package leaves to XLA."""
    paged_token_write_plain(
        kh, vh, pages.k, pages.v, pages.k_scales, pages.v_scales, flat_slots, lyr
    )


def _embed(params, input_ids, positions) -> torch.Tensor:
    return params["wte"][input_ids.long()] + params["wpe"][positions.long()]


def _mlp(x, p, eps, tp_group=None):
    h2 = _layer_norm(x, p["ln_2"], eps)
    m = F.gelu(_dense(h2, p["c_fc"]), approximate="tanh")
    return x + C.row_linear(m, *p["c_proj"], tp_group)


def _last_valid(x: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """(B, S, E) -> (B, E): row b's token ``lens[b] - 1`` (clamped to the
    row), the last real token of a prompt or chunk."""
    idx = (lens.to(x.device).long() - 1).clamp(0, x.shape[1] - 1)
    return x[torch.arange(x.shape[0], device=x.device), idx]


@torch.no_grad()
def prefill_step(
    params: Dict[str, Any],
    cfg: GPT2Config,
    input_ids: torch.Tensor,  # (B, S) right-padded with 0
    prompt_lengths: torch.Tensor,  # (B,)
    pages: KVPages,
    flat_slots: torch.Tensor,  # (B, S) int32 flat page slots (trash past len)
    quantized: bool,
    *,
    tp_group=None,
) -> torch.Tensor:
    """Prompt forward + cache fill (pool updated in place). Returns the
    last real token's logits (B, V) float32."""
    b, s = input_ids.shape
    d = cfg.n_embd // cfg.n_head
    h = _local_heads(params, d)
    eps = cfg.layer_norm_epsilon
    positions = torch.arange(s, device=input_ids.device)[None]
    x = _embed(params, input_ids, positions)
    slots = flat_slots.reshape(b * s)
    for lyr, p in enumerate(params["layers"]):
        h_in = _layer_norm(x, p["ln_1"], eps)
        qh = _dense(h_in, p["q_proj"]).reshape(b, s, h, d)
        kh = _dense(h_in, p["k_proj"]).reshape(b, s, h, d)
        vh = _dense(h_in, p["v_proj"]).reshape(b, s, h, d)
        _decode_write(pages, kh.reshape(b * s, h, d), vh.reshape(b * s, h, d), slots, lyr)
        attn = flash_attention_best(qh, kh, vh, causal=True).reshape(b, s, h * d)
        x = _mlp(x + C.row_linear(attn, *p["out_proj"], tp_group), p, eps, tp_group)
    x = _layer_norm(x, params["ln_f"], eps)
    return (_last_valid(x, prompt_lengths) @ params["wte"].T).float()


def _gather_history(pages: KVPages, page_tables: torch.Tensor, lyr: int, n_hist_pages: int):
    """The first ``n_hist_pages`` pages of each row of layer ``lyr`` as
    dense (B, n_hist_pages * page, Hkv, D) K and V, dequantized to float32
    for int8 pools (JAX ``_gather_history``)."""
    pt = page_tables[:, :n_hist_pages].long()  # (B, pps)

    def gather(pool, scales):
        g = pool[lyr][:, pt]  # (Hkv, B, pps, page, D)
        hkv, b, pps, page, d = g.shape
        g = g.permute(1, 2, 3, 0, 4).reshape(b, pps * page, hkv, d)
        if scales is None:
            return g
        sc = scales[lyr][:, pt].permute(1, 2, 3, 0).reshape(b, pps * page, hkv)
        return g.float() * sc[..., None]

    return gather(pages.k, pages.k_scales), gather(pages.v, pages.v_scales)


def _chunk_key_bias(chunk_start: torch.Tensor, chunk_lens: torch.Tensor, s_hist: int,
                    c: int) -> torch.Tensor:
    """(B, s_hist + C) float32 per-key bias over [history || chunk]: the
    mask value on the history past ``chunk_start`` (not yet written) and on
    the chunk's padding, 0 elsewhere."""
    device = chunk_start.device
    dead = torch.cat(
        [
            torch.arange(s_hist, device=device)[None] >= chunk_start[:, None],
            torch.arange(c, device=device)[None] >= chunk_lens[:, None],
        ],
        dim=1,
    )
    return torch.where(dead, DEFAULT_MASK_VALUE, 0.0).to(torch.float32)


def _attend_chunk(pages: KVPages, page_tables: torch.Tensor, lyr: int, n_hist_pages: int,
                  q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, slots: torch.Tensor,
                  k_bias: torch.Tensor) -> torch.Tensor:
    """One layer of a chunk's attention: gather the row's first
    ``n_hist_pages`` pages, write the chunk's (B, C, Hkv, D) K/V into the
    pool, and run ONE K1 call over [history || chunk] (end-aligned causal
    masking covers the chunk triangle, ``k_bias`` the rest). Returns
    (B, C, Hq, D)."""
    b, c, hkv, d = k.shape
    k_cat, v_cat = k, v
    if n_hist_pages > 0:
        k_hist, v_hist = _gather_history(pages, page_tables, lyr, n_hist_pages)
        k_cat = torch.cat([k_hist.to(q.dtype), k], dim=1)
        v_cat = torch.cat([v_hist.to(q.dtype), v], dim=1)
    _decode_write(pages, k.reshape(b * c, hkv, d), v.reshape(b * c, hkv, d), slots, lyr)
    return flash_attention(q, k_cat, v_cat, causal=True, k_bias=k_bias)


@torch.no_grad()
def prefill_chunk_step(
    params: Dict[str, Any],
    cfg: GPT2Config,
    input_ids: torch.Tensor,  # (B, C) chunk tokens, right-padded
    chunk_start: torch.Tensor,  # (B,) global position of chunk token 0
    chunk_lens: torch.Tensor,  # (B,) valid tokens in this chunk
    pages: KVPages,
    flat_slots: torch.Tensor,  # (B, C) int32 flat page slots (trash past the chunk)
    page_tables: torch.Tensor,  # (B, pages_per_seq) int32
    quantized: bool,
    s_hist: int,  # history window in tokens, a multiple of the page size
    *,
    tp_group=None,
) -> torch.Tensor:
    """One chunk of a chunked prefill (JAX ``prefill_chunk_step``), pool
    updated in place. Per layer: gather the first ``s_hist`` cached tokens
    of the row, write the chunk's K/V into its pages, and run ONE flash call
    (K1) over [history || chunk]: end-aligned causal masking covers the
    chunk triangle, and the per-key bias kills the history past
    ``chunk_start`` (not yet written) and the chunk's padding. Returns the
    last valid chunk token's logits (B, V) float32."""
    b, c = input_ids.shape
    d = cfg.n_embd // cfg.n_head
    h = _local_heads(params, d)
    eps = cfg.layer_norm_epsilon
    device = input_ids.device
    n_hist_pages = s_hist // pages.k.shape[3]
    chunk_start = chunk_start.to(device).long()
    chunk_lens = chunk_lens.to(device).long()
    positions = (chunk_start[:, None] + torch.arange(c, device=device)[None]).clamp(
        0, cfg.n_positions - 1
    )
    x = _embed(params, input_ids, positions)
    k_bias = _chunk_key_bias(chunk_start, chunk_lens, s_hist, c)
    slots = flat_slots.reshape(b * c)
    for lyr, p in enumerate(params["layers"]):
        h_in = _layer_norm(x, p["ln_1"], eps)
        qh = _dense(h_in, p["q_proj"]).reshape(b, c, h, d)
        kh = _dense(h_in, p["k_proj"]).reshape(b, c, h, d)
        vh = _dense(h_in, p["v_proj"]).reshape(b, c, h, d)
        attn = _attend_chunk(pages, page_tables, lyr, n_hist_pages, qh, kh, vh, slots, k_bias)
        x = _mlp(x + C.row_linear(attn.reshape(b, c, h * d), *p["out_proj"], tp_group), p, eps,
                 tp_group)
    x = _layer_norm(x, params["ln_f"], eps)
    return (_last_valid(x, chunk_lens) @ params["wte"].T).float()


@torch.no_grad()
def decode_step(
    params: Dict[str, Any],
    cfg: GPT2Config,
    input_ids: torch.Tensor,  # (B,) current token per sequence
    positions: torch.Tensor,  # (B,) position of that token
    pages: KVPages,
    flat_slots: torch.Tensor,  # (B,) int32 flat slot for the new token
    lengths: torch.Tensor,  # (B,) int32 cache length AFTER this token
    page_tables: torch.Tensor,  # (B, pages_per_seq) int32
    quantized: bool,
    *,
    tp_group=None,
) -> torch.Tensor:
    """One decode token per sequence (pool updated in place). Returns
    logits (B, V) float32."""
    b = input_ids.shape[0]
    d = cfg.n_embd // cfg.n_head
    h = _local_heads(params, d)
    eps = cfg.layer_norm_epsilon
    x = _embed(params, input_ids, positions)  # (B, E)
    for lyr, p in enumerate(params["layers"]):
        h_in = _layer_norm(x, p["ln_1"], eps)
        q = _dense(h_in, p["q_proj"]).reshape(b, h, d).float()
        kh = _dense(h_in, p["k_proj"]).reshape(b, h, d)
        vh = _dense(h_in, p["v_proj"]).reshape(b, h, d)
        attn = paged_decode_attention(
            q, kh, vh, pages.k, pages.v, lengths, page_tables, flat_slots, lyr,
            pages.k_scales if quantized else None,
            pages.v_scales if quantized else None,
        )
        attn = attn.reshape(b, h * d).to(x.dtype)
        x = _mlp(x + C.row_linear(attn, *p["out_proj"], tp_group), p, eps, tp_group)
    x = _layer_norm(x, params["ln_f"], eps)
    return (x @ params["wte"].T).float()


# ---------------------------------------------------------------------------
# Tensor-parallel serving layout (model-axis sharded decode)
# ---------------------------------------------------------------------------


def serving_param_specs(model_axis: str = "model") -> Dict[str, Any]:
    """The :class:`~..parallel.mesh.PartitionSpec` tree of the serving
    weights (:func:`prepare_params`) for GPT-2 TP (JAX
    ``serving_param_specs``, ``models/gpt2_serving.py:479``): q/k/v and
    ``c_fc`` column-parallel with their biases sharded alike, ``out_proj``
    and ``c_proj`` row-parallel with replicated biases, embeddings and
    LayerNorms replicated. ``layers`` holds the one layer spec every layer
    takes (JAX's scanned stack carries a leading (L,) axis instead); each
    (weight, bias) pair is ``nn.Linear``'s (out, in) weight, so the specs
    are JAX's kernels' reversed."""
    m = model_axis
    col = (PartitionSpec(m, None), PartitionSpec(m))
    row = (PartitionSpec(None, m), PartitionSpec())
    ln = (PartitionSpec(), PartitionSpec())
    return {
        "wte": PartitionSpec(),
        "wpe": PartitionSpec(),
        "ln_f": ln,
        "layers": {
            "ln_1": ln, "ln_2": ln,
            "q_proj": col, "k_proj": col, "v_proj": col, "out_proj": row,
            "c_fc": col, "c_proj": row,
        },
    }


def serving_pages_specs(quantized: bool, model_axis: str = "model") -> Dict[str, PartitionSpec]:
    """The pools shard on their KV-head axis, (L, Hkv, P, page, D), and the
    int8 pools' per-token scales with them (JAX ``serving_pages_specs``,
    ``models/gpt2_serving.py:517``)."""
    m = model_axis
    sc = PartitionSpec(None, m) if quantized else PartitionSpec()
    return {"k": PartitionSpec(None, m), "v": PartitionSpec(None, m),
            "k_scales": sc, "v_scales": sc}


def shard_params(params: Dict[str, Any], mesh, model_axis: str = "model") -> Dict[str, Any]:
    """This rank's TP shards of the serving weights, cut by
    :func:`serving_param_specs`."""
    specs = serving_param_specs(model_axis)

    def cut(t, spec):
        return shard_tensor(t, spec, mesh)

    def cut_pairs(layer):
        return {name: tuple(cut(t, sp) for t, sp in zip(wb, specs["layers"][name]))
                for name, wb in layer.items()}

    return {
        "wte": cut(params["wte"], specs["wte"]),
        "wpe": cut(params["wpe"], specs["wpe"]),
        "ln_f": tuple(cut(t, sp) for t, sp in zip(params["ln_f"], specs["ln_f"])),
        "layers": [cut_pairs(layer) for layer in params["layers"]],
    }
