"""Fused short-sequence attention path.

Port of ``photonic_flash_attention_tpu/ops/fused.py::fused_attention``:
below the router's crossover (``models/attention.py::dispatch_attention``)
and whenever a dense mask, an additive bias or the weights are asked for,
attention runs as one O(S^2) einsum-softmax-einsum. The JAX package leaves
this to XLA's fusion, so the port leaves it to plain PyTorch: it is not a
kernel. Gradients flow through autograd.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .reference import attention_reference


def fused_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    *,
    bias: Optional[torch.Tensor] = None,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    need_weights: bool = False,
    weights_only: bool = False,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """O(S^2) attention with optional mask, bias and weights (the
    reference's arguments and return pair)."""
    return attention_reference(
        q,
        k,
        v,
        mask,
        bias=bias,
        causal=causal,
        sm_scale=sm_scale,
        need_weights=need_weights,
        weights_only=weights_only,
    )
