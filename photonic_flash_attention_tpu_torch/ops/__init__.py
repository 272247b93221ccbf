"""Attention ops: plain PyTorch oracles and the hand-written CUDA kernels."""

from .flash import flash_attention
from .flash_fp8 import (
    flash_attention_fp8,
    flash_attention_fp8qk,
    flash_attention_int8,
    flash_attention_int8full,
    flash_attention_int8qk,
    flash_attention_quant,
)
from .flash_unrolled import (
    flash_attention_best,
    flash_attention_unrolled,
    unrolled_supported,
)
from .fused import fused_attention
from .nonlinearity import (
    NonlinearityType,
    apply_nonlinearity,
    fused_layer_norm,
    fused_rms_norm,
    fused_softmax,
)
from .quantization import (
    QuantizedTensor,
    dequantize,
    quantization_error,
    quantize,
    quantize_kv,
)
from .reference import attention_blockwise, attention_reference
from .rel_bias import ALiBi, T5RelBias, alibi_slopes, materialize

__all__ = [
    "ALiBi",
    "NonlinearityType",
    "QuantizedTensor",
    "T5RelBias",
    "alibi_slopes",
    "apply_nonlinearity",
    "attention_blockwise",
    "attention_reference",
    "dequantize",
    "flash_attention",
    "flash_attention_best",
    "flash_attention_fp8",
    "flash_attention_fp8qk",
    "flash_attention_int8",
    "flash_attention_int8full",
    "flash_attention_int8qk",
    "flash_attention_quant",
    "flash_attention_unrolled",
    "fused_attention",
    "fused_layer_norm",
    "fused_rms_norm",
    "fused_softmax",
    "materialize",
    "quantization_error",
    "quantize",
    "quantize_kv",
    "unrolled_supported",
]
