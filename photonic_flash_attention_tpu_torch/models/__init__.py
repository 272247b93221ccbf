"""Models: the drop-in attention layers, GPT-2 and T5 (dense forwards and
paged-KV serving steps), under the JAX package's names."""

from .attention import (
    PhotonicFlashAttention,
    PhotonicMultiHeadAttention,
    dispatch_attention,
)
from .gpt2 import GPT2Config, GPT2LMHead
from .t5 import (
    T5Config,
    T5ForConditionalGeneration,
    T5Model,
    load_hf_t5,
    transfer_hf_t5,
)

__all__ = [
    "GPT2Config",
    "GPT2LMHead",
    "PhotonicFlashAttention",
    "PhotonicMultiHeadAttention",
    "T5Config",
    "T5ForConditionalGeneration",
    "T5Model",
    "dispatch_attention",
    "load_hf_t5",
    "transfer_hf_t5",
]
