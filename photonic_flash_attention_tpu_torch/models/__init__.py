"""Models: the drop-in attention layers, GPT-2, BERT, T5 and Llama (dense
forwards; paged-KV serving steps for GPT-2, T5 and Llama), the HF
conversion and the sharding rules, under the JAX package's names."""

from .attention import (
    PhotonicFlashAttention,
    PhotonicMultiHeadAttention,
    dispatch_attention,
)
from .bert import BertConfig, BertModel, load_hf_bert, transfer_hf_bert
from .convert import (
    AttentionLayerDetector,
    ConversionReport,
    PhotonicConfig,
    convert_to_photonic,
)
from .gpt2 import GPT2Config, GPT2LMHead, load_hf_gpt2, param_sharding_rules
from .llama import (
    LlamaConfig,
    LlamaForCausalLM,
    llama_param_sharding_rules,
    load_hf_llama,
    transfer_hf_llama,
)
from .t5 import (
    T5Config,
    T5ForConditionalGeneration,
    T5Model,
    load_hf_t5,
    transfer_hf_t5,
)

__all__ = [
    "AttentionLayerDetector",
    "BertConfig",
    "BertModel",
    "ConversionReport",
    "GPT2Config",
    "GPT2LMHead",
    "LlamaConfig",
    "LlamaForCausalLM",
    "PhotonicConfig",
    "PhotonicFlashAttention",
    "PhotonicMultiHeadAttention",
    "T5Config",
    "T5ForConditionalGeneration",
    "T5Model",
    "convert_to_photonic",
    "dispatch_attention",
    "llama_param_sharding_rules",
    "load_hf_bert",
    "load_hf_gpt2",
    "load_hf_llama",
    "load_hf_t5",
    "param_sharding_rules",
    "transfer_hf_bert",
    "transfer_hf_llama",
    "transfer_hf_t5",
]
