"""PyTorch/CUDA port of ``photonic_flash_attention_tpu`` for one NVIDIA H100.

The JAX package beside this one is the reference: every module here
mirrors the JAX module of the same path, and the tests feed both the same
numpy inputs. The port imports ``torch`` and never ``jax``.

It covers GPT-2 and Llama paged-KV serving (``core.serving.ServingEngine``;
``models.llama_serving``: GQA pools, RoPE), GPT-2 training
(``training.Trainer``), the BERT encoder (``models.bert``), the HF
conversion (``convert_to_photonic`` and the ``transfer_hf_*`` functions,
which alone need ``transformers``), the drop-in layer
(``models.attention.PhotonicFlashAttention``) over the measured
``core.engine.AttentionEngine``, with chunked prefill, the engine's
quantized kinds (``quant_mode`` "int8" / "fp8", ``ops.flash_fp8``), and the
T5 encoder-decoder (``models.t5``, served through ``ServingEngine`` by
``models.t5_serving``) with the structured biases (``ops.rel_bias``), the
ops surface (``ops.nonlinearity``, ``ops.quantization``,
``ops.paged.paged_attention``) and the CLI (``cli``, ``pfa-torch``), on
eight hand-written CUDA kernels for sm_90a (``csrc/``):

* K1 ``ops.flash`` — flash-attention forward (prefill, and the training
  forward with its logsumexp), with the key-padding streams
  ``kv_lens``/``k_bias``, the quantized modes int8-QK, fp8-QK and
  int8-full (``ops.flash.flash_attention_qk_quant``), the relative-bias
  mode (T5 buckets, ALiBi: ``rel_bias=``) and the dense-bias mode
  (``attn_bias=``);
* K2 ``ops.paged.paged_token_write`` — per-token K/V write into the
  paged pool, int8-quantized when the pool is int8;
* K3 ``ops.paged.paged_decode_attend``, ``paged_attention_hf`` and
  ``paged_attention`` — one-query attention over a sequence's pages (float
  or int8 compute), with a per-token score bias (``token_bias=``, T5
  decode), split over the sequence and merged in one launch; and
  ``paged_decode_attention``, the decode step: K2's write folded into K3,
  one launch;
* K4/K5 ``ops.flash_bwd`` — flash-attention backward, dK/dV and dQ;
* K6 ``ops.flash_fp8.flash_attention_quant`` — fp8/int8 flash attention
  with per-128-row-block Q/K scales and P requantized per block.
* K7 ``ops.nonlinearity.fused_softmax`` — row softmax, any width;
* K8 ``ops.nonlinearity.fused_layer_norm`` and ``fused_rms_norm`` —
  LayerNorm and RMSNorm rows.

Each kernel's wrapper runs its plain PyTorch version for CPU tensors and
launches the kernel (or raises) for CUDA tensors. Training takes attention
dropout (``attn_pdrop``, ``Trainer(dropout_rng=...)``) and T5 takes
gradients through K1's relative-bias mode; K1, K4 and K5 carry the
sliding-window and dropout streams. The probes K9-K12 (``ops.hbm_bw``,
``ops.device_probes``) feed the roofline (``hardware``), and
``experiments`` holds the flash-forward design-space experiments of the
JAX repository's ``benchmarks/`` on K13-K16 (fixed-max, augmented V,
paired chains, the pipelined KV loop).

Distribution (``parallel``) runs over ``torch.distributed``, one rank a
card: ring and Ulysses attention (the engine's RING and ULYSSES kinds
after ``set_mesh``), the GPipe pipeline, tensor- and data-parallel GPT-2
training (``Trainer(mesh=, param_specs=)``) and head-sharded GPT-2 serving
(``ServingEngine(mesh=)``). The ops shell (``scaling``, ``monitoring``,
``resilience``, ``optimization``, ``intelligence``, ``research``,
``globalization``, ``utils.security``) and the design-space simulators
(``hardware.simulator``) complete the JAX package's modules; they run the
engine's kernels or plain PyTorch and add no kernel.

The package exports the JAX package's top-level names (the config
functions, the flash functions, the two drop-in layers,
``convert_to_photonic``), and ``models`` those of its models.
"""

from .config import GlobalConfig, get_config, reset_config, set_global_config

__version__ = "0.1.0"

__all__ = [
    "GlobalConfig",
    "get_config",
    "reset_config",
    "set_global_config",
    "__version__",
]


def __getattr__(name):
    # Lazy re-exports under the JAX package's names keep the import light.
    if name in (
        "flash_attention",
        "flash_attention_fp8",
        "flash_attention_fp8qk",
        "flash_attention_int8",
        "flash_attention_int8full",
        "flash_attention_int8qk",
        "flash_attention_quant",
        "fused_attention",
    ):
        from . import ops

        return getattr(ops, name)
    if name in ("PhotonicFlashAttention", "PhotonicMultiHeadAttention"):
        from . import models

        return getattr(models, name)
    if name == "convert_to_photonic":
        from .models import convert_to_photonic

        return convert_to_photonic
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
