"""PyTorch/CUDA port of ``photonic_flash_attention_tpu`` for one NVIDIA H100.

The JAX package beside this one is the reference: every module here
mirrors the JAX module of the same path, and the tests feed both the same
numpy inputs. The port imports ``torch`` and never ``jax``.

Slice 1 covers GPT-2 paged-KV serving (``core.serving.ServingEngine``)
and slice 2 GPT-2 training (``training.Trainer``), with five hand-written
CUDA kernels for sm_90a (``csrc/``):

* K1 ``ops.flash`` — flash-attention forward (prefill, and the training
  forward with its logsumexp);
* K2 ``ops.paged.paged_token_write`` — per-token K/V write into the
  paged pool, int8-quantized when the pool is int8;
* K3 ``ops.paged.paged_decode_attend`` — one-query attention over a
  sequence's pages;
* K4/K5 ``ops.flash_bwd`` — flash-attention backward, dK/dV and dQ.

Each kernel's wrapper runs its plain PyTorch version for CPU tensors and
launches the kernel (or raises) for CUDA tensors.
"""

__version__ = "0.1.0"
