"""The flash design-space experiments (forward and backward), on the card.

Each module is the port of the file of the same name under ``benchmarks/``
in the JAX repository (run there as ``python benchmarks/<name>.py``); here
``python -m photonic_flash_attention_tpu_torch.experiments.<name>
[--device cpu|cuda]`` runs its parity checks, then times each variant
against K1 (``ops/flash.py::flash_attention``; the backward against K4 + K5)
at JAX's geometries:

* ``flash_fixedmax_experiment`` (``benchmarks/flash_fixedmax_experiment.py``):
  :func:`flash_fixedmax`, kernel K13;
* ``flash_aug_experiment`` (``benchmarks/flash_aug_experiment.py``):
  :func:`flash_aug`, kernel K14;
* ``flash_pair_experiment`` (``benchmarks/flash_pair_experiment.py``):
  :func:`flash_pair`, kernel K15;
* ``flash_pipeline_experiment`` (``benchmarks/flash_pipeline_experiment.py``):
  :func:`flash_unrolled`, kernel K16; :func:`flash_chunked`, K17;
  :func:`flash_triangular` and :func:`flash_tri_i8`, K18 and its int8-QK
  mode; :func:`flash_fulltri`, K19; :func:`flash_segmented`, segment calls
  of K1 with lse merged by logsumexp (the file's other variants, run as
  ``python -m ...flash_pipeline_experiment [chunked|tri|i8|seg|fulltri]``);
* ``flash_bwd_unrolled_experiment``
  (``benchmarks/flash_bwd_unrolled_experiment.py``): :func:`flash_bwd_unrolled`,
  the backward one call per block, kernels K20 (dQ) and K21 (dK/dV), timed
  against K4 + K5 (``ops/flash_bwd.py::flash_attention_bwd``).

Each function launches its kernel for CUDA tensors and runs its plain
version (``*_plain``) for CPU tensors.
"""

from .flash_aug_experiment import flash_aug
from .flash_bwd_unrolled_experiment import flash_bwd_unrolled
from .flash_fixedmax_experiment import flash_fixedmax
from .flash_pair_experiment import flash_pair
from .flash_pipeline_experiment import (flash_chunked, flash_fulltri, flash_segmented,
                                        flash_tri_i8, flash_triangular, flash_unrolled)

__all__ = ["flash_aug", "flash_bwd_unrolled", "flash_chunked", "flash_fixedmax", "flash_fulltri",
           "flash_pair", "flash_segmented", "flash_tri_i8", "flash_triangular", "flash_unrolled"]
