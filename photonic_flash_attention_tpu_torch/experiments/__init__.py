"""The flash-forward design-space experiments, on the card.

Each module is the port of the file of the same name under ``benchmarks/``
in the JAX repository (run there as ``python benchmarks/<name>.py``); here
``python -m photonic_flash_attention_tpu_torch.experiments.<name>
[--device cpu|cuda]`` runs its parity checks, then times each variant
against K1 (``ops/flash.py::flash_attention``) at JAX's geometries:

* ``flash_fixedmax_experiment`` (``benchmarks/flash_fixedmax_experiment.py``):
  :func:`flash_fixedmax`, kernel K13;
* ``flash_aug_experiment`` (``benchmarks/flash_aug_experiment.py``):
  :func:`flash_aug`, kernel K14;
* ``flash_pair_experiment`` (``benchmarks/flash_pair_experiment.py``):
  :func:`flash_pair`, kernel K15;
* ``flash_pipeline_experiment`` (``benchmarks/flash_pipeline_experiment.py``,
  its ``flash_unrolled`` only): :func:`flash_unrolled`, kernel K16.

Each function launches its kernel for CUDA tensors and runs its plain
version (``*_plain``) for CPU tensors.
"""

from .flash_aug_experiment import flash_aug
from .flash_fixedmax_experiment import flash_fixedmax
from .flash_pair_experiment import flash_pair
from .flash_pipeline_experiment import flash_unrolled

__all__ = ["flash_aug", "flash_fixedmax", "flash_pair", "flash_unrolled"]
