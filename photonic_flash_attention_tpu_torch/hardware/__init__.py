"""Hardware: device detection and the roofline cost and energy model.

Port of ``photonic_flash_attention_tpu/hardware`` without its design-space
simulators (``CollectiveCost``, ``KernelPipelineSimulator``,
``PipelinePrediction``, ``TopologySimulator``: ROADMAP A14, later).
"""

from .detection import (
    TPUCapabilities,
    TPUDevice,
    detect_tpu_hardware,
    get_best_tpu_device,
    get_device_info,
)
from .roofline import (
    KernelCost,
    attention_decode_cost,
    attention_prefill_cost,
    matmul_cost,
    ring_attention_step_cost,
    roofline_fraction,
)

__all__ = [
    "KernelCost",
    "TPUCapabilities",
    "TPUDevice",
    "attention_decode_cost",
    "attention_prefill_cost",
    "detect_tpu_hardware",
    "get_best_tpu_device",
    "get_device_info",
    "matmul_cost",
    "ring_attention_step_cost",
    "roofline_fraction",
]
