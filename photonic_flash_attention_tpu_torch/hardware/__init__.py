"""Hardware: device detection, the roofline cost and energy model, and the
design-space simulators.

Port of ``photonic_flash_attention_tpu/hardware``, exporting its names.
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
from .simulator import (
    CollectiveCost,
    KernelPipelineSimulator,
    PipelinePrediction,
    TopologySimulator,
)

__all__ = [
    "CollectiveCost",
    "KernelCost",
    "KernelPipelineSimulator",
    "PipelinePrediction",
    "TPUCapabilities",
    "TPUDevice",
    "TopologySimulator",
    "attention_decode_cost",
    "attention_prefill_cost",
    "detect_tpu_hardware",
    "get_best_tpu_device",
    "get_device_info",
    "matmul_cost",
    "ring_attention_step_cost",
    "roofline_fraction",
]
