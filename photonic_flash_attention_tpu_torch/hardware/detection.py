"""Device detection: the current card's figures for the roofline.

Port of ``photonic_flash_attention_tpu/hardware/detection.py`` under JAX's
names (``TPUCapabilities``, ``TPUDevice``, ``detect_tpu_hardware``,
``get_best_tpu_device``, ``get_device_info``), so that one roofline reads
either record. Here the record holds the current CUDA card's figures. The
probe is ``torch.cuda.device_count()`` / ``get_device_properties``, and a
device's platform is ``"gpu"``. Without CUDA there is one device, the CPU,
with JAX's ``"cpu"`` row as it is (``is_simulated`` then holds, as for any
platform but ``"gpu"``).

The table holds one card, the H100 SXM, with NVIDIA's data-sheet figures
(dense rates at the 700 W limit). A CUDA card that is not in it raises: a
roofline of invented figures would mislead every share computed from it.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class TPUCapabilities:
    """Peak rates of one device (public data-sheet figures). On a card,
    ``vmem_mb`` is the shared memory one block can use and ``ici_gbps`` the
    NVLink rate each way."""

    generation: str
    bf16_tflops: float
    int8_tops: float
    hbm_gb: float
    hbm_gbps: float  # memory bandwidth
    vmem_mb: float
    ici_gbps: float  # per-link interconnect bandwidth
    #: Contraction depth of one matrix-unit instruction: a head dim below it
    #: underfills the unit (the roofline's ``min(1, head_dim / width)``).
    #: 128 for JAX's rows (the TPU's MXU); 16 for bf16 ``wgmma``/``mma.sync``.
    contraction_width: int = 128


# H100 SXM (NVIDIA's data sheet, dense, at 700 W): 989 TFLOP/s bf16, 1979
# TOP/s int8, 80 GB of HBM3 at 3350 GB/s, 227 KB (232,448 bytes) of shared
# memory a block, NVLink 900 GB/s, 450 each way.
_CAPABILITY_TABLE: Dict[str, TPUCapabilities] = {
    "h100": TPUCapabilities("h100", 989.0, 1979.0, 80.0, 3350.0, 232448 / 2**20, 450.0, 16),
    # The CPU: JAX's row, as it is.
    "cpu": TPUCapabilities("cpu", 0.2, 0.4, 8.0, 50.0, 0.03, 0.0),
}


@dataclasses.dataclass
class TPUDevice:
    """A detected device."""

    device_id: int
    kind: str
    platform: str
    capabilities: TPUCapabilities
    process_index: int = 0
    coords: Optional[tuple] = None

    @property
    def is_simulated(self) -> bool:
        return self.platform != "gpu"


def _lookup(device_name: str) -> Optional[TPUCapabilities]:
    """The table's row for a CUDA device name, None for a card it does not
    hold (the H100's PCIe and NVL parts have other figures)."""
    name = device_name.upper()
    if "H100" in name and "PCIE" not in name and "NVL" not in name:
        return _CAPABILITY_TABLE["h100"]
    return None


def _classify(device_name: str) -> str:
    """The table's key for a CUDA device name; raises for a card the table
    does not hold."""
    caps = _lookup(device_name)
    if caps is None:
        raise RuntimeError(
            f"no capability figures for the card {device_name!r}: the table holds "
            f"{sorted(k for k in _CAPABILITY_TABLE if k != 'cpu')}"
        )
    return caps.generation


@functools.lru_cache(maxsize=None)
def _devices() -> Tuple[TPUDevice, ...]:
    if not torch.cuda.is_available():
        return (TPUDevice(0, "cpu", "cpu", _CAPABILITY_TABLE["cpu"]),)
    out = []
    for i in range(torch.cuda.device_count()):
        name = torch.cuda.get_device_properties(i).name
        out.append(TPUDevice(i, name, "gpu", _CAPABILITY_TABLE[_classify(name)]))
    return tuple(out)


def detect_tpu_hardware(refresh: bool = False) -> List[TPUDevice]:
    """The devices of this process (the CPU alone when there is no card),
    detected once; ``refresh`` detects them again."""
    if refresh:
        _devices.cache_clear()
    return list(_devices())


def get_best_tpu_device() -> Optional[TPUDevice]:
    """The device with the highest bf16 peak."""
    return max(detect_tpu_hardware(), key=lambda d: d.capabilities.bf16_tflops, default=None)


def get_device_info() -> Dict:
    """Device count, whether every device is simulated, and per device its
    id, kind, platform, generation, bf16 peak and memory (JAX's keys)."""
    devices = detect_tpu_hardware()
    return {
        "device_count": len(devices),
        "simulated": all(d.is_simulated for d in devices),
        "devices": [
            {
                "id": d.device_id,
                "kind": d.kind,
                "platform": d.platform,
                "generation": d.capabilities.generation,
                "bf16_tflops": d.capabilities.bf16_tflops,
                "hbm_gb": d.capabilities.hbm_gb,
            }
            for d in devices
        ],
    }


def known_capabilities() -> Optional[TPUCapabilities]:
    """The current device's row without raising: the CPU's without a card,
    the table's for a card it holds, None for any other card (for callers
    such as the engine's energy estimate, which must not stop on one)."""
    if not torch.cuda.is_available():
        return _CAPABILITY_TABLE["cpu"]
    return _lookup(torch.cuda.get_device_properties(torch.cuda.current_device()).name)
