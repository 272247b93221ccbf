"""Analytic roofline cost model for attention kernels, and the energy model.

Port of ``photonic_flash_attention_tpu/hardware/roofline.py``: given a
workload and a device record (``hardware/detection.py``), the FLOPs, the
bytes moved, compute- or memory-bound, the speed-of-light time; the
composite ceiling of a flash forward from measured rates; and the energy
estimate the engine records and the router can blend into its score.

The formulas are JAX's. Four points differ:

* the matrix unit's underfill below a head dim is ``min(1, head_dim /
  caps.contraction_width)``: 128 on JAX's rows, so a record holding a TPU's
  numbers gives JAX's results exactly; 16 on the H100 (bf16 ``mma.sync``
  and ``wgmma`` depth);
* :data:`H100_MEASURED_RATES` replaces JAX's TPU v5e measurement; its
  "vpu" keys keep JAX's names, and on the card they are the SMs' FP32 and
  MUFU pipes, where the softmax stream and its exps run;
* :data:`STATIC_POWER_W` is the card's idle draw, not JAX's share of a
  v5e board's power;
* ``caps=None`` reads the port's detection (the current card, or the CPU).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from .detection import TPUCapabilities, get_best_tpu_device

_DTYPE_BYTES = {"bf16": 2, "fp16": 2, "f32": 4, "fp8": 1, "int8": 1}


@dataclasses.dataclass
class KernelCost:
    flops: float
    hbm_bytes: float
    t_compute_us: float
    t_memory_us: float

    @property
    def t_roofline_us(self) -> float:
        return max(self.t_compute_us, self.t_memory_us)

    @property
    def bound(self) -> str:
        return "compute" if self.t_compute_us >= self.t_memory_us else "memory"

    @property
    def arithmetic_intensity(self) -> float:
        return self.flops / max(self.hbm_bytes, 1.0)

    def as_dict(self) -> Dict:
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "t_compute_us": self.t_compute_us,
            "t_memory_us": self.t_memory_us,
            "t_roofline_us": self.t_roofline_us,
            "bound": self.bound,
            "arithmetic_intensity": self.arithmetic_intensity,
        }


def _caps(caps: Optional[TPUCapabilities]) -> TPUCapabilities:
    if caps is not None:
        return caps
    dev = get_best_tpu_device()
    if dev is None:
        raise RuntimeError("no device detected for roofline model")
    return dev.capabilities


def _underfill(head_dim: int, c: TPUCapabilities) -> float:
    """Share of the matrix unit's contraction a head dim fills."""
    return min(1.0, head_dim / c.contraction_width)


def attention_prefill_cost(
    batch: int,
    q_len: int,
    kv_len: int,
    num_heads: int,
    head_dim: int,
    *,
    causal: bool = False,
    dtype: str = "bf16",
    caps: Optional[TPUCapabilities] = None,
) -> KernelCost:
    """Flash-attention forward cost (QK^T + PV, streaming KV from HBM)."""
    c = _caps(caps)
    frac = 0.5 if causal and q_len == kv_len else 1.0
    flops = 4.0 * batch * num_heads * q_len * kv_len * head_dim * frac
    b = _DTYPE_BYTES[dtype]
    # q read + o write once; k, v read once (flash streams tiles).
    hbm = batch * num_heads * head_dim * b * (2 * q_len + 2 * kv_len)
    peak_flops = (c.int8_tops if dtype in ("int8", "fp8") else c.bf16_tflops) * 1e12
    t_comp = flops / (peak_flops * _underfill(head_dim, c)) * 1e6
    t_mem = hbm / (c.hbm_gbps * 1e9) * 1e6
    return KernelCost(flops, hbm, t_comp, t_mem)


def attention_decode_cost(
    batch: int,
    kv_len: int,
    num_q_heads: int,
    num_kv_heads: int,
    head_dim: int,
    *,
    kv_dtype: str = "bf16",
    caps: Optional[TPUCapabilities] = None,
) -> KernelCost:
    """Paged decode cost: one query token against the whole KV cache.
    Decode is HBM-bound: the cache read dominates, and int8 KV halves it."""
    c = _caps(caps)
    flops = 4.0 * batch * num_q_heads * kv_len * head_dim
    b = _DTYPE_BYTES[kv_dtype]
    hbm = 2.0 * batch * num_kv_heads * kv_len * head_dim * b  # K + V read
    if kv_dtype == "int8":
        hbm += 2.0 * batch * num_kv_heads * kv_len * 4  # per-token scales
    peak_flops = c.bf16_tflops * 1e12
    t_comp = flops / (peak_flops * _underfill(head_dim, c)) * 1e6
    t_mem = hbm / (c.hbm_gbps * 1e9) * 1e6
    return KernelCost(flops, hbm, t_comp, t_mem)


def matmul_cost(
    m: int,
    n: int,
    k: int,
    *,
    dtype: str = "bf16",
    caps: Optional[TPUCapabilities] = None,
) -> KernelCost:
    c = _caps(caps)
    flops = 2.0 * m * n * k
    b = _DTYPE_BYTES[dtype]
    hbm = (m * k + k * n + m * n) * b
    peak = (c.int8_tops if dtype in ("int8", "fp8") else c.bf16_tflops) * 1e12
    return KernelCost(
        flops, hbm, flops / peak * 1e6, hbm / (c.hbm_gbps * 1e9) * 1e6
    )


def ring_attention_step_cost(
    batch: int,
    local_seq: int,
    num_heads: int,
    head_dim: int,
    n_devices: int,
    *,
    dtype: str = "bf16",
    caps: Optional[TPUCapabilities] = None,
) -> Dict:
    """Per-step compute against the KV shard's transfer to the next device,
    and the predicted overlap (ring attention hides the transfer when the
    step's compute is at least as long)."""
    c = _caps(caps)
    comp = attention_prefill_cost(
        batch, local_seq, local_seq, num_heads, head_dim, dtype=dtype, caps=c
    )
    b = _DTYPE_BYTES[dtype]
    kv_bytes = 2.0 * batch * num_heads * local_seq * head_dim * b
    t_ici_us = kv_bytes / (max(c.ici_gbps, 1e-3) * 1e9) * 1e6
    overlap = min(1.0, comp.t_roofline_us / max(t_ici_us, 1e-9))
    return {
        "t_compute_us": comp.t_roofline_us,
        "t_ici_us": t_ici_us,
        "overlap_efficiency": overlap,
        "comm_hidden": comp.t_roofline_us >= t_ici_us,
        "steps": n_devices,
    }


def roofline_fraction(measured_us: float, cost: KernelCost) -> float:
    """Fraction of speed-of-light achieved."""
    return cost.t_roofline_us / max(measured_us, 1e-9)


# -- composite (measured-rate) roofline -----------------------------------

#: The rates this card's probes measure (``chip_smoke.py``'s roofline
#: phase; ops/hbm_bw.py, ops/device_probes.py), with JAX's keys, each on an
#: NVIDIA H100 80GB HBM3 at a 700.00 W power limit.
H100_MEASURED_RATES = {
    "hbm_read_Bps": 3050.6e9,  # K9, bench.py's 256 MiB bf16 stream
    # Asymptotic softmax-stream rate: 1 / b of the per-update model t = a +
    # b * elements (measure_softmax_linear: unmasked, 12672 rows, one wave),
    # and a, the fixed cost of one update of those rows.
    "vpu_softmax_elems_per_s": 2458.9e9,
    "vpu_softmax_fixed_s_per_tile": 65.8e-9,
    "vpu_exp_elems_per_s": 3817.3e9,  # K11, measure_exp_rate
}


def attention_composite_ceiling(
    batch: int,
    q_len: int,
    kv_len: int,
    num_heads: int,
    head_dim: int,
    *,
    causal: bool = False,
    score_dtype: str = "bf16",
    pv_dtype: str = "bf16",
    io_dtype: str = "bf16",
    num_kv_heads: Optional[int] = None,
    rates: Optional[Dict] = None,
    caps: Optional[TPUCapabilities] = None,
) -> Dict:
    """Per-geometry speed of light of a flash-attention forward, from the
    three units it uses:

    * matrix unit: QK^T at the score dtype's peak and P.V at the PV dtype's,
      derated below the unit's contraction width;
    * softmax stream ("vpu"): one pass per score element at the measured
      asymptotic stream rate (``rates``, default :data:`H100_MEASURED_RATES`);
    * HBM: q/k/v read and o written once at the measured read rate.

    The ceiling is the largest of the three times (perfect overlap). Score
    elements are the required ones (S_q * S_kv / 2 when causal). Returns
    each term (us), the binding unit and the ceiling; divide it by a
    measured time for the share of the composite.
    """
    c = _caps(caps)
    r = dict(H100_MEASURED_RATES)
    if rates:
        r.update({k: v for k, v in rates.items() if v})
    frac = 0.5 if causal and q_len == kv_len else 1.0
    n_scores = batch * num_heads * q_len * kv_len * frac
    mxu_eff = _underfill(head_dim, c)

    def mxu_rate(dtype: str) -> float:
        peak = c.int8_tops if dtype in ("int8",) else c.bf16_tflops
        return peak * 1e12 * mxu_eff

    t_mxu_s = 2.0 * n_scores * head_dim / mxu_rate(score_dtype)
    t_mxu_s += 2.0 * n_scores * head_dim / mxu_rate(pv_dtype)
    t_vpu_s = n_scores / r["vpu_softmax_elems_per_s"]
    hkv = num_kv_heads or num_heads
    b = _DTYPE_BYTES[io_dtype]
    hbm_bytes = (
        batch * num_heads * q_len * head_dim * b * 2  # q read + o write
        + batch * hkv * kv_len * head_dim * b * 2  # k + v read
    )
    t_hbm_s = hbm_bytes / r["hbm_read_Bps"]
    t_ceiling = max(t_mxu_s, t_vpu_s, t_hbm_s)
    bound = {t_mxu_s: "mxu", t_vpu_s: "vpu", t_hbm_s: "hbm"}[t_ceiling]
    return {
        "t_mxu_us": t_mxu_s * 1e6,
        "t_vpu_us": t_vpu_s * 1e6,
        "t_hbm_us": t_hbm_s * 1e6,
        "t_ceiling_us": t_ceiling * 1e6,
        "bound": bound,
        "n_scores": n_scores,
    }


def composite_fraction(measured_us: float, ceiling: Dict) -> float:
    """Measured time -> fraction of the composite speed of light."""
    return ceiling["t_ceiling_us"] / max(measured_us, 1e-9)


# -- energy model ---------------------------------------------------------

# Energy per operation: JAX's constants as they are. They are estimates from
# the accelerator-architecture literature (Horowitz, ISSCC 2014, scaled to
# ~7 nm; HBM2e access at ~3-7 pJ/bit), a measurement of neither chip: no
# per-kernel power counter is read here either. An HBM byte costs ~100x a
# FLOP, which is why a bytes-aware model ranks kernels that a latency x
# watts model cannot.
PJ_PER_FLOP = {
    "bf16": 0.30,
    "fp16": 0.30,
    "f32": 0.60,
    "int8": 0.12,
    "fp8": 0.12,
    # QK-only quantized kernels: score matmul at the int8/fp8 energy, P.V
    # at bf16 (flops split 50/50; core/engine.py::_ENERGY_DTYPE).
    "int8qk": 0.21,
    "fp8qk": 0.21,
}
PJ_PER_HBM_BYTE = 40.0
#: Power drawn whatever the work: the card's idle draw, ``nvidia-smi
#: --query-gpu=power.draw`` read by ``chip_smoke.py``'s device phase before
#: any work (70.05 W on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit).
STATIC_POWER_W = 70.05


def kernel_energy_mj(
    cost: KernelCost, latency_ms: float, *, dtype: str = "bf16"
) -> float:
    """Roofline-derived energy of one kernel execution (mJ):
    ``flops * e_flop(dtype) + hbm_bytes * e_byte + P_static * t``. The
    dynamic terms scale with the work (int8 lowers the energy of a FLOP and,
    where the kernel moves fewer bytes, the HBM term), the static term with
    the measured time."""
    e_flop = PJ_PER_FLOP.get(dtype, PJ_PER_FLOP["bf16"])
    dynamic_pj = cost.flops * e_flop + cost.hbm_bytes * PJ_PER_HBM_BYTE
    static_mj = STATIC_POWER_W * latency_ms  # W x ms = mJ
    return dynamic_pj * 1e-9 + static_mj
