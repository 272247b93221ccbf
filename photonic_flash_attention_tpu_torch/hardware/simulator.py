"""Design-space simulators: kernel pipeline + interconnect topology.

Port of ``photonic_flash_attention_tpu/hardware/simulator.py``
(``PipelinePrediction``, ``KernelPipelineSimulator``, ``CollectiveCost``,
``TopologySimulator``), with JAX's formulas, read from the port's device
record (``hardware/detection.py``):

* :class:`KernelPipelineSimulator` predicts a flash forward's latency per
  (block_q, block_kv) tile: per grid cell the tile loads against the
  matrix-unit and softmax work, ``max(t_dma, t_mxu + t_vpu)`` plus a fixed
  cost, times the cells plus one fill. The tile budget is ``vmem_mb`` of
  the record (on the card, the shared memory one block can use) times
  JAX's 1e6 bytes a MB and the budget fraction; the matrix unit's
  underfill below a head dim is ``min(1, head_dim / contraction_width)``,
  as ``hardware/roofline.py::_underfill`` computes it (16 on the H100,
  128 on JAX's rows, so a record holding a TPU's figures gives JAX's
  predictions exactly).
* :class:`TopologySimulator` prices the collectives over a mesh. Two
  topologies: JAX's ``"torus"`` (1D/2D/3D torus hop distances, ring
  collectives over bidirectional links, each direction carrying half) and
  ``"switch"``, the H100 host's NVSwitch all to all: every pair of cards
  one hop apart, each card sending at the record's NVLink rate each way
  (``ici_gbps``, 450 GB/s). On the switch the bytes a rank moves are
  ``parallel/telemetry.py::collective_bytes``'s for the same collective,
  given ``bytes_per_device`` as the buffer each rank holds in full (the
  all-gather's output, the all-reduce's operand); ``CollectiveCost.
  bytes_moved`` carries them. The record decides: the switch for the
  card's, the torus for any other.

Both are predictive tools: measured numbers win (the router and the
autotuner treat these as priors or bounds only).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence

from .detection import TPUCapabilities
from .roofline import _caps, _underfill, attention_prefill_cost

_DTYPE_BYTES = {"bf16": 2, "fp16": 2, "f32": 4, "fp8": 1, "int8": 1}
_LANE = 128
# Elementwise (softmax) throughput relative to the matrix unit's peak.
_VPU_FRACTION_OF_PEAK = 1.0 / 64.0
#: Device generations whose host joins its cards through a switch.
SWITCHED_GENERATIONS = ("h100",)
COLLECTIVES = ("psum", "all_gather", "reduce_scatter", "ppermute", "all_to_all")


@dataclasses.dataclass
class PipelinePrediction:
    block_q: int
    block_kv: int
    grid_cells: int
    vmem_bytes: int
    feasible: bool
    t_dma_us_per_cell: float
    t_mxu_us_per_cell: float
    t_vpu_us_per_cell: float
    t_total_us: float

    @property
    def bound(self) -> str:
        t = max(self.t_dma_us_per_cell, self.t_mxu_us_per_cell, self.t_vpu_us_per_cell)
        if t == self.t_dma_us_per_cell:
            return "dma"
        return "mxu" if t == self.t_mxu_us_per_cell else "vpu"

    def as_dict(self) -> Dict:
        return {**dataclasses.asdict(self), "bound": self.bound}


class KernelPipelineSimulator:
    """Predict flash-kernel latency per (block_q, block_kv) design point.

    Per cell (one q tile x kv tile step): the kv tile's load every cell and
    the q tile's once a kv sweep; QK^T + PV at ``4 * bq * bkv * d`` FLOPs;
    ~8 softmax operations a score element plus the online-softmax
    bookkeeping; 0.1 us of fixed cost. Causal square calls run half the
    cells.
    """

    def __init__(
        self,
        caps: Optional[TPUCapabilities] = None,
        vmem_budget_fraction: float = 0.5,
    ) -> None:
        self.caps = _caps(caps)
        self.vmem_budget = self.caps.vmem_mb * 1e6 * vmem_budget_fraction

    def predict(
        self,
        batch: int,
        q_len: int,
        kv_len: int,
        num_heads: int,
        head_dim: int,
        block_q: int,
        block_kv: int,
        *,
        causal: bool = False,
        dtype: str = "bf16",
    ) -> PipelinePrediction:
        c = self.caps
        b = _DTYPE_BYTES[dtype]
        d = max(head_dim, 64)

        num_q = -(-q_len // block_q)
        num_kv = -(-kv_len // block_kv)
        cells = batch * num_heads * num_q * num_kv
        if causal and q_len == kv_len:
            cells = max(1, cells // 2)  # future blocks skipped

        # Tile working set: double-buffered q/k/v tiles + fp32 m, l, acc.
        vmem = 2 * (block_q * d * b + 2 * block_kv * d * b) + block_q * (2 * _LANE + d) * 4
        feasible = vmem <= self.vmem_budget

        dma_bytes = 2 * block_kv * d * b + (block_q * d * b) / max(num_kv, 1)
        t_dma = dma_bytes / (c.hbm_gbps * 1e9) * 1e6

        mxu_flops = 4.0 * block_q * block_kv * d
        mxu_eff = _underfill(head_dim, c)
        mxu_eff *= min(1.0, block_q / 256.0)  # small row tiles underfill the pipeline
        t_mxu = mxu_flops / (c.bf16_tflops * 1e12 * mxu_eff) * 1e6

        vpu_ops = 8.0 * block_q * block_kv + 6.0 * block_q * d
        t_vpu = vpu_ops / (c.bf16_tflops * 1e12 * _VPU_FRACTION_OF_PEAK) * 1e6

        t_fixed = 0.1
        t_cell = max(t_dma, t_mxu + t_vpu) + t_fixed
        total = (cells + 1) * t_cell  # +1 pipeline fill
        return PipelinePrediction(
            block_q, block_kv, cells, int(vmem), feasible, t_dma, t_mxu, t_vpu, total
        )

    def sweep(
        self,
        batch: int,
        q_len: int,
        kv_len: int,
        num_heads: int,
        head_dim: int,
        *,
        causal: bool = False,
        dtype: str = "bf16",
        block_qs: Sequence[int] = (128, 256, 512, 1024),
        block_kvs: Sequence[int] = (128, 256, 512, 1024, 2048),
    ) -> List[PipelinePrediction]:
        """Design-space sweep; feasible points sorted fastest-first (all
        points when none is feasible)."""
        preds = [
            self.predict(batch, q_len, kv_len, num_heads, head_dim, bq, bkv,
                         causal=causal, dtype=dtype)
            for bq, bkv in itertools.product(block_qs, block_kvs)
            if bq <= max(_LANE, q_len) and bkv <= max(_LANE, kv_len)
        ]
        feasible = [p for p in preds if p.feasible]
        return sorted(feasible or preds, key=lambda p: p.t_total_us)

    def best(self, *args, **kwargs) -> PipelinePrediction:
        return self.sweep(*args, **kwargs)[0]


# ---------------------------------------------------------------------------
# Interconnect topology
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CollectiveCost:
    collective: str
    bytes_per_device: float
    t_us: float
    hops: int
    links_used: int
    #: Bytes one rank sends: the ring forms on the torus; on the switch,
    #: ``parallel/telemetry.py::collective_bytes``'s count.
    bytes_moved: float = 0.0


class TopologySimulator:
    """Mesh model with per-collective cost prediction.

    Ring-algorithm forms, per axis: psum moves ``2 (n-1)/n`` of the bytes
    over ``2 (n-1)`` steps; all_gather / reduce_scatter / all_to_all
    ``(n-1)/n`` over ``n-1``; ppermute the bytes once, one step. On the
    torus both directions of a ring carry half (JAX); on the switch a rank
    sends everything at its link rate each way.
    """

    def __init__(
        self,
        mesh_shape: Sequence[int],
        caps: Optional[TPUCapabilities] = None,
        wrap: bool = True,
    ) -> None:
        self.shape = tuple(int(s) for s in mesh_shape)
        self.caps = _caps(caps)
        self.wrap = wrap
        #: "switch" for a record of SWITCHED_GENERATIONS, else JAX's "torus".
        self.topology = "switch" if self.caps.generation in SWITCHED_GENERATIONS else "torus"
        self.num_devices = 1
        for s in self.shape:
            self.num_devices *= s

    def hop_distance(self, a: Sequence[int], b: Sequence[int]) -> int:
        """Manhattan distance on the (wrapped) torus; on the switch 1
        between two distinct devices."""
        if self.topology == "switch":
            return 0 if tuple(a) == tuple(b) else 1
        total = 0
        for x, y, s in zip(a, b, self.shape):
            d = abs(x - y)
            if self.wrap and s > 2:
                d = min(d, s - d)
            total += d
        return total

    def max_hops(self) -> int:
        """Network diameter (worst-case point-to-point hops)."""
        if self.topology == "switch":
            return 1 if self.num_devices > 1 else 0
        return sum((s // 2 if self.wrap and s > 2 else s - 1) for s in self.shape)

    def _axis_bw(self) -> float:
        # per-link bandwidth each way, bytes/s
        return self.caps.ici_gbps * 1e9

    def collective_cost(
        self, collective: str, bytes_per_device: float, axes: Optional[Sequence[int]] = None
    ) -> CollectiveCost:
        """Predict one collective's time over the given mesh axes (default:
        all axes)."""
        if collective not in COLLECTIVES:
            raise ValueError(f"unknown collective {collective!r}")
        axes = list(range(len(self.shape))) if axes is None else list(axes)
        n = 1
        for ax in axes:
            n *= self.shape[ax]
        bw = self._axis_bw()
        frac = (n - 1) / max(n, 1)
        if collective == "psum":
            moved, hops = 2.0 * frac * bytes_per_device, 2 * (n - 1)
        elif collective == "ppermute":
            moved, hops = bytes_per_device, 1
        else:  # all_gather, reduce_scatter, all_to_all
            moved, hops = frac * bytes_per_device, n - 1
        if self.topology == "switch":
            from ..parallel.telemetry import collective_bytes  # parallel imports hardware

            # telemetry counts an all-gather by its input shard
            shard = bytes_per_device / n if collective == "all_gather" else bytes_per_device
            moved = float(collective_bytes(collective, shard, n))
            t_us = moved / bw * 1e6
        elif self.wrap:
            t_us = moved / (2.0 * bw) * 1e6  # bidirectional rings
        else:
            t_us = moved / bw * 1e6
        return CollectiveCost(collective, bytes_per_device, t_us, hops, len(axes), moved)

    def ring_attention_overlap(
        self,
        batch: int,
        local_seq: int,
        num_heads: int,
        head_dim: int,
        axis: int = 0,
        *,
        dtype: str = "bf16",
    ) -> Dict:
        """Compute against the KV shard's ppermute for ring attention on one
        axis (the >= 85 % scaling-efficiency gate's analytic form)."""
        comp = attention_prefill_cost(
            batch, local_seq, local_seq, num_heads, head_dim, dtype=dtype, caps=self.caps,
        )
        kv_bytes = 2.0 * batch * num_heads * local_seq * head_dim * _DTYPE_BYTES[dtype]
        comm = self.collective_cost("ppermute", kv_bytes, axes=[axis])
        n = self.shape[axis]
        t_step = max(comp.t_roofline_us, comm.t_us)
        ideal = n * comp.t_roofline_us
        return {
            "steps": n,
            "t_compute_us": comp.t_roofline_us,
            "t_ppermute_us": comm.t_us,
            "comm_hidden": comp.t_roofline_us >= comm.t_us,
            "t_total_us": n * t_step,
            "scaling_efficiency": ideal / max(n * t_step, 1e-9),
        }

    def describe(self) -> Dict:
        return {
            "shape": self.shape,
            "devices": self.num_devices,
            "wrap": self.wrap,
            "diameter_hops": self.max_hops(),
            "ici_gbps_per_link": self.caps.ici_gbps,
            "topology": self.topology,
        }
