"""Adaptive attention engine: kernel registry, measured routing, stats.

Port of ``photonic_flash_attention_tpu/core/engine.py``: ``AttentionEngine``,
``get_engine`` and ``reset_engine``, with ``_analyze_mask`` (a concrete
boolean mask that is really key padding becomes ``kv_lens``/``k_bias``),
warm-up then exploit (each eligible kind is measured once before the router
exploits its table, ``core/timing.py``), the off-thread refresh of a stale
measurement, and the stats surface (``last_kernel_used``,
``get_performance_stats``). Calls are eager; there is no jit cache.

Kinds offered (no mesh):

* FUSED — ``ops/fused.py`` (plain PyTorch, as JAX leaves it to XLA);
* FLASH — ``ops/flash.py`` (K1), plain, with the key streams, or, for a
  mask with (Sq, Skv) structure, with the mask as a dense additive bias
  (K1's dense-bias mode; JAX ``core/engine.py:314-341``);
* FLASH_UNROLLED — ``ops/flash_unrolled.py`` (K1), square self-attention,
  ``kv_lens`` folded into the per-key bias first, as in JAX;
* PAGED_DECODE — decode-shaped calls (Sq = 1, Skv >= 128): contiguous K/V
  repacked into a token-major page-128 pool with an identity page table,
  then ``ops/paged.py::paged_attention_hf`` (K3);
* under ``enable_int8`` (default: ``quant_mode == "int8"``):
  FLASH_UNROLLED_INT8QK (square, ``flash_attention_unrolled(int8_qk=True)``),
  FLASH_INT8QK and FLASH_INT8FULL (``ops/flash_fp8.py``, K1's int8 modes);
* under ``enable_fp8`` (default: ``quant_mode == "fp8"``): FLASH_FP8
  (``flash_attention_fp8``, K6) and FLASH_FP8QK (K1's fp8-QK mode).
  The router offers the quantized kinds to mask-free calls only, as in JAX.
* after ``set_mesh`` (JAX ``core/engine.py:150-195``): RING
  (``parallel/ring.py``, K1 with lse a step) and ULYSSES
  (``parallel/ulysses.py``, K1 over the full sequence a head block), on the
  mesh's ``seq`` axis, where JAX's feasibility gates let them. Every rank
  of the mesh calls the engine with the same global tensors and gets the
  global output. The callables built over a mesh are dropped when the
  mesh changes (``set_mesh``/``clear_mesh``), as JAX drops its jits.
  ``seq_parallel_attention`` makes the same choice, over the seq axis
  alone and differentiable, for a module's call that does not route
  through the engine (a sharded trainer's attention).

Differences from the JAX engine, each in ROADMAP Queue C:

* no hidden fallback for CUDA tensors: a kernel that fails there raises
  (the JAX engine reruns the call on FUSED and counts the failure); CPU
  tensors keep the JAX fallback;
* FLASH_INT8QK and FLASH_FP8QK are not offered for fp32 V on the card:
  K1's quantized modes run P.V in bf16 (JAX runs it in fp32 for fp32 V);
  the plain versions on the CPU keep fp32.

Energy is JAX's roofline estimate (``_estimate_energy_mj``: FLOPs x energy
per FLOP + HBM bytes x energy per byte + the card's idle draw x latency,
``hardware/roofline.py``). The device record is resolved once, when the
engine is built. Without a workload, or on a card the roofline's table
does not hold, it is latency x the card's power limit, read once from
``nvidia-smi`` (None without a card), where JAX takes 170 W, a TPU v5e
figure: an unknown card fails the roofline's own calls, never attention.
A fault in the estimate raises: JAX's catch-all fallback is not carried
over.
"""

from __future__ import annotations

import subprocess
import threading
import time
from typing import Callable, Dict, Optional, Tuple

import torch

from ..config import get_config
from ..hardware.detection import known_capabilities
from ..hardware.roofline import attention_decode_cost, attention_prefill_cost, kernel_energy_mj
from ..ops.flash import flash_attention
from ..ops.flash_fp8 import (
    flash_attention_fp8,
    flash_attention_fp8qk,
    flash_attention_int8full,
    flash_attention_int8qk,
)
from ..ops.flash_unrolled import flash_attention_unrolled, unrolled_supported
from ..ops.fused import fused_attention
from ..ops.paged import paged_attention_hf
from ..ops.reference import DEFAULT_MASK_VALUE
from ..parallel.mesh import mesh_shape
from ..parallel.ring import make_ring_attention
from ..parallel.ulysses import make_ulysses_attention
from ..utils.exceptions import ComputationError
from ..utils.logging import get_logger
from ..utils.monitoring import get_metrics
from ..utils.validation import validate_attention_inputs
from .autotuner import Autotuner, TuneResult, candidate_blocks, get_autotuner
from .router import AdaptiveRouter, KernelKind, WorkloadCharacteristics
from .timing import measure_ms

logger = get_logger("engine")

#: Page size of the PAGED_DECODE repack (the JAX engine's).
DECODE_PAGE = 128
#: Kinds whose kernel mode takes bf16 V only (P.V in bf16): not offered
#: for fp32 V on the card.
BF16_V_KINDS = (KernelKind.FLASH_INT8QK, KernelKind.FLASH_FP8QK)
#: The quantized kinds that ``_run`` executes through one function each.
QUANT_KINDS = {
    KernelKind.FLASH_FP8: flash_attention_fp8,
    KernelKind.FLASH_FP8QK: flash_attention_fp8qk,
    KernelKind.FLASH_INT8QK: flash_attention_int8qk,
    KernelKind.FLASH_INT8FULL: flash_attention_int8full,
}


def card_power_limit_w() -> Optional[float]:
    """The current card's power limit in W from ``nvidia-smi``; None
    without CUDA or when it cannot be read."""
    if not torch.cuda.is_available():
        return None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
             "-i", str(torch.cuda.current_device())],
            check=True, capture_output=True, text=True, timeout=30,
        ).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError) as e:
        logger.warning("could not read the card's power limit: %s", e)
        return None


def _analyze_mask(mask: Optional[torch.Tensor], b: int, skv: int):
    """Classify a boolean mask for kernel routing (JAX ``_analyze_mask``).

    Returns ``(mask_kind, kv_lens, k_bias)``: ``("none", None, None)``;
    ``("key", lens, None)`` for a head- and row-invariant contiguous prefix
    (right padding); ``("key", lens, bias)`` for any other key pattern,
    lens then the last valid position + 1; ``("dense", None, None)`` for a
    mask with (Sq, Skv) structure."""
    if mask is None:
        return "none", None, None
    m = mask.to(torch.bool)
    while m.ndim < 4:
        m = m[None]
    if m.shape[1] != 1 and not bool((m == m[:, :1]).all()):
        return "dense", None, None
    mh = m[:, :1]
    if mh.shape[2] != 1 and not bool((mh == mh[:, :, :1]).all()):
        return "dense", None, None
    km = mh[:, 0, 0, :].expand(b, skv)
    pos = torch.arange(skv, device=km.device)
    lens = torch.where(km, pos + 1, 0).amax(dim=1).to(torch.int32)
    if bool((km == (pos[None] < lens[:, None])).all()):
        return "key", lens, None
    k_bias = torch.where(km, 0.0, DEFAULT_MASK_VALUE).to(torch.float32)
    return "key", lens, k_bias


def _key_keep(skv: int, kv_lens, k_bias, device) -> torch.Tensor:
    """The (B, Skv) boolean keep-mask of a key mask given as lens/bias."""
    if k_bias is not None:
        return k_bias >= DEFAULT_MASK_VALUE / 2
    return torch.arange(skv, device=device)[None] < kv_lens.to(device)[:, None]


def _dense_mask_bias(q, k, mask: torch.Tensor) -> torch.Tensor:
    """A boolean mask with (Sq, Skv) structure as K1's dense additive bias
    (B, 1|Hq, Sq, Skv) fp32: 0 = attend, ``DEFAULT_MASK_VALUE`` = ignore
    (JAX ``core/engine.py:325-334``)."""
    m = mask.to(device=q.device, dtype=torch.bool)
    while m.ndim < 4:
        m = m[None]
    b, sq, hq = q.shape[0], q.shape[1], q.shape[2]
    hb = 1 if m.shape[1] == 1 else hq
    m = m.expand(b, hb, sq, k.shape[1])
    return torch.where(m, 0.0, DEFAULT_MASK_VALUE).to(torch.float32)


def _decode_paged(q, k, v, kv_lens):
    """PAGED_DECODE: (B, 1, Hq, D) over contiguous (B, Skv, Hkv, D) K/V,
    repacked into a token-major (Hkv, B*pps, 128, D) pool with an identity
    page table, through paged_attention_hf."""
    b, _, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    pad = (-skv) % DECODE_PAGE
    pps = (skv + pad) // DECODE_PAGE

    def to_pages(x):
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        return x.reshape(b, pps, DECODE_PAGE, hkv, d).permute(3, 0, 1, 2, 4).reshape(
            hkv, b * pps, DECODE_PAGE, d
        ).contiguous()

    tables = torch.arange(b * pps, dtype=torch.int32, device=q.device).reshape(b, pps)
    lengths = (
        kv_lens.to(device=q.device, dtype=torch.int32)
        if kv_lens is not None
        else torch.full((b,), skv, dtype=torch.int32, device=q.device)
    )
    out = paged_attention_hf(q[:, 0], to_pages(k), to_pages(v), lengths, tables)
    return out[:, None]


class AttentionEngine:
    """Routes (q, k, v) attention calls across the port's kernels by
    measured latency per workload bucket."""

    def __init__(
        self,
        router: Optional[AdaptiveRouter] = None,
        autotuner: Optional[Autotuner] = None,
        enable_fp8: Optional[bool] = None,
        enable_int8: Optional[bool] = None,
    ) -> None:
        cfg = get_config()
        self.router = router or AdaptiveRouter()
        # Energy-aware arbitration (config.energy_weight > 0): the router
        # blends measured latency with the roofline energy estimate.
        self.router.energy_model = lambda kind, w, lat: self._estimate_energy_mj(kind, lat, w)
        self.autotuner = autotuner or get_autotuner()
        # Quantized kinds are opt-in per family, as in JAX: fp8 under
        # quant_mode "fp8", int8 under "int8".
        self.enable_fp8 = enable_fp8 if enable_fp8 is not None else cfg.quant_mode == "fp8"
        self.enable_int8 = enable_int8 if enable_int8 is not None else cfg.quant_mode == "int8"
        #: the card's power limit (W), read once; None without a card.
        self.board_power_w = card_power_limit_w()
        self.router.board_power_w = self.board_power_w
        #: the roofline's record of this device, None for a card it lacks.
        self.energy_caps = known_capabilities()
        self._lock = threading.RLock()
        self._metrics = get_metrics()
        self._refresh_inflight: set = set()
        self.last_kernel_used: Optional[str] = None
        self.last_latency_ms: float = 0.0
        self.last_energy_mj: Optional[float] = None
        self._total_calls = 0
        self._failure_counts: Dict[str, int] = {}
        # Mesh context of the sequence-parallel kinds (set_mesh); None:
        # RING and ULYSSES are not offered.
        self._mesh = None
        self._mesh_axes: Dict[str, Optional[str]] = {}
        self._seq_fns: Dict[Tuple, Callable] = {}

    # -- mesh context ----------------------------------------------------------

    @property
    def mesh(self):
        """The mesh of ``set_mesh``, or None."""
        return self._mesh

    @property
    def seq_axis(self) -> Optional[str]:
        """The mesh axis RING and ULYSSES run on, or None without a mesh."""
        return self._mesh_axes.get("seq")

    def set_mesh(self, mesh, *, seq_axis: str = "seq", data_axis: Optional[str] = None,
                 model_axis: Optional[str] = None) -> None:
        """Register a device mesh (``parallel/mesh.py``): RING and ULYSSES
        join the registry on its ``seq_axis``; batch rides ``data_axis``
        and heads ``model_axis`` where given. Drops the callables built
        over the previous mesh."""
        if seq_axis not in mesh_shape(mesh):
            raise ComputationError(f"mesh has no axis {seq_axis!r}")
        with self._lock:
            self._mesh = mesh
            self._mesh_axes = {"seq": seq_axis, "data": data_axis, "model": model_axis}
            self._seq_fns.clear()

    def clear_mesh(self) -> None:
        with self._lock:
            self._mesh = None
            self._mesh_axes = {}
            self._seq_fns.clear()

    def _n_seq(self) -> int:
        return mesh_shape(self._mesh)[self._mesh_axes["seq"]]

    def _ring_feasible(self, w: WorkloadCharacteristics) -> bool:
        """JAX's gate: a seq axis of more than one rank that divides the
        sequence into shards of at least 128; square self-attention with
        no mask or a key mask; no weights."""
        if self._mesh is None or w.is_decode or w.need_weights:
            return False
        if w.mask_kind not in ("none", "key") or w.q_len != w.kv_len:
            return False
        n_seq = self._n_seq()
        if n_seq <= 1 or w.q_len % n_seq:
            return False
        return w.q_len // n_seq >= 128

    def _ulysses_feasible(self, w: WorkloadCharacteristics) -> bool:
        """JAX's gate: the seq axis divides the heads, the KV heads and the
        sequence, into shards that are multiples of 128."""
        if self._mesh is None or w.is_decode or w.need_weights:
            return False
        if w.mask_kind not in ("none", "key") or w.q_len != w.kv_len:
            return False
        n_seq = self._n_seq()
        if n_seq <= 1 or w.num_heads % n_seq or w.q_len % n_seq:
            return False
        if (w.num_kv_heads or w.num_heads) % n_seq:
            return False
        return (w.q_len // n_seq) % 128 == 0

    def _seq_fn(self, kind: KernelKind, causal: bool, local: bool = False) -> Callable:
        """The RING or ULYSSES callable over the current mesh (global
        tensors in and out), built once a mesh, causality and ``local``.
        ``local``: over the seq axis alone and differentiable, for tensors
        that already hold this rank's batch block and heads."""
        with self._lock:
            if self._mesh is None:
                raise ComputationError(f"{kind.value} requires set_mesh() first")
            fn = self._seq_fns.get((kind, causal, local))
            if fn is None:
                axes = self._mesh_axes
                data_axis = None if local else axes["data"]
                if kind == KernelKind.RING:
                    fn = make_ring_attention(self._mesh, seq_axis=axes["seq"],
                                             data_axis=data_axis,
                                             model_axis=None if local else axes["model"],
                                             causal=causal, differentiable=local)
                else:
                    fn = make_ulysses_attention(self._mesh, seq_axis=axes["seq"],
                                                data_axis=data_axis, causal=causal)
                self._seq_fns[(kind, causal, local)] = fn
            return fn

    def seq_parallel_attention(self, q: torch.Tensor, k: torch.Tensor, *,
                               causal: bool) -> Optional[Callable]:
        """The differentiable sequence-parallel attention for a module's
        self-attention over (B, S, H, D) ``q`` and ``k`` that already hold
        this rank's batch block and heads (a sharded trainer's): ULYSSES
        where its gate lets it, else RING where its gate does, else None
        (no mesh, or a seq axis of one rank). ``fn(q, k, v, kv_lens=None,
        k_bias=None)`` splits the sequence over the seq axis and returns
        the whole output on every rank. Asked at every call, so a mesh set
        or cleared later is seen."""
        if self._mesh is None:
            return None
        w = WorkloadCharacteristics(
            batch_size=q.shape[0], q_len=q.shape[1], kv_len=k.shape[1], num_heads=q.shape[2],
            head_dim=q.shape[3], causal=causal, mask_kind="key",
            dtype=str(q.dtype).replace("torch.", ""), num_kv_heads=k.shape[2])
        for kind, feasible in ((KernelKind.ULYSSES, self._ulysses_feasible),
                               (KernelKind.RING, self._ring_feasible)):
            if feasible(w):
                return self._seq_fn(kind, causal, local=True)
        return None

    def _available_kernels(
        self, w: Optional[WorkloadCharacteristics] = None
    ) -> Tuple[KernelKind, ...]:
        kinds = [KernelKind.FUSED, KernelKind.FLASH]
        if w is not None and not w.is_decode and w.q_len == w.kv_len:
            if unrolled_supported(w.q_len, w.head_dim):
                kinds.append(KernelKind.FLASH_UNROLLED)
            if self.enable_int8 and unrolled_supported(w.q_len, w.head_dim, int8_qk=True):
                kinds.append(KernelKind.FLASH_UNROLLED_INT8QK)
        if self.enable_fp8:
            kinds += [KernelKind.FLASH_FP8, KernelKind.FLASH_FP8QK]
        if self.enable_int8:
            kinds += [KernelKind.FLASH_INT8QK, KernelKind.FLASH_INT8FULL]
        if (w is not None and w.is_decode and w.kv_len >= DECODE_PAGE
                and w.dtype in ("bfloat16", "float32")):
            kinds.append(KernelKind.PAGED_DECODE)  # pools K3 takes; not float16
        if w is not None and self._ring_feasible(w):
            kinds.append(KernelKind.RING)
        if w is not None and self._ulysses_feasible(w):
            kinds.append(KernelKind.ULYSSES)
        return tuple(kinds)

    def _run(self, kind: KernelKind, q, k, v, mask, kv_lens, k_bias, causal, need_weights):
        """Execute one kind: (output, weights or None)."""
        if kind == KernelKind.FUSED:
            if mask is None and (kv_lens is not None or k_bias is not None):
                # A key mask given as lens/bias: the fused path takes it dense.
                mask = _key_keep(k.shape[1], kv_lens, k_bias, q.device)[:, None, None, :]
            return fused_attention(q, k, v, mask, causal=causal, need_weights=need_weights)
        if kind == KernelKind.FLASH and mask is not None:
            return flash_attention(q, k, v, causal=causal, attn_bias=_dense_mask_bias(q, k, mask)), None
        if kind == KernelKind.FLASH:
            return flash_attention(q, k, v, causal=causal, kv_lens=kv_lens, k_bias=k_bias), None
        if kind == KernelKind.FLASH_UNROLLED:
            bias = k_bias.float() if k_bias is not None else None
            if kv_lens is not None:
                # Key padding as the in-kernel per-key bias (one fp32 stream).
                keep = _key_keep(k.shape[1], kv_lens, None, q.device)
                bias = torch.where(keep, 0.0 if bias is None else bias, DEFAULT_MASK_VALUE)
            return flash_attention_unrolled(q, k, v, causal=causal, k_bias=bias), None
        if kind == KernelKind.FLASH_UNROLLED_INT8QK:
            return flash_attention_unrolled(q, k, v, causal=causal, int8_qk=True), None
        if kind in QUANT_KINDS:
            return QUANT_KINDS[kind](q, k, v, causal=causal), None
        if kind == KernelKind.PAGED_DECODE:
            return _decode_paged(q, k, v, kv_lens), None
        if kind in (KernelKind.RING, KernelKind.ULYSSES):
            return self._seq_fn(kind, causal)(q, k, v, kv_lens=kv_lens, k_bias=k_bias), None
        raise ComputationError(f"engine has no kernel for {kind}")

    # -- main entry -------------------------------------------------------------

    def __call__(
        self,
        q: torch.Tensor,
        k: torch.Tensor,
        v: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
        *,
        causal: bool = False,
        need_weights: bool = False,
        kv_lens: Optional[torch.Tensor] = None,
        k_bias: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Route and execute one attention call: (B, S, H, D) in,
        ((B, Sq, Hq, D), optional (B, Hq, Sq, Skv) weights) out. Key padding
        may come as ``kv_lens``/``k_bias`` or as a boolean ``mask`` that
        ``_analyze_mask`` recognises."""
        validate_attention_inputs(q, k, v, mask)
        b, sq, hq, d = q.shape
        skv = k.shape[1]
        if kv_lens is not None or k_bias is not None:
            if mask is not None:
                raise ComputationError("pass either mask or kv_lens/k_bias, not both")
            mask_kind = "key"
        else:
            mask_kind, kv_lens, k_bias = _analyze_mask(mask, b, skv)
            if mask_kind == "key":
                mask = None  # carried as lens/bias from here on
        w = WorkloadCharacteristics(
            batch_size=b, q_len=sq, kv_len=skv, num_heads=hq, head_dim=d, causal=causal,
            mask_kind=mask_kind, need_weights=need_weights, is_decode=(sq == 1),
            dtype=str(q.dtype).split(".")[-1], num_kv_heads=k.shape[2],
        )
        cfg = get_config()
        # PAGED_DECODE takes key padding as lengths but has no per-key bias;
        # K1's int8/fp8-QK modes take no fp32 V on the card.
        available = tuple(
            kind for kind in self._available_kernels(w)
            if not (kind == KernelKind.PAGED_DECODE and k_bias is not None)
            and not (kind in BF16_V_KINDS and v.is_cuda and v.dtype == torch.float32)
        )
        eligible = self.router.eligible_kernels(w, available)
        if cfg.auto_kernel_selection:
            kind = self.router.select_kernel(w, available)
        else:
            kind = self.router.heuristic_selection(w, eligible)

        def run(kind: KernelKind, q_in: torch.Tensor):
            return self._run(kind, q_in, k, v, mask, kv_lens, k_bias, causal, need_weights)

        if (
            cfg.auto_kernel_selection
            and len(eligible) > 1
            and kind in eligible
            and self.router.needs_measurement(kind, w)
        ):
            if self.router.has_measurement(kind, w):
                # Stale: serve on the stale table now, refresh off-thread.
                self._refresh_async(kind, w, run, q)
            else:
                try:
                    self.router.record_measurement(kind, w, self._warmup_measure(kind, w, run, q))
                except Exception as e:  # noqa: BLE001 - CPU keeps the JAX fallback
                    if q.device.type == "cuda":
                        raise
                    logger.debug("warmup measurement failed for %s: %s", kind.value, e)

        t0 = time.perf_counter()
        try:
            out, weights = run(kind, q)
            if out.device.type == "cuda":
                torch.cuda.synchronize(out.device)
        except Exception as e:  # noqa: BLE001 - the JAX engine's failure fallback
            self._failure_counts[kind.value] = self._failure_counts.get(kind.value, 0) + 1
            if q.device.type == "cuda":
                raise  # no hidden fallback on the card
            logger.warning("kernel %s failed (%s); falling back to fused", kind.value, e)
            kind = KernelKind.FUSED
            out, weights = run(kind, q)
        latency_ms = (time.perf_counter() - t0) * 1e3
        self.router.note_usage(kind, latency_ms)
        self._record_stats(kind, latency_ms, w)
        return out, weights

    def _refresh_async(self, kind: KernelKind, w, run, q) -> None:
        """Refresh a stale (kind, bucket) measurement on a worker thread; at
        most one per (kind, bucket) in flight. A failure there counts in
        the failure stats."""
        key = (kind, w.bucket())
        with self._lock:
            if key in self._refresh_inflight:
                return
            self._refresh_inflight.add(key)

        def worker() -> None:
            try:
                self.router.record_measurement(kind, w, measure_ms(lambda c: run(kind, c)[0], q))
            except Exception as e:  # noqa: BLE001 - a worker thread reports, never raises
                with self._lock:
                    self._failure_counts[kind.value] = self._failure_counts.get(kind.value, 0) + 1
                logger.warning("async refresh failed for %s: %s", kind.value, e)
            finally:
                with self._lock:
                    self._refresh_inflight.discard(key)

        threading.Thread(target=worker, name=f"pfa-refresh-{kind.value}", daemon=True).start()

    def _warmup_measure(self, kind: KernelKind, w, run, q) -> float:
        """First-contact measurement; for a plain flash bucket without a
        tile profile, the profile of K1's tiles is recorded too."""
        ms = measure_ms(lambda c: run(kind, c)[0], q)
        cfg = get_config()
        if kind == KernelKind.FLASH and cfg.auto_block_tuning and w.mask_kind == "none":
            key = Autotuner.profile_key(w.q_len, w.kv_len, w.head_dim, w.batch_size, w.num_heads)
            if self.autotuner.lookup(key) is None:
                bq, bkv = candidate_blocks(w.q_len, w.kv_len, w.head_dim)[0]
                self.autotuner.record(key, TuneResult(bq, bkv, ms))
        return ms

    # -- stats --------------------------------------------------------------------

    #: Kind -> effective matmul dtype of the energy model: "int8qk"/"fp8qk"
    #: are the QK-only blends (score matmul quantized, P.V bf16), "int8"
    #: the fully quantized kind (JAX ``_ENERGY_DTYPE``).
    _ENERGY_DTYPE = {
        "flash_int8qk": "int8qk",
        "flash_int8full": "int8",
        "flash_fp8": "fp8",
        "flash_fp8qk": "fp8qk",
    }

    #: Kind -> HBM bytes per element of (q, k, v, o) (JAX
    #: ``_ENERGY_OPERAND_BYTES``): the QK-only kinds keep V and O in bf16.
    _ENERGY_OPERAND_BYTES = {
        "flash_int8qk": (1, 1, 2, 2),
        "flash_fp8qk": (1, 1, 2, 2),
        "flash_fp8": (1, 1, 1, 2),
        "flash_int8full": (1, 1, 1, 2),
    }

    def _estimate_energy_mj(
        self, kind: KernelKind, latency_ms: float, w: Optional[WorkloadCharacteristics]
    ) -> Optional[float]:
        """Roofline energy of one call (mJ): flops x e_flop + HBM bytes x
        e_byte + static power x latency (``kernel_energy_mj``), so a kind
        that moves fewer bytes or does cheaper FLOPs ranks below an equally
        fast one. Without a workload or a device record: latency x the
        card's power limit, None without a card."""
        caps = self.energy_caps
        if w is None or caps is None:
            return latency_ms * self.board_power_w if self.board_power_w else None
        dtype = self._ENERGY_DTYPE.get(kind.value, "bf16")
        if w.is_decode:
            cost = attention_decode_cost(w.batch_size, w.kv_len, w.num_heads,
                                         w.num_kv_heads or w.num_heads, w.head_dim, caps=caps)
        else:
            cost = attention_prefill_cost(
                w.batch_size, w.q_len, w.kv_len, w.num_heads, w.head_dim, causal=w.causal,
                dtype=dtype if dtype in ("bf16", "int8", "fp8") else "bf16", caps=caps,
            )
            ob = self._ENERGY_OPERAND_BYTES.get(kind.value)
            if ob is not None:
                # Mixed-precision traffic, with the KV head count for k and v.
                qb, kb, vb, o_b = ob
                hkv = w.num_kv_heads or w.num_heads
                cost.hbm_bytes = w.batch_size * w.head_dim * (
                    w.num_heads * w.q_len * (qb + o_b) + hkv * w.kv_len * (kb + vb)
                )
        if kind == KernelKind.FUSED:
            # FUSED writes the (B, H, Sq, Skv) fp32 scores to HBM and reads
            # them back through the softmax.
            cost.hbm_bytes += 4.0 * w.batch_size * w.num_heads * w.q_len * w.kv_len * 2
        return kernel_energy_mj(cost, latency_ms, dtype=dtype)

    def _record_stats(self, kind: KernelKind, latency_ms: float,
                      w: WorkloadCharacteristics) -> None:
        self._total_calls += 1
        self.last_kernel_used = kind.value
        self.last_latency_ms = latency_ms
        self.last_energy_mj = self._estimate_energy_mj(kind, latency_ms, w)
        self._metrics.record(f"attention.{kind.value}.latency_ms", latency_ms)
        if self.last_energy_mj is not None:
            self._metrics.record(f"attention.{kind.value}.energy_mj", self.last_energy_mj)

    def get_performance_stats(self) -> Dict:
        return {
            "total_calls": self._total_calls,
            "last_kernel_used": self.last_kernel_used,
            "last_latency_ms": self.last_latency_ms,
            "last_energy_mj": self.last_energy_mj,
            "board_power_w": self.board_power_w,
            "failures": dict(self._failure_counts),
            "router": self.router.get_stats(),
            "autotuner": self.autotuner.stats(),
            "metrics": {
                k: v for k, v in self._metrics.snapshot().items() if k.startswith("attention.")
            },
        }

    def reset_stats(self) -> None:
        self._total_calls = 0
        self._failure_counts.clear()
        self.router.reset()


_engine: Optional[AttentionEngine] = None
_engine_lock = threading.Lock()


def get_engine() -> AttentionEngine:
    """The process-wide engine, created at first use."""
    global _engine
    if _engine is None:
        with _engine_lock:
            if _engine is None:
                _engine = AttentionEngine()
    return _engine


def reset_engine() -> None:
    global _engine
    with _engine_lock:
        _engine = None
