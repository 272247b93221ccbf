"""Exp and softmax-stream probes (kernels K11 and K12) and the measured rates.

Port of ``photonic_flash_attention_tpu/ops/device_probes.py``. The
composite roofline (``hardware/roofline.py``) needs the card's measured
rate on each unit an attention kernel uses; these probes give the exp rate
and the rate of K1's online-softmax stream (on the H100, the SMs' MUFU and
FP32 pipes, where the TPU has its VPU):

* :func:`exp_probe`: ``iters`` chained x <- exp(-x) over an fp32 (rows,
  cols) array; returns rows 0-7. Kernel K11 (``csrc/probes.cu``, counted
  ``pfa_exp_probe``).
* :func:`softmax_block_probe`: ``iters`` chained online-softmax block
  updates over fp32 (rows, cols), cols % 128 == 0; returns rows 0-7.
  ``masked`` adds the TPU kernel's always-true mask select. Kernel K12
  (``pfa_softmax_probe``; cols up to 1024 on the card, a row held in the
  registers of 8 threads, K1's Hopper softmax step).
* :func:`measure_exp_rate`, :func:`measure_softmax_rate` (elements/s) and
  :func:`measure_softmax_linear` (JAX's keys: the fit t = a + b * elements
  of one block update), by the two-point fit of
  ``core/timing.py::fit_seconds``: on the card n launches replayed from one
  CUDA graph, on the CPU the plain versions by wall clock.

Shapes. JAX's measure functions take one TPU core's VMEM tile ((512, 512)
for exp, (128, 512) for the stream, which the 16 MB scoped-VMEM limit
caps). On the card 128 rows are 512 threads, about one warp on each of a
few SMs: a latency figure, not a rate. So with ``shape=None`` the card
takes rows that fill every SM at the kernel's occupancy (whole waves,
:func:`wave_rows`, asked of the CUDA occupancy API: one for K12,
:data:`EXP_WAVES` for K11), 512 columns as JAX's; the CPU takes JAX's
shapes. :data:`JAX_EXP_SHAPE`, :data:`JAX_SOFTMAX_SHAPE`
and :data:`JAX_LINEAR_SHAPES` are JAX's, for a caller that wants them.

CUDA tensors launch the kernels (or raise); CPU tensors take the plain
versions.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple, Union

import torch

from ..core.timing import fit_seconds
from . import _build
from .hbm_bw import SENTINEL

#: JAX's probe shapes (one TPU core's VMEM tile; see the module docstring).
JAX_EXP_SHAPE = (512, 512)
JAX_SOFTMAX_SHAPE = (128, 512)
#: JAX's two (rows, cols, iters) tile areas of measure_softmax_linear.
JAX_LINEAR_SHAPES = ((32, 512, 4096), (224, 896, 512))
#: The card's two areas: one wave of rows at 128 and at 512 columns (one
#: layout, eight threads a row, so the fixed cost per update is the same
#: code), iters
#: giving both the same elements per call.
CARD_LINEAR_COLS = ((128, 1024), (512, 256))
#: Waves of K11 in its card shape: one wave at 256 iterations is ~0.07 ms
#: (67 M exps per 132 SMs at 16 a clock), so four keep the gap between two
#: launches of a graph to under 1 % of a call.
EXP_WAVES = 4
#: The TPU probe's mask value, also the running max's start.
PROBE_MASK = -1e30
#: Widths K12 holds in registers.
SOFTMAX_COLS = tuple(range(128, 1025, 128))

Device = Union[str, torch.device]


def _check_fp32(x: torch.Tensor, name: str) -> None:
    if x.ndim != 2 or x.dtype != torch.float32:
        raise ValueError(f"{name} takes a (rows, cols) float32 array, got {tuple(x.shape)} {x.dtype}")
    if x.shape[0] < 8:
        raise ValueError(f"{name} returns 8 rows: it needs rows >= 8, got {x.shape[0]}")


def _check_cuda(x: torch.Tensor, name: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name} needs a contiguous, 16-byte aligned x")


def wave_rows(kernel: str, cols: int = 512, masked: bool = True,
              device: Device = "cuda") -> int:
    """Rows of ``cols`` fp32 values that one full wave of ``kernel``
    ("exp" = K11, "softmax" = K12) holds on the card: every SM at the
    kernel's occupancy, asked of the CUDA occupancy API."""
    which = {"exp": 0, "softmax": 1}[kernel]
    out = ctypes.c_int(0)
    with torch.cuda.device(torch.device(device)):
        err = _build.lib().pfa_probe_wave(which, cols, int(masked), ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"pfa_probe_wave: CUDA error {err}")
    return out.value // cols if which == 0 else out.value


# -- K11: exp ------------------------------------------------------------------


def exp_probe_plain(x: torch.Tensor, iters: int = 256) -> torch.Tensor:
    """K11's plain version: the torch.exp(-x) chain, rows 0-7."""
    y = x
    for _ in range(iters):
        y = torch.exp(-y)
    return y[:8].clone()


def exp_probe(x: torch.Tensor, iters: int = 256) -> torch.Tensor:
    """``iters`` chained exps over fp32 ``x``; returns an (8, cols) slice.
    Elements per call: x.numel() * iters."""
    _check_fp32(x, "exp_probe")
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    if x.device.type == "cpu":
        return exp_probe_plain(x, iters)
    _check_cuda(x, "K11 (exp_probe)")
    if x.shape[1] % 4:
        raise ValueError(f"K11 (exp_probe) takes cols % 4 == 0, got {x.shape[1]}")
    out = torch.empty((8, x.shape[1]), dtype=x.dtype, device=x.device)
    sink = torch.empty(1, dtype=torch.int32, device=x.device)
    _build.launch("pfa_exp_probe", x.device, x.data_ptr(), out.data_ptr(), sink.data_ptr(),
                  x.numel(), out.numel(), iters, SENTINEL)
    return out


# -- K12: the online-softmax stream --------------------------------------------


def softmax_block_probe_plain(x: torch.Tensor, iters: int = 64, masked: bool = True, *,
                              return_l: bool = False):
    """K12's plain version: the TPU kernel's block update, ``iters`` times,
    in fp32; rows 0-7 (and their running sums, with ``return_l``)."""
    rows, cols = x.shape
    buf = x
    m = torch.full((rows, 1), PROBE_MASK, dtype=torch.float32, device=x.device)
    l = torch.zeros((rows, 1), dtype=torch.float32, device=x.device)
    pos = torch.arange(cols, device=x.device)
    for i in range(iters):
        s = torch.where(pos <= i + cols, buf, PROBE_MASK) if masked else buf
        m_next = torch.maximum(m, s.amax(dim=1, keepdim=True))
        p = torch.exp(s - m_next)
        l = torch.exp(m - m_next) * l + p.sum(dim=1, keepdim=True)
        m = m_next
        buf = p.to(torch.bfloat16).float()
    return (buf[:8].clone(), l[:8, 0].clone()) if return_l else buf[:8].clone()


def softmax_block_probe(x: torch.Tensor, iters: int = 64, masked: bool = True, *,
                        return_l: bool = False):
    """``iters`` chained online-softmax block updates over fp32 ``x``
    ((rows, cols), cols % 128 == 0); returns an (8, cols) slice, and with
    ``return_l`` also the 8 rows' running sums l (which JAX's probe does not
    return). Score elements per call: x.numel() * iters. ``masked=False``
    drops the mask select, the stream an unmasked tile runs."""
    _check_fp32(x, "softmax_block_probe")
    if x.shape[1] % 128:
        raise ValueError(f"softmax_block_probe takes cols % 128 == 0, got {x.shape[1]}")
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    if x.device.type == "cpu":
        return softmax_block_probe_plain(x, iters, masked, return_l=return_l)
    _check_cuda(x, "K12 (softmax_block_probe)")
    rows, cols = x.shape
    if cols not in SOFTMAX_COLS:
        raise ValueError(f"K12 (softmax_block_probe) holds rows of at most "
                         f"{SOFTMAX_COLS[-1]} values on the card, got {cols}")
    out = torch.empty((8, cols), dtype=x.dtype, device=x.device)
    l = torch.empty(8, dtype=x.dtype, device=x.device)
    sink = torch.empty(1, dtype=torch.int32, device=x.device)
    _build.launch("pfa_softmax_probe", x.device, x.data_ptr(), out.data_ptr(), l.data_ptr(),
                  sink.data_ptr(), rows, cols, iters, cols, int(masked), SENTINEL,
                  count_as="pfa_softmax_probe" if masked else "pfa_softmax_probe_unmasked")
    return (out, l) if return_l else out


# -- measured rates --------------------------------------------------------------


def probe_input(rows: int, cols: int, device: Device) -> torch.Tensor:
    """JAX's probe input: linspace(0.1, 1.0) over the array."""
    return torch.linspace(0.1, 1.0, rows * cols, dtype=torch.float32,
                          device=device).reshape(rows, cols)


def _shape(shape: Optional[Tuple[int, int]], kernel: str, masked: bool, device: Device,
           jax_shape: Tuple[int, int]) -> Tuple[int, int]:
    if shape is not None:
        return tuple(shape)
    if torch.device(device).type == "cuda":
        waves = EXP_WAVES if kernel == "exp" else 1
        return (waves * wave_rows(kernel, 512, masked, device), 512)
    return jax_shape


def measure_exp_rate(*, iters: int = 256, fit: Tuple[int, int] = (20, 220),
                     shape: Optional[Tuple[int, int]] = None,
                     device: Device = "cuda") -> float:
    """Measured exp throughput (elements/s) of :func:`exp_probe` at
    ``shape`` (default: see the module docstring)."""
    rows, cols = _shape(shape, "exp", True, device, JAX_EXP_SHAPE)
    x = probe_input(rows, cols, device)
    t = fit_seconds(lambda: exp_probe(x, iters), fit, x.device)
    return rows * cols * iters / t


def measure_softmax_rate(*, iters: int = 512, fit: Tuple[int, int] = (20, 220),
                         masked: bool = True, shape: Optional[Tuple[int, int]] = None,
                         device: Device = "cuda") -> float:
    """Measured throughput (score elements/s) of the flash forward's
    softmax stream, :func:`softmax_block_probe`, at ``shape`` (default:
    see the module docstring)."""
    rows, cols = _shape(shape, "softmax", masked, device, JAX_SOFTMAX_SHAPE)
    x = probe_input(rows, cols, device)
    t = fit_seconds(lambda: softmax_block_probe(x, iters, masked), fit, x.device)
    return rows * cols * iters / t


def card_linear_shapes(device: Device = "cuda") -> Tuple[Tuple[int, int, int], ...]:
    """The card's (rows, cols, iters) pair for :func:`measure_softmax_linear`:
    one wave of K12's 512-column rows (the lower occupancy of the two), at
    each width of :data:`CARD_LINEAR_COLS`."""
    rows = wave_rows("softmax", 512, False, device)
    return tuple((rows, cols, iters) for cols, iters in CARD_LINEAR_COLS)


def measure_softmax_linear(*, fit: Tuple[int, int] = (30, 430),
                           shapes: Optional[Sequence[Tuple[int, int, int]]] = None,
                           device: Device = "cuda") -> dict:
    """Fit the cost of one unmasked block update, t = a + b * elements,
    from two (rows, cols, iters) areas (default: :func:`card_linear_shapes`
    on the card, :data:`JAX_LINEAR_SHAPES` on the CPU). On the card a is the
    fixed cost of one update of all the rows (the per-row statistics), b the
    cost of an element over the whole card; 1 / b is the asymptotic stream
    rate, the composite roofline's softmax term."""
    if shapes is None:
        shapes = (card_linear_shapes(device) if torch.device(device).type == "cuda"
                  else JAX_LINEAR_SHAPES)
    pts = []
    for rows, cols, iters in shapes:
        x = probe_input(rows, cols, device)
        t_call = fit_seconds(lambda: softmax_block_probe(x, iters, masked=False), fit, x.device)
        pts.append((rows * cols, t_call / iters))
    (e1, t1), (e2, t2) = pts
    b = (t2 - t1) / (e2 - e1)
    a = t1 - b * e1
    return {
        "fixed_s_per_tile": max(a, 0.0),
        "s_per_elem": max(b, 1e-15),
        "asymptotic_elems_per_s": 1.0 / max(b, 1e-15),
        "points": pts,
    }
