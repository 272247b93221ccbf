"""Kernel timing for the measured router.

Port of ``photonic_flash_attention_tpu/core/timing.py::measure_ms``. On a
CUDA device each launch is bracketed by CUDA events on the current stream
and the median of the per-launch times is returned; on the CPU the same
with ``time.perf_counter``. The JAX module differences two chained
``fori_loop`` runs through a linear fit because a remote TPU's ~24 ms
dispatch round trip swamps a single call; a local card's events time the
device work itself, so the fit has no reason to exist here.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable, Optional, Tuple

import torch


def default_runs(device: torch.device) -> Tuple[int, int]:
    """(warm-up launches, timed launches): enough for a stable median on
    the card, minimal on the CPU, where the tests only exercise the
    plumbing."""
    return (2, 10) if device.type == "cuda" else (1, 3)


def measure_ms(
    step_fn: Callable[[torch.Tensor], torch.Tensor],
    x0: torch.Tensor,
    *,
    runs: Optional[int] = None,
    warmup: Optional[int] = None,
) -> float:
    """Median milliseconds of one ``step_fn(x0)`` call, floored at 1e-4."""
    w, r = default_runs(x0.device)
    warmup = w if warmup is None else warmup
    runs = r if runs is None else runs
    for _ in range(warmup):
        step_fn(x0)
    times = []
    if x0.device.type == "cuda":
        for _ in range(runs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            step_fn(x0)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
    else:
        for _ in range(runs):
            t0 = time.perf_counter()
            step_fn(x0)
            times.append((time.perf_counter() - t0) * 1e3)
    return max(statistics.median(times), 1e-4)
