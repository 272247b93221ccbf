"""Kernel timing for the measured router.

Port of ``photonic_flash_attention_tpu/core/timing.py::measure_ms``. On a
CUDA device each launch is bracketed by CUDA events on the current stream
and the median of the per-launch times is returned; on the CPU the same
with ``time.perf_counter``. The JAX module differences two chained
``fori_loop`` runs through a linear fit because a remote TPU's ~24 ms
dispatch round trip swamps a single call; a local card's events time the
device work itself, so the fit has no reason to exist here.

The device probes (``ops/hbm_bw.py``, ``ops/device_probes.py``) measure a
rate, not one call: :func:`fit_seconds` keeps JAX's two-point fit over n
back-to-back calls, which on the card are captured in one CUDA graph and
replayed between CUDA events (:func:`graph_ms`), so no host time sits
between the launches and the graph's own launch cost cancels in the fit.
Where t(hi) does not exceed t(lo) (a loaded host, a window too short for
its clock), the fit widens ``hi`` as JAX's ``measure_ms`` widens its
window, and raises if that does not help: it never returns a time <= 0.
"""

from __future__ import annotations

import statistics
from time import perf_counter
from typing import Callable, Optional, Tuple

import torch


def default_iters(device: Optional[torch.device] = None) -> Tuple[int, int, int]:
    """(iters_lo, iters_hi, repeats) of a two-point fit, by device type
    where JAX asks ``jax.default_backend()``: on the card the fit's counts
    (2, 10) and five replays (``graph_ms``'s median); elsewhere JAX's CPU
    triple, which only exercises the plumbing. ``device`` defaults to the
    current CUDA device, or the CPU without one."""
    if device is None:
        device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    if torch.device(device).type == "cuda":
        return 2, 10, 5
    return 1, 3, 1


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
            t0 = perf_counter()
            step_fn(x0)
            times.append((perf_counter() - t0) * 1e3)
    return max(statistics.median(times), 1e-4)


def graph_ms(fn: Callable[[], object], runs: int = 20, replays: int = 5) -> float:
    """Device milliseconds of one ``fn()`` on the card: ``runs`` calls
    captured in one CUDA graph, the median over ``replays`` replays (CUDA
    events around each) divided by ``runs``. No host work sits between the
    launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(runs):
            fn()
    graph.replay()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / runs)
    del graph
    return statistics.median(times)


#: How far :func:`fit_seconds` widens its window: ``hi`` doubles up to this
#: many times the caller's ``hi``.
MAX_WIDEN = 16


def fit_seconds(fn: Callable[[], object], fit: Tuple[int, int], device: torch.device) -> float:
    """Seconds of one ``fn()`` by JAX's two-point fit: (t(hi) - t(lo)) /
    (hi - lo), t(n) the time of n back-to-back calls. On the card t(n) is
    one replay of a CUDA graph of n calls (:func:`graph_ms`); on the CPU
    the best of three wall-clock runs after one warm-up call.

    While t(hi) <= t(lo), ``hi`` doubles and t(hi) is taken again, up to
    :data:`MAX_WIDEN` times the given ``hi``; if the fit is still not
    positive there, ``RuntimeError`` names both times."""
    lo, hi = fit
    if not 0 < lo < hi:
        raise ValueError(f"fit must be two counts 0 < lo < hi, got {fit}")
    if device.type == "cuda":
        def run(n: int) -> float:
            return n * graph_ms(fn, n) * 1e-3
    else:
        def run(n: int) -> float:
            fn()
            best = float("inf")
            for _ in range(3):
                t0 = perf_counter()
                for _ in range(n):
                    fn()
                best = min(best, perf_counter() - t0)
            return best

    t_lo = run(lo)
    cap = MAX_WIDEN * hi
    while True:
        t_hi = run(hi)
        if t_hi > t_lo:
            return (t_hi - t_lo) / (hi - lo)
        if 2 * hi > cap:
            raise RuntimeError(
                f"fit_seconds on {device.type}: t({hi}) = {t_hi:.6g} s does not exceed "
                f"t({lo}) = {t_lo:.6g} s, with hi widened to {MAX_WIDEN} x the fit {fit}"
            )
        hi *= 2
