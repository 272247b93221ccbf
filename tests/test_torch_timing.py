"""The two-point fit of ``core/timing.py::fit_seconds`` on the CPU.

The clock that the module reads (``timing.perf_counter``) is replaced by a
scripted one: each timed window of n calls lasts the next duration of a
script, whatever n is. So the tests decide which of t(lo) and t(hi) is
larger, as a loaded host does, and check that the fit widens ``hi`` until
t(hi) > t(lo), or raises at its cap; it never returns a time <= 0.
"""

import pytest
import torch

from photonic_flash_attention_tpu_torch.core import timing

CPU = torch.device("cpu")


class ScriptedClock:
    """A clock read twice a window (start, end): the window lasts the next
    duration of ``durations``; the last one repeats."""

    def __init__(self, durations):
        self.durations = list(durations)
        self.now = 0.0
        self.reads = 0
        self.windows = 0

    def __call__(self) -> float:
        self.reads += 1
        if self.reads % 2 == 0:  # the end of a window
            i = min(self.windows, len(self.durations) - 1)
            self.now += self.durations[i]
            self.windows += 1
        return self.now


def _fit(monkeypatch, durations, fit):
    clock = ScriptedClock(durations)
    monkeypatch.setattr(timing, "perf_counter", clock)
    calls = []
    return clock, calls, lambda: timing.fit_seconds(lambda: calls.append(1), fit, CPU)


def test_fit_widens_hi_until_the_slope_is_positive(monkeypatch):
    # t(lo) = best of three 5 s windows; t(hi) and t(2 hi) come out at 1 s
    # (below t(lo)), t(4 hi) at 9 s.
    clock, calls, run = _fit(monkeypatch, [5, 5, 5, 1, 1, 1, 1, 1, 1, 9, 9, 9], (1, 2))
    t = run()
    assert t == pytest.approx((9 - 5) / (8 - 1))
    assert t > 0
    assert clock.windows == 12
    # One warm-up call a run, then three windows of n calls: n = 1, 2, 4, 8.
    assert len(calls) == sum(1 + 3 * n for n in (1, 2, 4, 8))


def test_fit_is_taken_at_once_when_the_first_window_resolves(monkeypatch):
    clock, calls, run = _fit(monkeypatch, [2, 3, 4, 7, 6, 8], (2, 10))
    assert run() == pytest.approx((6 - 2) / (10 - 2))
    assert clock.windows == 6


def test_fit_raises_when_widening_to_its_cap_does_not_resolve(monkeypatch):
    clock, calls, run = _fit(monkeypatch, [5, 5, 5, 4], (1, 2))
    with pytest.raises(RuntimeError, match=r"t\(32\) = 4 s does not exceed t\(1\) = 5 s"):
        run()
    # hi = 2, 4, 8, 16, 32 (16 x the fit's 2): five windows of three after t(lo).
    assert clock.windows == 3 + 5 * 3
    assert timing.MAX_WIDEN == 16


def test_equal_times_are_not_a_fit(monkeypatch):
    clock, calls, run = _fit(monkeypatch, [3], (1, 2))
    with pytest.raises(RuntimeError, match="does not exceed"):
        run()


@pytest.mark.parametrize("fit", [(0, 2), (2, 2), (3, 1)])
def test_fit_counts_must_be_ordered(fit):
    with pytest.raises(ValueError, match="0 < lo < hi"):
        timing.fit_seconds(lambda: None, fit, CPU)


def test_fit_on_real_work_is_positive():
    x = torch.ones(32, 32)
    assert timing.fit_seconds(lambda: x @ x, (1, 4), CPU) > 0
