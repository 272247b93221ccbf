"""The port's request schedulers (native C++ and Python) against JAX's.

The cases of ``tests/unit/test_native_sched.py`` run on both of the port's
schedulers, except that ``pop`` of a request behind the head succeeds: the
port's copy of ``native/request_scheduler.cpp`` removes it wherever it sits
(the JAX schedulers pop only a head, so best-fit admission admits a request
twice there). Seeded operation sequences that pop only heads must give
JAX's ``PyRequestScheduler``'s answers; a best-fit engine on the native
scheduler admits each request once.
"""

import re

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from photonic_flash_attention_tpu.core.native_sched import (
    PyRequestScheduler as JaxPyRequestScheduler,
)
from photonic_flash_attention_tpu_torch.core import native_sched
from photonic_flash_attention_tpu_torch.core.native_sched import (
    NativeRequestScheduler,
    PyRequestScheduler,
    make_scheduler,
)
from photonic_flash_attention_tpu_torch.core.serving import ServingEngine
from photonic_flash_attention_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from photonic_flash_attention_tpu_torch.ops import _build

IMPLS = [PyRequestScheduler, NativeRequestScheduler]


@pytest.fixture(params=IMPLS, ids=lambda c: c.__name__)
def sched(request):
    return request.param()


# -- the cases of tests/unit/test_native_sched.py -----------------------------


def test_fifo_within_priority(sched):
    for sid in (1, 2, 3):
        sched.submit(sid, priority=0)
    assert sched.peek() == 1
    assert sched.pop(1)
    assert sched.peek() == 2


def test_priority_order(sched):
    sched.submit(1, priority=0)
    sched.submit(2, priority=5)
    sched.submit(3, priority=5)
    assert sched.peek() == 2  # highest priority, FIFO within
    sched.pop(2)
    assert sched.peek() == 3
    sched.pop(3)
    assert sched.peek() == 1


def test_pop_behind_the_head_admits_it_once(sched):
    """JAX's ``test_pop_non_head_fails`` with the port's contract: the
    request behind the head leaves the queue; a second pop finds nothing."""
    sched.submit(1)
    sched.submit(2, priority=0)
    sched.submit(3, priority=4)
    assert sched.pop(2)
    assert not sched.pop(2)
    assert sched.waiting_ids() == [3, 1]
    assert sched.pop(1) and sched.peek() == 3
    assert sched.stats()["admitted"] == 2 and len(sched) == 1


def test_cancel(sched):
    sched.submit(1)
    sched.submit(2)
    assert sched.cancel(1)
    assert not sched.cancel(99)
    assert sched.peek() == 2
    assert len(sched) == 1


def test_waiting_ids_order(sched):
    sched.submit(10, priority=1)
    sched.submit(11, priority=0)
    sched.submit(12, priority=1)
    assert sched.waiting_ids() == [10, 12, 11]


def test_stats(sched):
    sched.submit(1)
    sched.submit(2)
    sched.pop(1)
    sched.cancel(2)
    st_ = sched.stats()
    assert st_["waiting"] == 0
    assert st_["admitted"] == 1
    assert st_["cancelled"] == 1
    assert st_["wait_p50_us"] >= 0
    assert st_["wait_max_us"] >= st_["wait_p50_us"]


def test_empty(sched):
    assert sched.peek() is None
    assert len(sched) == 0
    assert sched.stats()["waiting"] == 0


def test_native_builds_into_the_ports_build_dir():
    path = native_sched.library_path()
    assert path.parent == _build.BUILD_DIR and path.exists()
    assert re.fullmatch(r"libpfa_sched_[0-9a-f]{16}\.so", path.name)
    assert native_sched.native_available()
    assert isinstance(make_scheduler(), NativeRequestScheduler)


# -- op for op against JAX's Python scheduler (head pops only) -----------------

OPS = st.lists(
    st.one_of(
        st.tuples(st.just("submit"), st.integers(0, 3)),
        st.tuples(st.just("pop_head")),
        st.tuples(st.just("cancel"), st.integers(0, 30)),
    ),
    max_size=40,
)


def _run(sched, ops):
    trace, next_sid = [], 0
    for op in ops:
        if op[0] == "submit":
            sched.submit(next_sid, op[1])
            next_sid += 1
        elif op[0] == "pop_head":
            head = sched.peek()
            trace.append(("pop", head, head is not None and sched.pop(head)))
        else:
            trace.append(("cancel", sched.cancel(op[1])))
        st_ = sched.stats()
        trace.append((sched.peek(), len(sched), sched.waiting_ids(), st_["waiting"],
                      st_["admitted"], st_["cancelled"]))
    return trace


@settings(max_examples=60, deadline=None, derandomize=True, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(ops=OPS)
def test_schedulers_equal_jax_op_for_op(ops):
    want = _run(JaxPyRequestScheduler(), ops)
    for impl in IMPLS:
        assert _run(impl(), ops) == want, impl.__name__


# -- best-fit admission on the native scheduler --------------------------------


def test_best_fit_engine_admits_each_request_once():
    cfg = GPT2Config.tiny()
    state = GPT2LMHead(cfg).state_dict()
    # 5 usable pages of 16 tokens, two slots. The long first request holds
    # 4 pages; when the short one beside it retires, the next 40-token
    # request (3 pages) does not fit and best fit admits from behind it.
    eng = ServingEngine(cfg, state, device="cpu", num_pages=6, page_size=16, max_batch=2,
                        admission="best-fit")
    assert eng.status()["scheduler"] == "NativeRequestScheduler"
    admitted = []
    pop = eng._sched.pop

    def recording_pop(sid):
        admitted.append(sid)
        return pop(sid)

    eng._sched.pop = recording_pop
    rng = np.random.default_rng(0)
    requests = [(40, 12), (3, 2), (40, 2), (5, 2), (2, 2), (40, 3)]
    sids = [eng.submit(rng.integers(1, 1024, n).tolist(), max_new_tokens=m)
            for n, m in requests]
    while not all(eng._sequences[s].done for s in sids):
        assert eng.step() > 0
    assert sorted(admitted) == sids  # each admitted once
    assert admitted[:3] == [0, 1, 3]  # the third from behind the head
    assert [eng._sequences[s].new_tokens for s in sids] == [m for _, m in requests]
    st_ = eng.status()
    assert st_["queue"]["admitted"] == len(sids) and st_["waiting"] == 0
    assert st_["pages_free"] == st_["pages_total"]
