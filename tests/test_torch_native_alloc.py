"""The port's native (C++) page allocator against the Python allocators.

The cases of ``tests/unit/test_native_alloc.py`` run on the port's
``NativePageAllocator`` (its own copy of ``native/page_allocator.cpp``,
built with g++ into the port's ``_build/``); seeded operation sequences
(hypothesis, derandomised) must hand out the same page ids, in the same
order, and fail at the same operations as the port's ``_PyPageAllocator``
and the JAX package's.
"""

import re
import threading

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from photonic_flash_attention_tpu.core.serving import _PyPageAllocator as JaxPyAllocator
from photonic_flash_attention_tpu.utils.exceptions import KVCacheError as JaxKVCacheError
from photonic_flash_attention_tpu_torch.core import native_alloc
from photonic_flash_attention_tpu_torch.core.native_alloc import NativePageAllocator
from photonic_flash_attention_tpu_torch.core.serving import _PyPageAllocator, _make_allocator
from photonic_flash_attention_tpu_torch.ops import _build
from photonic_flash_attention_tpu_torch.utils.exceptions import KVCacheError

PAGE = 16


def make(num_pages=16, page_size=PAGE, max_pages=8):
    return NativePageAllocator(num_pages, page_size, max_pages)


# -- the cases of tests/unit/test_native_alloc.py -----------------------------


def test_trash_page_reserved():
    a = make(num_pages=4)
    s = a.allocate_sequence(3 * PAGE)  # 3 pages from a pool of 4-1
    assert 0 not in a.page_ids(s)
    assert a.stats()["pages_used"] == 3


def test_alloc_extend_free_cycle():
    a = make()
    s = a.allocate_sequence(20)  # 2 pages
    assert len(a.page_ids(s)) == 2
    a.extend(s, 40)  # 3 pages total
    assert len(a.page_ids(s)) == 3
    a.set_length(s, 33)
    assert a.length(s) == 33
    a.free_sequence(s)
    st_ = a.stats()
    assert st_["pages_used"] == 0
    assert st_["free_count"] == 3


def test_oom():
    a = make(num_pages=3)  # 2 usable (page 0 trash)
    a.allocate_sequence(2 * PAGE)
    with pytest.raises(KVCacheError, match="out of pages"):
        a.allocate_sequence(PAGE)
    assert a.stats()["oom_events"] == 1


def test_per_seq_cap():
    a = make(num_pages=64, max_pages=2)
    with pytest.raises(KVCacheError, match="max_pages_per_seq"):
        a.allocate_sequence(3 * PAGE)


def test_unknown_sequence():
    a = make()
    for call in (lambda: a.free_sequence(99), lambda: a.page_ids(99), lambda: a.extend(99, 1),
                 lambda: a.length(99), lambda: a.set_length(99, 1)):
        with pytest.raises(KVCacheError, match="unknown sequence"):
            call()


def test_pages_exclusive_across_sequences():
    a = make(num_pages=32)
    s1 = a.allocate_sequence(4 * PAGE)
    s2 = a.allocate_sequence(4 * PAGE)
    assert not set(a.page_ids(s1)) & set(a.page_ids(s2))


def test_recycling_reuses_pages():
    a = make(num_pages=4)
    s1 = a.allocate_sequence(3 * PAGE)
    pages1 = set(a.page_ids(s1))
    a.free_sequence(s1)
    s2 = a.allocate_sequence(3 * PAGE)
    assert set(a.page_ids(s2)) == pages1


def test_thread_safety():
    a = make(num_pages=256, max_pages=4)
    errors = []

    def worker():
        try:
            for _ in range(50):
                s = a.allocate_sequence(2 * PAGE)
                a.extend(s, 3 * PAGE)
                a.free_sequence(s)
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert a.stats()["pages_used"] == 0


# -- the library and the engine ----------------------------------------------


def test_library_lands_in_the_ports_build_dir():
    path = native_alloc.library_path()
    assert path.parent == _build.BUILD_DIR and path.exists()
    assert re.fullmatch(r"libpfa_alloc_[0-9a-f]{16}\.so", path.name)
    assert native_alloc.SOURCE.parent.parent == _build.BUILD_DIR.parent
    assert native_alloc.native_available()


def test_engine_prefers_the_native_allocator():
    assert isinstance(_make_allocator(8, PAGE, 4), NativePageAllocator)


# -- op for op against the Python allocators -----------------------------------

#: An operation: ("alloc", tokens), ("extend", which live sequence, tokens)
#: or ("free", which live sequence).
OPS = st.lists(
    st.one_of(
        st.tuples(st.just("alloc"), st.integers(0, 6 * PAGE)),
        st.tuples(st.just("extend"), st.integers(0, 7), st.integers(0, 9 * PAGE)),
        st.tuples(st.just("free"), st.integers(0, 7)),
    ),
    max_size=40,
)


def _run(alloc, ops):
    """Apply ``ops``; the trace of page ids, errors and free counts."""
    live, trace = [], []
    for op in ops:
        try:
            if op[0] == "alloc":
                sid = alloc.allocate_sequence(op[1])
                live.append(sid)
                trace.append(("alloc", alloc.page_ids(sid)))
            elif not live:
                continue
            elif op[0] == "extend":
                sid = live[op[1] % len(live)]
                alloc.extend(sid, op[2])
                trace.append(("extend", alloc.page_ids(sid)))
            else:
                sid = live.pop(op[1] % len(live))
                alloc.free_sequence(sid)
                trace.append(("free", sid))
        except (KVCacheError, JaxKVCacheError) as e:
            trace.append(("error", str(e)))
        trace.append(alloc.stats()["pages_free"])
    return trace


@settings(max_examples=60, deadline=None, derandomize=True, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(ops=OPS, num_pages=st.integers(2, 24), max_pages=st.integers(1, 8))
def test_native_equals_python_allocators_op_for_op(ops, num_pages, max_pages):
    want = _run(JaxPyAllocator(num_pages, PAGE, max_pages), ops)
    assert _run(_PyPageAllocator(num_pages, PAGE, max_pages), ops) == want
    assert _run(NativePageAllocator(num_pages, PAGE, max_pages), ops) == want
