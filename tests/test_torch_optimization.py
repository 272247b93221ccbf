"""Port parity: ``optimization`` (caching, performance_optimizer).

The result caches, the multi-level cache and the profiler are copies: the
cases of ``tests/unit/test_optimization.py`` run on both packages and give
equal hit/miss/eviction statistics. ``_array_fingerprint`` of a torch
tensor equals JAX's fingerprint of the same numpy data for float32 and
integer dtypes (shape, dtype name and digest), and a bfloat16 tensor
hashes its raw 16-bit words, as a JAX bfloat16 array's ``tobytes`` does.
``CompileCacheManager`` manages the kernel build directory and counts its
libraries. ``AdaptiveOptimizer`` memoises and profiles as JAX's does.
"""

import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photonic_flash_attention_tpu.optimization import caching as jax_caching
from photonic_flash_attention_tpu.optimization import performance_optimizer as jax_perf
from photonic_flash_attention_tpu_torch.ops import _build
from photonic_flash_attention_tpu_torch.optimization import caching as port_caching
from photonic_flash_attention_tpu_torch.optimization import performance_optimizer as port_perf

PORT = types.SimpleNamespace(c=port_caching, p=port_perf, arr=torch.from_numpy,
                             total=lambda x: torch.sum(x))
JAX = types.SimpleNamespace(c=jax_caching, p=jax_perf, arr=jnp.asarray, total=jnp.sum)


def _both(scenario):
    port, ref = scenario(PORT), scenario(JAX)
    assert port == ref
    return port


@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.int8, np.uint8, np.bool_])
@pytest.mark.parametrize("shape", [(7,), (64,), (300,), (1000,), (33, 65), (2, 3, 4, 129)])
def test_fingerprint_equals_jax(rng, dtype, shape):
    x = (rng.standard_normal(shape) * 50).astype(dtype)
    assert port_caching._array_fingerprint(torch.from_numpy(x)) == \
        jax_caching._array_fingerprint(jnp.asarray(x))


def test_fingerprint_bfloat16_hashes_raw_words(rng):
    x = rng.standard_normal((513,)).astype(np.float32)
    t = torch.from_numpy(x).to(torch.bfloat16)
    j = jnp.asarray(x).astype(jnp.bfloat16)
    assert port_caching._array_fingerprint(t) == jax_caching._array_fingerprint(j)
    other = t.clone()
    other[0] = other[0] + 1
    assert port_caching._array_fingerprint(other) != port_caching._array_fingerprint(t)


def test_fingerprint_takes_a_strided_sample(rng):
    """Only the sampled elements count: a change off the sample keeps the
    key (as in JAX), a change on it moves it."""
    x = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
    base = port_caching._array_fingerprint(x)
    y = x.clone()
    y[1] += 1.0  # step 16: element 1 is not sampled
    assert port_caching._array_fingerprint(y) == base
    y[16] += 1.0
    assert port_caching._array_fingerprint(y) != base


def test_cache_key_matches_jax(rng):
    x = rng.standard_normal((8, 8)).astype(np.float32)
    port = port_caching.cache_key(torch.from_numpy(x), 3, "a", None, flag=True, scale=0.5)
    ref = jax_caching.cache_key(jnp.asarray(x), 3, "a", None, flag=True, scale=0.5)
    assert port == ref


def _lru(m):
    c = m.c.ResultCache(capacity=2, policy="lru")
    c.put("a", 1)
    c.put("b", 2)
    c.get("a")
    c.put("c", 3)
    return c.get("a"), c.get("b"), c.stats.as_dict()


def _lfu(m):
    c = m.c.ResultCache(capacity=2, policy="lfu")
    c.put("a", 1)
    c.put("b", 2)
    for _ in range(3):
        c.get("a")
    c.put("c", 3)
    return c.get("a"), c.get("b"), c.stats.as_dict()


def _fifo(m):
    c = m.c.ResultCache(capacity=2, policy="fifo")
    for k, v in (("a", 1), ("b", 2)):
        c.put(k, v)
    c.get("a")
    c.put("c", 3)
    return c.get("a"), c.get("b"), len(c), c.stats.as_dict()


def _ttl(m):
    c = m.c.ResultCache(capacity=8, ttl_s=0.05)
    c.put("a", 1)
    first = c.get("a")
    time.sleep(0.06)
    return first, c.get("a"), c.stats.expirations


def _cached_computation(m):
    calls = {"n": 0}

    @m.c.cached_computation()
    def f(x):
        calls["n"] += 1
        return float(m.total(x))

    rng = np.random.default_rng(3)
    a = m.arr(rng.standard_normal(64).astype(np.float32))
    b = m.arr(rng.standard_normal(64).astype(np.float32))
    outs = [f(a), f(a), f(b)]
    return [round(o, 4) for o in outs], calls["n"], f.cache.stats.hits


def _promotes(m):
    mgr = m.c.MultiLevelCacheManager()
    mgr.put("k", 42)
    before = (len(mgr.l1), len(mgr.l2))
    got = [mgr.get("k") for _ in range(3)]
    return before, got, (len(mgr.l1), len(mgr.l2))


def _demotes(m):
    mgr = m.c.MultiLevelCacheManager(l2_capacity=2)
    for k, v in (("a", 1), ("b", 2), ("c", 3)):
        mgr.put(k, v)
    return mgr.get("a"), len(mgr.l3) >= 1


def _compression(m):
    mgr = m.c.MultiLevelCacheManager(l2_capacity=1, compress_l3=True)
    payload = {"big": list(range(1000))}
    mgr.put("x", payload)
    mgr.put("y", 0)
    return mgr.get("x") == payload


def _stats(m):
    mgr = m.c.MultiLevelCacheManager()
    miss = mgr.get("nope", "default")
    mgr.put("k", 1)
    mgr.get("k")
    return miss, mgr.get_stats()


CACHE_CASES = {
    "lru_eviction": (_lru, lambda o: o[:2] == (1, None) and o[2]["evictions"] == 1),
    "lfu_eviction": (_lfu, lambda o: o[:2] == (1, None)),
    "fifo_eviction": (_fifo, lambda o: o[:3] == (None, 2, 2)),
    "ttl_expiry": (_ttl, lambda o: o == (1, None, 1)),
    "cached_computation_distinguishes_data": (_cached_computation,
                                              lambda o: o[1] == 2 and o[2] == 1),
    "entry_starts_in_l2_and_promotes": (_promotes, lambda o: o == ((0, 1), [42] * 3, (1, 0))),
    "l2_eviction_demotes_to_l3": (_demotes, lambda o: o == (1, True)),
    "l3_compression_roundtrip": (_compression, lambda o: o is True),
    "miss_and_stats": (_stats, lambda o: o[0] == "default" and o[1]["overall"]["hits"] == 1),
}


@pytest.mark.parametrize("case", list(CACHE_CASES))
def test_cache_case_matches_jax(case):
    scenario, check = CACHE_CASES[case]
    assert check(_both(scenario))


def test_bad_policy_rejected():
    for m in (PORT, JAX):
        with pytest.raises(ValueError):
            m.c.ResultCache(policy="magic")


def test_compile_cache_manager_is_the_build_directory(tmp_path):
    m = port_caching.CompileCacheManager()
    assert m.cache_dir == str(_build.BUILD_DIR)
    d = tmp_path / "build"
    m = port_caching.CompileCacheManager(cache_dir=str(d))
    assert not m.enabled and m.stats()["entries"] == 0
    m.enable()
    (d / "libpfa_kernels_0123456789abcdef.so").write_bytes(b"x" * 10)
    (d / "libpfa_alloc_0123456789abcdef.so").write_bytes(b"y" * 5)
    (d / "kernels.o").write_bytes(b"z")  # an object file is no library
    assert m.stats() == {"enabled": True, "dir": str(d), "entries": 2, "bytes": 15}


def _profile(m):
    p = m.p.WorkloadProfiler()
    pid = p.start_profiling("attn", batch_size=4)
    time.sleep(0.01)
    rec = p.end_profiling(pid)
    return rec.duration_ms >= 10, p.summary()["operations"]["attn"]["count"]


#: (batch size, calls, training, start times): streaming is decided by the
#: gaps between starts, so they are set, not read from the clock.
CLASSIFY_RUNS = (
    (16, 5, False, None),
    (1, 12, False, [100.0 + i for i in range(12)]),  # steady arrivals: streaming
    (1, 12, False, [100.0 + i for i in range(11)] + [140.0]),  # one long pause: inference
    (4, 3, True, None),
    (4, 3, False, None),
)


def _classify(m):
    out = []
    for batch, n, training, starts in CLASSIFY_RUNS:
        p = m.p.WorkloadProfiler()
        for _ in range(n):
            pid = p.start_profiling("x", batch_size=batch, training=training)
            p.end_profiling(pid)
        if starts is not None:
            for rec, t in zip(p._completed, starts):
                rec.started_at = t
        out.append(p.classify_workload())
    return out


def _memoizes(m):
    opt = m.p.AdaptiveOptimizer()
    calls = {"n": 0}

    def fn(x):
        calls["n"] += 1
        return m.total(x)

    x = m.arr(np.random.default_rng(5).standard_normal(32).astype(np.float32))
    a = opt.optimize_operation(fn, x, operation="sum", cacheable=True)
    b = opt.optimize_operation(fn, x, operation="sum", cacheable=True)
    opt.optimize_operation(fn, x, operation="sum")
    stats = opt.get_stats()
    return (calls["n"], float(a) == float(b), stats["cache"]["hits"],
            stats["profiler"]["operations"]["sum"]["count"])


PROFILER_CASES = {
    "profile_and_summary": (_profile, lambda o: o == (True, 1)),
    "classification": (_classify, lambda o: o == ["batch", "streaming", "inference", "training",
                                                  "inference"]),
    "adaptive_optimizer_memoizes": (_memoizes, lambda o: o == (2, True, 1, 2)),
}


@pytest.mark.parametrize("case", list(PROFILER_CASES))
def test_profiler_case_matches_jax(case):
    scenario, check = PROFILER_CASES[case]
    assert check(_both(scenario))


def test_optimized_decorator_and_singleton():
    opt = port_perf.AdaptiveOptimizer()

    @opt.optimized(operation="double", cacheable=True)
    def double(x):
        return x * 2

    x = torch.arange(4.0)
    assert torch.equal(double(x), x * 2) and torch.equal(double(x), x * 2)
    assert opt.get_stats()["cache"]["hits"] == 1
    assert port_perf.get_performance_optimizer() is port_perf.get_performance_optimizer()


def test_block_until_ready_walks_outputs():
    """CPU tensors, nests and non-tensors pass through the wait."""
    port_perf._block_until_ready((torch.ones(2), [torch.zeros(1), {"a": torch.ones(1)}], 3, None))
