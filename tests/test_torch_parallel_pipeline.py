"""The port's pipeline, meshes, merges, errors, engine kinds and telemetry
against the JAX package.

Multi-rank cases run in spawned gloo workers (``tests/_parallel_workers.py::
misc_cases``, one spawn a world size); the JAX side runs here on the first
``world`` of the 8 virtual CPU devices. The merges and the byte counts need
no process group and run here directly. Tolerances: ``assert_close`` (JAX's
tests' own), the merges 1e-6 (float32, the same formula).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photonic_flash_attention_tpu.ops.flash import (
    merge_partial_attention as jax_merge_partial,
)
from photonic_flash_attention_tpu.ops.reference import attention_reference as jax_reference
from photonic_flash_attention_tpu.parallel import telemetry as jax_telemetry
from photonic_flash_attention_tpu.parallel.mesh import create_mesh as jax_create_mesh
from photonic_flash_attention_tpu.parallel.pipeline import make_pipeline as jax_pipeline
from photonic_flash_attention_tpu.parallel.ring import softmax_merge as jax_softmax_merge
from photonic_flash_attention_tpu.parallel.ulysses import make_ulysses_attention as jax_ulysses
from photonic_flash_attention_tpu.utils.exceptions import DistributionError as JaxDistErr
from photonic_flash_attention_tpu_torch.ops.flash import merge_partial_attention
from photonic_flash_attention_tpu_torch.parallel import telemetry as port_telemetry
from photonic_flash_attention_tpu_torch.parallel.multihost import initialize_multihost
from photonic_flash_attention_tpu_torch.parallel.ring import softmax_merge
from photonic_flash_attention_tpu_torch.utils.exceptions import DistributionError

from ._parallel_workers import run_world
from .conftest import assert_close

WORLDS = (2, 4)
PIPELINES = {"m4": 4, "m1": 1}


def _inputs(world):
    rng = np.random.default_rng(2000 + world)
    f = 16
    pipes = {name: {"m": m, "x": rng.standard_normal((8, f)).astype(np.float32),
                    "w": (rng.standard_normal((world, f, f)) * 0.5).astype(np.float32),
                    "b": (rng.standard_normal((world, f)) * 0.1).astype(np.float32)}
             for name, m in PIPELINES.items()}
    s = 128 * world
    engine = {n: rng.standard_normal((1, s, 2 * world, 64)).astype(np.float32)
              for n in ("q", "k", "v")}
    return {"pipeline": pipes, "engine": engine}


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(tree) if isinstance(tree, np.ndarray) else tree


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = {}
    for world in WORLDS:
        inp = _inputs(world)
        out[world] = (inp, run_world(world, "misc_cases", _to_torch(inp),
                                     tmp_path_factory.mktemp(f"misc{world}")))
    return out


# -- pipeline -------------------------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", sorted(PIPELINES))
def test_pipeline_matches_jax(worlds, world, name):
    c = worlds[world][0]["pipeline"][name]
    mesh = jax_create_mesh((world,), ("stage",), jax.devices()[:world])
    pipe = jax_pipeline(mesh, lambda p, x: jnp.tanh(x @ p["w"] + p["b"]), num_microbatches=c["m"])
    want = pipe({"w": jnp.asarray(c["w"]), "b": jnp.asarray(c["b"])}, jnp.asarray(c["x"]))
    for rank in worlds[world][1]:  # replicated on every rank
        assert_close(rank[f"pipeline/{name}"].numpy(), want)


# -- DistributionError where JAX raises it -----------------------------------------


def _jax_raises(fn) -> str:
    try:
        fn()
    except JaxDistErr as e:
        return f"DistributionError: {e}"
    return ""


def _jax_error_cases(world):
    devs = jax.devices()[:world]
    stage = jax_create_mesh((world,), ("stage",), devs)
    seq = jax_create_mesh((world,), ("seq",), devs)
    pipe = jax_pipeline(stage, lambda p, x: x @ p, num_microbatches=3)
    w = jnp.zeros((world, 16, 16))
    q = jnp.zeros((1, 64 * world, 2 * world + 1, 16))
    kv = jnp.zeros((1, 64 * world, 1, 16))
    return {
        "pipeline_batch": lambda: pipe(w, jnp.zeros((4, 16))),
        "pipeline_stages": lambda: pipe(w[:1], jnp.zeros((3, 16))),
        "pipeline_axis": lambda: jax_pipeline(stage, lambda p, x: x, 2, stage_axis="nope"),
        "two_minus_one": lambda: jax_create_mesh((-1, -1), ("a", "b"), devs),
        "not_covering": lambda: jax_create_mesh((world + 1,), ("a",), devs),
        "rank_mismatch": lambda: jax_create_mesh((world, 1), ("a",), devs),
        "ulysses_heads": lambda: jax_ulysses(seq, data_axis=None)(q, q, q),
        "ulysses_kv_heads": lambda: jax_ulysses(seq, data_axis=None)(
            jnp.zeros((1, 64 * world, world, 16)), kv, kv),
        "ulysses_axis": lambda: jax_ulysses(stage),
    }


ERRORS = ("pipeline_batch", "pipeline_stages", "pipeline_axis", "two_minus_one",
          "not_covering", "rank_mismatch", "ulysses_heads", "ulysses_kv_heads", "ulysses_axis")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ERRORS)
def test_distribution_errors_match_jax(worlds, world, name):
    want = _jax_raises(_jax_error_cases(world)[name])
    got = worlds[world][1][0][f"errors/{name}"]
    assert want.startswith("DistributionError: ") and got.startswith("DistributionError: ")
    assert got == want


def test_initialize_without_cuda_raises():
    """No CUDA and no ``device="cpu"``: no fallback to gloo."""
    assert not torch.distributed.is_initialized()
    with pytest.raises(DistributionError, match="device='cpu'"):
        initialize_multihost()
    assert not torch.distributed.is_initialized()


# -- meshes and the multihost surface ---------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_and_multihost_surface(worlds, world):
    for rank, res in enumerate(worlds[world][1]):
        assert res["mesh/minus_one"] == {"data": world, "model": 1}
        assert res["mesh/default"] == {"data": world, "model": 1}
        assert res["mesh/index"] == rank
        assert res["mesh/pod"] == {"data": world}
        again = res["multihost/again"]
        assert again["process_index"] == rank and again["process_count"] == world
        assert again["global_devices"] == world and again["backend"] == "gloo"
        assert res["multihost/summary"]["local_devices"] == ["cpu"]


# -- the engine's sequence-parallel kinds ------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("kind", ["ring", "ulysses"])
def test_engine_routes_to_sequence_parallel_kinds(worlds, world, kind):
    """RING by the heuristic above ``ring_threshold``; ULYSSES by the
    measured table when it is the fastest (JAX's engine tests)."""
    c = worlds[world][0]["engine"]
    want, _ = jax_reference(*(jnp.asarray(c[n]) for n in ("q", "k", "v")), causal=True)
    used, got = worlds[world][1][0][f"engine/{kind}"]
    assert used == kind
    assert_close(got.numpy(), want, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("world", WORLDS)
def test_engine_mesh_registry(worlds, world):
    res = worlds[world][1][0]
    assert {"ring", "ulysses"} <= set(res["engine/kinds"])
    assert res["engine/cache_after_set_mesh"] == 0
    assert not {"ring", "ulysses"} & set(res["engine/kinds_cleared"])


# -- telemetry ------------------------------------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
def test_telemetry_counts_match_jax(worlds, world):
    """The engine's one RING and one ULYSSES call recorded JAX's analytic
    bytes: n - 1 ring steps of both K and V shards, four all-to-alls."""
    q = worlds[world][0]["engine"]["q"]
    n = world
    shard = q.size // n * 4
    ring = (n - 1) * jax_telemetry.collective_bytes("ppermute", 2 * shard, n)
    uly = 4 * jax_telemetry.collective_bytes("all_to_all", shard * (n - 1) // n, n)
    stats = worlds[world][1][0]["telemetry"]
    assert stats["axes"]["seq"]["by_op"] == {"ppermute": ring, "all_to_all": uly}
    assert stats["axes"]["seq"]["ops"] == (n - 1) + 4
    assert stats["link_gbps"] == 450.0  # the H100's NVLink each way (data sheet)


@pytest.mark.parametrize("op", ["ppermute", "all_gather", "psum", "reduce_scatter",
                                "all_to_all", "other"])
@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_collective_bytes_match_jax(op, n):
    for shard in (0, 7, 4096, 1 << 20):
        assert port_telemetry.collective_bytes(op, shard, n) == \
            jax_telemetry.collective_bytes(op, shard, n)


def test_telemetry_window_matches_jax():
    port = port_telemetry.CollectiveTelemetry(link_gbps=100.0)
    ref = jax_telemetry.CollectiveTelemetry(ici_gbps=100.0)
    for t in (port, ref):
        t.record("seq", "ppermute", 1 << 20, 4)
        t.record("seq", "psum", 1 << 22, 4)
        t.record("model", "all_to_all", 12345, 2)
    a, b = port.get_stats()["axes"], ref.get_stats()["axes"]
    assert {k: (v["bytes_total"], v["ops"], v["by_op"]) for k, v in a.items()} == \
        {k: (v["bytes_total"], v["ops"], v["by_op"]) for k, v in b.items()}


# -- the lse merges ---------------------------------------------------------------------------


def _partials(seed):
    rng = np.random.default_rng(seed)
    b, s, h, d = 2, 48, 3, 16
    o1, o2 = (rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(2))
    l1, l2 = (rng.normal(0.0, 3.0, (b, h, s)).astype(np.float32) for _ in range(2))
    l1[0, 0, :8] = -np.inf  # one side wholly masked
    o1[0, :8, 0] = 0.0
    l2[0, 1, 8:16] = -np.inf  # the other side
    o2[0, 8:16, 1] = 0.0
    l1[1, 2, 16:24] = l2[1, 2, 16:24] = -np.inf  # both
    o1[1, 16:24, 2] = o2[1, 16:24, 2] = 0.0
    return o1, l1, o2, l2


def _check(got, want):
    o, lse = got
    assert_close(o.numpy(), want[0], rtol=1e-6, atol=1e-6)
    want_lse = np.asarray(want[1])
    assert np.array_equal(np.isneginf(lse.numpy()), np.isneginf(want_lse))
    fin = np.isfinite(want_lse)
    assert_close(lse.numpy()[fin], want_lse[fin], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_softmax_merge_matches_jax(seed):
    o1, l1, o2, l2 = _partials(seed)
    got = softmax_merge(*(torch.from_numpy(a) for a in (o1, l1, o2, l2)))
    _check(got, jax_softmax_merge(*(jnp.asarray(a) for a in (o1, l1, o2, l2))))
    assert bool((got[0][1, 16:24, 2] == 0).all())


@pytest.mark.parametrize("seed", [0, 1])
def test_merge_partial_attention_matches_jax(seed):
    o1, l1, o2, l2 = _partials(seed)
    l1t, l2t = l1.transpose(0, 2, 1).copy(), l2.transpose(0, 2, 1).copy()
    got = merge_partial_attention(*(torch.from_numpy(a) for a in (o1, l1t, o2, l2t)))
    _check(got, jax_merge_partial(*(jnp.asarray(a) for a in (o1, l1t, o2, l2t))))


def test_masked_partial_is_absorbed_exactly():
    o1, l1, _, _ = _partials(3)
    o, l_ = torch.from_numpy(o1), torch.from_numpy(l1)
    zero, neg = torch.zeros_like(o), torch.full_like(l_, float("-inf"))
    for got in (softmax_merge(o, l_, zero, neg), softmax_merge(zero, neg, o, l_)):
        assert torch.equal(got[0], o) and torch.equal(got[1], l_)
