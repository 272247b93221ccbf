"""Ring and Ulysses attention of the port on gloo ranks against JAX's
virtual mesh.

The port's side runs in spawned worker processes that form a gloo process
group (``tests/_parallel_workers.py``), one spawn a world size carrying
every case; the JAX side runs here, ``make_ring_attention`` and
``make_ulysses_attention`` on the first ``world`` of the 8 virtual CPU
devices, its Pallas kernels in interpret mode. Inputs are made with numpy
from a seed and handed to both. Tolerances are JAX's own: ``assert_close``
for outputs, rtol 2e-2 / atol 2e-3 for gradients
(``tests/integration/test_ring_attention.py:120``,
``test_ulysses.py:92``). Every rank must return the same (replicated)
global output.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photonic_flash_attention_tpu.parallel.mesh import create_mesh as jax_create_mesh
from photonic_flash_attention_tpu.parallel.ring import make_ring_attention as jax_ring
from photonic_flash_attention_tpu.parallel.ulysses import make_ulysses_attention as jax_ulysses

from ._parallel_workers import run_world
from .conftest import assert_close

WORLDS = (2, 4)
GRAD_TOL = dict(rtol=2e-2, atol=2e-3)


def _case(rng, world, *, b=1, h=4, hkv=None, d=64, causal=False, lens=False, bias=False):
    s = 64 * world
    hkv = hkv or h
    c = {
        "q": rng.standard_normal((b, s, h, d)).astype(np.float32),
        "k": rng.standard_normal((b, s, hkv, d)).astype(np.float32),
        "v": rng.standard_normal((b, s, hkv, d)).astype(np.float32),
        "causal": causal,
    }
    if lens:  # one row past the first shard, one ending inside the last
        c["kv_lens"] = np.array([s - 37, 40][:b] + [s] * max(0, b - 2), np.int32)
    if bias:
        c["k_bias"] = rng.standard_normal((b, s)).astype(np.float32)
    return c


RING_FWD = {
    "full": dict(),
    "causal": dict(causal=True),
    "causal-lens-bias-gqa": dict(b=2, hkv=2, causal=True, lens=True, bias=True),
    "lens-gqa": dict(b=2, hkv=2, lens=True),
}
RING_GRAD = {
    "full": dict(),
    "causal": dict(causal=True),
    "causal-gqa": dict(hkv=2, causal=True),
    "lens-bias": dict(b=2, lens=True, bias=True),
}
ULYSSES = {
    "causal": dict(h=4, causal=True),
    "lens-bias": dict(b=2, h=4, lens=True, bias=True),
}
MESH2D = {"model": ("model", "seq"), "data": ("data", "seq")}


def _inputs(world):
    rng = np.random.default_rng(1000 + world)
    inp = {
        "ring_fwd": {n: _case(rng, world, **kw) for n, kw in RING_FWD.items()},
        "ring_grad": {n: _case(rng, world, **kw) for n, kw in RING_GRAD.items()},
        "ulysses": {n: _case(rng, world, **kw) for n, kw in ULYSSES.items()},
    }
    if world == 4:
        inp["mesh2d"] = {n: {**_case(rng, 1, b=2, h=4, causal=True), "s": 256, "axes": axes}
                         for n, axes in MESH2D.items()}
        for c in inp["mesh2d"].values():
            for key in ("q", "k", "v"):
                c[key] = rng.standard_normal((2, 256, 4, 64)).astype(np.float32)
    return inp


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree)
    return tree


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{world: (numpy inputs, [rank results])}."""
    out = {}
    for world in WORLDS:
        inp = _inputs(world)
        out[world] = (inp, run_world(world, "attention_cases", _to_torch(inp),
                                     tmp_path_factory.mktemp(f"attn{world}")))
    return out


def _result(worlds, world, key):
    """Rank 0's result, after checking every rank returned the same."""
    ranks = [r[key] for r in worlds[world][1]]
    for other in ranks[1:]:
        a = ranks[0] if isinstance(ranks[0], dict) else {"o": ranks[0]}
        b = other if isinstance(other, dict) else {"o": other}
        for name in a:
            assert torch.equal(a[name], b[name]), f"{key}/{name} differs between ranks"
    return ranks[0]


def _jax_args(c):
    kw = {}
    if "kv_lens" in c:
        kw["kv_lens"] = jnp.asarray(c["kv_lens"])
    if "k_bias" in c:
        kw["k_bias"] = jnp.asarray(c["k_bias"])
    return (jnp.asarray(c["q"]), jnp.asarray(c["k"]), jnp.asarray(c["v"])), kw


def _seq_mesh(world):
    return jax_create_mesh((world,), ("seq",), jax.devices()[:world])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", sorted(RING_FWD))
def test_ring_forward_matches_jax(worlds, world, name):
    c = worlds[world][0]["ring_fwd"][name]
    fn = jax_ring(_seq_mesh(world), data_axis=None, model_axis=None, causal=c["causal"])
    args, kw = _jax_args(c)
    got = _result(worlds, world, f"ring_fwd/{name}")
    assert got.shape == c["q"].shape and got.dtype == torch.float32
    assert_close(got.numpy(), fn(*args, **kw))


def _jax_grads(fn, c):
    args, kw = _jax_args(c)
    names = ["q", "k", "v"] + (["k_bias"] if "k_bias" in kw else [])
    lens = kw.get("kv_lens")

    def loss(q, k, v, *bias):
        out = fn(q, k, v, kv_lens=lens, k_bias=bias[0] if bias else None)
        return jnp.sum(out.astype(jnp.float32) ** 2)

    leaves = list(args) + ([kw["k_bias"]] if "k_bias" in kw else [])
    grads = jax.grad(loss, argnums=tuple(range(len(leaves))))(*leaves)
    return {f"d{n}": g for n, g in zip(names, grads)}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", sorted(RING_GRAD))
def test_ring_grads_match_jax(worlds, world, name):
    c = worlds[world][0]["ring_grad"][name]
    fn = jax_ring(_seq_mesh(world), data_axis=None, model_axis=None, causal=c["causal"],
                  differentiable=True)
    want = _jax_grads(fn, c)
    got = _result(worlds, world, f"ring_grad/{name}")
    assert sorted(got) == sorted(want)
    for key in want:
        assert_close(got[key].numpy(), want[key], err_msg=key, **GRAD_TOL)


@pytest.mark.parametrize("name", sorted(MESH2D))
def test_ring_on_2d_mesh_matches_jax(worlds, name):
    """(2, 2) meshes: heads x sequence and batch x sequence."""
    c = worlds[4][0]["mesh2d"][name]
    mesh = jax_create_mesh((2, 2), c["axes"], jax.devices()[:4])
    kw = dict(model_axis=None) if name == "data" else dict(data_axis=None)
    fn = jax_ring(mesh, causal=True, **kw)
    got = _result(worlds, 4, f"mesh2d/{name}")
    assert_close(got.numpy(), fn(jnp.asarray(c["q"]), jnp.asarray(c["k"]), jnp.asarray(c["v"])))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", sorted(ULYSSES))
def test_ulysses_matches_jax(worlds, world, name):
    c = worlds[world][0]["ulysses"][name]
    fn = jax_ulysses(_seq_mesh(world), data_axis=None, causal=c["causal"])
    args, kw = _jax_args(c)
    assert_close(_result(worlds, world, f"ulysses/{name}").numpy(), fn(*args, **kw))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", sorted(ULYSSES))
def test_ulysses_matches_ring(worlds, world, name):
    """The two sequence-parallel schemes agree on the same inputs."""
    uly = _result(worlds, world, f"ulysses/{name}")
    ring = _result(worlds, world, f"ulysses_ring/{name}")
    assert_close(uly.numpy(), ring.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", sorted(ULYSSES))
def test_ulysses_grads_match_jax(worlds, world, name):
    c = worlds[world][0]["ulysses"][name]
    want = _jax_grads(jax_ulysses(_seq_mesh(world), data_axis=None, causal=c["causal"]), c)
    got = _result(worlds, world, f"ulysses_grad/{name}")
    assert sorted(got) == sorted(want)
    for key in want:
        assert_close(got[key].numpy(), want[key], err_msg=key, **GRAD_TOL)
