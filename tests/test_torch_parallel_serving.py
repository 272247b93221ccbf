"""Tensor-parallel GPT-2 serving of the port on gloo ranks against JAX's
sharded engine.

GPT-2 tiny (float32 model, weights from JAX's ``PRNGKey(0)`` init) is
served on a (data 1, model 2) mesh: float32 and int8 pools, chunked
prefill, and sampling. The port's side runs in spawned gloo workers
(``tests/_parallel_workers.py::serving_cases``), its sharded engine beside
its unsharded one; JAX's sharded engine runs here on 2 of the 8 virtual
CPU devices. Greedy tokens must equal JAX's sharded engine's and the
port's unsharded engine's. Sampled tokens must equal the port's unsharded
engine's: the two packages draw from different generators (``jax.random``
and ``torch.Generator``), so JAX's own test holds its sharded engine to
its unsharded one the same way. The sharded save/restore round trip and
the refusals (no mesh on restore, heads that do not divide) run too.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photonic_flash_attention_tpu.core.serving import ServingEngine as JaxEngine
from photonic_flash_attention_tpu.models.gpt2 import (
    GPT2Config as JaxConfig,
    GPT2LMHead as JaxGPT2,
)
from photonic_flash_attention_tpu.parallel.mesh import create_mesh as jax_create_mesh
from photonic_flash_attention_tpu_torch.models.from_jax import params_from_jax

from ._parallel_workers import run_world

JAX_CFG = dataclasses.replace(JaxConfig.tiny(), dtype=jnp.float32)
N_NEW = 6
CASES = {
    "f32": (dict(kv_dtype=torch.float32), dict(kv_dtype=jnp.float32)),
    "int8": (dict(kv_dtype=torch.int8), dict(kv_dtype=jnp.int8)),
    "chunked": (dict(kv_dtype=torch.float32, prefill_chunk=16),
                dict(kv_dtype=jnp.float32, prefill_chunk=16)),
    "sampled": (dict(kv_dtype=torch.float32, temperature=0.8, top_k=8, seed=42), None),
}


def _prompts():
    rng = np.random.default_rng(5)
    return {
        "f32": [rng.integers(1, 1024, n).tolist() for n in (5, 12)],
        "int8": [rng.integers(1, 1024, n).tolist() for n in (9, 3)],
        "chunked": [rng.integers(1, 1024, n).tolist() for n in (40, 7)],
        "sampled": [rng.integers(1, 1024, n).tolist() for n in (7, 11)],
        "bf16": [rng.integers(1, 1024, n).tolist() for n in (6, 13)],
    }


@pytest.fixture(scope="module")
def jax_params():
    return JaxGPT2(JAX_CFG).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]


@pytest.fixture(scope="module")
def port_runs(jax_params, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve")
    inputs = {
        "state": params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params)),
        "dtype": torch.float32,
        "cases": {name: port for name, (port, _) in CASES.items()},
        "prompts": _prompts(), "n_new": N_NEW, "ckpt_dir": str(tmp / "ckpt"),
    }
    return run_world(2, "serving_cases", inputs, tmp)


@pytest.mark.parametrize("name", ["f32", "int8", "chunked"])
def test_sharded_tokens_match_jax_sharded_engine(jax_params, port_runs, name):
    mesh = jax_create_mesh((1, 2), ("data", "model"), jax.devices()[:2])
    kw = CASES[name][1]
    want = JaxEngine(JAX_CFG, jax_params, num_pages=64, page_size=16, max_batch=2, mesh=mesh,
                     **kw).generate(_prompts()[name], max_new_tokens=N_NEW)
    for rank in port_runs:
        assert rank[f"sharded/{name}"] == want


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_tokens_match_unsharded_port(port_runs, name):
    for rank in port_runs:
        got = rank[f"sharded/{name}"]
        assert got == rank[f"unsharded/{name}"]
        assert [len(t) for t in got] == [N_NEW] * len(got)


def test_sharded_save_restore_round_trip(port_runs):
    for rank in port_runs:
        assert rank["restore/resumed"] == rank["restore/uninterrupted"]
        assert rank["restore/files"] == [
            "pages.model0-of-2.npz", "pages.model1-of-2.npz", "state.json"]
        assert rank["restore/no_mesh"].startswith("ValueError") and \
            "pass mesh=" in rank["restore/no_mesh"]


def test_indivisible_heads_rejected(port_runs):
    for rank in port_runs:
        assert rank["indivisible"].startswith("ValueError") and "must divide" in rank["indivisible"]
