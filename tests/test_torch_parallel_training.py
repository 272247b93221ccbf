"""Sharded GPT-2 training of the port on gloo ranks against JAX's sharded
``Trainer``, and the sharding rules against JAX's trees.

GPT-2 tiny (float32) takes 3 AdamW steps from the same init on (data 2)
and (model 2) meshes in both packages; the port also on a data-only mesh
without specs and, with the engine's seq axis of 2 ranks, sequence
parallel at S 256 (the engine's gates want shards of 128 tokens): Ulysses
on (model 1, seq 2) with specs, ring attention on (data 1, seq 2) without
them for a one-head variant, both against JAX's unsharded trainer. The
port's side runs in spawned gloo workers
(``tests/_parallel_workers.py::training_cases``); JAX's on 2 of the 8
virtual CPU devices. Bounds: losses and gradient norms within 1e-3
relative of JAX's, as the unsharded trainer's test
(``tests/test_torch_training.py::test_trainer_adamw_matches_optax``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding

from photonic_flash_attention_tpu.models.gpt2 import (
    GPT2Config as JaxConfig,
    GPT2LMHead as JaxGPT2,
    param_sharding_rules as jax_rules,
)
from photonic_flash_attention_tpu.models.gpt2_serving import (
    serving_pages_specs as jax_pages_specs,
    serving_param_specs as jax_serving_specs,
)
from photonic_flash_attention_tpu.models.llama import (
    LlamaConfig as JaxLlamaConfig,
    LlamaForCausalLM as JaxLlama,
    llama_param_sharding_rules as jax_llama_rules,
)
from photonic_flash_attention_tpu.parallel.mesh import create_mesh as jax_create_mesh
from photonic_flash_attention_tpu.training import Trainer as JaxTrainer, TrainState
from photonic_flash_attention_tpu.training import synthetic_lm_batches
from photonic_flash_attention_tpu_torch.models.from_jax import (
    llama_params_from_jax,
    params_from_jax,
)
from photonic_flash_attention_tpu_torch.models.gpt2 import param_sharding_rules
from photonic_flash_attention_tpu_torch.models.gpt2_serving import (
    serving_pages_specs,
    serving_param_specs,
)
from photonic_flash_attention_tpu_torch.models.llama import llama_param_sharding_rules

from ._parallel_workers import run_world

JAX_CFG = dataclasses.replace(JaxConfig.tiny(), dtype=jnp.float32)
ADAMW = dict(lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
BATCH, SEQ, STEPS = 2, 64, 3
SEQ_PAR = 256  # two sequence shards of 128, the least the engine's gates take
TOL = 1e-3


def _jax_params():
    return JaxGPT2(JAX_CFG).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]


def _batches(seq=SEQ):
    gen = synthetic_lm_batches(batch=BATCH, seq=seq, vocab=JAX_CFG.vocab_size, seed=11)
    return [next(gen) for _ in range(STEPS)]


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    params = _jax_params()
    state = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    tmp = tmp_path_factory.mktemp("train")
    inputs = {
        "state": state, "adamw": ADAMW, "cfg": {"dtype": torch.float32},
        "config": {"flash_threshold": 1, "flash_min_tokens": 1},
        "batches": [{k: torch.from_numpy(v) for k, v in b.items()} for b in _batches()],
        "seq_batches": [{k: torch.from_numpy(v) for k, v in b.items()}
                        for b in _batches(SEQ_PAR)],
        "ring_cfg": {"n_head": 1},
        "ckpt_dir": str(tmp / "ckpt"),
    }
    return run_world(2, "training_cases", inputs, tmp)


def _jax_metrics(shape, cfg=JAX_CFG, seq=SEQ):
    """3 steps of JAX's Trainer on a (data, model) mesh of 2 devices (None:
    unsharded), from PRNGKey(0)'s params (the same for any head count)."""
    params = _jax_params()
    tx = optax.adamw(ADAMW["lr"], b1=ADAMW["betas"][0], b2=ADAMW["betas"][1], eps=ADAMW["eps"],
                     weight_decay=ADAMW["weight_decay"])
    if shape is None:
        trainer = JaxTrainer(JaxGPT2(cfg), tx)
    else:
        mesh = jax_create_mesh(shape, ("data", "model"), jax.devices()[:2])
        specs = jax_rules(params, ("data", "model"))
        trainer = JaxTrainer(JaxGPT2(JAX_CFG), tx, mesh=mesh, param_specs=specs)
        params = jax.device_put(params, jax.tree_util.tree_map(
            lambda s: NamedSharding(mesh, s), specs,
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))
    state = TrainState(step=jnp.int32(0), params=params, opt_state=jax.jit(tx.init)(params))
    out = []
    for b in _batches(seq):
        state, m = trainer.train_step(state, b)
        out.append([float(m["loss"]), float(m["grad_norm"])])
    return np.array(out)


@pytest.fixture(scope="module")
def jax_runs():
    return {"data2": _jax_metrics((2, 1)), "model2": _jax_metrics((1, 2)),
            "data2_nospecs": _jax_metrics(None),
            "seq2": _jax_metrics(None, seq=SEQ_PAR),
            "data_seq2_ring": _jax_metrics(None, dataclasses.replace(JAX_CFG, n_head=1), SEQ_PAR)}


def _close(got, want):
    got = np.asarray(got)
    assert got.shape == want.shape == (STEPS, 2)
    assert np.all(np.abs(got - want) <= TOL * np.abs(want)), (got, want)


@pytest.mark.parametrize("name", ["data2", "model2"])
def test_sharded_trainer_matches_jax(port_runs, jax_runs, name):
    for rank in port_runs:  # the same metrics on every rank
        _close(rank[name], jax_runs[name])


@pytest.mark.parametrize("name", ["data2_nospecs", "seq2", "data_seq2_ring"])
def test_other_meshes_match_jax_unsharded(port_runs, jax_runs, name):
    """Data parallel without specs; tensor parallel at model 1 with the
    engine's seq axis of 2 (attention through Ulysses); data 1 without
    specs with the seq axis of 2 and one head (ring attention): each
    against JAX's unsharded trainer on the same batches and heads."""
    for rank in port_runs:
        _close(rank[name], jax_runs[name])


@pytest.mark.parametrize("name,collective", [("seq2", "all_to_all"),
                                             ("data_seq2_ring", "ppermute")])
def test_seq_parallel_runs_under_the_trainer(port_runs, name, collective):
    """The trainer's attention went over the engine's seq axis, although
    the mesh was set after the trainer was built: the telemetry holds the
    kind's collective and no other."""
    for rank in port_runs:
        moved = rank[f"{name}/collectives"]
        assert set(moved) == {collective} and moved[collective] > 0, moved


def test_sharded_checkpoint_resumes(port_runs):
    """Each rank saves its shards at step 2 and a fresh sharded trainer
    restores them: step 3 equals the uninterrupted run's."""
    for rank in port_runs:
        np.testing.assert_allclose(rank["resumed"], rank["model2"], rtol=1e-6, atol=0)
        assert rank["unsharded_restore"].startswith("CheckpointError")


# -- the sharding rules, spec for spec ----------------------------------------------------


def _flat_specs(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {tuple(getattr(e, "key", e) for e in kp): tuple(s) for kp, s in flat}


def _port_name(path, stack):
    """A Flax path of a scanned tree -> the port's name at layer 0, and
    whether the leaf is a Dense kernel (transposed in the port)."""
    path = list(path)
    kernel = path[-1] == "kernel"
    if path[-1] in ("kernel", "scale"):
        path[-1] = "weight"
    if path[0] == stack:
        path = [stack, "0"] + path[2:]
    if path == ["lm_head"]:  # a bare (H, V) parameter in Flax, nn.Linear's (V, H) here
        return "lm_head.weight", True
    return ".".join(path), kernel


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_sharding_rules_match_jax(family):
    if family == "gpt2":
        params = _jax_params()
        want, stack = _flat_specs(jax_rules(params)), "h"
        got = param_sharding_rules(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    else:
        cfg = JaxLlamaConfig.tiny()
        params = JaxLlama(cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
        want, stack = _flat_specs(jax_llama_rules(params)), "layers"
        got = llama_param_sharding_rules(
            llama_params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    checked = 0
    for path, spec in want.items():
        name, kernel = _port_name(path, stack)
        if path[0] == stack:
            spec = spec[1:]  # the scanned layer axis
        if kernel:
            spec = spec[::-1]
        assert tuple(got[name]) == spec or (not spec and not any(got[name])), name
        checked += 1
    assert checked == len(want) and all(
        tuple(got[n]) == tuple(got[n.replace(".0.", ".1.", 1)])
        for n in got if ".0." in n)


def test_serving_specs_match_jax():
    want = _flat_specs(jax_serving_specs("model"))
    got = serving_param_specs("model")
    names = {"scale": 0, "kernel": 0, "bias": 1}
    for path, spec in want.items():
        leaf = path[-1]
        if path[0] == "h":  # ("h", "block", group, name, leaf)
            node, spec = path[-2], spec[1:]
            port = got["layers"][node][names[leaf]]
        else:
            port = got[path[0]] if len(path) == 1 else got[path[0]][names[leaf]]
        if leaf == "kernel":
            spec = spec[::-1]
        assert tuple(port) == spec, path
    for quantized in (False, True):
        jp = jax_pages_specs(quantized, "model")
        pp = serving_pages_specs(quantized, "model")
        assert {"k": tuple(pp["k"]), "v": tuple(pp["v"]), "ks": tuple(pp["k_scales"]),
                "vs": tuple(pp["v_scales"])} == {k: tuple(v) for k, v in jp.items()}
