"""Llama training of the port against JAX's ``Trainer``: on one CPU
process, and sharded on gloo ranks.

Llama tiny (8 query heads over 2 KV heads, float32) from JAX's
``LlamaForCausalLM.init(PRNGKey(0))``, carried across by
``models/from_jax.py::llama_params_from_jax``. The port's
``flash_threshold`` and ``flash_min_tokens`` are 1, so its attention takes
the flash route: the plain versions of K1 (with lse) and K4/K5 with the
GQA repeat and group sum. In one process, JAX's thresholds are lowered too
(its Pallas forward and backward in interpret mode); JAX's sharded runs
keep its defaults.

* One process: the step-0 gradients per parameter, 3 AdamW steps
  unsharded and at ``accum_steps=2`` against JAX's ``Trainer``, remat
  against the plain step.
* Gloo ranks (``tests/_parallel_workers.py::llama_training_cases``, one
  spawned world of 2): 3 AdamW steps on (data 2), (model 2) and, with the
  tied head, (model 2) with ``llama_param_sharding_rules``, against JAX's
  ``Trainer`` on 2 of the 8 virtual CPU devices; the tensor-parallel
  logits against the unsharded model's; a sharded checkpoint that
  resumes; the ``ValueError`` of ``tensor_parallel``.

Bounds: losses and gradient norms within 1e-3 relative of JAX's (as
``tests/test_torch_training.py::test_trainer_adamw_matches_optax``);
step-0 gradients ``rel_err_norm`` <= 1e-3 per parameter.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding

from photonic_flash_attention_tpu.config import get_config as jax_get_config
from photonic_flash_attention_tpu.models.llama import (
    LlamaConfig as JaxConfig,
    LlamaForCausalLM as JaxLlama,
    llama_param_sharding_rules as jax_rules,
)
from photonic_flash_attention_tpu.parallel.mesh import create_mesh as jax_create_mesh
from photonic_flash_attention_tpu.training import Trainer as JaxTrainer, TrainState
from photonic_flash_attention_tpu.training import synthetic_lm_batches
from photonic_flash_attention_tpu.training.trainer import lm_loss as jax_lm_loss
from photonic_flash_attention_tpu_torch.config import get_config, reset_config
from photonic_flash_attention_tpu_torch.models.from_jax import llama_params_from_jax
from photonic_flash_attention_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from photonic_flash_attention_tpu_torch.ops import flash as port_flash
from photonic_flash_attention_tpu_torch.training import Trainer, TrainState as PortState
from photonic_flash_attention_tpu_torch.training import make_train_step
from photonic_flash_attention_tpu_torch.training.trainer import lm_loss

from ._parallel_workers import run_world
from .conftest import rel_err_norm

JAX_CFG = dataclasses.replace(JaxConfig.tiny(), dtype=jnp.float32)
PORT_CFG = dataclasses.replace(LlamaConfig.tiny(), dtype=torch.float32)
ADAMW = dict(lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
BATCH, SEQ, STEPS = 2, 64, 3
TOL = 1e-3
FLASH_EVERYWHERE = dict(flash_threshold=1, flash_min_tokens=1)
#: Llama tiny with one size that does not divide over 2 ranks each.
INDIVISIBLE = {"kv_heads": dict(num_key_value_heads=1),
               "heads": dict(num_attention_heads=1, num_key_value_heads=1),
               "intermediate": dict(intermediate_size=255),
               "vocab": dict(vocab_size=511)}


def _jax_params(tied: bool = False):
    cfg = dataclasses.replace(JAX_CFG, tie_word_embeddings=tied)
    return JaxLlama(cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]


def _state(params) -> dict:
    return llama_params_from_jax(jax.tree_util.tree_map(np.asarray, params))


def _batches(accum: int = 1):
    gen = synthetic_lm_batches(batch=BATCH, seq=SEQ, vocab=JAX_CFG.vocab_size,
                               accum_steps=accum, seed=11)
    return [next(gen) for _ in range(STEPS)]


def _tx():
    return optax.adamw(ADAMW["lr"], b1=ADAMW["betas"][0], b2=ADAMW["betas"][1],
                       eps=ADAMW["eps"], weight_decay=ADAMW["weight_decay"])


def _jax_metrics(shape=None, tied: bool = False, accum: int = 1):
    """3 steps of JAX's Trainer, unsharded (``shape`` None) or on a (data,
    model) mesh of 2 devices with Llama's rules."""
    params = _jax_params(tied)
    cfg = dataclasses.replace(JAX_CFG, tie_word_embeddings=tied)
    tx = _tx()
    if shape is None:
        trainer = JaxTrainer(JaxLlama(cfg), tx, accum_steps=accum)
    else:
        mesh = jax_create_mesh(shape, ("data", "model"), jax.devices()[:2])
        specs = jax_rules(params, ("data", "model"))
        trainer = JaxTrainer(JaxLlama(cfg), tx, mesh=mesh, param_specs=specs)
        params = jax.device_put(params, jax.tree_util.tree_map(
            lambda s: NamedSharding(mesh, s), specs,
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))
    state = TrainState(step=jnp.int32(0), params=params, opt_state=jax.jit(tx.init)(params))
    out = []
    for b in _batches(accum):
        state, m = trainer.train_step(state, b)
        out.append([float(m["loss"]), float(m["grad_norm"])])
    return np.array(out)


def _close(got, want):
    got = np.asarray(got)
    assert got.shape == want.shape == (STEPS, 2)
    assert np.all(np.abs(got - want) <= TOL * np.abs(want)), (got, want)


def _port_model(params=None) -> LlamaForCausalLM:
    model = LlamaForCausalLM(PORT_CFG, device="cpu")
    model.load_state_dict(_state(_jax_params() if params is None else params))
    return model


@pytest.fixture
def _flash_route():
    """Flash route at every size in both packages; the port's config is
    reset afterwards (the JAX one by tests/conftest.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    jax_get_config().update(**FLASH_EVERYWHERE)
    get_config().update(**FLASH_EVERYWHERE)
    yield
    reset_config()
    torch.set_num_threads(n)


# -- one process -------------------------------------------------------------------------


def test_step0_grads_match_jax(_flash_route, monkeypatch):
    """Every parameter's gradient of one batch's loss against ``jax.grad``;
    the port's attention backward ran once a layer, on the GQA route."""
    params = _jax_params()
    batch = _batches()[0]
    model = _port_model(params)
    calls = []
    bwd = port_flash.flash_attention_bwd

    def counted(q, k, *a, **kw):
        calls.append((q.shape[2], k.shape[2]))
        return bwd(q, k, *a, **kw)

    monkeypatch.setattr(port_flash, "flash_attention_bwd", counted)
    lm_loss(model, {k: torch.from_numpy(v) for k, v in batch.items()}).backward()
    hq, hkv = PORT_CFG.num_attention_heads, PORT_CFG.num_key_value_heads
    assert hkv < hq  # the tiny config has GQA
    assert calls == [(hq, hkv)] * PORT_CFG.num_hidden_layers  # K/V with their own heads
    grads = jax.jit(jax.grad(lambda p, b: jax_lm_loss(JaxLlama(JAX_CFG).apply, p, b)))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    ref = _state(grads)
    assert sorted(n for n, _ in model.named_parameters()) == sorted(ref)
    for name, p in model.named_parameters():
        assert rel_err_norm(p.grad.numpy(), ref[name].numpy()) <= 1e-3, name


@pytest.mark.parametrize("accum", [1, 2], ids=["unsharded", "accum2"])
def test_trainer_adamw_matches_jax(_flash_route, accum):
    """3 AdamW steps of the port's Trainer against JAX's, in one process;
    at ``accum_steps=2`` each step sums two microbatches of 2 rows."""
    want = _jax_metrics(accum=accum)
    model = _port_model()
    trainer = Trainer(model, torch.optim.AdamW(model.parameters(), **ADAMW), accum_steps=accum)
    state, got = trainer.init_state(), []
    for b in _batches(accum):
        state, m = trainer.train_step(state, b)
        got.append([float(m["loss"]), float(m["grad_norm"])])
    _close(got, want)
    assert state.step == STEPS


def test_remat_matches_plain(_flash_route):
    """One SGD step under ``remat`` equals the plain step."""
    batch = {k: torch.from_numpy(v) for k, v in _batches()[0].items()}
    models, losses = [], []
    for remat in (False, True):
        model = _port_model()
        opt = torch.optim.SGD(model.parameters(), lr=1e-2)
        _, m = make_train_step(model, opt, remat=remat)(PortState(0, model, opt), batch)
        models.append(model)
        losses.append(float(m["loss"]))
    assert abs(losses[0] - losses[1]) <= 1e-6 * losses[0]
    for a, b in zip(*(m.parameters() for m in models)):
        assert torch.allclose(a, b, rtol=1e-6, atol=1e-7)


# -- gloo ranks --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("llama_train")
    inputs = {
        "state": _state(_jax_params()), "state_tied": _state(_jax_params(tied=True)),
        "adamw": ADAMW, "cfg": {"dtype": torch.float32}, "config": FLASH_EVERYWHERE,
        "batches": [{k: torch.from_numpy(v) for k, v in b.items()} for b in _batches()],
        "ckpt_dir": str(tmp / "ckpt"), "indivisible": INDIVISIBLE,
    }
    return run_world(2, "llama_training_cases", inputs, tmp)


@pytest.mark.parametrize("name,shape,tied", [("data2", (2, 1), False),
                                             ("model2", (1, 2), False),
                                             ("model2_tied", (1, 2), True)])
def test_sharded_trainer_matches_jax(port_runs, name, shape, tied):
    """The port's sharded Trainer on gloo ranks against JAX's on a mesh of
    2 devices with the same rules: the same metrics on every rank."""
    want = _jax_metrics(shape, tied)
    for rank in port_runs:
        _close(rank[name], want)


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_tensor_parallel_logits_match_unsharded(port_runs, tied):
    """The (model 2) forward gives every rank the unsharded model's logits
    (the untied head's vocabulary blocks gathered, or the gathered
    embedding's tied head)."""
    for rank in port_runs:
        got, want = rank[f"logits/tied{tied}/model2"], rank[f"logits/tied{tied}/unsharded"]
        assert got.shape == want.shape == (BATCH, SEQ, PORT_CFG.vocab_size)
        assert rel_err_norm(got.numpy(), want.numpy()) <= 1e-5


def test_sharded_checkpoint_resumes(port_runs):
    """Each rank saves its shards at step 2 (``params.rank<r>-of-2.pt``) and
    a fresh (model 2) trainer restores them: step 3 equals the
    uninterrupted run's."""
    for rank in port_runs:
        np.testing.assert_allclose(rank["resumed"], rank["model2"], rtol=1e-6, atol=0)
        assert {"params.rank0-of-2.pt", "params.rank1-of-2.pt"} <= set(rank["checkpoint_files"])


@pytest.mark.parametrize("name", sorted(INDIVISIBLE) + ["layout"])
def test_tensor_parallel_refuses(port_runs, name):
    """A size that does not divide over the model axis raises ValueError
    (nothing is padded or replicated), as do specs of another layout."""
    field = {"kv_heads": "num_key_value_heads", "heads": "num_attention_heads",
             "intermediate": "intermediate_size", "vocab": "vocab_size",
             "layout": "llama_param_sharding_rules"}[name]
    for rank in port_runs:
        got = rank[f"raises/{name}"]
        assert got.startswith("ValueError") and field in got, got
