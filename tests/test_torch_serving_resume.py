"""Serving checkpoints: ``ServingEngine.save``/``restore`` against JAX's.

For GPT-2, Llama and T5 tiny (weights from the JAX inits through
``models/from_jax.py``), a server stopped after a few ``step()`` calls,
saved, restored into a fresh engine and run to the end gives the tokens of
the JAX engine's interrupted run and of the port's uninterrupted run
(greedy, bf16 pools: JAX's checkpoint names every float pool "bf16").
Sampled decoding resumes on the same random stream; page accounting,
the waiting queue, a chunked prefill stopped between chunks and T5's
pinned cross buffers survive; a checkpoint of a sharded engine raises without a mesh.
The port runs on the CPU (plain versions); one JAX interrupted run a
family, shared by the module.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photonic_flash_attention_tpu.core.serving import ServingEngine as JaxEngine
from photonic_flash_attention_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from photonic_flash_attention_tpu.models.gpt2 import GPT2LMHead as JaxGPT2
from photonic_flash_attention_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from photonic_flash_attention_tpu.models.llama import LlamaForCausalLM as JaxLlama
from photonic_flash_attention_tpu.models.t5 import T5Config as JaxT5Config
from photonic_flash_attention_tpu.models.t5 import T5ForConditionalGeneration as JaxT5
from photonic_flash_attention_tpu_torch.core.serving import ServingEngine
from photonic_flash_attention_tpu_torch.models.from_jax import (
    llama_params_from_jax,
    params_from_jax,
    t5_params_from_jax,
)
from photonic_flash_attention_tpu_torch.models.gpt2 import GPT2Config
from photonic_flash_attention_tpu_torch.models.llama import LlamaConfig
from photonic_flash_attention_tpu_torch.models.t5 import T5Config

NEW_TOKENS = 6
STEPS_BEFORE_SAVE = 2
#: Three prompts, two slots: one request is still waiting at the save.
ENGINE = dict(num_pages=64, page_size=16, max_batch=2)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gpt2():
    jcfg = dataclasses.replace(JaxGPT2Config.tiny(), dtype=jnp.float32)
    params = JaxGPT2(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    tcfg = dataclasses.replace(GPT2Config.tiny(), dtype=torch.float32)
    return jcfg, params, tcfg, params_from_jax(jax.tree_util.tree_map(np.asarray, params)), {}


def _llama():
    jcfg = dataclasses.replace(JaxLlamaConfig.tiny(), dtype=jnp.float32)
    params = JaxLlama(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    tcfg = dataclasses.replace(LlamaConfig.tiny(), dtype=torch.float32)
    return jcfg, params, tcfg, llama_params_from_jax(jax.tree_util.tree_map(np.asarray, params)), {}


def _t5():
    jcfg = JaxT5Config.tiny()
    params = JaxT5(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32),
                              jnp.zeros((1, 4), jnp.int32))["params"]
    state = t5_params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    return jcfg, params, T5Config.tiny(), state, {"enc_max_len": 32}


FAMILIES = {"gpt2": _gpt2, "llama": _llama, "t5": _t5}


def _prompts(seed=42, lens=(5, 12, 3)):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, 512, n).tolist() for n in lens]


@pytest.fixture(scope="module")
def families():
    """Each family's (JAX cfg, JAX params, port cfg, port state_dict, extra
    engine arguments), built on first use."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = FAMILIES[name]()
        return cache[name]

    return get


def _run_interrupted(eng, restore, prompts, path, steps=STEPS_BEFORE_SAVE, **submit):
    sids = [eng.submit(p, NEW_TOKENS, **submit) for p in prompts]
    for _ in range(steps):
        eng.step()
    assert not all(eng._sequences[s].done for s in sids)
    eng.save(path)
    eng2 = restore(path)
    while not all(eng2._sequences[s].done for s in sids):
        assert eng2.step() > 0
    return [eng2._sequences[s].tokens[eng2._sequences[s].prompt_len:] for s in sids], eng2


@pytest.fixture(scope="module")
def jax_resumed(families, tmp_path_factory):
    """The JAX engine's interrupted greedy run, per family (bf16 pools)."""
    cache = {}

    def get(name):
        if name not in cache:
            jcfg, params, _, _, extra = families(name)
            path = str(tmp_path_factory.mktemp(f"jax_{name}") / "ckpt")
            cache[name], _ = _run_interrupted(
                JaxEngine(jcfg, params, **ENGINE, **extra),
                lambda p: JaxEngine.restore(p, jcfg, params), _prompts(), path)
        return cache[name]

    return get


def _port(families, name, **kw):
    _, _, tcfg, state, extra = families(name)
    return ServingEngine(tcfg, state, device="cpu", **ENGINE, **extra, **kw)


def _port_restore(families, name):
    _, _, tcfg, state, _ = families(name)
    return lambda p: ServingEngine.restore(p, tcfg, state, device="cpu")


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_greedy_resume_equals_jax_and_the_uninterrupted_run(families, jax_resumed, name,
                                                             tmp_path):
    want = _port(families, name).generate(_prompts(), max_new_tokens=NEW_TOKENS)
    eng = _port(families, name)
    assert eng.status()["allocator"] == "NativePageAllocator"
    got, eng2 = _run_interrupted(eng, _port_restore(families, name), _prompts(),
                                 str(tmp_path / "ckpt"))
    assert got == want
    assert got == jax_resumed(name)
    assert eng2.status()["allocator"] == "_PyPageAllocator"
    assert eng2.status()["pages_free"] == eng2.status()["pages_total"]


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_sampled_resume_equals_the_uninterrupted_run(families, name, tmp_path):
    kw = dict(temperature=0.8, top_k=50, seed=7, kv_dtype=torch.int8, decode_window=2)
    prompts = _prompts(seed=3)
    want = _port(families, name, **kw).generate(prompts, max_new_tokens=NEW_TOKENS)
    got, eng2 = _run_interrupted(_port(families, name, **kw), _port_restore(families, name),
                                 prompts, str(tmp_path / "ckpt"), steps=3)
    assert got == want
    assert eng2.temperature == 0.8 and eng2.top_k == 50 and eng2.decode_window == 2
    assert eng2.kv_dtype == torch.int8 and eng2._sample_steps > 0


def test_restore_preserves_page_accounting(families, tmp_path):
    """JAX's ``test_restore_preserves_page_accounting``, and the restored
    allocator holds each running sequence's pages and hands out no other."""
    eng = _port(families, "gpt2")
    eng.submit([1, 2, 3, 4], 6)
    for p in _prompts(seed=5, lens=(30, 20)):
        eng.submit(p, 6)
    eng.step()
    before = eng.status()
    eng.save(str(tmp_path / "ckpt"))
    eng2 = _port_restore(families, "gpt2")(str(tmp_path / "ckpt"))
    after = eng2.status()
    for key in ("pages_free", "active", "waiting", "finished"):
        assert after[key] == before[key], key
    assert eng2._sched.waiting_ids() == eng._sched.waiting_ids() == [2]
    held = set()
    for seq in eng2._sequences.values():
        if seq.page_ids:
            assert eng2._alloc.page_ids(seq.alloc_id) == seq.page_ids
            held |= set(seq.page_ids)
    assert not held & set(eng2._alloc._free) and 0 not in eng2._alloc._free
    assert eng2._next_id == 3 and eng2._tables_dirty
    for f in dataclasses.fields(eng.pages):
        a, b = getattr(eng.pages, f.name), getattr(eng2.pages, f.name)
        assert (a is None and b is None) or torch.equal(a, b), f.name


def test_chunked_prefill_resumes_between_chunks(families, tmp_path):
    prompts = _prompts(seed=8, lens=(70, 9))
    kw = dict(prefill_chunk=16)
    want = _port(families, "gpt2", **kw).generate(prompts, max_new_tokens=NEW_TOKENS)
    eng = _port(families, "gpt2", **kw)
    sids = [eng.submit(p, NEW_TOKENS) for p in prompts]
    eng.step()
    eng.step()
    assert 0 < eng._sequences[sids[0]].prefilled < len(prompts[0])
    eng.save(str(tmp_path / "ckpt"))
    eng2 = _port_restore(families, "gpt2")(str(tmp_path / "ckpt"))
    assert eng2.prefill_chunk == 16
    assert eng2._sequences[sids[0]].prefilled == eng._sequences[sids[0]].prefilled
    while not all(eng2._sequences[s].done for s in sids):
        assert eng2.step() > 0
    assert [eng2._sequences[s].tokens[len(p):] for s, p in zip(sids, prompts)] == want


def test_t5_cross_buffers_are_saved(families, tmp_path):
    eng = _port(families, "t5")
    for p in _prompts(seed=6, lens=(9, 20)):
        eng.submit(p, NEW_TOKENS)
    eng.step()
    assert float(eng.pages.cross_k.abs().sum()) > 0
    eng.save(str(tmp_path / "ckpt"))
    with np.load(str(tmp_path / "ckpt" / "pages.npz")) as data:
        assert set(data.files) == {"k", "v", "cross_k", "cross_v", "enc_len"}
        assert data["cross_k"].dtype == np.uint16  # bf16 bits
    eng2 = _port_restore(families, "t5")(str(tmp_path / "ckpt"))
    for name in ("cross_k", "cross_v", "enc_len", "k", "v"):
        assert torch.equal(getattr(eng2.pages, name), getattr(eng.pages, name)), name


def test_sharded_checkpoint_raises(families, tmp_path):
    eng = _port(families, "gpt2")
    eng.submit([1, 2, 3], 4)
    eng.step()
    path = str(tmp_path / "ckpt")
    eng.save(path)
    with open(os.path.join(path, "state.json")) as f:
        host = json.load(f)
    assert host["ctor"]["sharded"] is False
    host["ctor"].update(sharded=True, model_axis="model")
    with open(os.path.join(path, "state.json"), "w") as f:
        json.dump(host, f)
    with pytest.raises(ValueError, match="pass mesh="):
        _port_restore(families, "gpt2")(path)
