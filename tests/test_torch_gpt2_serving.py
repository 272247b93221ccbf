"""Port parity for the slice as a whole: GPT-2 dense forward and serving.

Weights come from the JAX ``GPT2LMHead.init(PRNGKey(0))`` and reach the
port through ``models/from_jax.py::params_from_jax``. The port runs on the
CPU with the plain versions of its kernels.
"""

import dataclasses
import types

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
from photonic_flash_attention_tpu.models.gpt2_serving import (
    KVPages as JaxKVPages,
    _pages_to_scan_tree,
    prefill_step as jax_prefill_step,
)
from photonic_flash_attention_tpu_torch.core.serving import ServingEngine
from photonic_flash_attention_tpu_torch.models.from_jax import params_from_jax
from photonic_flash_attention_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from photonic_flash_attention_tpu_torch.models.gpt2_serving import (
    KVPages,
    prefill_step,
    prepare_params,
)

from .conftest import rel_err_norm

PROMPT_LENS = (5, 12, 3)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    """(JAX params, port state_dict) of GPT-2 tiny from PRNGKey(0)."""
    variables = JaxGPT2(JaxConfig.tiny()).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)
    )
    params = variables["params"]
    return params, params_from_jax(jax.tree_util.tree_map(np.asarray, params))


def _cfgs(dtype: str):
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return (
        dataclasses.replace(JaxConfig.tiny(), dtype=jdt),
        dataclasses.replace(GPT2Config.tiny(), dtype=tdt),
    )


def _port_model(cfg, state):
    model = GPT2LMHead(cfg)
    model.load_state_dict(state)
    return model


def _prompts(seed=42):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 1024, n).tolist() for n in PROMPT_LENS]


@pytest.mark.parametrize("dtype, bound", [("f32", 1e-5), ("bf16", 2e-2)])
def test_dense_forward_matches_flax(weights, dtype, bound):
    params, state = weights
    jcfg, tcfg = _cfgs(dtype)
    ids = np.random.default_rng(0).integers(0, 1024, (2, 24))
    j = JaxGPT2(jcfg).apply({"params": params}, jnp.asarray(ids, jnp.int32))
    with torch.no_grad():
        t = _port_model(tcfg, state)(torch.from_numpy(ids))
    assert t.dtype == tcfg.dtype and t.shape == (2, 24, 1024)
    assert rel_err_norm(t.float().numpy(), np.asarray(j, np.float32)) <= bound


def test_fp32_engine_matches_jax_engine_tokens(weights):
    params, state = weights
    jcfg, tcfg = _cfgs("f32")
    kwargs = dict(num_pages=64, page_size=16, max_batch=4)
    prompts = _prompts()
    j_out = JaxEngine(jcfg, params, kv_dtype=jnp.float32, **kwargs).generate(
        prompts, max_new_tokens=8
    )
    t_out = ServingEngine(tcfg, state, device="cpu", kv_dtype=torch.float32, **kwargs).generate(
        prompts, max_new_tokens=8
    )
    assert t_out == j_out


def test_int8_kv_first_token_and_prefill_logits_match_jax(weights):
    params, state = weights
    jcfg, tcfg = _cfgs("bf16")
    prompt = _prompts(seed=3)[1]
    kwargs = dict(num_pages=64, page_size=16, max_batch=2)
    j_tok = JaxEngine(jcfg, params, kv_dtype=jnp.int8, **kwargs).generate(
        [prompt], max_new_tokens=1
    )[0][0]
    t_tok = ServingEngine(tcfg, state, device="cpu", kv_dtype=torch.int8, **kwargs).generate(
        [prompt], max_new_tokens=1
    )[0][0]
    assert t_tok == j_tok
    # Prefill logits, bucketed to 16 tokens, page 1 onward.
    n, s_pad, page = len(prompt), 16, 16
    ids = np.zeros((1, s_pad), np.int32)
    ids[0, :n] = prompt
    slots = np.zeros((1, s_pad), np.int32)
    slots[0, :n] = page + np.arange(n)
    j_logits, _ = jax_prefill_step(
        params, jcfg, jnp.asarray(ids), jnp.asarray([n], jnp.int32),
        _pages_to_scan_tree(JaxKVPages.create(jcfg, 4, page, jnp.int8)),
        jnp.asarray(slots), True,
    )
    t_logits = prefill_step(
        prepare_params(state, tcfg, "cpu"), tcfg, torch.from_numpy(ids),
        torch.tensor([n]), KVPages.create(tcfg, 4, page, torch.int8, "cpu"),
        torch.from_numpy(slots), True,
    )
    assert rel_err_norm(t_logits.numpy(), np.asarray(j_logits)) <= 2e-2


def test_continuous_batching_page_recycling(weights):
    _, state = weights
    eng = ServingEngine(
        GPT2Config.tiny(), state, device="cpu", num_pages=12, page_size=16, max_batch=2,
        max_pages_per_seq=4,
    )
    # 5 requests through a pool that only fits ~2 at a time.
    rng = np.random.default_rng(42)
    prompts = [rng.integers(1, 1024, 8).tolist() for _ in range(5)]
    outs = eng.generate(prompts, max_new_tokens=4)
    assert all(len(o) == 4 for o in outs)
    st = eng.status()
    assert st["finished"] == 5
    assert st["pages_free"] == st["pages_total"]  # all recycled


def _dense_greedy(model, prompt, n_new):
    """Oracle: greedy decode by full re-forward each step."""
    toks = list(prompt)
    with torch.no_grad():
        for _ in range(n_new):
            toks.append(int(torch.argmax(model(torch.tensor([toks]))[0, -1])))
    return toks[len(prompt):]


def test_engine_matches_dense_greedy(weights):
    _, state = weights
    cfg = GPT2Config.tiny()
    eng = ServingEngine(cfg, state, device="cpu", num_pages=64, page_size=16, max_batch=4)
    prompts = _prompts()
    outs = eng.generate(prompts, max_new_tokens=8)
    model = _port_model(cfg, state)
    for p, o in zip(prompts, outs):
        assert o == _dense_greedy(model, p, 8), f"prompt {p}"


def test_sampling_counter_survives_stats_reset(weights):
    """Sampling streams are seeded from a counter that
    ``reset_performance_stats`` leaves alone (the JAX engine seeds them from
    ``_steps``, which the reset zeroes, so keys replay)."""
    _, state = weights
    kwargs = dict(num_pages=64, page_size=16, max_batch=4, temperature=1.0, top_k=8, seed=5)
    prompts = _prompts(seed=9)
    eng = ServingEngine(GPT2Config.tiny(), state, device="cpu", **kwargs)
    first = eng.generate(prompts, max_new_tokens=8)
    sampled = eng._sample_steps
    assert sampled > 0
    eng.reset_performance_stats()
    assert eng.get_performance_stats()["decode_steps"] == 0
    assert eng._sample_steps == sampled
    second = eng.generate(prompts, max_new_tokens=8)
    assert eng._sample_steps > sampled
    # A fresh engine with the same seed replays the first pass exactly.
    again = ServingEngine(GPT2Config.tiny(), state, device="cpu", **kwargs).generate(prompts, max_new_tokens=8)
    assert again == first
    assert all(0 <= t < 1024 for o in first + second for t in o)


def test_stats_surface(weights):
    _, state = weights
    eng = ServingEngine(GPT2Config.tiny(), state, device="cpu", num_pages=64, page_size=16, max_batch=2)
    eng.generate([_prompts()[0]], max_new_tokens=3)
    s = eng.get_performance_stats()
    assert s["prefill_tokens"] == PROMPT_LENS[0]
    assert s["decode_tokens"] == 2 and s["decode_tokens_per_s"] > 0
    assert s["kv_dtype"] == "bf16" and s["pages_free"] == s["pages_total"]


@pytest.mark.parametrize("kwargs, match", [(dict(mesh=types.SimpleNamespace(
    mesh_dim_names=("data",), mesh=torch.zeros(1))), "no axis 'model'")])
def test_parts_outside_the_slice_raise(weights, kwargs, match):
    """Sharded serving is ported (ROADMAP A12): a mesh without the model
    axis raises JAX's ``ValueError``."""
    _, state = weights
    with pytest.raises(ValueError, match=match):
        ServingEngine(GPT2Config.tiny(), state, device="cpu", num_pages=8, page_size=16, **kwargs)


def test_interleaved_submission(weights):
    """Sequences joining mid-flight (true continuous batching) still match
    the dense oracle."""
    _, state = weights
    cfg = dataclasses.replace(GPT2Config.tiny(), dtype=torch.float32)
    eng = ServingEngine(cfg, state, device="cpu", num_pages=64, page_size=16, max_batch=4,
                        kv_dtype=torch.float32, decode_window=2)
    p1, p2 = _prompts(seed=4)[:2]
    s1 = eng.submit(p1, max_new_tokens=6)
    eng.step()
    s2 = eng.submit(p2, max_new_tokens=3)  # joins mid-flight
    while not (eng._sequences[s1].done and eng._sequences[s2].done):
        eng.step()
    model = _port_model(cfg, state)
    assert eng._sequences[s1].tokens[len(p1):] == _dense_greedy(model, p1, 6)
    assert eng._sequences[s2].tokens[len(p2):] == _dense_greedy(model, p2, 3)


def test_eos_retires_and_frees_pages(weights):
    _, state = weights
    cfg = GPT2Config.tiny()
    prompt = _prompts()[1]
    first = ServingEngine(cfg, state, device="cpu", num_pages=64, page_size=16).generate(
        [prompt], max_new_tokens=8
    )[0]
    eos = first[2]
    eng = ServingEngine(cfg, state, device="cpu", num_pages=64, page_size=16, eos_token_id=eos)
    out = eng.generate([prompt], max_new_tokens=8)[0]
    assert out == first[: first.index(eos) + 1]
    assert eng.status()["pages_free"] == eng.status()["pages_total"]


def test_cancel_and_best_fit_admission(weights):
    _, state = weights
    # 5 usable pages of 16 tokens: the 40-token head needs 4, the small
    # requests 1 each.
    eng = ServingEngine(GPT2Config.tiny(), state, device="cpu", num_pages=6, page_size=16,
                        max_batch=2, admission="best-fit")
    big = eng.submit(list(range(1, 41)), max_new_tokens=8)
    small = eng.submit([5, 6, 7], max_new_tokens=2)
    gone = eng.submit([8, 9], max_new_tokens=2)
    assert eng.cancel(gone) and not eng.cancel(gone)
    eng._alloc.allocate_sequence(48)  # hold 3 pages: the head no longer fits
    eng.step()
    assert eng._sequences[small].done and not eng._sequences[big].done
    # The admitted request left the queue (the JAX schedulers pop only the
    # head, so it would be admitted again): only the head still waits.
    assert eng.status()["waiting"] == 1
    assert eng._sched.waiting_ids() == [big]
    eng.step()
    assert len(eng._sequences[small].tokens) == 5  # not prefilled again
    assert eng.status()["queue"]["admitted"] == 1
    with pytest.raises(ValueError, match="admission"):
        ServingEngine(GPT2Config.tiny(), state, device="cpu", num_pages=6, page_size=16, admission="lifo")


# -- chunked prefill (the JAX tests/integration/test_serving.py TestChunkedPrefill) --


def _chunked(state, cfg=None, **kw):
    kwargs = dict(device="cpu", num_pages=64, page_size=16, max_batch=2, prefill_chunk=16)
    kwargs.update(kw)
    return ServingEngine(cfg or GPT2Config.tiny(), state, **kwargs)


@pytest.mark.parametrize("n", [40, 37], ids=["whole_chunks", "last_chunk_partial"])
def test_chunked_prefill_matches_dense_greedy(weights, n):
    """Prompts prefilled in chunks of 16 (the last one partial for 37)
    decode the dense model's greedy tokens."""
    _, state = weights
    prompt = np.random.default_rng(n).integers(1, 1024, n).tolist()
    eng = _chunked(state)
    out = eng.generate([prompt], max_new_tokens=6)[0]
    assert eng.get_performance_stats()["prefill_chunks"] == -(-n // 16)
    assert out == _dense_greedy(_port_model(GPT2Config.tiny(), state), prompt, 6)


@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_chunked_prefill_matches_jax_engine(weights, kv):
    """The port's chunked engine against the JAX one with the same chunk
    size: the same tokens (fp32 model; int8 pools dequantize the history
    in both)."""
    params, state = weights
    jcfg, tcfg = _cfgs("f32")
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "int8": (jnp.int8, torch.int8)}[kv]
    prompts = [np.random.default_rng(7).integers(1, 1024, 45).tolist(), _prompts()[0]]
    kw = dict(num_pages=64, page_size=16, max_batch=2, prefill_chunk=16)
    j_out = JaxEngine(jcfg, params, kv_dtype=jdt, **kw).generate(prompts, max_new_tokens=5)
    t_out = _chunked(state, tcfg, kv_dtype=tdt).generate(prompts, max_new_tokens=5)
    assert t_out == j_out


def test_chunked_last_token_logits_match_single_shot(weights):
    """fp32: the logits of the last prompt token after 3 chunks equal the
    single-shot prefill's (bound 1e-5)."""
    _, state = weights
    cfg = dataclasses.replace(GPT2Config.tiny(), dtype=torch.float32)
    prompt = np.random.default_rng(1).integers(1, 1024, 40).tolist()
    seen = {}
    for chunk in (None, 16):
        eng = _chunked(state, cfg, kv_dtype=torch.float32, prefill_chunk=chunk)
        eng._pick_token = lambda logits, seq, _c=chunk: int(seen.setdefault(_c, logits.clone()).argmax())
        eng.generate([prompt], max_new_tokens=1)
    assert rel_err_norm(seen[16].numpy(), seen[None].numpy()) <= 1e-5


def test_long_prompt_does_not_stall_decode(weights):
    """A decoding sequence keeps producing tokens while another sequence's
    long prompt prefills chunk by chunk."""
    _, state = weights
    rng = np.random.default_rng(3)
    eng = _chunked(state, decode_window=2)
    short = eng.submit(rng.integers(1, 1024, 5).tolist(), 12)
    eng.step()  # short admits, prefills and starts decoding
    assert eng._sequences[short].new_tokens >= 1
    long = eng.submit(rng.integers(1, 1024, 48).tolist(), 4)
    progressed = 0
    while eng._sequences[long].prefilled < 48:
        before = eng._sequences[short].new_tokens
        eng.step()
        if not eng._sequences[short].done:
            progressed += eng._sequences[short].new_tokens - before
    assert progressed > 0  # decode advanced during the chunked prefill
    while not eng._sequences[long].done:
        eng.step()
    assert len(eng._sequences[long].tokens) == 48 + 4


@pytest.mark.parametrize("chunk", [10, 0, -16])
def test_invalid_chunk_size_rejected(weights, chunk):
    _, state = weights
    with pytest.raises(ValueError, match="multiple of"):
        _chunked(state, num_pages=16, prefill_chunk=chunk)


def test_default_device_is_the_card(weights):
    """Without device="cpu" the engine and the pool go to the card, and
    without CUDA that raises instead of running on the CPU."""
    _, state = weights
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(GPT2Config.tiny(), state, num_pages=8, page_size=16)
    with pytest.raises((RuntimeError, AssertionError)):
        KVPages.create(GPT2Config.tiny(), 4, 16)
