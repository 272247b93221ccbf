"""Port parity for Llama serving: the steps and the engine against JAX's.

Weights come from the JAX ``LlamaForCausalLM.init(PRNGKey(0))`` at
``tiny()`` (8 query heads over 2 KV heads) through
``models/from_jax.py::llama_params_from_jax``. Each JAX engine is built and
run once per module (its jit dominates the time); the port runs on the CPU
with the plain versions of its kernels. The card's run of the same engine
is ``tests/test_torch_cuda_llama.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photonic_flash_attention_tpu.core.serving import ServingEngine as JaxEngine
from photonic_flash_attention_tpu.models.llama import (
    LlamaConfig as JaxConfig,
    LlamaForCausalLM as JaxLlama,
)
from photonic_flash_attention_tpu.models.llama_serving import (
    create_llama_pages as jax_create_llama_pages,
    llama_prefill_step as jax_prefill_step,
)
from photonic_flash_attention_tpu_torch.core.serving import ServingEngine
from photonic_flash_attention_tpu_torch.models.from_jax import llama_params_from_jax
from photonic_flash_attention_tpu_torch.models.gpt2 import GPT2Config
from photonic_flash_attention_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from photonic_flash_attention_tpu_torch.models.llama_serving import (
    create_llama_pages,
    llama_prefill_step,
    prepare_params,
)
from photonic_flash_attention_tpu_torch.utils.exceptions import KVCacheError

from .conftest import rel_err_norm

PROMPT_LENS = (5, 12, 3)
ENGINE = dict(num_pages=64, page_size=16, max_batch=4)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    """(JAX params, port state_dict) of Llama tiny from PRNGKey(0)."""
    variables = JaxLlama(JaxConfig.tiny()).init(jax.random.PRNGKey(0),
                                                jnp.zeros((1, 8), jnp.int32))
    params = variables["params"]
    return params, llama_params_from_jax(jax.tree_util.tree_map(np.asarray, params))


def _cfgs(dtype: str):
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return (dataclasses.replace(JaxConfig.tiny(), dtype=jdt),
            dataclasses.replace(LlamaConfig.tiny(), dtype=tdt))


def _prompts(seed=42, lens=PROMPT_LENS):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 512, n).tolist() for n in lens]


def _chunk_prompt():
    return _prompts(seed=7, lens=(40,))[0]


@pytest.fixture(scope="module")
def jax_tokens(weights):
    """The JAX fp32 engine's greedy tokens: the three prompts (8 new tokens)
    and the 40-token prompt prefilled in chunks of 16 (5 new tokens)."""
    params, _ = weights
    jcfg, _ = _cfgs("f32")
    whole = JaxEngine(jcfg, params, kv_dtype=jnp.float32, **ENGINE).generate(
        _prompts(), max_new_tokens=8)
    chunked = JaxEngine(jcfg, params, kv_dtype=jnp.float32, prefill_chunk=16, **ENGINE).generate(
        [_chunk_prompt()], max_new_tokens=5)
    return {"whole": whole, "chunked": chunked[0]}


def _engine(state, dtype="f32", **kw):
    _, tcfg = _cfgs(dtype)
    kw = {**ENGINE, "kv_dtype": torch.float32 if dtype == "f32" else torch.bfloat16, **kw}
    return ServingEngine(tcfg, state, device="cpu", **kw)


def _dense_greedy(state, prompt, n_new):
    _, tcfg = _cfgs("f32")
    model = LlamaForCausalLM(tcfg, device="cpu")
    model.load_state_dict(state)
    toks = list(prompt)
    with torch.no_grad():
        for _ in range(n_new):
            toks.append(int(model(torch.tensor([toks]))[0, -1].argmax()))
    return toks[len(prompt):]


def test_fp32_engine_matches_jax_engine_tokens(weights, jax_tokens):
    _, state = weights
    assert _engine(state).generate(_prompts(), max_new_tokens=8) == jax_tokens["whole"]


def test_int8_kv_first_token_and_prefill_logits_match_jax(weights):
    params, state = weights
    jcfg, tcfg = _cfgs("bf16")
    prompt = _prompts(seed=3)[1]
    kw = dict(num_pages=64, page_size=16, max_batch=2)
    j_tok = JaxEngine(jcfg, params, kv_dtype=jnp.int8, **kw).generate(
        [prompt], max_new_tokens=1)[0][0]
    t_tok = ServingEngine(tcfg, state, device="cpu", kv_dtype=torch.int8, **kw).generate(
        [prompt], max_new_tokens=1)[0][0]
    assert t_tok == j_tok
    # Prefill logits, bucketed to 16 tokens, page 1 onward.
    n, s_pad, page = len(prompt), 16, 16
    ids = np.zeros((1, s_pad), np.int32)
    ids[0, :n] = prompt
    slots = np.zeros((1, s_pad), np.int32)
    slots[0, :n] = page + np.arange(n)
    j_logits, _ = jax_prefill_step(
        params, jcfg, jnp.asarray(ids), jnp.asarray([n], jnp.int32),
        jax_create_llama_pages(jcfg, 4, page, jnp.int8), jnp.asarray(slots), True,
    )
    pages = create_llama_pages(tcfg, 4, page, torch.int8, "cpu")
    t_logits = llama_prefill_step(
        prepare_params(state, tcfg, "cpu"), tcfg, torch.from_numpy(ids), torch.tensor([n]),
        pages, torch.from_numpy(slots), True,
    )
    assert rel_err_norm(t_logits.numpy(), np.asarray(j_logits)) <= 2e-2
    # The pool took the prompt's K (rotated) and V on page 1, int8 with scales.
    assert pages.k[:, :, 1, :n].abs().amax() > 0 and pages.k[:, :, 2:].abs().amax() == 0
    assert (pages.k_scales[:, :, 1, :n] != 1).all()


def test_pool_carries_kv_heads_not_query_heads(weights):
    _, state = weights
    eng = _engine(state, num_pages=32, page_size=8, max_batch=2)
    cfg = eng.cfg
    assert cfg.num_key_value_heads == 2 < cfg.num_attention_heads == 8
    assert eng.pages.k.shape == (cfg.num_hidden_layers, cfg.num_key_value_heads, 32, 8,
                                 cfg.head_dim)
    assert eng.pages.v.shape == eng.pages.k.shape and not eng.pages.quantized


def test_prepare_params_aliases_weights_in_their_dtype(weights):
    """A weight already in its serving dtype on its device is not copied."""
    _, state = weights
    _, tcfg = _cfgs("f32")
    params = prepare_params(state, tcfg, "cpu")
    assert params["layers"][1]["q_proj"] is state["layers.1.attn.q_proj.weight"]
    assert params["embed_tokens"] is state["embed_tokens"]
    assert params["lm_head"] is state["lm_head.weight"]
    _, bcfg = _cfgs("bf16")
    assert prepare_params(state, bcfg, "cpu")["layers"][0]["o_proj"].dtype == torch.bfloat16


def test_chunked_prefill_matches_single_shot_and_jax(weights, jax_tokens):
    _, state = weights
    prompt = _chunk_prompt()
    eng = _engine(state, prefill_chunk=16)
    chunked = eng.generate([prompt], max_new_tokens=5)[0]
    assert eng.get_performance_stats()["prefill_chunks"] == 3
    assert chunked == _engine(state).generate([prompt], max_new_tokens=5)[0]
    assert chunked == jax_tokens["chunked"]


def test_decode_across_a_page_boundary(weights):
    """A 14-token prompt on 16-token pages: decode positions 14-21 cross
    into the second page; the tokens are the dense model's greedy ones."""
    _, state = weights
    prompt = _prompts(seed=5, lens=(14,))[0]
    eng = _engine(state, decode_window=2)
    assert eng.generate([prompt], max_new_tokens=8)[0] == _dense_greedy(state, prompt, 8)


def test_request_past_max_position_embeddings_is_not_refused(weights):
    """RoPE has no position table: a Llama request longer than
    ``max_position_embeddings`` (256) is served; GPT-2 refuses one longer
    than ``n_positions``."""
    _, state = weights
    prompt = _prompts(seed=6, lens=(250,))[0]
    eng = _engine(state, num_pages=32, max_batch=1)
    assert eng.cfg.max_position_embeddings == 256
    out = eng.generate([prompt], max_new_tokens=10)[0]
    assert out[:2] == _dense_greedy(state, prompt, 2) and len(out) == 10
    gpt2 = ServingEngine(GPT2Config.tiny(), _gpt2_state(), device="cpu", **ENGINE)
    with pytest.raises(KVCacheError, match="positions"):
        gpt2.submit([1] * 250, max_new_tokens=10)


def _gpt2_state():
    from photonic_flash_attention_tpu_torch.models.gpt2 import GPT2LMHead

    return GPT2LMHead(GPT2Config.tiny(), generator=torch.Generator().manual_seed(0)).state_dict()


def test_engine_runs_on_the_card_by_default(weights):
    if torch.cuda.is_available():
        pytest.skip("the card is there: the default takes it")
    _, state = weights
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(_cfgs("f32")[1], state, **ENGINE)
