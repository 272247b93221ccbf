"""Port parity for the Llama family: RoPE, the dense forward, HF transfer.

Weights come from the JAX ``LlamaForCausalLM.init(PRNGKey(0))`` at
``tiny()`` (8 query heads over 2 KV heads) and reach the port through
``models/from_jax.py::llama_params_from_jax``. The port runs on the CPU
with the plain versions of its kernels.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photonic_flash_attention_tpu.config import get_config as jax_get_config
from photonic_flash_attention_tpu.models.llama import (
    LlamaConfig as JaxConfig,
    LlamaForCausalLM as JaxLlama,
    apply_rope as jax_apply_rope,
    rope_cos_sin as jax_rope_cos_sin,
)
from photonic_flash_attention_tpu_torch.config import get_config, reset_config
from photonic_flash_attention_tpu_torch.models.from_jax import llama_params_from_jax
from photonic_flash_attention_tpu_torch.models.llama import (
    LlamaConfig,
    LlamaForCausalLM,
    apply_rope,
    rope_cos_sin,
    transfer_hf_llama,
)

from .conftest import rel_err_norm

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def _one_thread_and_port_config():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    reset_config()
    yield
    reset_config()
    torch.set_num_threads(n)


def _init(tie: bool):
    cfg = dataclasses.replace(JaxConfig.tiny(), tie_word_embeddings=tie)
    variables = JaxLlama(cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    params = variables["params"]
    return params, llama_params_from_jax(jax.tree_util.tree_map(np.asarray, params))


@pytest.fixture(scope="module")
def weights():
    """(JAX params, port state_dict) of Llama tiny, untied head."""
    return _init(tie=False)


def _cfgs(dtype: str, **kw):
    jdt, tdt = DTYPES[dtype]
    return (dataclasses.replace(JaxConfig.tiny(), dtype=jdt, **kw),
            dataclasses.replace(LlamaConfig.tiny(), dtype=tdt, **kw))


def _port_model(cfg, state):
    model = LlamaForCausalLM(cfg, device="cpu")
    model.load_state_dict(state)
    return model


@pytest.mark.parametrize("head_dim", [16, 128])
def test_rope_matches_jax(head_dim):
    rng = np.random.default_rng(0)
    positions = rng.integers(0, 4096, (2, 40))
    j_cos, j_sin = jax_rope_cos_sin(jnp.asarray(positions, jnp.int32), head_dim, 10000.0)
    cos, sin = rope_cos_sin(torch.from_numpy(positions), head_dim, 10000.0)
    assert cos.dtype == torch.float32 and cos.shape == (2, 40, head_dim)
    np.testing.assert_allclose(cos.numpy(), np.asarray(j_cos), rtol=0, atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(j_sin), rtol=0, atol=1e-6)
    x = rng.standard_normal((2, 40, 3, head_dim)).astype(np.float32)
    j = jax_apply_rope(jnp.asarray(x), j_cos, j_sin)
    t = apply_rope(torch.from_numpy(x), cos, sin)
    assert t.is_contiguous() and t.dtype == torch.float32
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-6)


@pytest.mark.parametrize("route", ["fused", "flash"])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("dtype, bound", [("f32", 1e-4), ("bf16", 2e-2)])
def test_forward_matches_jax(weights, dtype, bound, masked, route):
    """Logits against the Flax model on the same weights; "flash" lowers the
    flash threshold in both packages, so an unmasked forward takes the flash
    path (K1's plain version against JAX's kernel in interpret mode)."""
    if route == "flash":
        get_config().update(flash_threshold=16, flash_min_tokens=1)
        jax_get_config().update(flash_threshold=16, flash_min_tokens=1)
    params, state = weights
    jcfg, tcfg = _cfgs(dtype)
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 512, (2, 24))
    mask = np.ones((2, 24), np.int32)
    mask[1, 17:] = 0
    mask[0, 3] = 0
    kw = dict(attention_mask=mask) if masked else {}
    j = JaxLlama(jcfg).apply({"params": params}, jnp.asarray(ids, jnp.int32),
                             **{k: jnp.asarray(v) for k, v in kw.items()})
    with torch.no_grad():
        t = _port_model(tcfg, state)(torch.from_numpy(ids),
                                     **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert t.dtype == tcfg.dtype and t.shape == (2, 24, 512)
    assert rel_err_norm(t.float().numpy(), np.asarray(j, np.float32)) <= bound


def test_causality(weights):
    _, state = weights
    _, tcfg = _cfgs("f32")
    model = _port_model(tcfg, state)
    a = np.random.default_rng(2).integers(0, 512, (1, 16))
    b = a.copy()
    b[:, 12:] = (b[:, 12:] + 1) % 512
    with torch.no_grad():
        out_a, out_b = (model(torch.from_numpy(x)) for x in (a, b))
    np.testing.assert_allclose(out_a[:, :12].numpy(), out_b[:, :12].numpy(), atol=1e-5)


def test_tied_head_matches_jax():
    params, state = _init(tie=True)
    assert "lm_head.weight" not in state
    jcfg, tcfg = _cfgs("f32", tie_word_embeddings=True)
    model = _port_model(tcfg, state)
    assert model.lm_head is None
    ids = np.random.default_rng(3).integers(0, 512, (2, 20))
    j = JaxLlama(jcfg).apply({"params": params}, jnp.asarray(ids, jnp.int32))
    with torch.no_grad():
        t = model(torch.from_numpy(ids))
    assert rel_err_norm(t.numpy(), np.asarray(j)) <= 1e-4


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("the card is there: the default takes it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LlamaForCausalLM(LlamaConfig.tiny())


def _hf_llama(**kw):
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    cfg = transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64, **kw)
    return transformers.LlamaForCausalLM(cfg).eval()


@pytest.mark.parametrize("tie", [False, True], ids=["untied", "tied"])
def test_transfer_hf_llama_matches_hf(tie):
    """The in-process config of the JAX package's HF parity test (GQA 4/2)."""
    hf = _hf_llama(tie_word_embeddings=tie)
    model, state, cfg = transfer_hf_llama(hf, dtype=torch.float32, device="cpu")
    assert cfg.num_key_value_heads == 2 and cfg.tie_word_embeddings == tie
    assert ("lm_head.weight" in state) != tie
    ids = torch.from_numpy(np.random.default_rng(4).integers(0, 128, (2, 24)))
    with torch.no_grad():
        ref = hf(ids).logits
        out = model(ids)
    assert rel_err_norm(out.numpy(), ref.numpy()) <= 1e-4


def test_transfer_bare_llama_model_ties_the_head():
    """A bare LlamaModel: keys without ``model.``, no head, so tied."""
    hf = _hf_llama()
    model, state, cfg = transfer_hf_llama(hf.model, dtype=torch.float32, device="cpu")
    assert cfg.tie_word_embeddings and model.lm_head is None
    ids = torch.from_numpy(np.random.default_rng(5).integers(0, 128, (1, 12)))
    with torch.no_grad():
        ref = hf.model(ids).last_hidden_state @ hf.model.embed_tokens.weight.T
        out = model(ids)
    assert rel_err_norm(out.numpy(), ref.numpy()) <= 1e-4
