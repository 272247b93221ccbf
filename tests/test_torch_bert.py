"""Port parity for BERT: the encoder against JAX's, HF transfer.

Weights come from the JAX ``BertModel.init(PRNGKey(0))`` at ``tiny()`` and
reach the port through ``models/from_jax.py::bert_params_from_jax``. The
port runs on the CPU with the plain versions of its kernels. Padded rows
differ by design between the two (neither defines them), so the sequence
output is compared on the kept rows.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photonic_flash_attention_tpu.config import get_config as jax_get_config
from photonic_flash_attention_tpu.models.bert import BertConfig as JaxConfig
from photonic_flash_attention_tpu.models.bert import BertModel as JaxBert
from photonic_flash_attention_tpu_torch.config import get_config, reset_config
from photonic_flash_attention_tpu_torch.models.bert import BertConfig, BertModel, transfer_hf_bert
from photonic_flash_attention_tpu_torch.models.from_jax import bert_params_from_jax

from .conftest import rel_err_norm

LENGTHS = (32, 24, 17)


@pytest.fixture(autouse=True)
def _one_thread_and_port_config():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    reset_config()
    yield
    reset_config()
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    variables = JaxBert(JaxConfig.tiny()).init(jax.random.PRNGKey(0),
                                               jnp.zeros((1, 8), jnp.int32))
    params = variables["params"]
    return params, bert_params_from_jax(jax.tree_util.tree_map(np.asarray, params))


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    b, s = len(LENGTHS), max(LENGTHS)
    ids = rng.integers(0, 512, (b, s))
    mask = (np.arange(s)[None] < np.asarray(LENGTHS)[:, None]).astype(np.int32)
    mask[0, 5] = 0  # a hole inside a row
    types = np.zeros((b, s), np.int64)
    types[:, s // 2:] = 1
    return ids, mask, types


@pytest.mark.parametrize("route", ["fused", "flash"])
@pytest.mark.parametrize("dtype, bound", [("f32", 1e-4), ("bf16", 2e-2)])
def test_encoder_matches_jax(weights, dtype, bound, route):
    """Sequence output (kept rows) and pooled output with a padding mask and
    token types; "flash" lowers the flash threshold in both packages, so the
    padding reaches the flash kernel as kv_lens/k_bias (K1's plain streams
    against JAX's kernel in interpret mode)."""
    if route == "flash":
        get_config().update(flash_threshold=16, flash_min_tokens=1)
        jax_get_config().update(flash_threshold=16, flash_min_tokens=1)
    params, state = weights
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    ids, mask, types = _inputs()
    j_seq, j_pool = JaxBert(dataclasses.replace(JaxConfig.tiny(), dtype=jdt)).apply(
        {"params": params}, jnp.asarray(ids, jnp.int32), jnp.asarray(mask),
        jnp.asarray(types, jnp.int32))
    model = BertModel(dataclasses.replace(BertConfig.tiny(), dtype=tdt), device="cpu")
    model.load_state_dict(state)
    with torch.no_grad():
        seq, pool = model(torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(types))
    assert seq.dtype == pool.dtype == tdt and seq.shape == (3, 32, 128)
    keep = mask.astype(bool)
    assert rel_err_norm(seq.float().numpy()[keep], np.asarray(j_seq, np.float32)[keep]) <= bound
    assert rel_err_norm(pool.float().numpy(), np.asarray(j_pool, np.float32)) <= bound


def test_unmasked_encoder_matches_jax(weights):
    params, state = weights
    ids = _inputs()[0]
    j_seq, j_pool = JaxBert(dataclasses.replace(JaxConfig.tiny(), dtype=jnp.float32)).apply(
        {"params": params}, jnp.asarray(ids, jnp.int32))
    model = BertModel(dataclasses.replace(BertConfig.tiny(), dtype=torch.float32), device="cpu")
    model.load_state_dict(state)
    with torch.no_grad():
        seq, pool = model(torch.from_numpy(ids))
    assert rel_err_norm(seq.numpy(), np.asarray(j_seq)) <= 1e-4
    assert rel_err_norm(pool.numpy(), np.asarray(j_pool)) <= 1e-4


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("the card is there: the default takes it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BertModel(BertConfig.tiny())


def _hf_bert(with_pooler: bool = True):
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    cfg = transformers.BertConfig(vocab_size=128, hidden_size=64, num_hidden_layers=2,
                                  num_attention_heads=4, intermediate_size=128,
                                  max_position_embeddings=64)
    return transformers.BertModel(cfg, add_pooling_layer=with_pooler).eval()


def test_transfer_hf_bert_matches_hf():
    """The in-process config of the JAX package's HF parity test: hidden
    states and pooler, then padding (kept rows; HF's additive mask leaks a
    little, so 1e-3 as there) and token types."""
    hf = _hf_bert()
    model, state, cfg = transfer_hf_bert(hf, dtype=torch.float32, device="cpu")
    assert cfg.hidden_size == 64 and "pooler.weight" in state
    rng = np.random.default_rng(1)
    ids = torch.from_numpy(rng.integers(0, 128, (2, 32)))
    mask = torch.ones(2, 32, dtype=torch.long)
    mask[:, 24:] = 0
    types = torch.zeros(2, 32, dtype=torch.long)
    types[:, 8:] = 1
    with torch.no_grad():
        ref = hf(ids)
        seq, pool = model(ids)
        assert rel_err_norm(seq.numpy(), ref.last_hidden_state.numpy()) <= 1e-4
        assert rel_err_norm(pool.numpy(), ref.pooler_output.numpy()) <= 1e-4
        ref = hf(ids, attention_mask=mask).last_hidden_state
        seq, _ = model(ids, attention_mask=mask)
        assert rel_err_norm(seq[:, :24].numpy(), ref[:, :24].numpy()) <= 1e-3
        ref = hf(ids, token_type_ids=types).last_hidden_state
        seq, _ = model(ids, token_type_ids=types)
        assert rel_err_norm(seq.numpy(), ref.numpy()) <= 1e-4


def test_transfer_hf_bert_without_pooler():
    model, state, _ = transfer_hf_bert(_hf_bert(with_pooler=False), dtype=torch.float32,
                                       device="cpu")
    assert model.pooler is None and not any(k.startswith("pooler") for k in state)
    with torch.no_grad():
        seq, pool = model(torch.zeros(1, 8, dtype=torch.long))
    assert pool is None and seq.shape == (1, 8, 64)
