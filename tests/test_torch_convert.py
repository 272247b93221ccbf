"""Port parity for the HF conversion: ``convert_to_photonic`` per family.

HF models of the four families are built in process from small configs
(those of the JAX package's HF parity tests), converted by the port and by
the JAX package: the port's module must reproduce HF's outputs, and its
report must count what JAX's counts.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from photonic_flash_attention_tpu.models.convert import (
    AttentionLayerDetector as JaxDetector,
    PhotonicConfig as JaxPhotonicConfig,
    convert_to_photonic as jax_convert,
)
from photonic_flash_attention_tpu_torch import convert_to_photonic as top_level_convert
from photonic_flash_attention_tpu_torch.models import (
    transfer_hf_bert,
    transfer_hf_llama,
    transfer_hf_t5,
)
from photonic_flash_attention_tpu_torch.models.convert import (
    AttentionLayerDetector,
    PhotonicConfig,
    _detect_family,
    convert_to_photonic,
)
from photonic_flash_attention_tpu_torch.models.gpt2 import transfer_hf_gpt2
from photonic_flash_attention_tpu_torch.utils.exceptions import ConfigurationError

from .conftest import rel_err_norm

transformers = pytest.importorskip("transformers")

FAMILIES = ("gpt2", "bert", "t5", "llama")


def _hf(family: str):
    torch.manual_seed(0)
    if family == "gpt2":
        return transformers.GPT2LMHeadModel(transformers.GPT2Config(
            vocab_size=128, n_positions=64, n_embd=64, n_layer=2, n_head=4, attn_pdrop=0.0,
            resid_pdrop=0.0, embd_pdrop=0.0)).eval()
    if family == "bert":
        return transformers.BertModel(transformers.BertConfig(
            vocab_size=128, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=128, max_position_embeddings=64)).eval()
    if family == "t5":
        return transformers.T5ForConditionalGeneration(transformers.T5Config(
            vocab_size=128, d_model=64, d_kv=16, d_ff=128, num_layers=2, num_decoder_layers=2,
            num_heads=4, dropout_rate=0.0)).eval()
    return transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64)).eval()


@pytest.fixture(scope="module")
def hf_models():
    return {family: _hf(family) for family in FAMILIES}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: Attention layers the detector finds in each two-layer model: GPT-2's and
#: Llama's one a block, BERT's one a layer, T5's self- and cross-attention.
LAYERS = {"gpt2": 2, "bert": 2, "t5": 6, "llama": 2}


@pytest.mark.parametrize("family", FAMILIES)
def test_detector_matches_jax(hf_models, family):
    model = hf_models[family]
    found = AttentionLayerDetector.find_attention_layers(model)
    assert [p for p, _ in found] == [p for p, _ in JaxDetector.find_attention_layers(model)]
    assert len(found) == LAYERS[family]
    assert _detect_family(model) == family


def _outputs(family, hf, module, rng):
    """(HF's output, the port's) on the same random ids."""
    ids = torch.from_numpy(rng.integers(0, 128, (2, 16)))
    with torch.no_grad():
        if family == "bert":
            return hf(ids).last_hidden_state, module(ids)[0]
        if family == "t5":
            dec = torch.from_numpy(rng.integers(0, 128, (2, 12)))
            return hf(input_ids=ids, decoder_input_ids=dec).logits, module(ids, dec)
        return hf(ids).logits, module(ids)


@pytest.mark.parametrize("family", FAMILIES)
def test_convert_matches_hf_and_jax_report(hf_models, family):
    hf = hf_models[family]
    module, state, report = convert_to_photonic(hf, PhotonicConfig(dtype=torch.float32), device="cpu")
    assert isinstance(module, nn.Module) and module.state_dict().keys() == state.keys()
    ref, out = _outputs(family, hf, module, np.random.default_rng(0))
    assert rel_err_norm(out.numpy(), ref.numpy()) <= 1e-4
    _, _, j_report = jax_convert(hf, JaxPhotonicConfig(dtype=jnp.float32))
    for field in ("model_family", "total_attention_layers", "converted_layers",
                  "skipped_layers", "parameters_transferred", "warnings"):
        assert getattr(report, field) == getattr(j_report, field), field
    assert report.conversion_rate == 1.0 and report.model_family == family
    assert family in report.summary()


@pytest.mark.parametrize("family", FAMILIES)
def test_default_device_is_the_card(hf_models, family):
    """``convert_to_photonic`` and the family's ``transfer_hf_*`` build on
    the card unless given a device: without CUDA the default raises."""
    if torch.cuda.is_available():
        pytest.skip("the card is there: the default takes it")
    transfer = {"gpt2": transfer_hf_gpt2, "bert": transfer_hf_bert, "t5": transfer_hf_t5,
                "llama": transfer_hf_llama}[family]
    for call in (convert_to_photonic, transfer):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call(hf_models[family])


def test_convert_places_the_model_on_the_given_device(hf_models):
    module, state, _ = convert_to_photonic(hf_models["llama"], device=torch.device("cpu"))
    assert {t.device.type for t in state.values()} == {"cpu"}
    assert next(module.parameters()).device.type == "cpu"


def test_top_level_export_is_the_models_function():
    assert top_level_convert is convert_to_photonic


def test_unknown_family_raises():
    class Custom(nn.Module):
        def __init__(self):
            super().__init__()
            self.mha = nn.MultiheadAttention(16, 2)

    with pytest.raises(ConfigurationError, match="unknown.*1 attention layers"):
        convert_to_photonic(Custom(), device="cpu")


def test_transfer_bare_gpt2_model():
    """A bare GPT2Model (keys without ``transformer.``): the port's tied head
    over HF's hidden states."""
    hf = _hf("gpt2").transformer
    model, state, cfg = transfer_hf_gpt2(hf, dtype=torch.float32, device="cpu")
    assert cfg.n_layer == 2 and state["h.0.attn.q_proj.weight"].shape == (64, 64)
    ids = torch.from_numpy(np.random.default_rng(1).integers(0, 128, (2, 16)))
    with torch.no_grad():
        ref = hf(ids).last_hidden_state @ hf.wte.weight.T
        out = model(ids)
    assert rel_err_norm(out.numpy(), ref.numpy()) <= 1e-4
