"""Port parity: the T5 encoder-decoder forward.

Weights come from the JAX ``T5ForConditionalGeneration.init(PRNGKey(0))``
(the gated-gelu variant swaps in a seeded second input kernel) and reach
the port through ``models/from_jax.py::t5_params_from_jax``. The port runs
on the CPU with the plain versions of its kernels. Logits are held against
``model.apply`` for the unmasked stacks on the fused path (the default
``flash_threshold``), on the relative-bias flash path (the threshold
lowered in both packages: K1's relative-bias mode here, the Pallas
far/band pair in interpret mode there) and for masked stacks:
``rel_err_norm`` <= 1e-5 in fp32, and the fused route in bf16 <= 2e-2.
Then the HF model of an in-process ``transformers.T5Config`` through
``transfer_hf_t5`` (the JAX HF test's bounds).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photonic_flash_attention_tpu.config import get_config as jax_get_config
from photonic_flash_attention_tpu.models.t5 import (
    T5Config as JaxT5Config,
    T5ForConditionalGeneration as JaxT5,
)
from photonic_flash_attention_tpu_torch.config import get_config, reset_config
from photonic_flash_attention_tpu_torch.models.from_jax import t5_params_from_jax
from photonic_flash_attention_tpu_torch.models.t5 import (
    T5Config,
    T5ForConditionalGeneration,
    T5Model,
    transfer_hf_t5,
)

from .conftest import rel_err_norm

DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5), "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


@pytest.fixture(autouse=True)
def _fresh():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    reset_config()
    yield
    reset_config()
    torch.set_num_threads(n)


def _gated(params):
    """The relu tree with each ``ffn/wi`` replaced by a gated-gelu pair:
    ``wi_0`` the relu kernel, ``wi_1`` seeded noise of its shape."""
    rng = np.random.default_rng(7)
    tree = jax.tree_util.tree_map(np.asarray, params)
    for stack in ("encoder", "decoder"):
        ffn = tree["model"][stack]["blocks"]["block"]["ffn"]
        wi = ffn.pop("wi")["kernel"]
        ffn["wi_0"] = {"kernel": wi}
        ffn["wi_1"] = {"kernel": (rng.standard_normal(wi.shape) * 0.1).astype(np.float32)}
    return tree


@pytest.fixture(scope="module")
def weights():
    """(JAX params, port state_dict) of T5 tiny (relu) from PRNGKey(0), and
    of its gated-gelu variant."""
    params = JaxT5(JaxT5Config.tiny()).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32),
                                            jnp.zeros((1, 4), jnp.int32))["params"]
    gated = _gated(params)
    return {ff: (tree, t5_params_from_jax(jax.tree_util.tree_map(np.asarray, tree)))
            for ff, tree in (("relu", params), ("gated-gelu", gated))}


def _port(state, dtype=torch.float32, ff="relu"):
    cfg = dataclasses.replace(T5Config.tiny(), dtype=dtype, feed_forward_proj=ff)
    model = T5ForConditionalGeneration(cfg)
    model.load_state_dict(state)
    return model


def test_t5_params_from_jax(weights):
    params, state = weights["relu"]
    model = T5ForConditionalGeneration(T5Config.tiny())
    assert set(state) == set(model.state_dict())
    for name, t in model.state_dict().items():
        assert state[name].shape == t.shape and state[name].dtype == torch.float32, name
    blk = params["model"]["decoder"]["blocks"]["block"]
    np.testing.assert_array_equal(state["model.decoder.blocks.1.cross_attn.k.weight"].numpy(),
                                  np.asarray(blk["cross_attn"]["k"]["kernel"][1]).T)
    np.testing.assert_array_equal(state["model.decoder.blocks.0.ffn_ln.weight"].numpy(),
                                  np.asarray(blk["ffn_ln"]["scale"][0]))
    np.testing.assert_array_equal(
        state["model.encoder.rel_bias.rel_embedding"].numpy(),
        np.asarray(params["model"]["encoder"]["rel_bias"]["rel_embedding"]))
    assert state["model.encoder.rel_bias.rel_embedding"].shape == (32, 4)
    gated = weights["gated-gelu"][1]
    assert "model.encoder.blocks.0.ffn.wi_1.weight" in gated and "model.encoder.blocks.0.ffn.wi.weight" not in gated


def _inputs(seed=0, s_enc=24, s_dec=16, b=2):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 512, (b, s_enc)), rng.integers(0, 512, (b, s_dec))


@pytest.mark.parametrize("route, dtype", [("fused", "f32"), ("flash_rel_bias", "f32"),
                                          ("masked", "f32"), ("fused", "bf16")])
def test_logits_match_flax(weights, route, dtype):
    params, state = weights["relu"]
    jdt, tdt, bound = DTYPES[dtype]
    enc, dec = _inputs()
    kw = {}
    if route == "flash_rel_bias":  # both stacks and the cross-attention on flash
        get_config().update(flash_threshold=16, flash_min_tokens=1)
        jax_get_config().update(flash_threshold=16, flash_min_tokens=1)
    if route == "masked":
        mask = np.ones((2, 24), np.int64)
        mask[1, 17:] = 0
        dmask = np.ones((2, 16), np.int64)
        dmask[0, 12:] = 0
        kw = dict(attention_mask=mask, decoder_attention_mask=dmask)
    jcfg = dataclasses.replace(JaxT5Config.tiny(), dtype=jdt)
    want = JaxT5(jcfg).apply({"params": params}, jnp.asarray(enc, jnp.int32),
                             jnp.asarray(dec, jnp.int32),
                             **{k: jnp.asarray(v) for k, v in kw.items()})
    with torch.no_grad():
        got = _port(state, tdt)(torch.from_numpy(enc), torch.from_numpy(dec),
                                **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert got.dtype == tdt and got.shape == (2, 16, 512)
    assert rel_err_norm(got.float().numpy(), np.asarray(want, np.float32)) <= bound


def test_grads_match_flax_on_the_rel_bias_flash_route(weights, monkeypatch):
    """The gradient of a seq2seq cross entropy over every parameter, both
    ``rel_embedding`` tables included, against ``jax.grad`` of the Flax
    model, ``flash_threshold`` lowered in both packages: the stacks'
    self-attention on the relative-bias flash route (K1's relative-bias
    mode with lse and the blockwise backward here, the Pallas far/band pair
    and the XLA ``_flash_bwd`` there), the cross-attention on plain flash.
    fp32, ``rel_err_norm`` <= 5e-4 per parameter (the JAX rel-bias
    gradient tests' bound)."""
    from photonic_flash_attention_tpu_torch.ops import flash as port_flash

    params, state = weights["relu"]
    enc, dec = _inputs(seed=3)
    labels = np.random.default_rng(4).integers(0, 512, dec.shape)
    get_config().update(flash_threshold=16, flash_min_tokens=1)
    jax_get_config().update(flash_threshold=16, flash_min_tokens=1)
    jcfg = dataclasses.replace(JaxT5Config.tiny(), dtype=jnp.float32)

    def jax_loss(p):
        logits = JaxT5(jcfg).apply({"params": p}, jnp.asarray(enc, jnp.int32),
                                   jnp.asarray(dec, jnp.int32))
        logp = jax.nn.log_softmax(logits, axis=-1)
        return -jnp.mean(jnp.take_along_axis(logp, jnp.asarray(labels)[..., None], -1))

    want = t5_params_from_jax(jax.tree_util.tree_map(np.asarray, jax.grad(jax_loss)(params)))
    model = _port(state)
    calls = []
    rel_fn = port_flash._FlashAttentionRelFn.apply
    monkeypatch.setattr(port_flash._FlashAttentionRelFn, "apply",
                        lambda *a: calls.append(1) or rel_fn(*a))
    logits = model(torch.from_numpy(enc), torch.from_numpy(dec))
    logp = torch.log_softmax(logits.float(), dim=-1)
    loss = -logp.gather(-1, torch.from_numpy(labels)[..., None]).mean()
    loss.backward()
    assert len(calls) == 4  # 2 encoder + 2 decoder self-attentions
    names = [n for n, _ in model.named_parameters()]
    assert sorted(names) == sorted(want)
    for name, p in model.named_parameters():
        assert rel_err_norm(p.grad.numpy(), want[name].numpy()) <= 5e-4, name
    assert float(model.model.encoder.rel_bias.rel_embedding.grad.abs().max()) > 0


def test_gated_gelu_logits_match_flax(weights):
    params, state = weights["gated-gelu"]
    enc, dec = _inputs(seed=1)
    jcfg = dataclasses.replace(JaxT5Config.tiny(), dtype=jnp.float32, feed_forward_proj="gated-gelu")
    want = JaxT5(jcfg).apply({"params": jax.tree_util.tree_map(jnp.asarray, params)},
                             jnp.asarray(enc, jnp.int32), jnp.asarray(dec, jnp.int32))
    with torch.no_grad():
        got = _port(state, ff="gated-gelu")(torch.from_numpy(enc), torch.from_numpy(dec))
    assert rel_err_norm(got.numpy(), np.asarray(want)) <= 1e-5


def test_decoder_is_causal(weights):
    _, state = weights["relu"]
    model = _port(state)
    enc, dec = _inputs(seed=2, b=1, s_dec=12)
    dec_b = dec.copy()
    dec_b[:, 8:] = (dec_b[:, 8:] + 1) % 512
    with torch.no_grad():
        a = model(torch.from_numpy(enc), torch.from_numpy(dec))
        b = model(torch.from_numpy(enc), torch.from_numpy(dec_b))
    torch.testing.assert_close(a[:, :8], b[:, :8], atol=1e-5, rtol=0)


def _hf_pair(lm_head):
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    hf_cfg = transformers.T5Config(vocab_size=128, d_model=64, d_kv=16, d_ff=128, num_layers=2,
                                   num_decoder_layers=2, num_heads=4, dropout_rate=0.0)
    cls = transformers.T5ForConditionalGeneration if lm_head else transformers.T5Model
    hf = cls(hf_cfg).eval()
    return hf, transfer_hf_t5(hf, dtype=torch.float32, device="cpu")


@pytest.mark.parametrize("lm_head", [False, True], ids=["decoder_states", "lm_logits"])
def test_hf_parity(lm_head):
    hf, (model, state, cfg) = _hf_pair(lm_head)
    assert isinstance(model, T5ForConditionalGeneration if lm_head else T5Model)
    assert set(state) == set(model.state_dict()) and cfg.vocab_size == 128
    rng = np.random.default_rng(0)
    enc = torch.from_numpy(rng.integers(0, 128, (2, 24)))
    dec = torch.from_numpy(rng.integers(0, 128, (2, 16)))
    with torch.no_grad():
        out = hf(input_ids=enc, decoder_input_ids=dec)
        ref = out.logits if lm_head else out.last_hidden_state
        got = model(enc, dec)
    assert rel_err_norm(got.numpy(), ref.numpy()) < 1e-4


def test_hf_parity_encoder_padding():
    hf, (model, _, _) = _hf_pair(False)
    rng = np.random.default_rng(1)
    enc = torch.from_numpy(rng.integers(0, 128, (2, 24)))
    dec = torch.from_numpy(rng.integers(0, 128, (2, 8)))
    mask = torch.ones(2, 24, dtype=torch.long)
    mask[:, 16:] = 0
    with torch.no_grad():
        ref = hf(input_ids=enc, attention_mask=mask, decoder_input_ids=dec).last_hidden_state
        got = model(enc, dec, attention_mask=mask)
    # HF adds a finite large negative mask (small leakage); the port's is exact.
    assert rel_err_norm(got.numpy(), ref.numpy()) < 1e-3


def test_random_init_is_seeded_and_finite():
    cfg = T5Config.tiny()
    a = T5ForConditionalGeneration(cfg, generator=torch.Generator().manual_seed(0))
    b = T5ForConditionalGeneration(cfg, generator=torch.Generator().manual_seed(0))
    for (n, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), n
    sd = a.state_dict()
    assert abs(float(sd["model.shared"].std()) - 1.0) < 0.05
    assert float(sd["model.encoder.rel_bias.rel_embedding"].std()) < 0.05
    assert torch.equal(sd["model.decoder.final_ln.weight"], torch.ones(64))
    enc, dec = _inputs()
    with torch.no_grad():
        logits = a(torch.from_numpy(enc), torch.from_numpy(dec))
    assert logits.shape == (2, 16, 512) and torch.isfinite(logits.float()).all()
