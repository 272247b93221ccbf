"""Port parity: T5 serving (paged decoder self-attention with the token bias).

``paged_decode_attention(token_bias=...)`` against the JAX function (its
Pallas kernel in interpret mode) after the pool layout conversion, for
bf16 and int8 pools; ``t5_prefill_step``/``t5_decode_step`` logits against
the JAX steps (fp32 within 1e-5, bf16 weights over an int8 pool within
2e-2); the served greedy tokens against the JAX ``ServingEngine`` on T5
tiny; and the five cases of ``tests/integration/test_t5_serving.py``,
ported, against the port's dense ``T5ForConditionalGeneration`` with the
JAX test's greedy-parity rule. Weights come from the JAX init through
``t5_params_from_jax``; the port runs on the CPU (plain versions).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photonic_flash_attention_tpu.core.serving import ServingEngine as JaxEngine
from photonic_flash_attention_tpu.models.t5 import (
    T5Config as JaxT5Config,
    T5ForConditionalGeneration as JaxT5,
)
from photonic_flash_attention_tpu.models.t5_serving import (
    create_t5_pages as jax_create_pages,
    t5_decode_step as jax_decode_step,
    t5_prefill_step as jax_prefill_step,
)
from photonic_flash_attention_tpu.ops.paged import paged_decode_attention as jax_paged_decode
from photonic_flash_attention_tpu_torch.core.serving import ServingEngine
from photonic_flash_attention_tpu_torch.models.from_jax import t5_params_from_jax
from photonic_flash_attention_tpu_torch.models.t5 import T5Config, T5ForConditionalGeneration
from photonic_flash_attention_tpu_torch.models.t5_serving import (
    DECODER_START_TOKEN_ID,
    create_t5_pages,
    prepare_params,
    t5_decode_step,
    t5_prefill_step,
)
from photonic_flash_attention_tpu_torch.ops.paged import paged_decode_attention, to_jax_layout
from photonic_flash_attention_tpu_torch.utils.exceptions import KVCacheError

from .conftest import rel_err_norm

PAGE = 16


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    """(JAX params, port state_dict) of T5 tiny from PRNGKey(0)."""
    params = JaxT5(JaxT5Config.tiny()).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32), jnp.zeros((1, 4), jnp.int32)
    )["params"]
    return params, t5_params_from_jax(jax.tree_util.tree_map(np.asarray, params))


@pytest.fixture(scope="module")
def dense(weights):
    """The port's dense bf16 T5 tiny: the serving oracle."""
    model = T5ForConditionalGeneration(T5Config.tiny())
    model.load_state_dict(weights[1])
    return model


# -- K3's token-bias mode: plain version against the JAX kernel ---------------


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_paged_decode_token_bias_matches_jax(kv):
    rng = np.random.default_rng(0)
    L, H, P, D, b, pps = 2, 4, 16, 16, 3, 4
    lengths = np.array([5, 33, 1], np.int32)
    tables = (rng.permutation(P - 1)[: b * pps] + 1).reshape(b, pps).astype(np.int32)
    slots = np.array([tables[i, (n - 1) // PAGE] * PAGE + (n - 1) % PAGE
                      for i, n in enumerate(lengths)], np.int32)
    q, kn, vn = (rng.standard_normal((b, H, D)).astype(np.float32) for _ in range(3))
    bias = (rng.standard_normal((b, H, 50)) * 2).astype(np.float32)  # shorter than 4 pages
    quant = kv == "int8"
    jdt, tdt = (jnp.int8, torch.int8) if quant else (jnp.bfloat16, torch.bfloat16)
    pools = [rng.integers(-127, 128, (L, H, P, PAGE, D)).astype(np.float32) if quant
             else rng.standard_normal((L, H, P, PAGE, D)).astype(np.float32) for _ in range(2)]
    scales = [(rng.random((L, H, P, PAGE)) * 0.05 + 1e-3).astype(np.float32) for _ in range(2)]
    tk, tv = (torch.from_numpy(x).to(tdt) for x in pools)
    ts = [torch.from_numpy(s.copy()) for s in scales] if quant else [None, None]
    jk, jv = (jnp.asarray(np.asarray(to_jax_layout(t).float()), jdt) for t in (tk, tv))
    js = [jnp.asarray(s) for s in scales] if quant else [None, None]
    knew, vnew = (x.astype(np.float32) for x in (kn, vn))
    outs = jax_paged_decode(
        jnp.asarray(q), jnp.asarray(knew, jnp.bfloat16), jnp.asarray(vnew, jnp.bfloat16), jk, jv,
        jnp.asarray(lengths), jnp.asarray(tables), jnp.asarray(slots), jnp.int32(1), *js,
        sm_scale=1.0, token_bias=jnp.asarray(bias),
    )
    got = paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(knew).to(torch.bfloat16),
        torch.from_numpy(vnew).to(torch.bfloat16), tk, tv, torch.from_numpy(lengths),
        torch.from_numpy(tables), torch.from_numpy(slots), 1, *ts, sm_scale=1.0,
        token_bias=torch.from_numpy(bias),
    )
    assert rel_err_norm(got.numpy(), np.asarray(outs[0])) <= 1e-5
    for t, j in zip((tk, tv), outs[1:3]):  # the written token, in JAX's layout
        np.testing.assert_array_equal(to_jax_layout(t).float().numpy(), np.asarray(j, np.float32))
    # Without the bias the output moves: the bias is really applied.
    plain = paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(knew).to(torch.bfloat16),
        torch.from_numpy(vnew).to(torch.bfloat16), tk, tv, torch.from_numpy(lengths),
        torch.from_numpy(tables), torch.from_numpy(slots), 1, *ts, sm_scale=1.0)
    assert rel_err_norm(plain.numpy(), got.numpy()) > 1e-2


# -- the serving steps against the JAX steps ----------------------------------


@pytest.mark.parametrize("model_dtype, kv, bound", [("f32", "f32", 1e-5), ("bf16", "int8", 2e-2)])
def test_prefill_and_decode_logits_match_jax(weights, model_dtype, kv, bound):
    params, state = weights
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[model_dtype]
    kjdt, ktdt = {"f32": (jnp.float32, torch.float32), "int8": (jnp.int8, torch.int8)}[kv]
    quant = kv == "int8"
    jcfg = dataclasses.replace(JaxT5Config.tiny(), dtype=jdt)
    tcfg = dataclasses.replace(T5Config.tiny(), dtype=tdt)
    tp = prepare_params(state, tcfg, "cpu")
    kw = dict(max_batch=2, enc_max_len=32)
    jpages = jax_create_pages(jcfg, 8, PAGE, kjdt, **kw)
    tpages = create_t5_pages(tcfg, 8, PAGE, ktdt, device="cpu", **kw)
    rng = np.random.default_rng(5)
    tables = np.array([[1, 2], [3, 4]], np.int32)
    lens = [13, 7]
    for slot, n in enumerate(lens):  # prefill both slots
        ids = np.zeros((1, 16), np.int32)
        ids[0, :n] = rng.integers(2, 512, n)
        dec0 = np.array([tables[slot, 0] * PAGE], np.int32)
        j_logits, jpages = jax_prefill_step(
            {"model": params["model"]}, jcfg, jnp.asarray(ids), jnp.asarray([n], jnp.int32), jpages,
            jnp.asarray(dec0), jnp.asarray(tables[slot:slot + 1]), quant, jnp.int32(slot))
        t_logits = t5_prefill_step(
            tp, tcfg, torch.from_numpy(ids), torch.tensor([n], dtype=torch.int32), tpages,
            torch.from_numpy(dec0), torch.from_numpy(tables[slot:slot + 1]), quant, slot)
        assert rel_err_norm(t_logits.numpy(), np.asarray(j_logits)) <= bound
    assert tpages.enc_len.tolist() == lens
    for step in range(3):  # decode positions 1..3 of both slots
        ids = rng.integers(2, 512, 2).astype(np.int32)
        pos = np.full((2,), step + 1, np.int32)
        flat = tables[:, 0] * PAGE + pos
        lengths = pos + 1
        j_logits, jpages = jax_decode_step(
            {"model": params["model"]}, jcfg, jnp.asarray(ids), jnp.asarray(pos), jpages,
            jnp.asarray(flat), jnp.asarray(lengths), jnp.asarray(tables), quant)
        t_logits = t5_decode_step(
            tp, tcfg, torch.from_numpy(ids), torch.from_numpy(pos), tpages,
            torch.from_numpy(flat.astype(np.int32)), torch.from_numpy(lengths),
            torch.from_numpy(tables), quant)
        assert rel_err_norm(t_logits.numpy(), np.asarray(j_logits)) <= bound


def test_greedy_tokens_match_jax_engine(weights):
    params, state = weights
    rng = np.random.default_rng(42)
    prompts = [rng.integers(2, 512, n).tolist() for n in (5, 11, 3, 30)]
    kw = dict(num_pages=64, page_size=PAGE, max_batch=4, enc_max_len=32)
    want = JaxEngine(JaxT5Config.tiny(), params, **kw).generate(prompts, max_new_tokens=8)
    got = ServingEngine(T5Config.tiny(), state, device="cpu", **kw).generate(prompts, max_new_tokens=8)
    assert got == want


# -- the five cases of tests/integration/test_t5_serving.py -------------------


def _dense_logits(model, enc_prompt, dec):
    with torch.no_grad():
        return model(torch.tensor([enc_prompt]), torch.tensor([dec]))[0, -1].float()


def dense_greedy_t5(model, enc_prompt, n_new):
    """Oracle: greedy decode by a full encoder + decoder re-forward."""
    dec = [DECODER_START_TOKEN_ID]
    for _ in range(n_new):
        dec.append(int(torch.argmax(_dense_logits(model, enc_prompt, dec))))
    return dec[1:]


def assert_greedy_parity(model, enc_prompt, served, tol=0.05):
    """The JAX test's rule: along the SERVED trajectory each token's oracle
    logit is within ``tol`` of the oracle's best (bf16 ties of an untrained
    model make the argmax order unspecified)."""
    dec = [DECODER_START_TOKEN_ID]
    for i, tok in enumerate(served):
        lg = _dense_logits(model, enc_prompt, dec)
        assert float(lg[tok]) >= float(lg.max()) - tol, f"step {i}: served {tok}"
        dec.append(tok)


def _engine(state, **kw):
    return ServingEngine(T5Config.tiny(), state, device="cpu", page_size=PAGE, **kw)


def test_bf16_matches_dense_greedy(weights, dense):
    rng = np.random.default_rng(42)
    prompts = [rng.integers(2, 512, n).tolist() for n in (5, 11, 3)]
    outs = _engine(weights[1], num_pages=64, max_batch=4, enc_max_len=32).generate(
        prompts, max_new_tokens=8)
    for p, o in zip(prompts, outs):
        assert_greedy_parity(dense, p, o)


def test_int8_kv_first_token_matches(weights, dense):
    prompt = np.random.default_rng(43).integers(2, 512, 9).tolist()
    eng = _engine(weights[1], num_pages=64, max_batch=2, kv_dtype=torch.int8, enc_max_len=32)
    outs = eng.generate([prompt], max_new_tokens=4)
    assert len(outs[0]) == 4
    assert outs[0][0] == dense_greedy_t5(dense, prompt, 1)[0]


def test_page_accounting_is_decoder_only(weights, dense):
    """A long encoder prompt takes no KV pages: it lives in the pinned cross
    buffers. 30 encoder tokens would need 2 pages as a causal prompt; the
    decoder's 1 + 8 tokens need 1."""
    prompt = np.random.default_rng(44).integers(2, 512, 30).tolist()
    eng = _engine(weights[1], num_pages=4, max_batch=1, max_pages_per_seq=2, enc_max_len=32)
    outs = eng.generate([prompt], max_new_tokens=8)
    assert_greedy_parity(dense, prompt, outs[0])
    assert eng.status()["pages_free"] == eng.status()["pages_total"]


def test_slot_reuse_after_retirement(weights, dense):
    """The second request's prefill overwrites the retired one's cross
    buffers in the same slot."""
    rng = np.random.default_rng(45)
    p1, p2 = rng.integers(2, 512, 6).tolist(), rng.integers(2, 512, 13).tolist()
    eng = _engine(weights[1], num_pages=16, max_batch=1, enc_max_len=32)
    o1 = eng.generate([p1], max_new_tokens=5)[0]
    o2 = eng.generate([p2], max_new_tokens=5)[0]
    assert_greedy_parity(dense, p1, o1)
    assert_greedy_parity(dense, p2, o2)
    assert int(eng.pages.enc_len[0]) == len(p2)


def test_oversized_prompt_rejected(weights):
    eng = _engine(weights[1], num_pages=16, max_batch=1, enc_max_len=16)
    with pytest.raises(KVCacheError, match="enc_max_len"):
        eng.submit(list(range(2, 22)), max_new_tokens=2)


def test_prompt_bucket_capped_at_enc_max_len(weights, dense):
    """A 20-token prompt with enc_max_len 24: its power-of-two bucket (32)
    passes enc_max_len, so the prefill pads to 24 instead; the request is
    served to completion and frees its slot and pages. (The JAX engine pads
    to 32 and its prefill step then refuses the request, which keeps its
    slot and pages: ROADMAP Queue C.)"""
    prompt = np.random.default_rng(46).integers(2, 512, 20).tolist()
    eng = _engine(weights[1], num_pages=16, max_batch=1, enc_max_len=24)
    outs = eng.generate([prompt], max_new_tokens=5)
    assert len(outs[0]) == 5
    assert_greedy_parity(dense, prompt, outs[0])
    st = eng.status()
    assert st["active"] == 0 and st["pages_free"] == st["pages_total"]


def test_t5_engine_surface(weights):
    """No chunked prefill for T5 (as JAX); the status names the family."""
    with pytest.raises(ValueError, match="no chunked-prefill step"):
        _engine(weights[1], num_pages=16, prefill_chunk=PAGE)
    st = _engine(weights[1], num_pages=16, enc_max_len=64).status()
    assert st["family"] == "encdec" and st["enc_max_len"] == 64
