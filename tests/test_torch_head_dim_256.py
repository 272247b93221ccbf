"""Port parity at the head dims 129-256 that the card serves: K1's bf16 plain
and key-stream modes and K3 over int8 and bf16 pools on D 256.

The JAX kernels pad a head dim past 128 to a multiple of 128
(``ops/flash.py::_pad_head_dim``) and its paged decode has no head-dim
limit; the port runs 129-256 on its D 256 instantiations of K1 and K3 and
refuses every other kernel and mode there (``ops/_build.py::head_dim_plan``,
``WIDE_KERNELS``). Here, on the CPU, the same numpy inputs (made from a
seed) go through the JAX functions (Pallas in interpret mode) and the port's
plain versions at d in {136, 180, 192, 256}, 8 query heads over 1 KV head
(Gemma-2B's group), and Llama at d 256 (hidden 512, 2 heads over 1 KV head)
through both packages' dense forward and serving engine.

Bounds: fp32 forward and lse ``rel_err_norm`` 1e-5; bf16 forward
``assert_close`` (2e-2, ``test_torch_flash``); key streams ``rel_err_norm``
1e-5 (``test_torch_flash_masked``); paged decode ``rel_err_norm`` 1e-4 and
the pools after the write bit-equal (``test_torch_paged``); Llama fp32
logits 1e-4 (``test_torch_llama``) and fp32 served tokens equal
(``test_torch_llama_serving``). Kept apart from ``test_torch_head_dims.py``
so that the driver's ``--dist loadfile`` gives the two files to two workers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photonic_flash_attention_tpu.config import (
    get_config as jax_get_config,
    reset_config as jax_reset_config,
)
from photonic_flash_attention_tpu.core.serving import ServingEngine as JaxEngine
from photonic_flash_attention_tpu.models.llama import (
    LlamaConfig as JaxConfig,
    LlamaForCausalLM as JaxLlama,
)
from photonic_flash_attention_tpu.ops.flash import (
    flash_attention as jax_flash,
    flash_attention_with_lse as jax_flash_lse,
)
from photonic_flash_attention_tpu.ops.paged import paged_decode_attention as jax_paged_decode
from photonic_flash_attention_tpu_torch.config import get_config, reset_config
from photonic_flash_attention_tpu_torch.core.engine import AttentionEngine
from photonic_flash_attention_tpu_torch.core.router import (
    AdaptiveRouter,
    KernelKind,
    WorkloadCharacteristics,
)
from photonic_flash_attention_tpu_torch.core.serving import ServingEngine
from photonic_flash_attention_tpu_torch.models.from_jax import llama_params_from_jax
from photonic_flash_attention_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from photonic_flash_attention_tpu_torch.ops import _build, flash as flash_ops
from photonic_flash_attention_tpu_torch.ops import flash_bwd as bwd_ops
from photonic_flash_attention_tpu_torch.ops import paged as paged_ops
from photonic_flash_attention_tpu_torch.ops.flash import flash_attention, flash_attention_with_lse
from photonic_flash_attention_tpu_torch.ops.paged import (
    k3_plan,
    k3_smem,
    paged_decode_attention,
    to_jax_layout,
)
from photonic_flash_attention_tpu_torch.ops.reference import DEFAULT_MASK_VALUE

from .conftest import assert_close, rel_err_norm

WIDE_DIMS = (136, 180, 192, 256)
F32 = (jnp.float32, torch.float32)
BF16 = (jnp.bfloat16, torch.bfloat16)


@pytest.fixture(autouse=True)
def _one_thread_and_configs():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    reset_config()
    jax_reset_config()
    yield
    reset_config()
    jax_reset_config()
    torch.set_num_threads(n)


def _arrays(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


# -- K1's plain versions against the JAX kernel --------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("d", WIDE_DIMS)
def test_forward_and_lse_match_jax(d, causal, dtype):
    """flash_attention_with_lse at B1 Sq40 Skv72 (causal: aligned to the
    end) or Sq72 Skv40, 8 query heads over 1 KV head, against the JAX kernel
    in interpret mode (head dim padded to 256 there); fp32 rel_err_norm
    1e-5, bf16 assert_close; then flash_attention equal to it."""
    jdt, tdt = F32 if dtype == "f32" else BF16
    sq, skv = (40, 72) if causal else (72, 40)
    arrs = _arrays([(1, sq, 8, d), (1, skv, 1, d), (1, skv, 1, d)], seed=d + causal)
    q, k, v = (torch.from_numpy(a).to(tdt) for a in arrs)
    out, lse = flash_attention_with_lse(q, k, v, causal=causal)
    ref, ref_lse = jax_flash_lse(*(jnp.asarray(a, jdt) for a in arrs), causal=causal)
    assert out.shape == (1, sq, 8, d) and lse.shape == (1, 8, sq)
    for got, want in ((out, ref), (lse, ref_lse)):
        a, b = got.float().numpy(), np.asarray(want, np.float32)
        if dtype == "f32":
            assert rel_err_norm(a, b) <= 1e-5
        else:
            assert_close(a, b)
    assert torch.equal(flash_attention(q, k, v, causal=causal), out)


def test_key_streams_match_jax():
    """kv_lens and k_bias together at d 256 (a row of one key, bias holes),
    fp32, rel_err_norm 1e-5."""
    b, sq, skv, d = 3, 48, 80, 256
    q, k, v = _arrays([(b, sq, 8, d), (b, skv, 1, d), (b, skv, 1, d)], seed=9)
    rng = np.random.default_rng(10)
    lens = np.array([skv, 37, 1], np.int32)
    bias = np.where(rng.random((b, skv)) < 0.2, DEFAULT_MASK_VALUE,
                    rng.standard_normal((b, skv))).astype(np.float32)
    bias[:, 0] = 0.0
    out = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=True,
                          kv_lens=torch.from_numpy(lens), k_bias=torch.from_numpy(bias))
    ref = jax_flash(*(jnp.asarray(a) for a in (q, k, v)), causal=True,
                    kv_lens=jnp.asarray(lens), k_bias=jnp.asarray(bias))
    assert rel_err_norm(out.numpy(), np.asarray(ref)) <= 1e-5


# -- K3: the plan, and the plain decode against JAX's fused kernel --------------


@pytest.mark.parametrize("elt", [1, 2])
@pytest.mark.parametrize("hq, hkv", [(16, 16), (64, 8)], ids=["group1", "group8"])
def test_k3_plan_at_d256(elt, hq, hkv):
    """K3's plan at D 256 over int8 and bf16 pools: a power-of-two tile that
    fills at most one stage, two (int8) or four (bf16) heads a CTA in a
    group of 8, the D 256 state counted, inside the card's shared memory;
    an fp32 pool refused naming d and A17."""
    plan = k3_plan(8, hq, hkv, 256, elt, 16, 128)
    assert 2 * plan.tile * 256 * elt <= paged_ops._K3_STAGE_BYTES
    assert plan.tile & (plan.tile - 1) == 0 and plan.tile % 16 == 0
    assert plan.gcmax == (1 if hq == hkv else 2 * elt)
    assert plan.smem == k3_smem(8, 256, elt, plan.gcmax, plan.tile, plan.split_pages, 0)
    assert plan.smem <= paged_ops._K3_SMEM_MAX
    assert _build.head_dim_plan(256, elt, "K3") == (256, False)
    with pytest.raises(ValueError, match=r"head dim 256\b.*A17"):
        k3_plan(8, hq, hkv, 256, 4, 16, 128)


@pytest.mark.parametrize("pool", ["int8", "bf16"])
@pytest.mark.parametrize("hq, hkv", [(2, 2), (8, 1)], ids=["group1", "group8"])
def test_paged_decode_matches_jax_at_d256(pool, hq, hkv):
    """Write + attend over an int8 or bf16 pool at head dim 256, the JAX
    fused kernel in interpret mode: the pools after the write bit-equal
    (int8 scales 1e-6), output rel_err_norm 1e-4, a length-0 row 0."""
    d, lay, page, num_pages, pps = 256, 2, 16, 16, 3
    lengths = np.array([0, 5, 23, 48], np.int32)
    bsz = len(lengths)
    rng = np.random.default_rng(hq + (pool == "int8"))
    shape = (lay, hkv, num_pages, d, page)
    if pool == "int8":
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        ks = rng.uniform(1e-3, 5e-2, shape[:3] + (page,)).astype(np.float32)
        vs = rng.uniform(1e-3, 5e-2, shape[:3] + (page,)).astype(np.float32)
        jk, jv = jnp.asarray(k), jnp.asarray(v)
        kp, vp = (to_jax_layout(torch.from_numpy(a)).contiguous() for a in (k, v))
        scales = (jnp.asarray(ks), jnp.asarray(vs))
        tks, tvs = torch.from_numpy(ks.copy()), torch.from_numpy(vs.copy())
    else:
        k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
        jk, jv = jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16)
        kp, vp = (to_jax_layout(torch.from_numpy(a)).bfloat16().contiguous() for a in (k, v))
        scales, tks, tvs = (), None, None
    tables = (rng.permutation(num_pages - 1)[: bsz * pps] + 1).reshape(bsz, pps).astype(np.int32)
    slots = np.zeros(bsz, np.int32)
    for i, n in enumerate(lengths):
        if n:
            slots[i] = tables[i, (n - 1) // page] * page + (n - 1) % page
    q = rng.standard_normal((bsz, hq, d)).astype(np.float32)
    k_new = rng.standard_normal((bsz, hkv, d)).astype(np.float32)
    v_new = rng.standard_normal((bsz, hkv, d)).astype(np.float32)
    layer = 1
    j_out = jax_paged_decode(
        jnp.asarray(q), jnp.asarray(k_new, jnp.bfloat16), jnp.asarray(v_new, jnp.bfloat16),
        jk, jv, jnp.asarray(lengths), jnp.asarray(tables), jnp.asarray(slots),
        jnp.asarray(layer, jnp.int32), *scales)
    out = paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k_new).bfloat16(),
        torch.from_numpy(v_new).bfloat16(), kp, vp, torch.from_numpy(lengths),
        torch.from_numpy(tables), torch.from_numpy(slots), layer, tks, tvs)
    for got, want in ((kp, j_out[1]), (vp, j_out[2])):
        assert np.array_equal(to_jax_layout(got).float().numpy(),
                              np.asarray(want).astype(np.float32))
    if pool == "int8":
        for got, want in ((tks, j_out[3]), (tvs, j_out[4])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)
    assert out.shape == (bsz, hq, d)
    assert rel_err_norm(out.numpy(), np.asarray(j_out[0])) <= 1e-4
    assert np.all(out[0].numpy() == 0.0)


# -- what the card refuses at 129-256, before any build or launch ----------------


def test_what_has_no_d256_body_refuses_before_any_launch():
    """At d 192: K1's relative-bias, dense-bias, window and dropout modes and
    its fp32 body, K4/K5 (bf16 and fp32), K3 over an fp32 pool, K1's 8-bit
    modes and K6 raise ValueError naming d and A17; past 256 (d 264) K1 and
    K3 too. K1's plain and key-stream modes and K3 over int8 and bf16 pools
    take d 192 (the check alone). Nothing is built or launched."""
    d = 192
    q = torch.zeros(1, 4, 2, d, dtype=torch.bfloat16)
    for mode in ("K1 rel", "K1 dense", "K1 window", "K1 dropout"):
        with pytest.raises(ValueError, match=rf"head dim {d}\b.*A17"):
            flash_ops._k1_inputs(q, q, q, mode)
    with pytest.raises(ValueError, match=rf"head dim {d}\b.*A17"):
        flash_ops._k1_inputs(q.float(), q.float(), q.float(), "K1")
    lse = torch.zeros(1, 2, 4)
    for t in (q, q.float()):
        with pytest.raises(ValueError, match=rf"head dim {d}\b.*A17"):
            bwd_ops._check_cuda(lse, None, q=t, k=t, v=t, o=t, do=t)
    with pytest.raises(ValueError, match=rf"head dim {d}\b.*A17"):
        k3_plan(8, 8, 1, d, 4, 16, 4)
    for kernel in ("K1 int8qk", "K1 fp8qk", "K1 int8full", "K6"):
        with pytest.raises(ValueError, match=rf"head dim {d}\b.*A17"):
            _build.head_dim_plan(d, 1, kernel)
    for mode in ("K1", "K1 streams"):
        assert flash_ops._k1_inputs(q, q, q, mode) == (q, q, q)
    for elt in (1, 2):
        assert k3_plan(8, 8, 1, d, elt, 16, 4).gcmax == 2 * elt
    wide = torch.zeros(1, 4, 2, 264, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=r"head dim 264\b.*D > 256.*A17"):
        flash_ops._k1_inputs(wide, wide, wide, "K1 streams")
    with pytest.raises(ValueError, match=r"head dim 264\b.*D > 256.*A17"):
        k3_plan(8, 8, 1, 264, 2, 16, 4)
    assert _build._lib is None


def test_engine_kinds_at_d192_are_the_cards():
    """At d 192 the engine offers what K1's bf16 body and K3 take: FLASH
    and FLASH_UNROLLED in bf16 (none of the 8-bit kinds), PAGED_DECODE over
    a bf16 pool; nothing but FUSED in fp32, with a dense mask, or past
    256."""
    eng = AttentionEngine(router=AdaptiveRouter(exploration_rate=0.0, seed=0), enable_fp8=True,
                          enable_int8=True)
    kinds = lambda **kw: eng._available_kernels(WorkloadCharacteristics(  # noqa: E731
        **{**dict(batch_size=2, q_len=512, kv_len=512, num_heads=8, head_dim=192,
                  num_kv_heads=1), **kw}))
    unrolled = (KernelKind.FUSED, KernelKind.FLASH, KernelKind.FLASH_UNROLLED)
    assert kinds() == unrolled and kinds(mask_kind="key") == unrolled
    decode = dict(q_len=1, kv_len=2048, is_decode=True)
    assert kinds(**decode) == (KernelKind.FUSED, KernelKind.FLASH, KernelKind.PAGED_DECODE)
    for kw in (dict(dtype="float32"), dict(decode, dtype="float32"), dict(mask_kind="dense"),
               dict(head_dim=320)):
        assert kinds(**kw) == (KernelKind.FUSED,), kw


# -- Llama at d 256, the slice as a whole -----------------------------------------

#: Gemma-2B's attention group (8 query heads over 1 KV head, d 256) at a
#: test's width: 2 query heads over 1 KV head, d 256.
D256 = dict(vocab_size=512, hidden_size=512, intermediate_size=512, num_hidden_layers=2,
            num_attention_heads=2, num_key_value_heads=1, max_position_embeddings=256)


@pytest.fixture(scope="module")
def d256_weights():
    """(JAX params, port state_dict) of the d-256 Llama from PRNGKey(0)."""
    variables = JaxLlama(JaxConfig(**D256)).init(jax.random.PRNGKey(0),
                                                 jnp.zeros((1, 8), jnp.int32))
    params = variables["params"]
    return params, llama_params_from_jax(jax.tree_util.tree_map(np.asarray, params))


@pytest.mark.parametrize("route", ["fused", "flash"])
def test_llama_d256_logits_match_flax(d256_weights, route):
    """fp32 logits against the Flax model on the same weights, rel_err_norm
    1e-4; "flash" lowers both packages' flash thresholds, so the forward
    takes K1's plain version against JAX's kernel in interpret mode."""
    if route == "flash":
        get_config().update(flash_threshold=16, flash_min_tokens=1)
        jax_get_config().update(flash_threshold=16, flash_min_tokens=1)
    params, state = d256_weights
    assert LlamaConfig(**D256).head_dim == 256
    ids = np.random.default_rng(1).integers(0, 512, (2, 24))
    want = JaxLlama(JaxConfig(**D256, dtype=jnp.float32)).apply({"params": params},
                                                                jnp.asarray(ids, jnp.int32))
    model = LlamaForCausalLM(LlamaConfig(**D256, dtype=torch.float32), device="cpu")
    model.load_state_dict(state)
    with torch.no_grad():
        got = model(torch.from_numpy(ids))
    assert rel_err_norm(got.numpy(), np.asarray(want)) <= 1e-4


def test_llama_d256_served_tokens_match_jax_engine(d256_weights):
    """Greedy tokens of three prompts (8 new) and of a 40-token prompt
    prefilled in chunks of 16 (K1's key streams, 5 new): the fp32 engines
    over fp32 pools give the same tokens."""
    params, state = d256_weights
    kwargs = dict(num_pages=64, page_size=16, max_batch=4)
    rng = np.random.default_rng(42)
    prompts = [rng.integers(1, 512, n).tolist() for n in (5, 12, 3)]
    chunked = rng.integers(1, 512, 40).tolist()
    jcfg = JaxConfig(**D256, dtype=jnp.float32)
    tcfg = LlamaConfig(**D256, dtype=torch.float32)
    want = JaxEngine(jcfg, params, kv_dtype=jnp.float32, **kwargs).generate(
        prompts, max_new_tokens=8)
    got = ServingEngine(tcfg, state, device="cpu", kv_dtype=torch.float32, **kwargs).generate(
        prompts, max_new_tokens=8)
    assert got == want
    want = JaxEngine(jcfg, params, kv_dtype=jnp.float32, prefill_chunk=16, **kwargs).generate(
        [chunked], max_new_tokens=5)
    got = ServingEngine(tcfg, state, device="cpu", kv_dtype=torch.float32, prefill_chunk=16,
                        **kwargs).generate([chunked], max_new_tokens=5)
    assert got == want


def test_gemma_2b_widths_are_a_plain_llama_config():
    """No preset: Gemma-2B's attention widths (google/gemma-2b config.json)
    are a plain LlamaConfig with head dim 2048 / 8 = 256."""
    cfg = dataclasses.replace(LlamaConfig(), vocab_size=256000, hidden_size=2048,
                              intermediate_size=16384, num_hidden_layers=18,
                              num_attention_heads=8, num_key_value_heads=1,
                              tie_word_embeddings=True)
    assert cfg.head_dim == 256 and not hasattr(LlamaConfig, "gemma_2b")
