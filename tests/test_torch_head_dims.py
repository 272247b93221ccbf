"""Port parity at the head dims the JAX package pads: every d from 1 to 128.

The JAX kernels pad the head dim to 64 or 128 (``ops/flash.py::
_pad_head_dim``) and its paged decode has no head-dim limit; the port's
card kernels run d <= 64 on their D 64 instantiation and d <= 128 on their
D 128 one, padding a copy only where a row is not whole 16-byte units
(``ops/_build.py::head_dim_plan``). Here, on the CPU, the same numpy
inputs (made from a seed) go through the JAX functions (Pallas in interpret
mode) and the port's plain versions at d in {16, 32, 80, 96, 100}, and
GPT-2 at Cerebras-GPT-2.7B's head dim (n_embd 160, n_head 2: d 80) through
both packages' dense forward and serving engine.

Bounds, the existing ones: fp32 forward max-abs 1e-4 (``test_torch_flash``)
and lse likewise; key streams ``rel_err_norm`` 1e-5 (``test_torch_flash_masked``);
fp32 gradients 2e-4 (``test_torch_flash_bwd``); bf16 forward ``assert_close``
(2e-2); paged decode over an int8 pool ``rel_err_norm`` 1e-4 and pools
after the write bit-equal (``test_torch_paged``); GPT-2 fp32 logits
``rel_err_norm`` 1e-5 and fp32 served tokens equal
(``test_torch_gpt2_serving``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photonic_flash_attention_tpu.core.serving import ServingEngine as JaxEngine
from photonic_flash_attention_tpu.models.gpt2 import GPT2Config as JaxConfig, GPT2LMHead as JaxGPT2
from photonic_flash_attention_tpu.ops.flash import (
    flash_attention as jax_flash,
    flash_attention_with_lse as jax_flash_lse,
)
from photonic_flash_attention_tpu.ops.paged import paged_decode_attention as jax_paged_decode
from photonic_flash_attention_tpu_torch.core.engine import CARD_KERNELS, AttentionEngine
from photonic_flash_attention_tpu_torch.core.router import (
    AdaptiveRouter,
    KernelKind,
    WorkloadCharacteristics,
)
from photonic_flash_attention_tpu_torch.core.serving import ServingEngine
from photonic_flash_attention_tpu_torch.models.from_jax import params_from_jax
from photonic_flash_attention_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from photonic_flash_attention_tpu_torch.ops import _build, flash as flash_ops
from photonic_flash_attention_tpu_torch.ops import flash_bwd as bwd_ops
from photonic_flash_attention_tpu_torch.ops import paged as paged_ops
from photonic_flash_attention_tpu_torch.ops.flash import flash_attention, flash_attention_with_lse
from photonic_flash_attention_tpu_torch.ops.flash_bwd import bwd_unrolled_supported
from photonic_flash_attention_tpu_torch.ops.flash_unrolled import unrolled_supported
from photonic_flash_attention_tpu_torch.ops.paged import (
    k3_plan,
    k3_smem,
    paged_attention_xla,
    paged_decode_attention,
    to_jax_layout,
)
from photonic_flash_attention_tpu_torch.ops.reference import DEFAULT_MASK_VALUE

from .conftest import assert_close, rel_err_norm

HEAD_DIMS = (16, 32, 80, 96, 100)
F32 = (jnp.float32, torch.float32)
BF16 = (jnp.bfloat16, torch.bfloat16)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


# -- the rule ----------------------------------------------------------------


#: Every card kernel and mode the plan names, with the element bytes of the
#: rows each takes on the card.
PLAN_KERNELS = {"K1": (2, 4), "K1 streams": (2, 4), "K1 rel": (2, 4), "K1 dense": (2, 4),
                "K1 window": (2, 4), "K1 dropout": (2, 4), "K1 int8qk": (1,), "K1 fp8qk": (1,),
                "K1 int8full": (1,), "K6": (1,), "K4/K5": (2, 4), "K3": (1, 2, 4)}
#: What takes 129-256 (D 256), as the one table states it: K1's bf16 plain
#: and key-stream modes, K3 over int8 and bf16 pools.
WIDE = {(kernel, elt) for kernel, elts in _build.WIDE_KERNELS.items() for elt in elts}


@pytest.mark.parametrize("d", range(1, 257))
def test_head_dim_plan(d):
    """D_c 64 up to d 64, 128 up to 128 for every kernel and mode, 256 up to
    256 for what WIDE holds; the copy exactly where a row of d elements is
    not whole 16-byte units; a ValueError naming d and the ROADMAP item
    for the rest past 128."""
    for kernel, elts in PLAN_KERNELS.items():
        for elt in elts:
            if d > 128 and (kernel, elt) not in WIDE:
                with pytest.raises(ValueError,
                                   match=rf"head dim {d}\b.*{_build.WIDE_HEAD_DIM_ITEM}"):
                    _build.head_dim_plan(d, elt, kernel)
                assert not _build.takes_head_dim(kernel, d, elt)
                continue
            dc, copy = _build.head_dim_plan(d, elt, kernel)
            assert dc == (64 if d <= 64 else 128 if d <= 128 else 256) and dc >= d
            assert copy == ((d * elt) % 16 != 0)
            assert _build.takes_head_dim(kernel, d, elt)
    assert _build.head_dim_plan(d, 2, "K1")[1] == (d % 8 != 0)
    assert _build.head_dim_plan(d, 1, "K3")[1] == (d % 16 != 0)
    assert unrolled_supported(64, d)
    assert unrolled_supported(64, d, int8_qk=True) == bwd_unrolled_supported(64, d) == (d <= 128)


def test_head_dim_plan_rejects_zero():
    with pytest.raises(ValueError, match="head dim"):
        _build.head_dim_plan(0, 2, "K1")


@pytest.mark.parametrize("d, copied", [(80, False), (100, True), (16, False), (33, True)])
def test_k1_inputs_pad_only_where_the_plan_copies(d, copied):
    """K1's argument check on bf16 tensors: a copy D_c wide, zero past d,
    only where the plan asks for one (the card's path; here on CPU tensors,
    which the public functions never send there)."""
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _arrays([(1, 4, 2, d)] * 3, seed=d))
    got = flash_ops._k1_inputs(q, k, v, "K1")
    dc = _build.head_dim_plan(d, 2, "K1")[0]
    for t, g in zip((q, k, v), got):
        if copied:
            assert g.shape[-1] == dc and torch.equal(g[..., :d], t)
            assert not g[..., d:].any()
        else:
            assert g is t
    assert _build.cut_head(got[0], d).shape == q.shape


def test_card_paths_refuse_past_128_before_any_launch():
    """What has no D 256 instantiation refuses d 160 naming it and A17: K1's
    other modes and its fp32 body, K4/K5, K3 over an fp32 pool; past 256
    K1 and K3 refuse too. Nothing is built or launched."""
    q = torch.zeros(1, 4, 2, 160, dtype=torch.bfloat16)
    for mode in ("K1 window", "K1 dropout", "K1 rel", "K1 dense"):
        with pytest.raises(ValueError, match=r"head dim 160\b.*A17"):
            flash_ops._k1_inputs(q, q, q, mode)
    with pytest.raises(ValueError, match=r"head dim 160\b.*A17"):
        flash_ops._k1_inputs(q.float(), q.float(), q.float(), "K1")
    lse = torch.zeros(1, 2, 4)
    with pytest.raises(ValueError, match=r"head dim 160\b.*A17"):
        bwd_ops._check_cuda(lse, None, q=q, k=q, v=q, o=q, do=q)
    with pytest.raises(ValueError, match=r"head dim 160\b.*A17"):
        k3_plan(8, 16, 16, 160, 4, 16, 4)
    wide = torch.zeros(1, 4, 2, 264, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=r"head dim 264\b.*D > 256.*A17"):
        flash_ops._k1_inputs(wide, wide, wide, "K1")
    with pytest.raises(ValueError, match=r"head dim 264\b.*D > 256.*A17"):
        k3_plan(8, 16, 16, 264, 1, 16, 4)
    assert _build._lib is None  # nothing was built or launched


# -- K1 and K4/K5's plain versions against the JAX kernels --------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_forward_and_lse_match_jax(d, causal, dtype):
    """flash_attention_with_lse at B2 S40/72 (Sq < Skv when causal: end
    aligned) H4 over 2 KV heads (GQA) against the JAX kernel in interpret
    mode; fp32 max-abs 1e-4, bf16 assert_close."""
    jdt, tdt = F32 if dtype == "f32" else BF16
    sq, skv = (40, 72) if causal else (72, 40)
    arrs = _arrays([(2, sq, 4, d), (2, skv, 2, d), (2, skv, 2, d)], seed=d + causal)
    out, lse = flash_attention_with_lse(*(torch.from_numpy(a).to(tdt) for a in arrs),
                                        causal=causal)
    ref, ref_lse = jax_flash_lse(*(jnp.asarray(a, jdt) for a in arrs), causal=causal)
    assert out.shape == (2, sq, 4, d) and lse.shape == (2, 4, sq)
    for got, want in ((out, ref), (lse, ref_lse)):
        a, b = got.float().numpy(), np.asarray(want, np.float32)
        if dtype == "f32":
            assert np.max(np.abs(a - b)) <= 1e-4
        else:
            assert_close(a, b)


@pytest.mark.parametrize("d", [80, 100])
def test_key_streams_match_jax(d):
    """kv_lens and k_bias together (a row of one key, bias holes), fp32,
    rel_err_norm 1e-5."""
    b, sq, skv = 3, 64, 100
    q, k, v = _arrays([(b, sq, 4, d), (b, skv, 2, d), (b, skv, 2, d)], seed=7)
    rng = np.random.default_rng(8)
    lens = np.array([skv, 37, 1], np.int32)
    bias = np.where(rng.random((b, skv)) < 0.2, DEFAULT_MASK_VALUE,
                    rng.standard_normal((b, skv))).astype(np.float32)
    bias[:, 0] = 0.0
    out = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=True,
                          kv_lens=torch.from_numpy(lens), k_bias=torch.from_numpy(bias))
    ref = jax_flash(*(jnp.asarray(a) for a in (q, k, v)), causal=True,
                    kv_lens=jnp.asarray(lens), k_bias=jnp.asarray(bias))
    assert rel_err_norm(out.numpy(), np.asarray(ref)) <= 1e-5


@pytest.mark.parametrize("hq, hkv, causal", [(2, 2, True), (4, 2, False)], ids=["mha", "gqa"])
@pytest.mark.parametrize("d", [16, 80, 100])
def test_grads_match_jax(d, hq, hkv, causal):
    """dq, dk, dv of sum(o * do) through the port's flash_attention (K1's
    and K4/K5's plain versions) against jax.grad of the JAX flash, fp32,
    2e-4."""
    b, s = 1, 96
    q, k, v, do = _arrays([(b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d), (b, s, hq, d)],
                          seed=d + hq)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = flash_attention(*leaves, causal=causal)
    got = torch.autograd.grad((out * torch.from_numpy(do)).sum(), leaves)
    want = jax.grad(lambda a, b_, c: jnp.sum(jax_flash(a, b_, c, causal=causal) * do),
                    argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    for name, g, r in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-4, atol=2e-4,
                                   err_msg=f"d{name} at head dim {d}")


# -- K3: the plan and the plain decode against JAX's paged kernel -------------


@pytest.mark.parametrize("elt", [1, 2, 4])
@pytest.mark.parametrize("d", [16, 32, 80, 96, 112])
def test_k3_plan_at_head_dims(d, elt):
    """Every K3 plan at a head dim whose rows are whole 16-byte units:
    tiles a power of two that fill at most one stage, the D_c-wide state
    counted, inside the card's shared memory."""
    if (d * elt) % 16:
        with pytest.raises(ValueError, match="D in whole 16-byte rows"):
            k3_plan(8, 32, 8, d, elt, 16, 128)
        return
    plan = k3_plan(8, 32, 8, d, elt, 16, 128)
    assert 2 * plan.tile * d * elt <= paged_ops._K3_STAGE_BYTES
    assert plan.tile & (plan.tile - 1) == 0 and plan.tile % 16 == 0
    dc = _build.head_dim_plan(d, elt, "K3")[0]
    assert plan.smem == k3_smem(8, d, elt, plan.gcmax, plan.tile, plan.split_pages, 0)
    assert plan.smem <= paged_ops._K3_SMEM_MAX
    # The merge state is D_c wide, the ring d wide.
    narrow = k3_smem(8, dc, elt, plan.gcmax, plan.tile, plan.split_pages, 0)
    assert plan.smem <= narrow


@pytest.mark.parametrize("d", [80, 100])
def test_paged_decode_int8_pool_matches_jax(d):
    """Write + attend over an int8 pool at head dim d (Hq 4 over Hkv 2),
    the JAX fused kernel in interpret mode: pools after the write
    bit-equal, scales 1e-6, output rel_err_norm 1e-4, a length-0 row 0."""
    lay, hkv, hq, page, num_pages, pps = 2, 2, 4, 16, 16, 3
    lengths = np.array([0, 5, 23, 48], np.int32)
    bsz = len(lengths)
    rng = np.random.default_rng(d)
    shape = (lay, hkv, num_pages, d, page)
    k = rng.integers(-127, 128, shape).astype(np.int8)
    v = rng.integers(-127, 128, shape).astype(np.int8)
    ks = rng.uniform(1e-3, 5e-2, shape[:3] + (page,)).astype(np.float32)
    vs = rng.uniform(1e-3, 5e-2, shape[:3] + (page,)).astype(np.float32)
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
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths), jnp.asarray(tables),
        jnp.asarray(slots), jnp.asarray(layer, jnp.int32), jnp.asarray(ks), jnp.asarray(vs))
    kp, vp = (to_jax_layout(torch.from_numpy(a)).contiguous() for a in (k, v))
    tks, tvs = torch.from_numpy(ks.copy()), torch.from_numpy(vs.copy())
    out = paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k_new).bfloat16(),
        torch.from_numpy(v_new).bfloat16(), kp, vp, torch.from_numpy(lengths),
        torch.from_numpy(tables), torch.from_numpy(slots), layer, tks, tvs)
    for got, want in ((kp, j_out[1]), (vp, j_out[2])):
        assert np.array_equal(to_jax_layout(got).numpy(), np.asarray(want))
    for got, want in ((tks, j_out[3]), (tvs, j_out[4])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)
    assert out.shape == (bsz, hq, d)
    assert rel_err_norm(out.numpy(), np.asarray(j_out[0])) <= 1e-4
    assert np.all(out[0].numpy() == 0.0)
    ref = paged_attention_xla(torch.from_numpy(q), kp[layer], vp[layer],
                              torch.from_numpy(lengths), torch.from_numpy(tables),
                              tks[layer], tvs[layer])
    assert rel_err_norm(out[1:].numpy(), ref[1:].numpy()) <= 1e-5


# -- GPT-2 at Cerebras-GPT-2.7B's head dim (d 80), the slice as a whole --------

#: Cerebras-GPT-2.7B's head dim (n_embd 2560 / n_head 32) at a test's width.
D80 = dict(vocab_size=1024, n_positions=256, n_embd=160, n_layer=2, n_head=2)


@pytest.fixture(scope="module")
def d80_weights():
    """(JAX params, port state_dict) of the d-80 GPT-2 from PRNGKey(0)."""
    variables = JaxGPT2(JaxConfig(**D80)).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    params = variables["params"]
    return params, params_from_jax(jax.tree_util.tree_map(np.asarray, params))


def test_gpt2_d80_logits_match_flax(d80_weights):
    params, state = d80_weights
    jcfg = JaxConfig(**D80, dtype=jnp.float32)
    tcfg = GPT2Config(**D80, dtype=torch.float32)
    assert tcfg.n_embd // tcfg.n_head == 80
    ids = np.random.default_rng(0).integers(0, 1024, (2, 40))
    want = JaxGPT2(jcfg).apply({"params": params}, jnp.asarray(ids, jnp.int32))
    model = GPT2LMHead(tcfg)
    model.load_state_dict(state)
    with torch.no_grad():
        got = model(torch.from_numpy(ids))
    assert got.shape == (2, 40, 1024)
    assert rel_err_norm(got.numpy(), np.asarray(want, np.float32)) <= 1e-5


def test_gpt2_d80_served_tokens_match_jax_engine(d80_weights):
    """Greedy tokens of three prompts served by both engines at the same
    max_batch, fp32 pools (the existing rule: equal batches, exact
    tokens)."""
    params, state = d80_weights
    kwargs = dict(num_pages=64, page_size=16, max_batch=4)
    rng = np.random.default_rng(42)
    prompts = [rng.integers(1, 1024, n).tolist() for n in (5, 21, 3)]
    want = JaxEngine(JaxConfig(**D80, dtype=jnp.float32), params, kv_dtype=jnp.float32,
                     **kwargs).generate(prompts, max_new_tokens=6)
    got = ServingEngine(GPT2Config(**D80, dtype=torch.float32), state, device="cpu",
                        kv_dtype=torch.float32, **kwargs).generate(prompts, max_new_tokens=6)
    assert got == want


# -- the engine offers at d 80 only kinds whose card kernels take d 80 --------


def test_engine_kinds_at_d80_are_the_cards():
    eng = AttentionEngine(router=AdaptiveRouter(exploration_rate=0.0, seed=0), enable_fp8=True,
                          enable_int8=True)
    card = {KernelKind.FLASH: 2, KernelKind.FLASH_UNROLLED: 2, KernelKind.FLASH_UNROLLED_INT8QK: 1,
            KernelKind.FLASH_FP8: 1, KernelKind.FLASH_FP8QK: 1, KernelKind.FLASH_INT8QK: 1,
            KernelKind.FLASH_INT8FULL: 1, KernelKind.PAGED_DECODE: 1}
    for kw in (dict(batch_size=2, q_len=512, kv_len=512, num_heads=32, head_dim=80, causal=True),
               dict(batch_size=8, q_len=1, kv_len=2048, num_heads=32, head_dim=80,
                    is_decode=True)):
        kinds = eng._available_kernels(WorkloadCharacteristics(**kw))
        assert KernelKind.FUSED in kinds and KernelKind.FLASH in kinds
        for kind in kinds:
            if kind in card:  # its card kernel's plan takes d 80 (elt: its payload bytes)
                name = CARD_KERNELS.get(kind, "K1")
                dc, _ = _build.head_dim_plan(kw["head_dim"], card[kind], name)
                assert dc == 128
    # Past 128 the 8-bit kinds go; K1's bf16 body takes d 160, its fp32 body
    # does not; past 256 only FUSED.
    wide = dict(batch_size=2, q_len=512, kv_len=512, num_heads=8, head_dim=160)
    assert eng._available_kernels(WorkloadCharacteristics(**wide)) == (
        KernelKind.FUSED, KernelKind.FLASH, KernelKind.FLASH_UNROLLED)
    assert eng._available_kernels(WorkloadCharacteristics(**wide, dtype="float32")) == (
        KernelKind.FUSED,)
    assert eng._available_kernels(WorkloadCharacteristics(**{**wide, "head_dim": 320})) == (
        KernelKind.FUSED,)


def test_engine_layer_at_d80_runs_on_the_cpu():
    """The drop-in engine call at d 80 on the CPU (plain versions) against
    the fused reference, fp32 1e-5."""
    q, k, v = _arrays([(2, 48, 4, 80)] * 3, seed=11)
    eng = AttentionEngine(router=AdaptiveRouter(exploration_rate=0.0, seed=0))
    out, _ = eng(*(torch.from_numpy(a) for a in (q, k, v)), causal=True)
    ref = jax_flash(*(jnp.asarray(a) for a in (q, k, v)), causal=True)
    assert rel_err_norm(out.numpy(), np.asarray(ref)) <= 1e-5


def test_d80_config_is_built_inline():
    """No preset: Cerebras-GPT-2.7B's widths are a plain GPT2Config."""
    cfg = dataclasses.replace(GPT2Config(), n_embd=2560, n_head=32, n_layer=32, n_positions=2048)
    assert cfg.n_embd // cfg.n_head == 80 and not hasattr(GPT2Config, "cerebras")
