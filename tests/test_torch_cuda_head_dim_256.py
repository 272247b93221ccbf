"""K1 and K3 at head dims 129-256 (their D 256 instantiations) against their
plain versions, on the GPU.

Every test here carries the ``cuda`` marker and skips without a GPU; the
file imports no JAX:

    python -m pytest tests/test_torch_cuda_head_dim_256.py -m cuda --noconftest -q

Bounds, the existing ones (``tests/test_torch_cuda_kernels.py``): K1 bf16
``rel_err_norm`` 1e-2 and its lse 1e-4; K3's fused decode 1e-4 with the
pools after its write bit-exact with K2's plain version, its token bias
1e-2, the read-only decode 1e-3, ``paged_attention_hf`` 1e-4 (float) and
1e-3 (int8 compute). Each call must launch its kernel once; what has no
D 256 instantiation must raise ValueError naming d and A17 and launch
nothing.
"""

import numpy as np
import pytest
import torch

from photonic_flash_attention_tpu_torch.ops import _build
from photonic_flash_attention_tpu_torch.ops.flash import (
    flash_attention,
    flash_attention_with_lse,
    flash_attention_with_lse_plain,
)
from photonic_flash_attention_tpu_torch.ops.flash_bwd import flash_attention_bwd
from photonic_flash_attention_tpu_torch.ops.reference import DEFAULT_MASK_VALUE
from photonic_flash_attention_tpu_torch.ops.paged import (
    k3_plan,
    paged_attention_hf,
    paged_attention_hf_plain,
    paged_decode_attend,
    paged_decode_attend_plain,
    paged_decode_attention,
    paged_token_write_plain,
)

WIDE_DIMS = (136, 180, 192, 256)
#: (Hq, Hkv): MHA and Gemma-2B's 8 query heads over 1 KV head.
GROUPS = ((4, 4), (8, 1))


def rel_err_norm(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float(torch.linalg.norm(a - b) / max(float(torch.linalg.norm(b)), 1e-9))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("streams", [False, True], ids=["plain", "streams"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("hq, hkv", GROUPS, ids=["mha", "gqa8"])
@pytest.mark.parametrize("d", WIDE_DIMS)
def test_k1_wide_matches_plain(d, hq, hkv, causal, streams, cuda_device):
    """K1 bf16 at Sq 129 over Skv 300 (causal aligned to the end), with lse
    and without, and with the key streams (a row of length 0, bias holes)."""
    gen = torch.Generator(device=cuda_device).manual_seed(d + hq)
    q = torch.randn(2, 129, hq, d, generator=gen, device=cuda_device).to(torch.bfloat16)
    k, v = (torch.randn(2, 300, hkv, d, generator=gen, device=cuda_device).to(torch.bfloat16)
            for _ in range(2))
    kw = {}
    if streams:
        bias = torch.randn(2, 300, generator=gen, device=cuda_device)
        kw = dict(kv_lens=torch.tensor([300, 0], dtype=torch.int32, device=cuda_device),
                  k_bias=torch.where(bias > 1.5, DEFAULT_MASK_VALUE, bias))
    counter = "pfa_flash_fwd_streams" if streams else "pfa_flash_fwd"
    before = _build.LAUNCHES[counter]
    out, lse = flash_attention_with_lse(q, k, v, causal=causal, **kw)
    bare = flash_attention(q, k, v, causal=causal, **kw)
    ref, ref_lse = flash_attention_with_lse_plain(q, k, v, causal=causal, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[counter] == before + 2
    live = torch.isfinite(ref_lse)
    assert torch.equal(torch.isneginf(lse), torch.isneginf(ref_lse))
    assert rel_err_norm(lse[live], ref_lse[live]) <= 1e-4
    for got in (out, bare):
        assert got.shape == q.shape and torch.isfinite(got).all()
        assert rel_err_norm(got, ref) <= 1e-2


def _pools(pool_dtype, hkv, d, gen, device, layers=2, num_pages=64, page=16):
    shape = (layers, hkv, num_pages, page, d)
    if pool_dtype == torch.int8:
        k, v = (torch.randint(-127, 128, shape, generator=gen, device=device, dtype=torch.int8)
                for _ in range(2))
        ks, vs = (torch.rand(shape[:4], generator=gen, device=device) * 0.05 + 1e-3
                  for _ in range(2))
        return [k, v, ks, vs]
    return [torch.randn(shape, generator=gen, device=device).to(pool_dtype) for _ in range(2)] + [
        None, None]


LENGTHS = (0, 1, 17, 100, 129)


#: K3's modes and pools: the decode modes over int8 and bf16 pools,
#: paged_attention_hf in float compute over bf16 pools and in int8 compute
#: (its default there) over int8 ones.
K3_MODES = [(mode, pool) for mode in ("fused", "fused_tbias", "attend")
            for pool in ("int8", "bf16")] + [("hf", "bf16"), ("hf_int8", "int8")]


@pytest.mark.cuda
@pytest.mark.parametrize("mode, pool", K3_MODES)
@pytest.mark.parametrize("hq, hkv", GROUPS, ids=["group1", "group8"])
@pytest.mark.parametrize("d", [160, 256])
def test_k3_wide_matches_plain(d, hq, hkv, pool, mode, cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(d * 10 + hq)
    pool_dtype = torch.int8 if pool == "int8" else torch.bfloat16
    pools = _pools(pool_dtype, hkv, d, gen, cuda_device)
    b, page, pps, layer = len(LENGTHS), 16, 10, 1
    perm = torch.randperm(63, generator=gen, device=cuda_device)[: b * pps].to(torch.int32) + 1
    tables = perm.view(b, pps).contiguous()
    lens = torch.tensor(LENGTHS, dtype=torch.int32, device=cuda_device)
    slots = torch.zeros(b, dtype=torch.int32, device=cuda_device)
    for i, n in enumerate(LENGTHS):
        if n:
            slots[i] = tables[i, (n - 1) // page] * page + (n - 1) % page
    q = torch.randn(b, hq, d, generator=gen, device=cuda_device)
    k_new, v_new = (torch.randn(b, hkv, d, generator=gen, device=cuda_device).to(torch.bfloat16)
                    for _ in range(2))
    scale, bias = d ** -0.5, None
    if mode == "fused_tbias":
        bias, scale = torch.randn(b, hkv, pps * page, generator=gen, device=cuda_device) * 2, 1.0
    counter = {"fused": "pfa_paged_decode_fused", "fused_tbias": "pfa_paged_decode_fused_tbias",
               "attend": "pfa_paged_decode_attend", "hf": "pfa_paged_hf",
               "hf_int8": "pfa_paged_hf_int8"}[mode]
    before = _build.LAUNCHES[counter]
    if mode.startswith("fused"):
        ref_pools = [t.clone() if t is not None else None for t in pools]
        out = paged_decode_attention(q, k_new, v_new, pools[0], pools[1], lens, tables, slots,
                                     layer, pools[2], pools[3], sm_scale=scale, token_bias=bias)
        paged_token_write_plain(k_new, v_new, *ref_pools, slots, layer)
        ref = paged_decode_attend_plain(q, *ref_pools[:2], lens, tables, layer, *ref_pools[2:],
                                        scale, bias)
        bound = 1e-4 if bias is None else 1e-2
    elif mode == "attend":
        out = paged_decode_attend(q, *pools[:2], lens, tables, layer, *pools[2:])
        ref = paged_decode_attend_plain(q, *pools[:2], lens, tables, layer, *pools[2:], scale)
        bound = 1e-3
    else:
        int8 = mode == "hf_int8"
        qb = q.to(torch.bfloat16)
        out = paged_attention_hf(qb, *pools[:2], lens, tables, *pools[2:], layer=layer)
        ref = paged_attention_hf_plain(qb, *pools[:2], lens, tables, layer, *pools[2:], scale, 8,
                                       int8).to(qb.dtype)
        bound = 1e-3 if int8 else 1e-4
    torch.cuda.synchronize()
    assert _build.LAUNCHES[counter] == before + 1
    if mode.startswith("fused"):
        assert all(a is None or torch.equal(a, w) for a, w in zip(pools, ref_pools))
    assert out.shape == (b, hq, d) and torch.isfinite(out).all()
    assert not out[0].float().abs().any()  # length 0
    assert rel_err_norm(out, ref) <= bound


@pytest.mark.cuda
def test_k3_plan_smem_matches_kernel_at_d256(cuda_device):
    """k3_plan's shared-memory count equals the kernel's own layout at D 256
    (and at d 160 on it), over int8 and bf16 pools, in float and int8
    compute."""
    lib = _build.lib()
    for b, hq, hkv, d, elt, page, pps, ppb in [(8, 8, 1, 256, 1, 128, 16, None),
                                               (8, 8, 1, 256, 2, 128, 16, None),
                                               (8, 16, 16, 256, 2, 16, 64, None),
                                               (5, 8, 1, 256, 1, 16, 64, 3),
                                               (8, 8, 1, 160, 1, 128, 16, 4),
                                               (8, 4, 4, 160, 2, 16, 64, None)]:
        plan = k3_plan(b, hq, hkv, d, elt, page, pps, ppb)
        assert plan.smem == lib.pfa_paged_k3_smem(b, d, elt, plan.gcmax, int(ppb is not None),
                                                  plan.tile, plan.split_pages, plan.block)


@pytest.mark.cuda
def test_what_has_no_d256_body_refuses_on_the_card(cuda_device):
    """At d 192 K1's window, dropout and dense-bias modes, its fp32 body,
    K5/K4, and K3 over an fp32 pool raise ValueError naming d and A17, and a
    d-256 training call launches K1 with lse forward and raises before K5 or
    K4: nothing else is launched."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    q, k, v = (torch.randn(1, 256, 4, 192, generator=gen, device=cuda_device).to(torch.bfloat16)
               for _ in range(3))
    f32 = [t.float() for t in (q, k, v)]
    lse = torch.zeros(1, 4, 256, device=cuda_device)
    pools32 = _pools(torch.float32, 4, 192, gen, cuda_device, layers=1, num_pages=4)
    one = torch.ones(1, 1, dtype=torch.int32, device=cuda_device)
    calls = [
        lambda: flash_attention(q, k, v, causal=True, window=(-40, 0)),
        lambda: flash_attention(q, k, v, dropout_rate=0.1, dropout_seed=7),
        lambda: flash_attention(q, k, v, attn_bias=torch.zeros(1, 1, 256, 256, device=cuda_device)),
        lambda: flash_attention(*f32),
        lambda: flash_attention_bwd(q, k, v, q, lse, q, sm_scale=1.0, causal=False),
        lambda: paged_decode_attend(f32[0][:, 0], *pools32[:2], one[0], one, 0),
    ]
    torch.cuda.synchronize()
    launched = sum(_build.LAUNCHES.values())
    for call in calls:
        with pytest.raises(ValueError, match=r"head dim 192\b.*A17"):
            call()
    assert sum(_build.LAUNCHES.values()) == launched
    leaves = [torch.randn(1, 256, h, 256, generator=gen, device=cuda_device).to(torch.bfloat16)
              .requires_grad_() for h in (8, 1, 1)]
    before = _build.LAUNCHES["pfa_flash_fwd"]
    out = flash_attention(*leaves, causal=True)
    with pytest.raises(ValueError, match=r"head dim 256\b.*A17"):
        torch.autograd.grad(out.float().sum(), leaves)
    assert _build.LAUNCHES["pfa_flash_fwd"] == before + 1
    assert sum(_build.LAUNCHES.values()) == launched + 1
    assert np.isfinite(out.float().cpu().numpy()).all()
