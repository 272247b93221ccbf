"""The ops surface's kernels against their plain versions, on the GPU.

Every test here carries the ``cuda`` marker and skips without a GPU. The
file imports no JAX, so it also runs on a machine that has none:

    python -m pytest tests/test_torch_cuda_ops.py -m cuda --noconftest -q

K7 (``fused_softmax``) and K8 (``fused_layer_norm``, ``fused_rms_norm``)
at small and ragged shapes (D 1, 200, 1001, 50257; rows 1 and 1000), both
16-byte and one-element paths: within ``rel_err_norm`` 1e-5 in fp32 (the
exp and the sums run in another order) and 1e-2 in bf16 (one rounding of
the output); each call launches its kernel exactly once. The norms'
gradients (plain recompute, as in JAX) on the card against the CPU. The
B14 entry (``paged_attention`` on K3) against its plain version within
1e-4, with rows of length 0 and 1, rank-4 and rank-5 pools, int8 scales;
``paged_attention_auto`` takes K3 on the card and raises for a pool K3
does not take.
"""

import numpy as np
import pytest
import torch

from photonic_flash_attention_tpu_torch.ops import _build
from photonic_flash_attention_tpu_torch.ops import nonlinearity as nl
from photonic_flash_attention_tpu_torch.ops.paged import (
    k3_plan,
    paged_attention,
    paged_attention_auto,
    paged_decode_attend_plain,
)

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
TOL = {"f32": 1e-5, "bf16": 1e-2}
ROWS = [(1, 1), (1, 200), (1000, 200), (1000, 1001), (3, 50257)]


def rel_err_norm(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float(torch.linalg.norm(a - b) / max(float(torch.linalg.norm(b)), 1e-9))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _randn(shape, dtype, dev, seed, scale=1.0, shift=0.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32) * scale + shift
    return torch.from_numpy(x).to(dev, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("rows,d", ROWS)
def test_softmax_kernel_matches_plain(rows, d, dtype_name, cuda_device):
    x = _randn((rows, d), DTYPES[dtype_name], cuda_device, 0, scale=3.0)
    before = _build.LAUNCHES["pfa_softmax"]
    out = nl.fused_softmax(x)
    ref = nl.softmax_rows_plain(x)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["pfa_softmax"] == before + 1
    assert out.dtype == x.dtype and torch.isfinite(out).all()
    assert rel_err_norm(out, ref) <= TOL[dtype_name]


@pytest.mark.cuda
def test_softmax_kernel_non_last_axis_and_extremes(cuda_device):
    x = _randn((4, 96, 6), torch.float32, cuda_device, 1, scale=100.0)
    out = nl.fused_softmax(x, axis=1)
    ref = torch.softmax(x, dim=1)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and rel_err_norm(out, ref) <= 1e-5


@pytest.mark.cuda
def test_kernels_refuse_other_dtypes(cuda_device):
    x = torch.ones(4, 8, device=cuda_device, dtype=torch.float16)
    with pytest.raises(ValueError):
        nl.fused_softmax(x)
    with pytest.raises(ValueError):
        nl.fused_layer_norm(x, torch.ones(8, device=cuda_device))
    with pytest.raises(ValueError):
        nl.fused_rms_norm(torch.ones(2, nl.MAX_NORM_D + 1, device=cuda_device),
                          torch.ones(nl.MAX_NORM_D + 1, device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("rms", [False, True], ids=["ln", "rms"])
@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("rows,d", ROWS[:4] + [(7, 4096)])
def test_norm_kernel_matches_plain(rows, d, dtype_name, rms, cuda_device):
    dtype = DTYPES[dtype_name]
    x = _randn((rows, d), dtype, cuda_device, 2, scale=2.0, shift=1.0)
    g = _randn((d,), dtype, cuda_device, 3, scale=0.1, shift=1.0)
    b = None if rms else _randn((d,), dtype, cuda_device, 4, scale=0.1)
    name = "pfa_rms_norm" if rms else "pfa_layer_norm"
    before = _build.LAUNCHES[name]
    out = nl.fused_rms_norm(x, g) if rms else nl.fused_layer_norm(x, g, b)
    ref = nl.rownorm_plain(x, g, b, 1e-6 if rms else 1e-5, rms)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[name] == before + 1
    assert out.dtype == x.dtype and torch.isfinite(out).all()
    assert rel_err_norm(out, ref) <= TOL[dtype_name]


@pytest.mark.cuda
@pytest.mark.parametrize("rms", [False, True], ids=["ln", "rms"])
def test_norm_gradients_match_cpu(rms, cuda_device):
    x = _randn((6, 5, 200), torch.float32, "cpu", 5, scale=2.0, shift=1.0)
    g = _randn((200,), torch.float32, "cpu", 6, scale=0.1, shift=1.0)
    b = _randn((200,), torch.float32, "cpu", 7, scale=0.1)
    dy = _randn((6, 5, 200), torch.float32, "cpu", 8)
    grads = {}
    for dev in ("cpu", cuda_device):
        leaves = [t.detach().to(dev).requires_grad_() for t in ((x, g) if rms else (x, g, b))]
        y = nl.fused_rms_norm(*leaves) if rms else nl.fused_layer_norm(*leaves)
        y.backward(dy.to(dev))
        grads[str(dev)] = [t.grad.cpu() for t in leaves]
    for got, want in zip(grads["cuda"], grads["cpu"]):
        assert rel_err_norm(got, want) <= 1e-5


def _pools(dev, kv: str, hq: int, rank5: bool, seed: int = 0):
    """Token-major pools (L, Hkv, P, page, D), scattered tables, lengths
    with 0 and 1."""
    rng = np.random.default_rng(seed)
    L, hkv, p, page, d = 3, 2, 48, 16, 64
    lengths = [0, 1, 17, 100, 128]
    shape = (L, hkv, p, page, d)
    if kv == "int8":
        k = torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))
        v = torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))
        ks = torch.from_numpy(rng.uniform(1e-3, 5e-2, shape[:4]).astype(np.float32))
        vs = torch.from_numpy(rng.uniform(1e-3, 5e-2, shape[:4]).astype(np.float32))
    else:
        k = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(DTYPES[kv])
        v = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(DTYPES[kv])
        ks = vs = None
    tables = torch.from_numpy((rng.permutation(p - 1)[: 5 * 8] + 1).reshape(5, 8).astype(np.int32))
    q = torch.from_numpy(rng.standard_normal((5, hq, d)).astype(np.float32))
    lens = torch.tensor(lengths, dtype=torch.int32)
    layer = 1
    if not rank5:
        k, v = k[layer], v[layer]
        ks, vs = (ks[layer], vs[layer]) if ks is not None else (None, None)
        layer = None
    move = lambda t: None if t is None else t.to(dev).contiguous()  # noqa: E731
    return [move(t) for t in (q, k, v, lens, tables, ks, vs)], layer


@pytest.mark.cuda
@pytest.mark.parametrize("rank5", [False, True], ids=["rank4", "rank5"])
@pytest.mark.parametrize("hq", [2, 8], ids=["mha", "gqa"])
@pytest.mark.parametrize("kv", ["int8", "bf16", "f32"])
def test_paged_attention_kernel_matches_plain(kv, hq, rank5, cuda_device):
    (q, k, v, lens, tables, ks, vs), layer = _pools(cuda_device, kv, hq, rank5)
    before = _build.LAUNCHES["pfa_paged_attention"]
    out = paged_attention(q, k, v, lens, tables, ks, vs, layer=layer)
    k5, v5 = (k, v) if rank5 else (k[None], v[None])
    ks5, vs5 = (ks, vs) if rank5 or ks is None else (ks[None], vs[None])
    ref = paged_decode_attend_plain(q, k5, v5, lens, tables, layer or 0, ks5, vs5, 64 ** -0.5)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["pfa_paged_attention"] == before + 1
    assert out.dtype == q.dtype and (out[0] == 0).all()
    assert rel_err_norm(out, ref) <= 1e-4


@pytest.mark.cuda
def test_paged_attention_auto_dispatch(cuda_device):
    (q, k, v, lens, tables, ks, vs), layer = _pools(cuda_device, "int8", 8, True)
    before = _build.LAUNCHES["pfa_paged_attention"]
    out = paged_attention_auto(q, k, v, lens, tables, ks, vs, layer=layer)
    assert _build.LAUNCHES["pfa_paged_attention"] == before + 1
    assert (out[0] == 0).all()
    # A group K3 does not hold ((Hq/Hkv) * D > 4096) raises on the card.
    q_wide = torch.randn(5, 2 * 72, 64, device=cuda_device)
    with pytest.raises(ValueError, match="K3 needs"):
        paged_attention_auto(q_wide, k, v, lens, tables, ks, vs, layer=layer)
    assert _build.LAUNCHES["pfa_paged_attention"] == before + 1


# K3's split and page edges through the B14 entry: pages of 16, 64 a
# sequence, splits of 256 tokens (k3_plan at these shapes).
EDGE_LENGTHS = (0, 1, 15, 16, 17, 255, 256, 257, 513, 1023, 1024)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("kv", ["int8", "bf16", "f32"])
def test_paged_attention_split_edges_match_plain(kv, d, cuda_device):
    rng = np.random.default_rng(21)
    b, hq, hkv, page, pps = len(EDGE_LENGTHS), 4, 2, 16, 64
    p = b * pps + 1
    shape = (hkv, p, page, d)
    if kv == "int8":
        k, v = (torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8)) for _ in "kv")
        ks, vs = (torch.from_numpy(rng.uniform(1e-3, 5e-2, shape[:3]).astype(np.float32))
                  for _ in "kv")
    else:
        k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(DTYPES[kv])
                for _ in "kv")
        ks = vs = None
    tables = torch.from_numpy((rng.permutation(p - 1)[: b * pps] + 1).reshape(b, pps)
                              .astype(np.int32))
    q = torch.from_numpy(rng.standard_normal((b, hq, d)).astype(np.float32))
    lens = torch.tensor(EDGE_LENGTHS, dtype=torch.int32)
    q, k, v, lens, tables = (t.to(cuda_device) for t in (q, k, v, lens, tables))
    ks, vs = (None, None) if ks is None else (ks.to(cuda_device), vs.to(cuda_device))
    plan = k3_plan(b, hq, hkv, d, k.element_size(), page, pps)
    assert plan.split_pages * page == 256 and plan.n_split == 4
    before = _build.LAUNCHES["pfa_paged_attention"]
    out = paged_attention(q, k, v, lens, tables, ks, vs)
    ref = paged_decode_attend_plain(q, k[None], v[None], lens, tables, 0,
                                    None if ks is None else ks[None],
                                    None if vs is None else vs[None], d ** -0.5)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["pfa_paged_attention"] == before + 1
    assert (out[0] == 0).all() and torch.isfinite(out).all()
    assert rel_err_norm(out, ref) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["int8", "bf16", "f32"])
def test_paged_attention_gqa_d128_matches_plain(kv, cuda_device):
    """Hq 32 over Hkv 8 at D 128, rank-5 pools, q in bf16 (fp32 over int8)."""
    gen = torch.Generator(device=cuda_device).manual_seed(23)
    b, hq, hkv, d, page, pps, L = 4, 32, 8, 128, 16, 64, 2
    p = b * pps + 1
    shape = (L, hkv, p, page, d)
    if kv == "int8":
        k, v = (torch.randint(-127, 128, shape, generator=gen, device=cuda_device,
                              dtype=torch.int8) for _ in "kv")
        ks, vs = (torch.rand(shape[:4], generator=gen, device=cuda_device) * 0.05 + 1e-3
                  for _ in "kv")
        qdt = torch.float32
    else:
        k, v = (torch.randn(shape, generator=gen, device=cuda_device).to(DTYPES[kv])
                for _ in "kv")
        ks = vs = None
        qdt = torch.bfloat16
    tables = (torch.randperm(p - 1, generator=gen, device=cuda_device)[: b * pps] + 1)
    tables = tables.view(b, pps).to(torch.int32)
    lens = torch.tensor([0, 1, 700, 1024], dtype=torch.int32, device=cuda_device)
    q = torch.randn(b, hq, d, generator=gen, device=cuda_device).to(qdt)
    before = _build.LAUNCHES["pfa_paged_attention"]
    out = paged_attention(q, k, v, lens, tables, ks, vs, layer=1)
    ref = paged_decode_attend_plain(q.float(), k, v, lens, tables, 1, ks, vs, d ** -0.5)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["pfa_paged_attention"] == before + 1
    assert out.dtype == qdt and (out[0] == 0).all()
    assert rel_err_norm(out, ref) <= (1e-4 if qdt == torch.float32 else 1e-2)
