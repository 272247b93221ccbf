"""The card's probes (K9-K12) against their plain versions, on the GPU.

Every test here carries the ``cuda`` marker and skips without a GPU. The
file imports no JAX, so it also runs on a machine that has none:

    python -m pytest tests/test_torch_cuda_probes.py -m cuda --noconftest -q

K9 (``hbm_read_probe``) and K10 (``hbm_copy``) bit for bit (a slice and a
copy), in bf16, fp32 and int8, K10 also at its ring's tails (16 bytes, a
chunk and 16 bytes, a size that is not a multiple of the chunk) and on
other rings (stages, chunk, grid), its launcher refusing a plan not its
own; K11 (``exp_probe``) within 1e-6 abs
(exp2f against torch.exp, rounding errors that exp's slope below 1 keeps
from growing); K12 (``softmax_block_probe``) within one bf16 ulp (2^-8) in
both modes at every width it holds, its running sums l within 1e-4
relative, masked equal to unmasked, and at 0 iterations x's rows with l
= 0. Both are checked at 1, 2, 3, 5 and 7
iterations on wide inputs, where the outputs still depend on the count
(K11's chain reaches its fixed point, K12's rows one value each, within a
few dozen iterations), and at the counts the measure functions run. Each
call launches its kernel once, a call under CUDA-graph capture is counted
as captured, not launched; wrong dtypes, shapes and layouts raise.
"""

import math

import numpy as np
import pytest
import torch

from photonic_flash_attention_tpu_torch.hardware import detection
from photonic_flash_attention_tpu_torch.ops import _build
from photonic_flash_attention_tpu_torch.ops import device_probes as dp
from photonic_flash_attention_tpu_torch.ops import hbm_bw

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _uniform(shape, lo, hi, dev, seed):
    x = np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)
    return torch.from_numpy(x).to(dev)


def _launched(name, fn):
    before = _build.LAUNCHES[name]
    out = fn()
    torch.cuda.synchronize()
    assert _build.LAUNCHES[name] == before + 1, name
    return out


@pytest.mark.parametrize("rows", [4096, 8192, 12288, 40960])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.int8])
def test_hbm_read_probe_returns_the_plain_slice(cuda_device, rows, dtype):
    x = (_uniform((rows, 512), -100, 100, cuda_device, rows)).to(dtype)
    out = _launched("pfa_hbm_read", lambda: hbm_bw.hbm_read_probe(x))
    assert out.dtype == dtype and torch.equal(out, hbm_bw.hbm_read_probe_plain(x))


@pytest.mark.parametrize("shape", [(1, 8), (100, 512), (4096, 256), (131072, 512)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.int8])
def test_hbm_copy_is_exact(cuda_device, shape, dtype):
    x = _uniform(shape, -100, 100, cuda_device, 1).to(dtype)
    if (shape[1] * x.element_size()) % 16:
        with pytest.raises(ValueError, match="16-byte"):
            hbm_bw.hbm_copy(x)
        return
    y = _launched("pfa_hbm_copy", lambda: hbm_bw.hbm_copy(x))
    assert torch.equal(y, x) and y.data_ptr() != x.data_ptr()


#: K10's tails in bytes: one 16-byte chunk, a chunk and 16 bytes, and a
#: size that is not a multiple of the chunk.
K10_TAILS = [16, hbm_bw.COPY_CHUNK + 16, 5 * hbm_bw.COPY_CHUNK // 2 + 48]


@pytest.mark.parametrize("n_bytes", K10_TAILS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.int8])
def test_hbm_copy_tails_are_exact(cuda_device, n_bytes, dtype):
    elt = torch.empty((), dtype=dtype).element_size()
    x = _uniform((1, n_bytes // elt), -100, 100, cuda_device, n_bytes).to(dtype)
    y = _launched("pfa_hbm_copy", lambda: hbm_bw.hbm_copy(x))
    assert torch.equal(y, x)


@pytest.mark.parametrize("chunk, stages", [(16384, 2), (65536, 3), (4096, 8), (32768, 6)])
def test_hbm_copy_rings_are_exact(cuda_device, chunk, stages):
    """Every ring the plan allows copies every byte: bench.py's copy and a
    size that ends mid chunk, on few SMs (several chunks a CTA), all, and a
    CTA a chunk."""
    for shape in ((131072, 512), (3, 40008)):
        x = _uniform(shape, -100, 100, cuda_device, 2).to(torch.bfloat16)
        for sms, persistent in ((7, True), (132, True), (132, False)):
            y = torch.zeros_like(x)
            plan = hbm_bw.k10_plan(x.numel() * 2, sms, chunk=chunk, stages=stages,
                                   persistent=persistent)
            _launched("pfa_hbm_copy", lambda: hbm_bw._copy_into(x, y, plan))
            assert torch.equal(y, x), (shape, sms)


def test_hbm_copy_refuses_other_plans(cuda_device):
    x = torch.ones(4096, 512, device=cuda_device, dtype=torch.bfloat16)
    y = torch.empty_like(x)
    plan = hbm_bw.k10_plan(x.numel() * 2, persistent=True)
    for bad in (plan._replace(grid=plan.chunks + 1), plan._replace(grid=0),
                plan._replace(chunk=1000), plan._replace(stages=1),
                plan._replace(stages=8, chunk=65536)):
        with pytest.raises(RuntimeError, match="pfa_hbm_copy"):
            hbm_bw._copy_into(x, y, bad)


#: Counts at which the outputs still depend on the input and the count,
#: none a multiple of K11's unroll of 4, and the measure functions' counts.
ITERS = [1, 2, 3, 5, 7, 256]


@pytest.mark.parametrize("iters", ITERS)
@pytest.mark.parametrize("shape", [(8, 4), (40, 132), (512, 512), (3000, 512)])
def test_exp_probe_matches_plain(cuda_device, shape, iters):
    x = _uniform(shape, 0.0, 4.0, cuda_device, 2)
    out = _launched("pfa_exp_probe", lambda: dp.exp_probe(x, iters))
    assert out.shape == (8, shape[1])
    assert float((out - dp.exp_probe_plain(x, iters)).abs().max()) <= 1e-6
    assert torch.equal(dp.exp_probe(x, 0), x[:8])


@pytest.mark.parametrize("iters", ITERS[:-1] + [16])
@pytest.mark.parametrize("cols", dp.SOFTMAX_COLS)
def test_softmax_probe_matches_plain(cuda_device, cols, iters):
    x = _uniform((200, cols), -8.0, 1.0, cuda_device, cols)
    outs = {}
    for masked, name in ((True, "pfa_softmax_probe"), (False, "pfa_softmax_probe_unmasked")):
        outs[masked] = _launched(name, lambda: dp.softmax_block_probe(x, iters, masked,
                                                                     return_l=True))
        ref, ref_l = dp.softmax_block_probe_plain(x, iters, masked, return_l=True)
        assert float((outs[masked][0] - ref).abs().max()) <= 2.0 ** -8, (cols, masked)
        assert float(((outs[masked][1] - ref_l).abs() / ref_l).max()) <= 1e-4, (cols, masked)
    assert torch.equal(outs[True][0], outs[False][0])
    assert torch.equal(outs[True][1], outs[False][1])


@pytest.mark.parametrize("cols", dp.SOFTMAX_COLS)
def test_softmax_probe_zero_iters(cuda_device, cols):
    """At 0 iterations both modes return the input's rows 0-7 and l = 0."""
    x = _uniform((200, cols), -8.0, 1.0, cuda_device, cols)
    for masked, name in ((True, "pfa_softmax_probe"), (False, "pfa_softmax_probe_unmasked")):
        out, l = _launched(name, lambda: dp.softmax_block_probe(x, 0, masked, return_l=True))
        assert torch.equal(out, x[:8])
        assert torch.equal(l, torch.zeros_like(l))


def test_captured_calls_are_not_launches(cuda_device):
    x = _uniform((512, 512), 0.0, 4.0, cuda_device, 3)
    dp.exp_probe(x, 3)
    torch.cuda.synchronize()
    launched, captured = _build.LAUNCHES["pfa_exp_probe"], _build.CAPTURED["pfa_exp_probe"]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = dp.exp_probe(x, 3)
        dp.exp_probe(x, 3)
    graph.replay()
    torch.cuda.synchronize()
    assert _build.LAUNCHES["pfa_exp_probe"] == launched
    assert _build.CAPTURED["pfa_exp_probe"] == captured + 2
    assert float((out - dp.exp_probe_plain(x, 3)).abs().max()) <= 1e-6


def test_argument_errors(cuda_device):
    x = torch.zeros(16, 1152, device=cuda_device)
    with pytest.raises(ValueError, match="at most 1024"):
        dp.softmax_block_probe(x)
    with pytest.raises(ValueError, match="cols % 4"):
        dp.exp_probe(torch.zeros(16, 6, device=cuda_device))
    with pytest.raises(ValueError, match="float32"):
        dp.exp_probe(torch.zeros(16, 128, device=cuda_device, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        dp.softmax_block_probe(torch.zeros(512, 16, device=cuda_device).t())
    with pytest.raises(ValueError, match="contiguous"):
        hbm_bw.hbm_read_probe(torch.zeros(1024, 4096, device=cuda_device).t())
    with pytest.raises(ValueError, match="unsupported device"):
        hbm_bw.hbm_copy(torch.zeros(16, 16, device="meta"))


def test_detection_and_rates_on_the_card(cuda_device):
    dev = detection.get_best_tpu_device()
    assert dev.platform == "gpu" and not dev.is_simulated
    assert dev.kind == torch.cuda.get_device_name(0)
    assert dev.capabilities.contraction_width == 16
    assert dp.wave_rows("softmax", 512) % 32 == 0 and dp.wave_rows("exp") > 0
    x = torch.ones(4096 * 8, 512, dtype=torch.bfloat16, device=cuda_device)
    for rate in (hbm_bw.hbm_read_bytes_per_s(x, fit=(2, 10)),
                 dp.measure_exp_rate(iters=16, fit=(2, 10)),
                 dp.measure_softmax_rate(iters=16, fit=(2, 10), masked=False)):
        assert math.isfinite(rate) and rate > 0
