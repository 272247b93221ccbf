"""K13-K21 (the flash experiments) against their plain versions, on the GPU.

Every test here carries the ``cuda`` marker and skips without a GPU. The
file imports no JAX, so it also runs on a machine that has none:

    python -m pytest tests/test_torch_cuda_experiments.py -m cuda --noconftest -q

Each kernel runs bf16 (K16 also fp32) at small and ragged shapes and at
every geometry the experiments' mains time (B4 S2048 H12 D64, B1 S8192 H12
D64, K16 also B4 S4096 H32/8 D128), and must agree with its plain version
on the same inputs within rel_err_norm 1e-2 (K1's bf16 bound in
``chip_smoke.py``), launching its kernel exactly once a call: K13 in both
exp modes, causal and not, at D 64 and 128 and at S 320 (not a multiple of
the 128-row work tile), one call captured into a CUDA graph and replayed
on new inputs, its launcher refusing a plan not its own; K14 causal at Sq
= Skv, Sq < Skv and Sq > Skv; K15 at every nchain it takes
(``CARD_NCHAINS``: 1, the control, to 4), at a length whose last work
tile is ragged (chains past Sq) and at Sq != Skv each way, one call captured into a CUDA graph and replayed on new inputs,
K14's and K15's launchers refusing a plan not their own and an unaligned
bf16 base raising; K16 causal and not, GQA, D
64 and 128; K17 at each unroll it takes (2, 4), K18 causal, K18's int8-QK
mode causal and not, K19, each at a small shape, a length that is a
multiple of 64 but not of 128, D 128 with GQA, fp32 inputs and the mains'
geometries (``CARD_CHECK_SHAPES``; K18 launched once per row-block, at
each of ``main_tri``'s blocks that divides S, and at 64-row blocks at S
192 and 320; K16-K19 counted under their Hopper body's name in bf16 and
``*_fp32`` on the mma.sync body, each dtype reaching only its own, a plan
not the launcher's own refused, an unaligned bf16 base raising; K18's
chain of programmatic dependent launches captured into a CUDA graph and
replayed on new inputs); K18's int8 mode with a bf16 V on K1's Hopper
int8-QK body (counted as ``pfa_flash_tri_i8``) and an fp32 V on the
mma.sync body (``pfa_flash_tri_i8_fp32``), each V dtype reaching only its
own, one launch whose range ends inside a work tile (or starts off the
128-row grid) writing its rows and no other, a call replayed from a CUDA
graph causal and not, its launcher refusing a plan or rows not its own
and an unaligned bf16 V raising before any launch; the segmented path at its
main's long geometries on its last rows; K20 and K21 (the unrolled
backward) through ``flash_bwd_unrolled`` at ``CARD_CHECKS`` causal and not
(blocks of 64, a launch of 320 rows, D 128, fp32 inputs) and at every
geometry and block of its main, launched once a row-block (K20: bf16 on
K5's Hopper body, counted as ``pfa_flash_bwd_dq_rowblock``, fp32 on the
mma.sync body, counted as ``pfa_flash_bwd_dq_rowblock_fp32``) and once a
key block (K21: bf16 on K4's Hopper body, counted as
``pfa_flash_bwd_dkv_colblock``, fp32 on the mma.sync body, counted as
``pfa_flash_bwd_dkv_colblock_fp32``), each output within 1e-2 of the plain
version; K20 at row-blocks of 64, 192 and 320 rows, its dq bit-equal to
K5's, in either launch order and with the chaining off; one K20 or K21
launch of a 64-row block that ends mid work tile writes its rows and no
other, a K20 and a K21 call (their launches after the first programmatic
dependent launches) replay from a CUDA graph, and their launchers refuse
a plan not their own; an unaligned bf16 base raises for K13, K20 and K21
before any launch. fp32 on
K13-K15, an nchain K15 is not compiled for, an unroll K17 is not compiled for, a
dtype or a D a kernel does not take, and K20/K21's blocks that are not
multiples of 64, GQA and lengths the blocks do not divide raise.
"""

import numpy as np
import pytest
import torch

from photonic_flash_attention_tpu_torch import experiments
from photonic_flash_attention_tpu_torch.experiments import _common
from photonic_flash_attention_tpu_torch.experiments import flash_aug_experiment as aug
from photonic_flash_attention_tpu_torch.experiments import flash_bwd_unrolled_experiment as bwd
from photonic_flash_attention_tpu_torch.experiments import flash_fixedmax_experiment as fixedmax
from photonic_flash_attention_tpu_torch.experiments import flash_pair_experiment as pair
from photonic_flash_attention_tpu_torch.experiments import flash_pipeline_experiment as pipeline
from photonic_flash_attention_tpu_torch.ops import _build
from photonic_flash_attention_tpu_torch.ops.flash import flash_attention_with_lse_plain
from photonic_flash_attention_tpu_torch.ops.flash_bwd import flash_bwd_dq

pytestmark = pytest.mark.cuda
BOUND = 1e-2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _qkv(dev, seed, q_shape, kv_shape=None, dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)
    kv_shape = kv_shape or q_shape
    return [_common.normal(rng, s, dtype, dev) for s in (q_shape, kv_shape, kv_shape)]


def _check(name, fn, plain, launches=1):
    before = _build.LAUNCHES[name]
    out = fn()
    torch.cuda.synchronize()
    assert _build.LAUNCHES[name] == before + launches, name
    ref = plain()
    assert out.dtype == ref.dtype and out.shape == ref.shape
    assert torch.isfinite(out).all()
    err = _common.rel_err_norm(out, ref)
    assert err <= BOUND, (name, err)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("shape, blk", [((2, 256, 4, 64), 128), ((1, 96, 3, 128), 32),
                                        ((2, 320, 3, 64), 64), ((1, 320, 2, 128), 64),
                                        ((4, 2048, 12, 64), 512), ((1, 8192, 12, 64), 512)])
def test_k13_fixedmax_matches_plain(cuda_device, causal, fast, shape, blk):
    q, k, v = _qkv(cuda_device, 1, shape)
    kw = dict(causal=causal, block_q=blk, block_kv=blk, fast_exp=fast)
    _check("pfa_flash_fixedmax_fast" if fast else "pfa_flash_fixedmax",
           lambda: experiments.flash_fixedmax(q, k, v, **kw),
           lambda: fixedmax.flash_fixedmax_plain(q, k, v, **kw))


@pytest.mark.parametrize("fast", [False, True])
def test_k13_graph_replay_matches_plain(cuda_device, fast):
    """A K13 call captured into a CUDA graph and replayed on new inputs,
    read by the stream's next kernel before any synchronisation."""
    shape = (4, 2048, 12, 64)
    q, k, v = _qkv(cuda_device, 36, shape)
    kw = dict(causal=True, block_q=512, block_kv=512, fast_exp=fast)
    name = "pfa_flash_fixedmax_fast" if fast else "pfa_flash_fixedmax"
    experiments.flash_fixedmax(q, k, v, **kw)  # build and warm up outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = _build.CAPTURED[name]
    with torch.cuda.graph(graph):
        out = experiments.flash_fixedmax(q, k, v, **kw)
    assert _build.CAPTURED[name] == before + 1
    for seed in (37, 38):
        for t, new in zip((q, k, v), _qkv(cuda_device, seed, shape)):
            t.copy_(new)
        graph.replay()
        got = out.float() * 1.0
        torch.cuda.synchronize()
        ref = fixedmax.flash_fixedmax_plain(q, k, v, **kw)
        assert torch.isfinite(got).all()
        assert _common.rel_err_norm(got, ref) <= BOUND, seed


def test_k13_refuses_other_plans(cuda_device):
    """K13's launcher runs its own plan (K16's): another tile width, stage
    count, shared memory or grid, or a walk past S's tiles, is refused."""
    b, s, h, d = 1, 320, 2, 64
    q, k, v = _qkv(cuda_device, 39, (b, s, h, d))
    fm = fixedmax.fixed_max_bound(q, k, d ** -0.5)
    o = torch.empty_like(q)

    def k13(plan):
        _build.launch("pfa_flash_fixedmax_sm90", cuda_device, q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), o.data_ptr(), fm.data_ptr(), b, s, h, d, d ** -0.5, 1, 0,
                      plan.tile_keys, plan.stages, plan.smem, plan.grid,
                      pipeline._c_walk(plan.walk))

    p13 = pipeline.k13_plan(b, s, h, d, True)
    k13(p13)
    torch.cuda.synchronize()
    for plan in (p13._replace(tile_keys=64), p13._replace(stages=p13.stages - 1),
                 p13._replace(smem=p13.smem + 1024), p13._replace(grid=p13.grid + 1),
                 p13._replace(walk=((p13.walk[0][0], 4),) + p13.walk[1:])):
        with pytest.raises(RuntimeError, match="_sm90"):
            k13(plan)


@pytest.mark.parametrize("shape_q, skv, blk", [((2, 256, 4, 64), 256, 128),
                                               ((1, 96, 2, 64), 160, 32),
                                               ((1, 160, 2, 64), 96, 32),
                                               ((4, 2048, 12, 64), 2048, 512),
                                               ((1, 8192, 12, 64), 8192, 512)])
def test_k14_aug_matches_plain(cuda_device, shape_q, skv, blk):
    b, _, h, d = shape_q
    q, k, v = _qkv(cuda_device, 2, shape_q, (b, skv, h, d))
    _check("pfa_flash_aug", lambda: experiments.flash_aug(q, k, v, bq=blk, bkv=blk),
           lambda: aug.flash_aug_plain(q, k, v, bq=blk, bkv=blk))


#: K15's checks: (B, S, H) at each nchain of CARD_NCHAINS (the mains'
#: geometries, small ones, and a length whose last work tile is ragged:
#: chains past Sq, and chains that pass their diagonal before the last).
PAIR_CHECKS = [(nchain, b, *pair.pair_case(s, nchain), h)
               for nchain in pair.CARD_NCHAINS
               for b, s, h in ((2, 384, 4), (1, 1536, 3), (4, 2048, 12), (1, 8192, 12),
                               (2, pair.RAGGED_LENGTHS[nchain], 3))]


@pytest.mark.parametrize("nchain, b, s, blk, h", PAIR_CHECKS,
                         ids=[f"n{n}-b{b}s{s}h{h}" for n, b, s, _, h in PAIR_CHECKS])
def test_k15_pair_matches_plain(cuda_device, nchain, b, s, blk, h):
    q, k, v = _qkv(cuda_device, 3, (b, s, h, 64))
    _check("pfa_flash_pair",
           lambda: experiments.flash_pair(q, k, v, bq=blk, bkv=blk, nchain=nchain),
           lambda: pair.flash_pair_plain(q, k, v, bq=blk, bkv=blk, nchain=nchain))


@pytest.mark.parametrize("nchain", pair.CARD_NCHAINS)
@pytest.mark.parametrize("sq, skv", [(192, 320), (384, 192)])
def test_k15_pair_sq_ne_skv(cuda_device, nchain, sq, skv):
    """Sq < Skv and Sq > Skv: the key tiles clamp to Skv, the store to Sq."""
    q, k, v = _qkv(cuda_device, 31, (2, sq, 3, 64), (2, skv, 3, 64))
    blk = next(b for b in (64, 32, 16) if sq % (nchain * b) == 0)
    _check("pfa_flash_pair",
           lambda: experiments.flash_pair(q, k, v, bq=blk, bkv=32, nchain=nchain),
           lambda: pair.flash_pair_plain(q, k, v, bq=blk, bkv=32, nchain=nchain))


@pytest.mark.parametrize("nchain", pair.CARD_NCHAINS)
def test_k15_graph_replay_matches_plain(cuda_device, nchain):
    """A K15 call captured into a CUDA graph and replayed on new inputs,
    read by the stream's next kernel before any synchronisation."""
    s, blk = pair.pair_case(2048, nchain)
    shape = (4, s, 12, 64)
    q, k, v = _qkv(cuda_device, 32, shape)
    kw = dict(bq=blk, bkv=blk, nchain=nchain)
    experiments.flash_pair(q, k, v, **kw)  # build and warm up outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = _build.CAPTURED["pfa_flash_pair"]
    with torch.cuda.graph(graph):
        out = experiments.flash_pair(q, k, v, **kw)
    assert _build.CAPTURED["pfa_flash_pair"] == before + 1
    for seed in (33, 34):
        for t, new in zip((q, k, v), _qkv(cuda_device, seed, shape)):
            t.copy_(new)
        graph.replay()
        got = out.float() * 1.0
        torch.cuda.synchronize()
        ref = pair.flash_pair_plain(q, k, v, **kw)
        assert torch.isfinite(got).all()
        assert _common.rel_err_norm(got, ref) <= BOUND, seed


def test_k14_k15_unaligned_bf16_raises(cuda_device):
    """TMA reads 16-byte-aligned bases: a bf16 tensor that starts 2 bytes
    in raises, before any launch."""
    b, s, h, d = 1, 384, 2, 64
    n = b * s * h * d
    buf = torch.randn(3 * n + 1, device=cuda_device).to(torch.bfloat16)
    q, k, v = (buf[1 + i * n:1 + (i + 1) * n].view(b, s, h, d) for i in range(3))
    before = (_build.LAUNCHES["pfa_flash_aug"], _build.LAUNCHES["pfa_flash_pair"])
    with pytest.raises(ValueError, match="16-byte"):
        experiments.flash_aug(q, k, v, bq=128, bkv=128)
    for nchain in pair.CARD_NCHAINS:
        with pytest.raises(ValueError, match="16-byte"):
            experiments.flash_pair(q, k, v, bq=32, bkv=128, nchain=nchain)
    assert (_build.LAUNCHES["pfa_flash_aug"], _build.LAUNCHES["pfa_flash_pair"]) == before


def test_k14_k15_refuse_other_plans(cuda_device):
    """K14's and K15's launchers run their own plans: another tile width,
    stage count, shared memory or grid, or a walk off the work tile's
    rows or past Skv's tiles, is refused."""
    b, sq, skv, h, d = 1, 320, 192, 2, 64
    q, k, v = _qkv(cuda_device, 35, (b, sq, h, d), (b, skv, h, d))
    o = torch.empty_like(q)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, sq, skv, h, d, d ** -0.5)

    def k14(plan):
        _build.launch("pfa_flash_aug_sm90", cuda_device, *ptrs, plan.tile_keys, plan.stages,
                      plan.smem, plan.grid, pipeline._c_walk(plan.walk))

    def k15(plan, nchain=2):
        _build.launch("pfa_flash_pair_sm90", cuda_device, *ptrs, nchain, plan.tile_keys,
                      plan.stages, plan.smem, plan.grid, pipeline._c_walk(plan.walk))

    p14, p15 = pipeline.k14_plan(b, sq, skv, h), pipeline.k15_plan(b, sq, skv, h, 2)
    k14(p14)
    k15(p15)
    torch.cuda.synchronize()
    for launch, plan in ((k14, p14._replace(stages=p14.stages - 1)),
                         (k14, p14._replace(tile_keys=64)),
                         (k14, p14._replace(smem=p14.smem - 256)),
                         (k14, p14._replace(walk=((p14.walk[0][0], 3),) + p14.walk[1:])),
                         (k15, p15._replace(grid=p15.grid + 1)),
                         (k15, p15._replace(walk=((64, 1),) + p15.walk[1:]))):
        with pytest.raises(RuntimeError, match="_sm90"):
            launch(plan)
    with pytest.raises(RuntimeError, match="_sm90"):
        k15(p15, nchain=3)  # a plan of nchain 2


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape, hkv, dtype", [
    ((2, 256, 4, 64), 4, torch.bfloat16),
    ((1, 96, 4, 64), 2, torch.bfloat16),
    ((2, 320, 8, 128), 2, torch.bfloat16),
    ((1, 192, 4, 128), 1, torch.float32),
    ((2, 256, 2, 64), 2, torch.float32),
    ((4, 2048, 12, 64), 12, torch.bfloat16),
    ((1, 8192, 12, 64), 12, torch.bfloat16),
    ((4, 4096, 32, 128), 8, torch.bfloat16),
])
def test_k16_pipelined_matches_plain(cuda_device, causal, shape, hkv, dtype):
    b, s, h, d = shape
    q, k, v = _qkv(cuda_device, 4, shape, (b, s, hkv, d), dtype)
    blk = 32 if s % 64 else 512 if s >= 2048 else 64
    kw = dict(causal=causal, block_q=blk, block_kv=blk)
    _check(_route("pfa_flash_pipelined", dtype), lambda: experiments.flash_unrolled(q, k, v, **kw),
           lambda: pipeline.flash_unrolled_plain(q, k, v, **kw))


def _pipeline_qkv(dev, seed, shape):
    b, s, hq, hkv, d, dtype = shape
    return _qkv(dev, seed, (b, s, hq, d), (b, s, hkv, d), dtype)


def _route(name, dtype):
    """K16-K19's launch counter: the Hopper body's in bf16, the mma.sync
    body's in fp32."""
    return name if dtype == torch.bfloat16 else name + "_fp32"


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("unroll", pipeline.CARD_UNROLLS)
@pytest.mark.parametrize("shape", pipeline.CARD_CHECK_SHAPES, ids=pipeline.CARD_CHECK_IDS)
def test_k17_chunked_matches_plain(cuda_device, causal, unroll, shape):
    q, k, v = _pipeline_qkv(cuda_device, 8, shape)
    kw = dict(causal=causal, block_q=pipeline.check_block(shape[1]),
              block_kv=pipeline.check_block(shape[1], unroll), unroll=unroll)
    _check(_route("pfa_flash_chunked", shape[5]), lambda: experiments.flash_chunked(q, k, v, **kw),
           lambda: pipeline.flash_chunked_plain(q, k, v, **kw))


@pytest.mark.parametrize("shape", pipeline.CARD_CHECK_SHAPES, ids=pipeline.CARD_CHECK_IDS)
def test_k18_tri_matches_plain(cuda_device, shape):
    q, k, v = _pipeline_qkv(cuda_device, 9, shape)
    for bq, bkv in pipeline.check_tri_blocks(shape[1]):
        kw = dict(block_q=bq, block_kv=bkv)
        _check(_route("pfa_flash_tri", shape[5]),
               lambda: experiments.flash_triangular(q, k, v, **kw),
               lambda: pipeline.flash_triangular_plain(q, k, v, **kw), launches=shape[1] // bq)


@pytest.mark.parametrize("shape, block_q", [((4, 2048, 12, 12, 64), 512),
                                            ((1, 8192, 12, 12, 64), 512),
                                            ((2, 320, 8, 2, 128), 64)],
                         ids=["b4s2048-bq512", "s8192-bq512", "gqa-d128-s320-bq64"])
def test_k18_graph_replay_matches_plain(cuda_device, shape, block_q):
    """A K18 call (its launches after the first programmatic dependent
    launches) captured into a CUDA graph, replayed on new inputs and read
    by the next kernel of the stream before any synchronisation: every row
    of every launch is there."""
    b, s, hq, hkv, d = shape
    q, k, v = _pipeline_qkv(cuda_device, 17, (*shape, torch.bfloat16))
    kw = dict(block_q=block_q, block_kv=block_q)
    experiments.flash_triangular(q, k, v, **kw)  # build and warm up outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = _build.CAPTURED["pfa_flash_tri"]
    with torch.cuda.graph(graph):
        out = experiments.flash_triangular(q, k, v, **kw)
    assert _build.CAPTURED["pfa_flash_tri"] == before + s // block_q
    for seed in (18, 19):
        for t, new in zip((q, k, v), _pipeline_qkv(cuda_device, seed, (*shape, torch.bfloat16))):
            t.copy_(new)
        graph.replay()
        got = out.float() * 1.0  # the stream's next kernel reads the call's rows
        torch.cuda.synchronize()
        ref = pipeline.flash_triangular_plain(q, k, v, **kw)
        assert torch.isfinite(got).all()
        assert _common.rel_err_norm(got, ref) <= BOUND, seed


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", pipeline.CARD_CHECK_SHAPES, ids=pipeline.CARD_CHECK_IDS)
def test_k18_tri_i8_matches_plain(cuda_device, causal, shape):
    q, k, v = _pipeline_qkv(cuda_device, 10, shape)
    bq = pipeline.check_block(shape[1])
    kw = dict(causal=causal, block_q=bq, block_kv=bq)
    _check(_route("pfa_flash_tri_i8", shape[5]), lambda: experiments.flash_tri_i8(q, k, v, **kw),
           lambda: pipeline.flash_tri_i8_plain(q, k, v, **kw), launches=shape[1] // bq)


def _launch_i8(dev, q8, k8, v, o, sc, plan, row0, rows, causal, chained=0):
    b, s, hq, d = q8.shape
    _build.launch("pfa_flash_tri_i8_sm90", dev, q8.data_ptr(), k8.data_ptr(), v.data_ptr(),
                  o.data_ptr(), sc.data_ptr(), b, s, hq, k8.shape[2], d, row0, rows, int(causal),
                  chained, plan.stages, plan.smem, plan.grid)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d, row0, rows", [(64, 64, 64), (64, 64, 192), (128, 64, 192),
                                           (128, 1, 318), (64, 256, 64)])
def test_k18_i8_range_ending_mid_work_tile_writes_only_its_rows(cuda_device, causal, d, row0,
                                                               rows):
    """One launch of K18's int8 mode on the Hopper body whose range ends
    inside its last 128-row work tile (or starts off the 128-row grid)
    writes its rows, within the bound of the plain version's, and no
    other row."""
    b, s, hq, hkv = 1, 320, 4, 2
    q, k, v = _pipeline_qkv(cuda_device, 45, (b, s, hq, hkv, d, torch.bfloat16))
    q8, k8, sc = pipeline.quant_qk(q, k)
    o = torch.full_like(q, float("nan"))
    plan = pipeline.k18_i8_plan(b, s, hq, hkv, d, row0, rows)
    _launch_i8(cuda_device, q8, k8, v, o, sc, plan, row0, rows, causal)
    torch.cuda.synchronize()
    ref = pipeline._tri_i8_payload_plain(q8, k8, sc, v, 64, 64, causal)
    assert torch.isnan(o[:, :row0]).all() and torch.isnan(o[:, row0 + rows:]).all()
    got = o[:, row0:row0 + rows]
    assert torch.isfinite(got).all()
    assert _common.rel_err_norm(got, ref[:, row0:row0 + rows]) <= BOUND


@pytest.mark.parametrize("shape, block_q, causal", [((4, 2048, 12, 12, 64), 512, True),
                                                    ((1, 8192, 12, 12, 64), 512, True),
                                                    ((2, 320, 8, 2, 128), 64, False)],
                         ids=["b4s2048-bq512", "s8192-bq512", "gqa-d128-s320-bq64-full"])
def test_k18_i8_graph_replay_matches_plain(cuda_device, shape, block_q, causal):
    """A call of K18's int8 mode (its quantization passes, then a launch a
    row-block, each after the first chained) captured into a CUDA graph,
    replayed on new inputs and read by the next kernel of the stream before
    any synchronisation: every row of every launch is there."""
    b, s, hq, hkv, d = shape
    q, k, v = _pipeline_qkv(cuda_device, 47, (*shape, torch.bfloat16))
    kw = dict(causal=causal, block_q=block_q, block_kv=block_q)
    experiments.flash_tri_i8(q, k, v, **kw)  # build and warm up outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = _build.CAPTURED["pfa_flash_tri_i8"]
    with torch.cuda.graph(graph):
        out = experiments.flash_tri_i8(q, k, v, **kw)
    assert _build.CAPTURED["pfa_flash_tri_i8"] == before + s // block_q
    for seed in (48, 49):
        for t, new in zip((q, k, v), _pipeline_qkv(cuda_device, seed, (*shape, torch.bfloat16))):
            t.copy_(new)
        graph.replay()
        got = out.float() * 1.0  # the stream's next kernel reads the call's rows
        torch.cuda.synchronize()
        ref = pipeline.flash_tri_i8_plain(q, k, v, **kw)
        assert torch.isfinite(got).all()
        assert _common.rel_err_norm(got, ref) <= BOUND, seed


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k18_i8_route_by_v_dtype(cuda_device, dtype):
    """A bf16 V reaches only the Hopper int8-QK body, an fp32 V only the
    mma.sync body; one count a launch."""
    q, k, v = _pipeline_qkv(cuda_device, 46, (1, 320, 4, 2, 64, dtype))
    names = ("pfa_flash_tri_i8", "pfa_flash_tri_i8_fp32")
    before = {n: _build.LAUNCHES[n] for n in names}
    experiments.flash_tri_i8(q, k, v, block_q=64, block_kv=64)
    torch.cuda.synchronize()
    got = {n: _build.LAUNCHES[n] - before[n] for n in names}
    assert got == {n: 5 * int(n.endswith("_fp32") == (dtype == torch.float32)) for n in names}


def test_k18_i8_refuses_other_plans(cuda_device):
    """K18 int8's launcher runs its own plan: another stage count or shared
    memory, a grid of no CTA or of more CTAs than work tiles, or rows
    outside [0, S) are refused."""
    b, s, hq, hkv, d = 1, 320, 4, 2, 64
    q, k, v = _pipeline_qkv(cuda_device, 50, (b, s, hq, hkv, d, torch.bfloat16))
    q8, k8, sc = pipeline.quant_qk(q, k)
    o = torch.empty_like(q)
    plan = pipeline.k18_i8_plan(b, s, hq, hkv, d, 64, 192)
    _launch_i8(cuda_device, q8, k8, v, o, sc, plan, 64, 192, True)
    torch.cuda.synchronize()
    for bad in (plan._replace(stages=plan.stages - 1), plan._replace(smem=plan.smem + 1024),
                plan._replace(grid=0), plan._replace(grid=plan.work + 1)):
        with pytest.raises(RuntimeError, match="_sm90"):
            _launch_i8(cuda_device, q8, k8, v, o, sc, bad, 64, 192, True)
    for row0, rows in ((256, 128), (-64, 128), (320, 64), (0, 0)):
        with pytest.raises(RuntimeError, match="_sm90"):
            _launch_i8(cuda_device, q8, k8, v, o, sc, plan, row0, rows, True)


def test_k18_i8_unaligned_bf16_raises(cuda_device):
    """TMA reads 16-byte-aligned bases: a bf16 V that starts 2 bytes in
    raises, before any launch, and nothing falls back."""
    b, s, h, d = 1, 256, 2, 64
    n = b * s * h * d
    buf = torch.randn(3 * n + 1, device=cuda_device).to(torch.bfloat16)
    q, k, v = (buf[1 + i * n:1 + (i + 1) * n].view(b, s, h, d) for i in range(3))
    names = ("pfa_flash_tri_i8", "pfa_flash_tri_i8_fp32")
    before = {n_: _build.LAUNCHES[n_] for n_ in names}
    with pytest.raises(ValueError, match="16-byte"):
        experiments.flash_tri_i8(q, k, v, block_q=128, block_kv=128)
    assert {n_: _build.LAUNCHES[n_] for n_ in names} == before


@pytest.mark.parametrize("shape", pipeline.CARD_CHECK_SHAPES, ids=pipeline.CARD_CHECK_IDS)
def test_k19_fulltri_matches_plain(cuda_device, shape):
    q, k, v = _pipeline_qkv(cuda_device, 11, shape)
    s = shape[1]
    kw = dict(block_q=pipeline.check_block(s, 2), block_kv=pipeline.check_block(s))
    _check(_route("pfa_flash_fulltri", shape[5]), lambda: experiments.flash_fulltri(q, k, v, **kw),
           lambda: pipeline.flash_fulltri_plain(q, k, v, **kw))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k16_k18_route_by_dtype(cuda_device, dtype):
    """bf16 reaches only the Hopper body, fp32 only the mma.sync one; K18
    counts one a launch."""
    q, k, v = _pipeline_qkv(cuda_device, 20, (1, 320, 4, 2, 64, dtype))
    names = ("pfa_flash_pipelined", "pfa_flash_pipelined_fp32", "pfa_flash_tri",
             "pfa_flash_tri_fp32")
    before = {n: _build.LAUNCHES[n] for n in names}
    experiments.flash_unrolled(q, k, v, block_q=64, block_kv=64, causal=True)
    experiments.flash_triangular(q, k, v, block_q=64, block_kv=64)
    torch.cuda.synchronize()
    got = {n: _build.LAUNCHES[n] - before[n] for n in names}
    want = {n: int(n.endswith("_fp32") == (dtype == torch.float32)) * (5 if "tri" in n else 1)
            for n in names}
    assert got == want


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k17_k19_route_by_dtype(cuda_device, dtype):
    """bf16 reaches only the Hopper body, fp32 only the mma.sync one."""
    q, k, v = _pipeline_qkv(cuda_device, 15, (1, 320, 4, 2, 64, dtype))
    names = ("pfa_flash_chunked", "pfa_flash_chunked_fp32", "pfa_flash_fulltri",
             "pfa_flash_fulltri_fp32")
    before = {n: _build.LAUNCHES[n] for n in names}
    experiments.flash_chunked(q, k, v, block_q=64, block_kv=32, unroll=2, causal=True)
    experiments.flash_fulltri(q, k, v, block_q=64, block_kv=64)
    torch.cuda.synchronize()
    got = {n: _build.LAUNCHES[n] - before[n] for n in names}
    want = {n: int(n.endswith("_fp32") == (dtype == torch.float32)) for n in names}
    assert got == want


def test_k17_k19_refuse_other_plans(cuda_device):
    """The launchers run their own plans and refuse another tile width,
    stage count or shared memory, or a walk with a q-block of no chunk."""
    b, s, hq, hkv, d = 1, 320, 4, 2, 64
    q, k, v = _pipeline_qkv(cuda_device, 16, (b, s, hq, hkv, d, torch.bfloat16))
    o = torch.empty_like(q)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, s, hq, hkv, d, d ** -0.5)

    def k17(plan):  # causal, unroll 2
        _build.launch("pfa_flash_chunked_sm90", cuda_device, *args, 1, 2, plan.tile_keys,
                      plan.stages, plan.smem, plan.grid, pipeline._c_walk(plan.walk))

    def k19(plan):
        _build.launch("pfa_flash_fulltri_sm90", cuda_device, *args, plan.tile_keys, plan.stages,
                      plan.smem, plan.grid, pipeline._c_walk(plan.walk))

    p17, p19 = pipeline.k17_plan(b, s, hq, hkv, d, 2), pipeline.k19_plan(b, s, hq, hkv, d)
    k17(p17)
    k19(p19)
    torch.cuda.synchronize()
    empty_row = ((p19.walk[0][0], 0),) + p19.walk[1:]
    for launch, plan in ((k17, p17._replace(stages=p17.stages - 1)),
                         (k17, p17._replace(tile_keys=128)),
                         (k19, p19._replace(smem=p19.smem + 1024)),
                         (k19, p19._replace(walk=empty_row))):
        with pytest.raises(RuntimeError, match="_sm90"):
            launch(plan)


def test_k16_k18_refuse_other_plans(cuda_device):
    """K16's and K18's launchers run their own plans: another tile width or
    shared memory, a walk whose q-block lies outside the launch's rows or
    off its 128-row steps, or rows past S are refused."""
    b, s, hq, hkv, d = 1, 320, 4, 2, 64
    q, k, v = _pipeline_qkv(cuda_device, 21, (b, s, hq, hkv, d, torch.bfloat16))
    o = torch.empty_like(q)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, s, hq, hkv, d)

    def k16(plan):
        _build.launch("pfa_flash_pipelined_sm90", cuda_device, *ptrs, d ** -0.5, 1,
                      plan.tile_keys, plan.stages, plan.smem, plan.grid,
                      pipeline._c_walk(plan.walk))

    def k18(plan, row0=64, rows=192):
        _build.launch("pfa_flash_tri_sm90", cuda_device, *ptrs, row0, rows, d ** -0.5, 0,
                      plan.tile_keys, plan.stages, plan.smem, plan.grid,
                      pipeline._c_walk(plan.walk))

    p16 = pipeline.k16_plan(b, s, hq, hkv, d, True)
    p18 = pipeline.k18_plan(b, s, hq, hkv, d, 64, 192)
    k16(p16)
    k18(p18)
    torch.cuda.synchronize()
    for launch, plan in ((k16, p16._replace(tile_keys=64)),
                         (k16, p16._replace(smem=p16.smem + 1024)),
                         (k18, p18._replace(walk=((0, 2),) + p18.walk[1:])),
                         (k18, p18._replace(walk=((128, 2),) + p18.walk[1:])),
                         (k18, p18._replace(grid=p18.grid + 1))):
        with pytest.raises(RuntimeError, match="_sm90"):
            launch(plan)
    with pytest.raises(RuntimeError, match="_sm90"):
        k18(p18, rows=320)


def test_k17_k19_unaligned_bf16_raises(cuda_device):
    """TMA reads 16-byte-aligned bases: a bf16 tensor that starts 2 bytes
    in raises, before any launch."""
    b, s, h, d = 1, 256, 2, 64
    n = b * s * h * d
    buf = torch.randn(3 * n + 1, device=cuda_device).to(torch.bfloat16)
    q, k, v = (buf[1 + i * n:1 + (i + 1) * n].view(b, s, h, d) for i in range(3))
    before = (_build.LAUNCHES["pfa_flash_chunked"], _build.LAUNCHES["pfa_flash_fulltri"])
    with pytest.raises(ValueError, match="16-byte"):
        experiments.flash_chunked(q, k, v, block_q=128, block_kv=64, unroll=2, causal=True)
    with pytest.raises(ValueError, match="16-byte"):
        experiments.flash_fulltri(q, k, v, block_q=128, block_kv=128)
    assert (_build.LAUNCHES["pfa_flash_chunked"], _build.LAUNCHES["pfa_flash_fulltri"]) == before


def test_segmented_runs_on_k1(cuda_device):
    q, k, v = _qkv(cuda_device, 12, (1, 1024, 2, 64))
    before = _build.LAUNCHES["pfa_flash_fwd"]
    out = experiments.flash_segmented(q, k, v, block_q=128, block_kv=128, seg_tiles=2)
    torch.cuda.synchronize()
    n = sum(len(pipeline.segments(i, 8, 2, True)) for i in range(8))
    assert _build.LAUNCHES["pfa_flash_fwd"] == before + n
    assert _common.rel_err_norm(out, _common.oracle(q, k, v, causal=True)) <= BOUND


@pytest.mark.parametrize("shape", [shape for _, shape in pipeline.SEG_CASES],
                         ids=[name for name, _ in pipeline.SEG_CASES])
def test_segmented_at_the_mains_geometries(cuda_device, shape):
    """The last 1024 rows (several interior segments merged) against K1's
    plain version on those rows and every key (end-aligned: col <= row)."""
    b, s, h, d = shape
    q, k, v = _qkv(cuda_device, 13, shape)
    blk, n_kv = pipeline.SEG_BLOCK, s // pipeline.SEG_BLOCK
    before = _build.LAUNCHES["pfa_flash_fwd"]
    out = experiments.flash_segmented(q, k, v, block_q=blk, block_kv=blk,
                                      seg_tiles=pipeline.SEG_TILES)[:, -1024:]
    torch.cuda.synchronize()
    n = sum(len(pipeline.segments(i, n_kv, pipeline.SEG_TILES, True)) for i in range(n_kv))
    assert _build.LAUNCHES["pfa_flash_fwd"] == before + n
    ref = flash_attention_with_lse_plain(q[:, -1024:], k, v, causal=True)[0]
    assert torch.isfinite(out).all()
    assert _common.rel_err_norm(out, ref) <= BOUND


def test_card_contract_errors(cuda_device):
    q, k, v = _qkv(cuda_device, 5, (1, 256, 2, 64), dtype=torch.float32)
    for fn in (lambda: experiments.flash_fixedmax(q, k, v, block_q=128, block_kv=128),
               lambda: experiments.flash_aug(q, k, v, bq=128, bkv=128),
               lambda: experiments.flash_pair(q, k, v, bq=64, bkv=128)):
        with pytest.raises(ValueError, match="takes"):
            fn()
    qb, kb, vb = _qkv(cuda_device, 7, (1, 384, 2, 64))
    with pytest.raises(ValueError, match="nchain in"):  # not compiled
        experiments.flash_pair(qb, kb, vb, bq=16, bkv=128, nchain=max(pair.CARD_NCHAINS) + 2)
    q3, k3, v3 = _qkv(cuda_device, 6, (1, 256, 2, 32))
    for fn in (lambda: experiments.flash_aug(q3, k3, v3, bq=128, bkv=128),
               lambda: experiments.flash_unrolled(q3, k3, v3, block_q=128, block_kv=128),
               lambda: experiments.flash_fixedmax(q3, k3, v3, block_q=128, block_kv=128)):
        with pytest.raises(ValueError, match="head_dim"):
            fn()
    for fn in (lambda: experiments.flash_chunked(q3, k3, v3, block_q=128, block_kv=64),
               lambda: experiments.flash_triangular(q3, k3, v3, block_q=128, block_kv=128),
               lambda: experiments.flash_tri_i8(q3, k3, v3, block_q=128, block_kv=128),
               lambda: experiments.flash_fulltri(q3, k3, v3, block_q=128, block_kv=128)):
        with pytest.raises(ValueError, match="head_dim"):
            fn()
    qh, kh, vh = (t.half() for t in (qb, kb, vb))
    for fn in (lambda: experiments.flash_chunked(qh, kh, vh, block_q=128, block_kv=32),
               lambda: experiments.flash_triangular(qh, kh, vh, block_q=128, block_kv=128),
               lambda: experiments.flash_tri_i8(qh, kh, vh, block_q=128, block_kv=128),
               lambda: experiments.flash_fulltri(qh, kh, vh, block_q=128, block_kv=128)):
        with pytest.raises(ValueError, match="takes"):
            fn()
    with pytest.raises(ValueError, match=r"unroll in \(2, 4\)"):
        experiments.flash_chunked(qb, kb, vb, block_q=128, block_kv=128, unroll=3)


def _bwd_inputs(dev, seed, shape, dtype, causal):
    """q, k, v, o, lse, dO in [B, H, S, D] (lse (B, H, S)), o and lse from
    K1's plain version."""
    b, s, h, d = shape
    rng = np.random.default_rng(seed)
    q, k, v, do = (_common.normal(rng, (b, h, s, d), dtype, dev) for _ in range(4))
    t = lambda x: x.transpose(1, 2)  # noqa: E731
    o, lse = flash_attention_with_lse_plain(t(q), t(k), t(v), causal=causal)
    return q, k, v, t(o).contiguous(), lse.contiguous(), do


BWD_CASES = ([(shape, dtype, blocks, causal) for shape, dtype, blocks in bwd.CARD_CHECKS
              for causal in (False, True)]
             + [(shape, torch.bfloat16, bwd.BLOCKS, causal) for _, shape, causal in bwd.CASES])


@pytest.mark.parametrize("shape, dtype, blocks, causal", BWD_CASES,
                         ids=[f"{'x'.join(map(str, c[0]))}-{str(c[1])[6:]}-causal{c[3]}"
                              for c in BWD_CASES])
def test_k20_k21_unrolled_backward_matches_plain(cuda_device, shape, dtype, blocks, causal):
    q, k, v, o, lse, do = _bwd_inputs(cuda_device, 14, shape, dtype, causal)
    s = shape[1]
    for bq, bkv in blocks:
        kw = dict(sm_scale=shape[3] ** -0.5, causal=causal, block_q=bq, block_kv=bkv)
        k20 = _route("pfa_flash_bwd_dq_rowblock", dtype)
        k21 = _route("pfa_flash_bwd_dkv_colblock", dtype)
        before = (_build.LAUNCHES[k20], _build.LAUNCHES[k21])
        got = experiments.flash_bwd_unrolled(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        assert (_build.LAUNCHES[k20] - before[0],
                _build.LAUNCHES[k21] - before[1]) == (s // bq, s // bkv)
        want = bwd.flash_bwd_unrolled_plain(q, k, v, o, lse, do, **kw)
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            assert g.dtype == w.dtype == dtype and g.shape == w.shape
            assert torch.isfinite(g).all(), name
            assert _common.rel_err_norm(g, w) <= BOUND, (name, bq, bkv)


@pytest.mark.parametrize("d", [64, 128])
def test_k21_block_ending_mid_work_tile_writes_only_its_keys(cuda_device, d):
    """One K21 launch of the 64-key block [64, 128) at S 384, causal: its
    128-key work tile's second warpgroup holds keys 128-191, computed and
    not stored. The block's rows match the plain version's; every other row
    of dk and dv keeps what it held."""
    b, s, h = 2, 384, 3
    q, k, v, o, lse, do = _bwd_inputs(cuda_device, 40, (b, s, h, d), torch.bfloat16, True)
    di = bwd.flash_bwd_di(o, do)
    dk, dv = (torch.full_like(k, 7.0) for _ in range(2))
    plan = bwd.k21_plan(b, s, h, d, 64, 64)
    assert plan.work == b * h
    _build.launch("pfa_flash_bwd_dkv_colblock_sm90", cuda_device, q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), do.data_ptr(), lse.data_ptr(), di.data_ptr(), dk.data_ptr(),
                  dv.data_ptr(), b, s, h, d, 64, 64, d ** -0.5, 1, 0, plan.stages, plan.smem,
                  plan.grid)
    torch.cuda.synchronize()
    want = bwd.dkv_colblocks_plain(q, k, v, do, lse, di, sm_scale=d ** -0.5, causal=True,
                                   block_q=64, block_kv=64)
    rows = slice(64, 128)
    for got, ref in zip((dk, dv), want):
        assert torch.isfinite(got[:, :, rows]).all()
        assert _common.rel_err_norm(got[:, :, rows], ref[:, :, rows]) <= BOUND
        assert (got[:, :, :64] == 7.0).all() and (got[:, :, 128:] == 7.0).all()


@pytest.mark.parametrize("shape, block_kv", [((4, 2048, 12, 64), 512), ((2, 320, 3, 128), 64)],
                         ids=["b4s2048-bkv512", "d128-s320-bkv64"])
def test_k21_graph_replay_matches_plain(cuda_device, shape, block_kv):
    """A K21 call (its launches after the first programmatic dependent
    launches) captured into a CUDA graph, replayed on new inputs and read
    by the stream's next kernel before any synchronisation: every key of
    every launch is there."""
    b, s, h, d = shape
    q, k, v, o, lse, do = _bwd_inputs(cuda_device, 41, shape, torch.bfloat16, True)
    di = bwd.flash_bwd_di(o, do)
    kw = dict(sm_scale=d ** -0.5, causal=True, block_q=block_kv, block_kv=block_kv)
    bwd.dkv_colblocks(q, k, v, do, lse, di, **kw)  # build and warm up outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = _build.CAPTURED["pfa_flash_bwd_dkv_colblock"]
    with torch.cuda.graph(graph):
        out = torch.stack(bwd.dkv_colblocks(q, k, v, do, lse, di, **kw))
    assert _build.CAPTURED["pfa_flash_bwd_dkv_colblock"] == before + s // block_kv
    for seed in (42, 43):
        fresh = _bwd_inputs(cuda_device, seed, shape, torch.bfloat16, True)
        for t, new in zip((q, k, v, o, lse, do), fresh):
            t.copy_(new)
        di.copy_(bwd.flash_bwd_di(o, do))
        graph.replay()
        got = out.float() * 1.0
        torch.cuda.synchronize()
        ref = torch.stack(bwd.dkv_colblocks_plain(q, k, v, do, lse, di, **kw))
        assert torch.isfinite(got).all()
        assert _common.rel_err_norm(got, ref) <= BOUND, seed


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k21_route_by_dtype(cuda_device, dtype):
    """bf16 reaches only K4's Hopper body, fp32 only the mma.sync one; one
    count a launch."""
    q, k, v, o, lse, do = _bwd_inputs(cuda_device, 44, (1, 256, 2, 64), dtype, True)
    di = bwd.flash_bwd_di(o, do)
    names = ("pfa_flash_bwd_dkv_colblock", "pfa_flash_bwd_dkv_colblock_fp32")
    before = {n: _build.LAUNCHES[n] for n in names}
    bwd.dkv_colblocks(q, k, v, do, lse, di, sm_scale=0.125, causal=True, block_q=64,
                      block_kv=64)
    torch.cuda.synchronize()
    got = {n: _build.LAUNCHES[n] - before[n] for n in names}
    assert got == {n: 4 * int(n.endswith("_fp32") == (dtype == torch.float32)) for n in names}


def test_k21_refuses_other_plans(cuda_device):
    """K21's launcher runs its own plan: another ring depth, shared memory
    or a grid past the work tiles is refused, and so is a key range off the
    grid of 64 or past S."""
    b, s, h, d = 1, 256, 2, 64
    q, k, v, o, lse, do = _bwd_inputs(cuda_device, 45, (b, s, h, d), torch.bfloat16, True)
    di = bwd.flash_bwd_di(o, do)
    dk, dv = torch.empty_like(k), torch.empty_like(v)

    def k21(plan, row0=64, rows=128):
        _build.launch("pfa_flash_bwd_dkv_colblock_sm90", cuda_device, q.data_ptr(),
                      k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), di.data_ptr(),
                      dk.data_ptr(), dv.data_ptr(), b, s, h, d, row0, rows, d ** -0.5, 1, 0,
                      plan.stages, plan.smem, plan.grid)

    plan = bwd.k21_plan(b, s, h, d, 64, 128)
    k21(plan)
    torch.cuda.synchronize()
    for bad, row0, rows in ((plan._replace(stages=plan.stages - 1), 64, 128),
                            (plan._replace(smem=plan.smem + 1024), 64, 128),
                            (plan._replace(grid=plan.work + 1), 64, 128),
                            (plan, 32, 128), (plan, 64, 96), (plan, 192, 128)):
        with pytest.raises(RuntimeError, match="_sm90"):
            k21(bad, row0, rows)


def test_k13_k21_unaligned_bf16_raises(cuda_device):
    """TMA reads 16-byte-aligned bases: a bf16 tensor that starts 2 bytes
    in raises, before any launch, for K13 and for K21 (bf16 only)."""
    b, s, h, d = 1, 256, 2, 64
    n = b * s * h * d
    buf = torch.randn(4 * n + 1, device=cuda_device).to(torch.bfloat16)
    q, k, v, do = (buf[1 + i * n:1 + (i + 1) * n].view(b, s, h, d) for i in range(4))
    lse = torch.zeros(b, h, s, device=cuda_device)
    names = ("pfa_flash_fixedmax", "pfa_flash_fixedmax_fast", "pfa_flash_bwd_dkv_colblock")
    before = {n_: _build.LAUNCHES[n_] for n_ in names}
    for fast in (False, True):
        with pytest.raises(ValueError, match="16-byte"):
            experiments.flash_fixedmax(q, k, v, block_q=128, block_kv=128, fast_exp=fast)
    qt, kt, vt, dot = (t.view(b, h, s, d) for t in (q, k, v, do))
    with pytest.raises(ValueError, match="16-byte"):
        bwd.dkv_colblocks(qt, kt, vt, dot, lse, lse, sm_scale=0.125, causal=True, block_q=64,
                          block_kv=64)
    assert {n_: _build.LAUNCHES[n_] for n_ in names} == before


def test_k20_k21_card_contract_errors(cuda_device):
    q, k, v, o, lse, do = _bwd_inputs(cuda_device, 15, (1, 256, 2, 64), torch.bfloat16, True)
    kw = dict(sm_scale=0.125, causal=True)
    for bq, bkv in ((128, 32), (32, 128)):
        with pytest.raises(ValueError, match="multiples of 64"):
            experiments.flash_bwd_unrolled(q, k, v, o, lse, do, block_q=bq, block_kv=bkv, **kw)
    with pytest.raises(ValueError, match="not a multiple"):
        experiments.flash_bwd_unrolled(q, k, v, o, lse, do, block_q=192, block_kv=64, **kw)
    with pytest.raises(ValueError, match="no GQA"):
        experiments.flash_bwd_unrolled(q, k[:, :1].contiguous(), v[:, :1].contiguous(), o, lse,
                                       do, block_q=64, block_kv=64, **kw)
    qh, kh, vh, oh, doh = (t.half() for t in (q, k, v, o, do))
    with pytest.raises(ValueError, match="takes"):
        experiments.flash_bwd_unrolled(qh, kh, vh, oh, lse, doh, block_q=64, block_kv=64, **kw)
    q3, k3, v3, o3, lse3, do3 = _bwd_inputs(cuda_device, 16, (1, 128, 2, 32), torch.bfloat16,
                                            True)
    with pytest.raises(ValueError, match="head_dim"):
        experiments.flash_bwd_unrolled(q3, k3, v3, o3, lse3, do3, block_q=64, block_kv=64, **kw)
    qt = q.transpose(2, 3).contiguous().transpose(2, 3)  # the same values, not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        experiments.flash_bwd_unrolled(qt, k, v, o, lse, do, block_q=64, block_kv=64, **kw)


@pytest.mark.parametrize("s, block_q", [(384, 64), (384, 192), (320, 320)],
                         ids=["rows64", "rows192", "rows320"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_k20_row_blocks_match_plain(cuda_device, s, block_q, d, causal):
    """K20 in bf16 at row-blocks of 64, 192 and 320 rows (the last work tile
    of a launch holding rows past it), one launch a row-block, in the
    shipped order and chaining and with the levers (ascending, chaining
    off): each within 1e-2 of the plain version and all bit-equal."""
    shape = (2, s, 3, d)
    q, k, v, o, lse, do = _bwd_inputs(cuda_device, 46, shape, torch.bfloat16, causal)
    di = bwd.flash_bwd_di(o, do)
    kw = dict(sm_scale=d ** -0.5, causal=causal, block_q=block_q)
    before = _build.LAUNCHES["pfa_flash_bwd_dq_rowblock"]
    got = bwd.dq_rowblocks(q, k, v, do, lse, di, block_kv=64, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["pfa_flash_bwd_dq_rowblock"] - before == s // block_q
    want = bwd.dq_rowblocks_plain(q, k, v, do, lse, di, block_kv=64, **kw)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    assert _common.rel_err_norm(got, want) <= BOUND
    for descending in (False, True):
        for chained in (False, True):
            dq = torch.full_like(q, 7.0)
            bwd._k20_launches(q, k, v, do, lse, di, dq, descending=descending, chained=chained,
                              **kw)
            torch.cuda.synchronize()
            assert torch.equal(dq, got), (descending, chained)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_k20_equals_k5(cuda_device, d, causal):
    """Each row of K20 sees K5's key tiles in K5's order, so at row-blocks
    on K5's 128-row grid, on the di K5 computes in its prologue, its dq is
    K5's bit for bit."""
    b, s, h = 2, 512, 3
    q, k, v, o, lse, do = _bwd_inputs(cuda_device, 47, (b, s, h, d), torch.bfloat16, causal)
    t = lambda x: x.transpose(1, 2).contiguous()  # noqa: E731
    k5, di = flash_bwd_dq(t(q), t(k), t(v), t(o), lse, t(do), sm_scale=d ** -0.5, causal=causal)
    got = bwd.dq_rowblocks(q, k, v, do, lse, di, sm_scale=d ** -0.5, causal=causal,
                           block_q=256, block_kv=256)
    torch.cuda.synchronize()
    assert torch.equal(got, k5.transpose(1, 2))


@pytest.mark.parametrize("d", [64, 128])
def test_k20_block_ending_mid_work_tile_writes_only_its_rows(cuda_device, d):
    """One K20 launch of the 64-row block [64, 128) at S 384, causal: its
    128-row work tile's second warpgroup holds rows 128-191, computed and
    not stored. The block's rows match the plain version's; every other row
    of dq keeps what it held."""
    b, s, h = 2, 384, 3
    q, k, v, o, lse, do = _bwd_inputs(cuda_device, 48, (b, s, h, d), torch.bfloat16, True)
    di = bwd.flash_bwd_di(o, do)
    dq = torch.full_like(q, 7.0)
    plan = bwd.k20_plan(b, s, h, d, 64, 64)
    assert plan.work == b * h
    _build.launch("pfa_flash_bwd_dq_rowblock_sm90", cuda_device, q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), do.data_ptr(), lse.data_ptr(), di.data_ptr(), dq.data_ptr(),
                  b, s, h, d, 64, 64, d ** -0.5, 1, 0, plan.stages, plan.smem, plan.grid)
    torch.cuda.synchronize()
    want = bwd.dq_rowblocks_plain(q, k, v, do, lse, di, sm_scale=d ** -0.5, causal=True,
                                  block_q=64, block_kv=64)
    rows = slice(64, 128)
    assert torch.isfinite(dq[:, :, rows]).all()
    assert _common.rel_err_norm(dq[:, :, rows], want[:, :, rows]) <= BOUND
    assert (dq[:, :, :64] == 7.0).all() and (dq[:, :, 128:] == 7.0).all()


@pytest.mark.parametrize("shape, block_q", [((4, 2048, 12, 64), 512), ((2, 320, 3, 128), 64)],
                         ids=["b4s2048-bq512", "d128-s320-bq64"])
def test_k20_graph_replay_matches_plain(cuda_device, shape, block_q):
    """A K20 call (its launches after the first programmatic dependent
    launches) captured into a CUDA graph, replayed on new inputs and read
    by the stream's next kernel before any synchronisation: every row of
    every launch is there."""
    b, s, h, d = shape
    q, k, v, o, lse, do = _bwd_inputs(cuda_device, 49, shape, torch.bfloat16, True)
    di = bwd.flash_bwd_di(o, do)
    kw = dict(sm_scale=d ** -0.5, causal=True, block_q=block_q, block_kv=block_q)
    bwd.dq_rowblocks(q, k, v, do, lse, di, **kw)  # build and warm up outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = _build.CAPTURED["pfa_flash_bwd_dq_rowblock"]
    with torch.cuda.graph(graph):
        out = bwd.dq_rowblocks(q, k, v, do, lse, di, **kw)
    assert _build.CAPTURED["pfa_flash_bwd_dq_rowblock"] == before + s // block_q
    for seed in (50, 51):
        fresh = _bwd_inputs(cuda_device, seed, shape, torch.bfloat16, True)
        for t, new in zip((q, k, v, o, lse, do), fresh):
            t.copy_(new)
        di.copy_(bwd.flash_bwd_di(o, do))
        graph.replay()
        got = out.float() * 1.0
        torch.cuda.synchronize()
        ref = bwd.dq_rowblocks_plain(q, k, v, do, lse, di, **kw)
        assert torch.isfinite(got).all()
        assert _common.rel_err_norm(got, ref) <= BOUND, seed


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k20_route_by_dtype(cuda_device, dtype):
    """bf16 reaches only K5's Hopper body, fp32 only the mma.sync one; one
    count a launch."""
    q, k, v, o, lse, do = _bwd_inputs(cuda_device, 52, (1, 256, 2, 64), dtype, True)
    di = bwd.flash_bwd_di(o, do)
    names = ("pfa_flash_bwd_dq_rowblock", "pfa_flash_bwd_dq_rowblock_fp32")
    before = {n: _build.LAUNCHES[n] for n in names}
    bwd.dq_rowblocks(q, k, v, do, lse, di, sm_scale=0.125, causal=True, block_q=64, block_kv=64)
    torch.cuda.synchronize()
    got = {n: _build.LAUNCHES[n] - before[n] for n in names}
    assert got == {n: 4 * int(n.endswith("_fp32") == (dtype == torch.float32)) for n in names}


def test_k20_refuses_other_plans(cuda_device):
    """K20's launcher runs its own plan: another ring depth, shared memory
    or a grid past the work tiles is refused, and so is a row range off the
    grid of 64 or past S."""
    b, s, h, d = 1, 256, 2, 64
    q, k, v, o, lse, do = _bwd_inputs(cuda_device, 53, (b, s, h, d), torch.bfloat16, True)
    di = bwd.flash_bwd_di(o, do)
    dq = torch.empty_like(q)

    def k20(plan, row0=64, rows=128):
        _build.launch("pfa_flash_bwd_dq_rowblock_sm90", cuda_device, q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), do.data_ptr(), lse.data_ptr(), di.data_ptr(), dq.data_ptr(),
                      b, s, h, d, row0, rows, d ** -0.5, 1, 0, plan.stages, plan.smem, plan.grid)

    plan = bwd.k20_plan(b, s, h, d, 64, 128)
    k20(plan)
    torch.cuda.synchronize()
    for bad, row0, rows in ((plan._replace(stages=plan.stages - 1), 64, 128),
                            (plan._replace(smem=plan.smem + 1024), 64, 128),
                            (plan._replace(grid=plan.work + 1), 64, 128),
                            (plan, 32, 128), (plan, 64, 96), (plan, 192, 128)):
        with pytest.raises(RuntimeError, match="_sm90"):
            k20(bad, row0, rows)


def test_k20_unaligned_bf16_raises(cuda_device):
    """TMA reads 16-byte-aligned bases: a bf16 K20 call on a tensor that
    starts 2 bytes in raises before any launch, and never falls back to
    the mma.sync body."""
    b, s, h, d = 1, 256, 2, 64
    n = b * s * h * d
    buf = torch.randn(4 * n + 1, device=cuda_device).to(torch.bfloat16)
    q, k, v, do = (buf[1 + i * n:1 + (i + 1) * n].view(b, h, s, d) for i in range(4))
    lse = torch.zeros(b, h, s, device=cuda_device)
    names = ("pfa_flash_bwd_dq_rowblock", "pfa_flash_bwd_dq_rowblock_fp32")
    before = {n_: _build.LAUNCHES[n_] for n_ in names}
    with pytest.raises(ValueError, match="16-byte"):
        bwd.dq_rowblocks(q, k, v, do, lse, lse, sm_scale=0.125, causal=True, block_q=64,
                         block_kv=64)
    assert {n_: _build.LAUNCHES[n_] for n_ in names} == before


def test_k16_k18_unaligned_bf16_raises(cuda_device):
    """The same for K16 and K18: a bf16 base 2 bytes in raises before any
    launch, and so does a K18 call's first launch."""
    b, s, h, d = 1, 256, 2, 64
    n = b * s * h * d
    buf = torch.randn(3 * n + 1, device=cuda_device).to(torch.bfloat16)
    q, k, v = (buf[1 + i * n:1 + (i + 1) * n].view(b, s, h, d) for i in range(3))
    before = (_build.LAUNCHES["pfa_flash_pipelined"], _build.LAUNCHES["pfa_flash_tri"])
    with pytest.raises(ValueError, match="16-byte"):
        experiments.flash_unrolled(q, k, v, block_q=128, block_kv=128, causal=True)
    with pytest.raises(ValueError, match="16-byte"):
        experiments.flash_triangular(q, k, v, block_q=128, block_kv=128)
    assert (_build.LAUNCHES["pfa_flash_pipelined"], _build.LAUNCHES["pfa_flash_tri"]) == before
