"""K4 (dK/dV) and K5 (dQ), the bf16 Hopper backward, against the plain
backward on the GPU.

Every test here carries the ``cuda`` marker and skips without a GPU. The
file imports no JAX, so it also runs on a machine that has none:

    python -m pytest tests/test_torch_cuda_bwd.py -m cuda --noconftest -q

At the kernels' edges (every Sq != Skv among 1, 127, 129 and 300, causal
where Sq < Skv; D 64 and 128) in each stream mode (plain, window, dropout
0.1), dq, dk and dv must agree with ``flash_attention_bwd_plain`` on the
same inputs within 1e-2 ``rel_err_norm`` (bf16 rounding of P and dS), each
call must launch K5 and K4 once under its mode's counter, and two launches
on the same inputs must give bit-identical results (no atomic additions of
values). The plain version at these geometries is anchored to JAX's grid
pair on the CPU (``tests/test_torch_flash_bwd.py``,
``tests/test_torch_flash_bwd_gqa.py``). Rows that see no key in a window
get zero gradients; GQA 12/4 and 32/8 run through ``flash_attention``'s
autograd (K/V with their own heads) against the CPU. Native GQA straight
through ``flash_attention_bwd`` (groups 2, 4 and MQA, every stream mode,
K4 at every slice count of the group, bf16 1e-2 and fp32 1e-4 against the
plain version), K5's di against ``flash_bwd_di`` (fp32, 1e-6 relative) and
two calls at a shape K4 splits into slices, bit-equal.

With one key (Skv 1) and no dropout the softmax is constant and o = V[0]
exactly: P = 1 and dP = di up to fp32 rounding, so the exact dq and dk are
zero and both sides hold only that rounding (their ratio is noise). There
dq and dk must stay below 1e-3 of dv's norm instead, which an O(1) error
in dS would exceed by far. (With dropout, o = V[0] / (1 - rate) is rounded
to bf16, and both sides compute the same small dS from that rounding.)
"""

import pytest
import torch

from photonic_flash_attention_tpu_torch.ops import _build
from photonic_flash_attention_tpu_torch.ops.flash import (
    flash_attention,
    flash_attention_with_lse_plain,
)
from photonic_flash_attention_tpu_torch.ops.flash_bwd import (
    flash_attention_bwd,
    flash_attention_bwd_plain,
    flash_bwd_di,
    flash_bwd_dkv,
    flash_bwd_dq,
    k4_slices,
)

BOUND = 1e-2
EDGE_LENGTHS = (1, 127, 129, 300)
EDGE_CASES = [(2, sq, skv, 4, d, sq < skv)
              for sq in EDGE_LENGTHS for skv in EDGE_LENGTHS if sq != skv for d in (64, 128)]
MODES = {
    "plain": lambda causal: {},
    "window": lambda causal: dict(window=(-40, 0) if causal else (-90, 40)),
    "dropout": lambda causal: dict(dropout_rate=0.1, dropout_seed=77),
}
COUNTERS = {"plain": ("pfa_flash_bwd_dkv", "pfa_flash_bwd_dq"),
            "window": ("pfa_flash_bwd_dkv_window", "pfa_flash_bwd_dq_window"),
            "dropout": ("pfa_flash_bwd_dkv_dropout", "pfa_flash_bwd_dq_dropout")}


def rel_err_norm(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float(torch.linalg.norm(a - b) / max(float(torch.linalg.norm(b)), 1e-9))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _inputs(b, sq, skv, h, d, causal, streams, dev, seed):
    """bf16 q, k, v, dO and the plain forward's o and lse under ``streams``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, do = (torch.randn(b, sq, h, d, generator=gen, device=dev).bfloat16() for _ in range(2))
    k, v = (torch.randn(b, skv, h, d, generator=gen, device=dev).bfloat16() for _ in range(2))
    o, lse = flash_attention_with_lse_plain(q, k, v, causal=causal, **streams)
    return q, k, v, do, o, lse


def _check_against_plain(case, mode, dev, seed):
    b, sq, skv, h, d, causal = case
    streams = MODES[mode](causal)
    q, k, v, do, o, lse = _inputs(b, sq, skv, h, d, causal, streams, dev, seed)
    kw = dict(sm_scale=d ** -0.5, causal=causal, **streams)
    before = [_build.LAUNCHES[n] for n in COUNTERS[mode]]
    got = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert [_build.LAUNCHES[n] for n in COUNTERS[mode]] == [n + 1 for n in before]
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        assert torch.isfinite(g).all(), name
        if skv == 1 and mode != "dropout" and name != "dv":  # the exact gradient is 0
            assert float(torch.linalg.norm(g.float())) <= 1e-3 * float(
                torch.linalg.norm(want[2].float())), name
        else:
            assert rel_err_norm(g, w) <= BOUND, (name, rel_err_norm(g, w))
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("case", EDGE_CASES, ids=lambda c: "q{}k{}d{}{}".format(*c[1:3], c[4],
                                                                                 "c" if c[5] else "n"))
def test_bwd_edges_match_plain(case, mode, cuda_device):
    _check_against_plain(case, mode, cuda_device, seed=case[1] * 1000 + case[2])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_window_rows_without_a_key_get_zero_grads(d, cuda_device):
    """Window (-20, -5), not causal: rows 0-4 see no key (lse = -inf); their
    dq is 0 and they add nothing to dk/dv."""
    q, k, v, do, o, lse = _inputs(2, 300, 300, 4, d, False, dict(window=(-20, -5)), cuda_device, 3)
    assert torch.isneginf(lse[..., :5]).all()
    kw = dict(sm_scale=d ** -0.5, causal=False, window=(-20, -5))
    dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert (dq[:, :5] == 0).all()
    for g, w in zip((dq, dk, dv), want):
        assert torch.isfinite(g).all() and rel_err_norm(g, w) <= BOUND


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("d", [64, 128])
def test_repeat_launches_are_bit_identical(d, mode, cuda_device):
    """Two kernels, no atomics: the same inputs give the same bits."""
    b, sq, skv, h, causal = 2, 1000, 1000, 4, True
    streams = MODES[mode](causal)
    q, k, v, do, o, lse = _inputs(b, sq, skv, h, d, causal, streams, cuda_device, 5)
    o = o.contiguous()
    kw = dict(sm_scale=d ** -0.5, causal=causal, **streams)

    def call():
        dq, di = flash_bwd_dq(q, k, v, o, lse, do, **kw)
        return (dq, di, *flash_bwd_dkv(q, k, v, do, lse, di, **kw))

    first, second = call(), call()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(MODES))
def test_each_wrapper_counts_one_launch(mode, cuda_device):
    """flash_bwd_dq and flash_bwd_dkv each add one to their mode's counter
    and to no other."""
    q, k, v, do, o, lse = _inputs(1, 256, 256, 2, 64, True, MODES[mode](True), cuda_device, 9)
    kw = dict(sm_scale=0.125, causal=True, **MODES[mode](True))
    before = dict(_build.LAUNCHES)
    _, di = flash_bwd_dq(q, k, v, o.contiguous(), lse, do, **kw)
    after_dq = dict(_build.LAUNCHES)
    flash_bwd_dkv(q, k, v, do, lse, di, **kw)
    torch.cuda.synchronize()
    dkv_name, dq_name = COUNTERS[mode]
    assert {n: c - before.get(n, 0) for n, c in after_dq.items() if c != before.get(n, 0)} == {
        dq_name: 1}
    assert {n: c - after_dq.get(n, 0) for n, c in _build.LAUNCHES.items()
            if c != after_dq.get(n, 0)} == {dkv_name: 1}


@pytest.mark.cuda
@pytest.mark.parametrize("hq, hkv, s, d", [(12, 4, 300, 64), (32, 8, 129, 128)])
def test_gqa_grads_through_autograd_match_cpu(hq, hkv, s, d, cuda_device):
    """flash_attention's backward on the card (K1 with lse, then K5 and K4
    on K/V with their own heads, nothing around them) against the same bf16
    call on the CPU (the plain versions)."""
    gen = torch.Generator().manual_seed(hq)
    q, g = (torch.randn(2, s, hq, d, generator=gen).bfloat16() for _ in range(2))
    k, v = (torch.randn(2, s, hkv, d, generator=gen).bfloat16() for _ in range(2))

    def grads(device):
        leaves = [t.to(device).requires_grad_() for t in (q, k, v)]
        return torch.autograd.grad(flash_attention(*leaves, causal=True), leaves, g.to(device))

    before = [_build.LAUNCHES[n] for n in ("pfa_flash_fwd", *COUNTERS["plain"])]
    got = grads(cuda_device)
    torch.cuda.synchronize()
    assert [_build.LAUNCHES[n] for n in ("pfa_flash_fwd", *COUNTERS["plain"])] == [
        n + 1 for n in before]
    for name, a, w in zip(("dq", "dk", "dv"), got, grads("cpu")):
        assert a.dtype == torch.bfloat16 and a.shape == w.shape and torch.isfinite(a).all()
        assert rel_err_norm(a.cpu(), w) <= BOUND, (name, rel_err_norm(a.cpu(), w))


def _gqa_inputs(b, sq, skv, hq, hkv, d, causal, streams, dtype, dev, seed):
    """q, k (Hkv heads), v, dO and the plain forward's o (contiguous) and lse."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, do = (torch.randn(b, sq, hq, d, generator=gen, device=dev).to(dtype) for _ in range(2))
    k, v = (torch.randn(b, skv, hkv, d, generator=gen, device=dev).to(dtype) for _ in range(2))
    o, lse = flash_attention_with_lse_plain(q, k, v, causal=causal, **streams)
    return q, k, v, do, o.contiguous(), lse


# (B, Sq, Skv, Hq, Hkv, D, causal): groups 2, 4 and 8/1 (MQA) at D 64, the
# Llama-2-70B group 64/8 at D 128, and GQA at Sq < Skv.
GQA_CASES = [(2, 300, 300, 4, 2, 64, True), (2, 300, 300, 8, 2, 64, False),
             (2, 257, 257, 8, 1, 64, True), (1, 300, 300, 64, 8, 128, True),
             (2, 129, 300, 8, 2, 128, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("case", GQA_CASES, ids=lambda c: "q{}k{}h{}-{}d{}{}".format(
    *c[1:6], "c" if c[6] else "n"))
def test_native_gqa_matches_plain_at_every_slice_count(case, mode, cuda_device):
    """flash_attention_bwd on K/V with Hkv heads (the planner's slices) and
    K4 at every slice count of the group, against the plain version; one
    K5 and one K4 launch a call; dk, dv with Hkv heads."""
    b, sq, skv, hq, hkv, d, causal = case
    streams = MODES[mode](causal)
    q, k, v, do, o, lse = _gqa_inputs(b, sq, skv, hq, hkv, d, causal, streams, torch.bfloat16,
                                      cuda_device, seed=sq + hq)
    kw = dict(sm_scale=d ** -0.5, causal=causal, **streams)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    before = [_build.LAUNCHES[n] for n in COUNTERS[mode]]
    got = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert [_build.LAUNCHES[n] for n in COUNTERS[mode]] == [n + 1 for n in before]
    _, di = flash_bwd_dq(q, k, v, o, lse, do, **kw)
    for slices in [n for n in range(1, hq // hkv + 1) if (hq // hkv) % n == 0]:
        got += flash_bwd_dkv(q, k, v, do, lse, di, slices=slices, **kw)
    torch.cuda.synchronize()
    for i, (g, w) in enumerate(zip(got, want + want[1:] * ((len(got) - 3) // 2))):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape and torch.isfinite(g).all(), i
        assert rel_err_norm(g, w) <= BOUND, (i, rel_err_norm(g, w))


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(2, 200, 200, 4, 2, 64, True), (2, 129, 300, 8, 2, 128, True),
                                  (1, 256, 256, 8, 1, 128, False)],
                         ids=["gqa4to2", "gqa8to2_sq_lt_skv", "mqa_d128"])
def test_native_gqa_fp32_matches_plain(case, cuda_device):
    """The fp32 FMA bodies: K5 over Hq heads on the KV head's tiles, K4 over
    Hkv with a loop over the group; 1e-4 against the plain version."""
    b, sq, skv, hq, hkv, d, causal = case
    q, k, v, do, o, lse = _gqa_inputs(b, sq, skv, hq, hkv, d, causal, {}, torch.float32,
                                      cuda_device, seed=7)
    kw = dict(sm_scale=d ** -0.5, causal=causal)
    got = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert rel_err_norm(g, w) <= 1e-4, rel_err_norm(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("mode", list(MODES))
def test_k5_di_matches_flash_bwd_di(dtype, mode, cuda_device):
    """K5's prologue di = rowsum(o * dO) against the plain helper, fp32,
    1e-6 relative (the same products, summed in another order); rows past
    Sq are not written, the ragged last block included (Sq 300)."""
    causal = True
    streams = MODES[mode](causal)
    q, k, v, do, o, lse = _gqa_inputs(2, 300, 300, 8, 2, 64, causal, streams, dtype,
                                      cuda_device, seed=21)
    _, di = flash_bwd_dq(q, k, v, o, lse, do, sm_scale=0.125, causal=causal, **streams)
    torch.cuda.synchronize()
    want = flash_bwd_di(o, do)
    assert di.shape == want.shape == (2, 8, 300) and di.dtype == torch.float32
    assert rel_err_norm(di, want) <= 1e-6, rel_err_norm(di, want)


@pytest.mark.cuda
@pytest.mark.parametrize("slices", [None, 4, 8], ids=["planner", "4", "8"])
def test_split_k4_is_bit_identical_across_calls(slices, cuda_device):
    """At Llama-2-70B's B1 S2048 Hq64/Hkv8 D128 causal, where K4 splits each
    group (the planner's 2 slices, and 4 and 8): the slices' partials are
    summed in slice order whichever arrives last, so two calls give the
    same bits in dq, dk and dv."""
    q, k, v, do, o, lse = _gqa_inputs(1, 2048, 2048, 64, 8, 128, True, {}, torch.bfloat16,
                                      cuda_device, seed=23)
    kw = dict(sm_scale=128 ** -0.5, causal=True)
    if slices is None:
        sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
        assert k4_slices(1, 2048, 2048, 64, 8, True, None, sms) > 1
        runs = [flash_attention_bwd(q, k, v, o, lse, do, **kw) for _ in range(2)]
    else:
        _, di = flash_bwd_dq(q, k, v, o, lse, do, **kw)
        runs = [flash_bwd_dkv(q, k, v, do, lse, di, slices=slices, **kw) for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))
