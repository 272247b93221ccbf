"""K4 (dK/dV) and K5 (dQ), the bf16 Hopper backward, against the plain
backward on the GPU.

Every test here carries the ``cuda`` marker and skips without a GPU. The
file imports no JAX, so it also runs on a machine that has none:

    python -m pytest tests/test_torch_cuda_bwd.py -m cuda --noconftest -q

At the kernels' edges (every Sq != Skv among 1, 127, 129 and 300, causal
where Sq < Skv; D 64 and 128) in each stream mode (plain, window, dropout
0.1), dq, dk and dv must agree with ``flash_attention_bwd_plain`` on the
same inputs within 1e-2 ``rel_err_norm`` (bf16 rounding of P and dS), each
call must launch K4 and K5 once under its mode's counter, and two launches
on the same inputs must give bit-identical results (no atomics). The plain
version at these geometries is anchored to JAX's grid pair on the CPU
(``tests/test_torch_flash_bwd.py``). Rows that see no key in a window get
zero gradients; GQA 12/4 and 32/8 run through ``flash_attention``'s
autograd (K/V repeated, dk/dv summed over the group) against the CPU.

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
    di = flash_bwd_di(o, do)
    kw = dict(sm_scale=d ** -0.5, causal=causal, **streams)
    first = (*flash_bwd_dkv(q, k, v, do, lse, di, **kw), flash_bwd_dq(q, k, v, do, lse, di, **kw))
    second = (*flash_bwd_dkv(q, k, v, do, lse, di, **kw), flash_bwd_dq(q, k, v, do, lse, di, **kw))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(MODES))
def test_each_wrapper_counts_one_launch(mode, cuda_device):
    """flash_bwd_dkv and flash_bwd_dq each add one to their mode's counter
    and to no other."""
    q, k, v, do, o, lse = _inputs(1, 256, 256, 2, 64, True, MODES[mode](True), cuda_device, 9)
    di = flash_bwd_di(o, do)
    kw = dict(sm_scale=0.125, causal=True, **MODES[mode](True))
    before = dict(_build.LAUNCHES)
    flash_bwd_dkv(q, k, v, do, lse, di, **kw)
    after_dkv = dict(_build.LAUNCHES)
    flash_bwd_dq(q, k, v, do, lse, di, **kw)
    torch.cuda.synchronize()
    dkv_name, dq_name = COUNTERS[mode]
    assert {n: c - before.get(n, 0) for n, c in after_dkv.items() if c != before.get(n, 0)} == {
        dkv_name: 1}
    assert {n: c - after_dkv.get(n, 0) for n, c in _build.LAUNCHES.items()
            if c != after_dkv.get(n, 0)} == {dq_name: 1}


@pytest.mark.cuda
@pytest.mark.parametrize("hq, hkv, s, d", [(12, 4, 300, 64), (32, 8, 129, 128)])
def test_gqa_grads_through_autograd_match_cpu(hq, hkv, s, d, cuda_device):
    """flash_attention's backward on the card (K1 with lse, K4, K5; the GQA
    repeat and group sum around them) against the same bf16 call on the CPU
    (the plain versions)."""
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
