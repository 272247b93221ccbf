"""Port parity: the attention backward with native GQA (K/V with Hkv heads).

K4/K5's contract takes K/V with their own Hkv heads (query head h reads KV
head h // (Hq / Hkv)) and returns dk/dv with Hkv heads, summed over the
group in fp32 and rounded once. Here, on the CPU:

* ``flash_attention_bwd`` (K4/K5's plain version) on Hkv K/V against the
  JAX grid pair ``flash_attention_bwd_pallas`` in interpret mode, fed the
  same K/V repeated over the group, its dk/dv summed over the group in
  numpy: Hq/Hkv 2/2, 4/2, 8/2 and 4/1 (MQA), causal and not, and Sq < Skv;
* each of the three autograd Functions of ``flash_attention`` (plain,
  window, dropout; key streams; relative bias) against ``jax.vjp`` of the
  JAX ``flash_attention`` at a GQA group;
* the argument rules (Hq a multiple of Hkv) and K4's slice planner.

Tolerance: fp32 rtol = atol = 2e-4 on every gradient, as
``tests/test_torch_flash_bwd.py``'s backward checks (fp32 sums taken in
another order; the kernels are not involved on the CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photonic_flash_attention_tpu.ops import rel_bias as jrb
from photonic_flash_attention_tpu.ops.flash import flash_attention as jax_flash
from photonic_flash_attention_tpu.ops.flash_bwd import flash_attention_bwd_pallas
from photonic_flash_attention_tpu_torch.ops import rel_bias as trb
from photonic_flash_attention_tpu_torch.ops.flash import (
    flash_attention,
    flash_attention_with_lse_plain,
)
from photonic_flash_attention_tpu_torch.ops.flash_bwd import (
    flash_attention_bwd,
    flash_attention_bwd_masked_plain,
    k4_query_tiles,
    k4_slices,
)
from photonic_flash_attention_tpu_torch.ops.reference import DEFAULT_MASK_VALUE, window_keep

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(b, sq, skv, hq, hkv, d, seed):
    """fp32 numpy q, k, v and a cotangent g (q's shape)."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d), (b, sq, hq, d))]


def _bhsd(a):
    return jnp.asarray(np.ascontiguousarray(a.transpose(0, 2, 1, 3)))


# (B, Sq, Skv, Hq, Hkv, D, causal): groups 1, 2, 4 and MQA (4/1), causal
# and not; the last two at Sq < Skv (end-aligned causal).
BWD_CASES = [
    (1, 128, 128, 2, 2, 64, True),
    (1, 128, 128, 4, 2, 64, True),
    (1, 128, 128, 4, 2, 64, False),
    (1, 128, 128, 8, 2, 64, True),
    (1, 128, 128, 8, 2, 64, False),
    (1, 128, 128, 4, 1, 64, True),
    (1, 128, 128, 4, 1, 64, False),
    (2, 128, 256, 4, 2, 64, True),
    (1, 128, 256, 4, 1, 128, False),
]


@pytest.mark.parametrize("case", BWD_CASES, ids=lambda c: "b{}q{}k{}h{}-{}d{}{}".format(
    *c[:6], "c" if c[6] else "n"))
def test_bwd_plain_gqa_matches_jax_grid_pair_with_group_sum(case):
    b, sq, skv, hq, hkv, d, causal = case
    group = hq // hkv
    q, k, v, do = _arrays(b, sq, skv, hq, hkv, d, seed=sq + hq)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = flash_attention_with_lse_plain(tq, tk, tv, causal=causal)
    got = flash_attention_bwd(tq, tk, tv, o, lse, tdo, sm_scale=d ** -0.5, causal=causal)
    kr, vr = (np.repeat(a, group, axis=2) for a in (k, v))
    ref = flash_attention_bwd_pallas(
        _bhsd(q), _bhsd(kr), _bhsd(vr), _bhsd(o.numpy()), jnp.asarray(lse.numpy()), _bhsd(do),
        sm_scale=d ** -0.5, causal=causal, block_q=128, block_kv=128, interpret=True)
    dq, dk, dv = (np.asarray(r).transpose(0, 2, 1, 3) for r in ref)
    dk, dv = (t.reshape(b, skv, hkv, group, d).sum(3) for t in (dk, dv))
    assert got[1].shape == got[2].shape == (b, skv, hkv, d)
    for name, g, r in zip(("dq", "dk", "dv"), got, (dq, dk, dv)):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), r, err_msg=name, **TOL)


def test_blockwise_plain_gqa_equals_repeat_then_sum():
    """The blockwise plain backward on Hkv K/V equals the same function on
    K/V repeated over the group with dk/dv summed after (one path, not two)."""
    b, sq, skv, hq, hkv, d = 2, 96, 160, 8, 2, 64
    q, k, v, do = (torch.from_numpy(a) for a in _arrays(b, sq, skv, hq, hkv, d, seed=3))
    lens = torch.tensor([160, 90], dtype=torch.int32)
    o, lse = flash_attention_with_lse_plain(q, k, v, causal=True, kv_lens=lens)
    kw = dict(sm_scale=d ** -0.5, causal=True, kv_lens=lens, block_kv=64)
    native = flash_attention_bwd_masked_plain(q, k, v, o, lse, do, **kw)
    kr, vr = (t.repeat_interleave(hq // hkv, dim=2) for t in (k, v))
    rep = flash_attention_bwd_masked_plain(q, kr, vr, o, lse, do, **kw)
    torch.testing.assert_close(native[0], rep[0], rtol=0, atol=0)
    for g, r in zip(native[1:3], rep[1:3]):
        torch.testing.assert_close(g, r.view(b, skv, hkv, hq // hkv, d).sum(3), **TOL)


def _port_and_jax_grads(arrs, port_kw, jax_kw, extra=None):
    """Gradients of sum(o * g) through the port's flash_attention (autograd)
    and the JAX one (jax.vjp), over q, k, v and ``extra`` (a numpy array
    that ``port_kw``/``jax_kw`` turn into each side's keywords)."""
    q, k, v, g = arrs
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    xt = torch.from_numpy(extra).requires_grad_() if extra is not None else None
    out = flash_attention(*leaves, **port_kw(xt))
    (out * torch.from_numpy(g)).sum().backward()
    port = [t.grad for t in leaves] + ([xt.grad] if xt is not None else [])

    def fn(q, k, v, *x):
        return jax_flash(q, k, v, **jax_kw(*x))

    prim = [jnp.asarray(a) for a in (q, k, v)] + ([jnp.asarray(extra)] if extra is not None else [])
    o, vjp = jax.vjp(fn, *prim)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(o), rtol=2e-5, atol=2e-5)
    return port, vjp(jnp.asarray(g))


def _check(port, ref, names):
    for name, p, r in zip(names, port, ref):
        assert p is not None, name
        np.testing.assert_allclose(p.numpy(), np.asarray(r), err_msg=name, **TOL)


@pytest.mark.parametrize("hq, hkv, causal", [(4, 2, True), (8, 2, False), (4, 1, True)],
                         ids=["gqa4to2c", "gqa8to2n", "mqa4c"])
def test_plain_function_grads_gqa_match_jax_vjp(hq, hkv, causal):
    arrs = _arrays(1, 128, 128, hq, hkv, 64, seed=11)
    port, ref = _port_and_jax_grads(arrs, lambda _: dict(causal=causal),
                                    lambda: dict(causal=causal, block_q=128, block_kv=128))
    _check(port, ref, ("dq", "dk", "dv"))


def test_window_function_grads_gqa_match_jax_vjp():
    arrs = _arrays(1, 256, 256, 8, 2, 64, seed=12)
    window = (-60, 20)
    port, ref = _port_and_jax_grads(
        arrs, lambda _: dict(causal=False, window=window),
        lambda: dict(causal=False, window=window, block_q=128, block_kv=128))
    _check(port, ref, ("dq", "dk", "dv"))


def test_dropout_function_grads_gqa_match_jax_vjp():
    arrs = _arrays(1, 128, 256, 4, 2, 64, seed=13)
    kw = dict(causal=True, dropout_rate=0.2, dropout_seed=1234)
    port, ref = _port_and_jax_grads(arrs, lambda _: kw,
                                    lambda: dict(block_q=128, block_kv=128, **kw))
    _check(port, ref, ("dq", "dk", "dv"))


def test_key_stream_function_grads_gqa_match_jax_vjp():
    """kv_lens and k_bias (the masked Function, its plain backward on Hkv
    K/V): dq, dk, dv and the k_bias gradient."""
    b, s = 2, 128
    arrs = _arrays(b, s, s, 4, 2, 64, seed=14)
    rng = np.random.default_rng(15)
    lens = np.array([s, 77], np.int32)
    bias = np.where(rng.random((b, s)) < 0.2, DEFAULT_MASK_VALUE,
                    rng.standard_normal((b, s))).astype(np.float32)
    bias[:, 0] = 0.0
    port, ref = _port_and_jax_grads(
        arrs, lambda kb: dict(causal=True, kv_lens=torch.from_numpy(lens), k_bias=kb),
        lambda kb: dict(causal=True, kv_lens=jnp.asarray(lens), k_bias=kb), extra=bias)
    _check(port, ref, ("dq", "dk", "dv", "dk_bias"))


def test_rel_bias_function_grads_gqa_match_jax_vjp():
    """T5's relative bias (the relative-bias Function, its plain backward
    on Hkv K/V): dq, dk, dv and the table's gradient."""
    hq = 4
    arrs = _arrays(1, 128, 128, hq, 2, 64, seed=16)
    table = (np.random.default_rng(17).standard_normal((32, hq)) * 0.5).astype(np.float32)
    port, ref = _port_and_jax_grads(
        arrs, lambda t: dict(causal=True, sm_scale=1.0, rel_bias=trb.T5RelBias(t, False, 128)),
        lambda t: dict(causal=True, sm_scale=1.0, rel_bias=jrb.T5RelBias(t, False, 128),
                       block_q=128, block_kv=128), extra=table)
    _check(port, ref, ("dq", "dk", "dv", "dtable"))


def _zeros(hq, hkv):
    q, o, do = (torch.zeros(1, 8, hq, 64) for _ in range(3))
    k, v = torch.zeros(1, 8, hkv, 64), torch.zeros(1, 8, hkv, 64)
    return q, k, v, o, torch.zeros(1, hq, 8), do


@pytest.mark.parametrize("hq, hkv", [(3, 2), (4, 3), (2, 4)])
def test_flash_attention_bwd_rejects_heads_not_a_multiple(hq, hkv):
    with pytest.raises(ValueError, match="multiple of the k/v heads"):
        flash_attention_bwd(*_zeros(hq, hkv), sm_scale=0.125, causal=True)


@pytest.mark.parametrize("hq, hkv", [(4, 2), (8, 1)])
def test_cpu_bwd_returns_kv_heads(hq, hkv):
    dq, dk, dv = flash_attention_bwd(*_zeros(hq, hkv), sm_scale=0.125, causal=True)
    assert dq.shape == (1, 8, hq, 64) and dk.shape == dv.shape == (1, 8, hkv, 64)


@pytest.mark.parametrize("sq, skv, causal, window", [
    (2048, 2048, True, None), (300, 300, False, None), (129, 300, True, (-40, 0)),
    (300, 129, False, (-90, 40)), (1, 127, False, (-20, -5)), (300, 300, False, (-20, -5))])
def test_k4_query_tiles_cover_each_key_blocks_queries(sq, skv, causal, window):
    """The query tiles the planner counts for each 128-key block are those
    that hold a query seeing one of its keys (the plain mask), from the
    first such tile, floored to 64 rows, to the last."""
    keep = window_keep(sq, skv, causal, window, torch.device("cpu"))
    keep = torch.ones(sq, skv, dtype=torch.bool) if keep is None else keep.reshape(sq, skv)
    for kb, n in enumerate(k4_query_tiles(sq, skv, causal, window)):
        rows = keep[:, kb * 128:(kb + 1) * 128].any(1).nonzero().flatten()
        if len(rows) == 0:
            assert n == 0, kb
            continue
        first, last = int(rows[0]) // 64 * 64, int(rows[-1])
        assert first + (n - 1) * 64 <= last < first + n * 64, kb


def test_k4_slices_planner():
    """One slice for MHA, groups of 2 and where one slice a group already
    balances; more where the first key block's work would outlast an SM's
    mean, but never one head a slice; the count always divides the group."""
    assert k4_slices(4, 2048, 2048, 12, 12, True) == 1
    assert k4_slices(1, 2048, 2048, 8, 4, True) == 1
    assert k4_slices(1, 2048, 2048, 64, 8, True, sms=132) == 2
    assert k4_slices(1, 1024, 1024, 64, 8, True, sms=132) == 4
    assert k4_slices(1, 512, 512, 64, 8, True, sms=132) == 4
    assert k4_slices(2, 4096, 4096, 32, 8, True, sms=132) == 1
    assert k4_slices(1, 2048, 2048, 64, 8, True, sms=1) == 1
    for args in [(1, 300, 300, 12, 4, True), (2, 513, 513, 32, 8, True), (1, 64, 64, 8, 1, False)]:
        n = k4_slices(*args)
        group = args[3] // args[4]
        assert group % n == 0 and group // n >= 2
