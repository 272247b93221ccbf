"""Port parity: paged decode (token write K2 + attend K3) against the JAX package.

The JAX ``paged_decode_attention`` runs its fused Pallas kernel in
interpret mode on the CPU; the port runs the plain versions of K2 and K3.
Pools hold the same values in the two layouts (JAX token-minor
``(L, Hkv, P, D, page)``, port token-major ``(L, Hkv, P, page, D)``,
converted by ``to_jax_layout``). After the write, int8 payloads and bf16
pools are equal exactly and scales to 1e-6 relative; the attention output
agrees within 1e-4 max-abs (bf16 pool) or 1e-4 ``rel_err_norm`` (int8
pool: both sides dequantize identical values).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photonic_flash_attention_tpu.ops.paged import (
    _quant_token_write as jax_quant,
    paged_attention_xla as jax_paged_xla,
    paged_decode_attention as jax_paged_decode,
)
from photonic_flash_attention_tpu_torch.ops.paged import (
    _quant_token_write,
    paged_attention_xla,
    paged_decode_attend,
    paged_decode_attention,
    paged_token_write,
    paged_token_write_plain,
    to_jax_layout,
)

from .conftest import rel_err_norm

L, HQ, HKV, D, PAGE, NUM_PAGES, PPS = 2, 4, 2, 64, 16, 24, 4
# Lengths include the current token: an empty slot, a partial first page,
# a partial second page, a token on a page boundary, a full table.
LENGTHS = [0, 5, 23, 33, 64]
B = len(LENGTHS)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(quantized: bool, seed: int = 0):
    """numpy inputs in the JAX layout: scattered page tables, flat slots of
    each sequence's current token (trash page 0 for the empty slot)."""
    rng = np.random.default_rng(seed)
    shape = (L, HKV, NUM_PAGES, D, PAGE)
    if quantized:
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        ks = rng.uniform(1e-3, 5e-2, shape[:3] + (PAGE,)).astype(np.float32)
        vs = rng.uniform(1e-3, 5e-2, shape[:3] + (PAGE,)).astype(np.float32)
    else:
        k = rng.standard_normal(shape).astype(np.float32)
        v = rng.standard_normal(shape).astype(np.float32)
        ks = vs = None
    tables = (rng.permutation(NUM_PAGES - 1)[: B * PPS] + 1).reshape(B, PPS).astype(np.int32)
    slots = np.zeros(B, np.int32)
    for i, n in enumerate(LENGTHS):
        if n:
            slots[i] = tables[i, (n - 1) // PAGE] * PAGE + (n - 1) % PAGE
    q = rng.standard_normal((B, HQ, D)).astype(np.float32)
    k_new = rng.standard_normal((B, HKV, D)).astype(np.float32)
    v_new = rng.standard_normal((B, HKV, D)).astype(np.float32)
    k_new[2, 1] = 0.0  # an all-zero token takes scale 1
    return dict(q=q, k=k, v=v, ks=ks, vs=vs, tables=tables, slots=slots,
                k_new=k_new, v_new=v_new, lengths=np.asarray(LENGTHS, np.int32))


def _port_pool(a, dtype):
    return to_jax_layout(torch.from_numpy(a)).contiguous().to(dtype)


@pytest.mark.parametrize("layer", [0, 1])
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_paged_decode_attention_matches_jax(kv, layer):
    quantized = kv == "int8"
    p = _problem(quantized, seed=layer)
    pool_jdt = jnp.int8 if quantized else jnp.bfloat16
    pool_tdt = torch.int8 if quantized else torch.bfloat16
    j_out = jax_paged_decode(
        jnp.asarray(p["q"]),
        jnp.asarray(p["k_new"], jnp.bfloat16),
        jnp.asarray(p["v_new"], jnp.bfloat16),
        jnp.asarray(p["k"], pool_jdt),
        jnp.asarray(p["v"], pool_jdt),
        jnp.asarray(p["lengths"]),
        jnp.asarray(p["tables"]),
        jnp.asarray(p["slots"]),
        jnp.asarray(layer, jnp.int32),
        jnp.asarray(p["ks"]) if quantized else None,
        jnp.asarray(p["vs"]) if quantized else None,
    )
    kp, vp = _port_pool(p["k"], pool_tdt), _port_pool(p["v"], pool_tdt)
    ks = torch.from_numpy(p["ks"]) if quantized else None
    vs = torch.from_numpy(p["vs"]) if quantized else None
    lengths, tables = torch.from_numpy(p["lengths"]), torch.from_numpy(p["tables"])
    out = paged_decode_attention(
        torch.from_numpy(p["q"]),
        torch.from_numpy(p["k_new"]).bfloat16(),
        torch.from_numpy(p["v_new"]).bfloat16(),
        kp, vp, lengths, tables, torch.from_numpy(p["slots"]), layer, ks, vs,
    )
    # Pools after the write.
    for got, want in ((kp, j_out[1]), (vp, j_out[2])):
        assert np.array_equal(
            to_jax_layout(got).float().numpy(), np.asarray(want, np.float32)
        )
    if quantized:
        for got, want in ((ks, j_out[3]), (vs, j_out[4])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)
    # Attention output.
    j_o = np.asarray(j_out[0])
    if quantized:
        assert rel_err_norm(out.numpy(), j_o) <= 1e-4
    else:
        assert np.max(np.abs(out.numpy() - j_o)) <= 1e-4
    assert np.all(out[0].numpy() == 0.0)  # length 0 -> zeros, as the TPU kernel
    # ... and against the gather oracle on the written pool (rows with tokens).
    ref = paged_attention_xla(
        torch.from_numpy(p["q"]), kp[layer], vp[layer], lengths, tables,
        ks[layer] if quantized else None, vs[layer] if quantized else None,
    )
    assert rel_err_norm(out[1:].numpy(), ref[1:].numpy()) <= 1e-5


@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_paged_attention_xla_matches_jax(kv):
    quantized = kv == "int8"
    p = _problem(quantized, seed=5)
    layer = 1
    j = jax_paged_xla(
        jnp.asarray(p["q"]), jnp.asarray(p["k"][layer]), jnp.asarray(p["v"][layer]),
        jnp.asarray(p["lengths"]), jnp.asarray(p["tables"]),
        jnp.asarray(p["ks"][layer]) if quantized else None,
        jnp.asarray(p["vs"][layer]) if quantized else None,
    )
    dt = torch.int8 if quantized else torch.float32
    out = paged_attention_xla(
        torch.from_numpy(p["q"]),
        _port_pool(p["k"], dt)[layer], _port_pool(p["v"], dt)[layer],
        torch.from_numpy(p["lengths"]), torch.from_numpy(p["tables"]),
        torch.from_numpy(p["ks"][layer]) if quantized else None,
        torch.from_numpy(p["vs"][layer]) if quantized else None,
    )
    assert np.max(np.abs(out.numpy() - np.asarray(j))) <= 1e-5


def test_quant_token_write_matches_jax_bit_exact():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((6, 3, D)).astype(np.float32)
    x[1, 2] = 0.0
    # absmax 127 -> scale exactly 1: ties at .5 round half to even.
    x[2, 0, :4] = [127.0, 2.5, -3.5, 0.5]
    payload, scale = _quant_token_write(torch.from_numpy(x))
    j_payload, j_scale = jax_quant(jnp.asarray(x))
    assert np.array_equal(payload.numpy(), np.asarray(j_payload))
    assert np.array_equal(scale.numpy(), np.asarray(j_scale))
    assert payload[2, 0, :4].tolist() == [127, 2, -4, 0]


def test_plain_token_write_empty_slots_land_in_trash_page():
    p = _problem(True, seed=9)
    kp, vp = _port_pool(p["k"], torch.int8), _port_pool(p["v"], torch.int8)
    ks, vs = torch.from_numpy(p["ks"]), torch.from_numpy(p["vs"])
    before = kp.clone()
    slots = torch.zeros(B, dtype=torch.int32)  # every slot empty
    paged_token_write_plain(
        torch.from_numpy(p["k_new"]), torch.from_numpy(p["v_new"]),
        kp, vp, ks, vs, slots, 0,
    )
    changed = (kp != before).any(dim=-1).nonzero().tolist()
    assert changed and all(c[0] == 0 and c[2] == 0 and c[3] == 0 for c in changed)


def test_wrappers_reject_bad_inputs():
    p = _problem(True)
    kp, vp = _port_pool(p["k"], torch.int8), _port_pool(p["v"], torch.int8)
    k_new = torch.from_numpy(p["k_new"])
    slots = torch.from_numpy(p["slots"])
    with pytest.raises(ValueError, match="scales"):
        paged_token_write(k_new, k_new, kp, vp, None, None, slots, 0)
    ks, vs = torch.from_numpy(p["ks"]), torch.from_numpy(p["vs"])
    with pytest.raises(ValueError, match="int32"):
        paged_token_write(k_new, k_new, kp, vp, ks, vs, slots.long(), 0)
    with pytest.raises(ValueError, match="layer"):
        paged_token_write(k_new, k_new, kp, vp, ks, vs, slots, L)
    with pytest.raises(ValueError, match="float32"):
        paged_decode_attend(
            torch.from_numpy(p["q"]).bfloat16(), kp, vp,
            torch.from_numpy(p["lengths"]), torch.from_numpy(p["tables"]), 0, ks, vs,
        )
