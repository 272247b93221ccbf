"""Port parity: device detection and the roofline cost and energy model.

The port's ``hardware/roofline.py`` keeps JAX's formulas with one new
field in the record, the matrix unit's contraction width. A port record
that holds a JAX row's numbers with width 128 must give JAX's results to
1e-12 relative (the same float operations in the same order); the H100
row (width 16) must not derate head dim 64, where JAX's 128-wide MXU
derates it by half. Detection on the CPU: JAX's keys and JAX's CPU row.
"""

import dataclasses

import pytest

from photonic_flash_attention_tpu.hardware import detection as jax_det
from photonic_flash_attention_tpu.hardware import roofline as jax_rl
from photonic_flash_attention_tpu_torch.hardware import detection as det
from photonic_flash_attention_tpu_torch.hardware import roofline as rl

REL = 1e-12
JAX_ROWS = sorted(jax_det._CAPABILITY_TABLE)


def _port_record(generation: str) -> det.TPUCapabilities:
    """JAX's row as a port record, contraction width 128."""
    return det.TPUCapabilities(*dataclasses.astuple(jax_det._CAPABILITY_TABLE[generation]),
                               contraction_width=128)


def _same(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (bool, str)):
        assert a == b
    else:
        assert a == pytest.approx(b, rel=REL, abs=0.0)


def _cost(c):
    return {"flops": c.flops, "hbm_bytes": c.hbm_bytes, "t_compute_us": c.t_compute_us,
            "t_memory_us": c.t_memory_us, **c.as_dict()}


PREFILL = [
    (4, 2048, 2048, 12, 64, True, "bf16"),
    (1, 512, 4096, 16, 128, False, "int8"),
    (2, 1024, 1024, 8, 32, False, "fp8"),
    (8, 100, 100, 4, 256, True, "f32"),
]


@pytest.mark.parametrize("generation", JAX_ROWS)
def test_cost_functions_match_jax(generation):
    caps, jcaps = _port_record(generation), jax_det._CAPABILITY_TABLE[generation]
    for b, sq, skv, h, d, causal, dtype in PREFILL:
        _same(_cost(rl.attention_prefill_cost(b, sq, skv, h, d, causal=causal, dtype=dtype,
                                              caps=caps)),
              _cost(jax_rl.attention_prefill_cost(b, sq, skv, h, d, causal=causal, dtype=dtype,
                                                  caps=jcaps)))
    for kv_dtype in ("bf16", "int8"):
        _same(_cost(rl.attention_decode_cost(8, 8192, 32, 8, 128, kv_dtype=kv_dtype, caps=caps)),
              _cost(jax_rl.attention_decode_cost(8, 8192, 32, 8, 128, kv_dtype=kv_dtype,
                                                 caps=jcaps)))
    for dtype in ("bf16", "int8"):
        _same(_cost(rl.matmul_cost(4096, 1024, 512, dtype=dtype, caps=caps)),
              _cost(jax_rl.matmul_cost(4096, 1024, 512, dtype=dtype, caps=jcaps)))
    _same(rl.ring_attention_step_cost(1, 8192, 16, 128, 4, caps=caps),
          jax_rl.ring_attention_step_cost(1, 8192, 16, 128, 4, caps=jcaps))
    cost = rl.matmul_cost(4096, 4096, 4096, caps=caps)
    _same(rl.roofline_fraction(123.4, cost),
          jax_rl.roofline_fraction(123.4, jax_rl.matmul_cost(4096, 4096, 4096, caps=jcaps)))


RATES = {"hbm_read_Bps": 2.9e12, "vpu_softmax_elems_per_s": 3.3e12,
         "vpu_softmax_fixed_s_per_tile": 2e-7, "vpu_exp_elems_per_s": 3.9e12}


@pytest.mark.parametrize("generation", JAX_ROWS)
@pytest.mark.parametrize("score, pv, hkv", [("bf16", "bf16", None), ("int8", "bf16", 4),
                                            ("int8", "int8", 12)])
def test_composite_ceiling_matches_jax(generation, score, pv, hkv):
    caps, jcaps = _port_record(generation), jax_det._CAPABILITY_TABLE[generation]
    for b, s, h, d, causal in ((4, 2048, 12, 64, True), (1, 8192, 32, 128, False)):
        got = rl.attention_composite_ceiling(b, s, s, h, d, causal=causal, score_dtype=score,
                                             pv_dtype=pv, num_kv_heads=hkv, rates=RATES,
                                             caps=caps)
        want = jax_rl.attention_composite_ceiling(b, s, s, h, d, causal=causal,
                                                  score_dtype=score, pv_dtype=pv,
                                                  num_kv_heads=hkv, rates=RATES, caps=jcaps)
        _same(got, want)
        _same(rl.composite_fraction(250.0, got), jax_rl.composite_fraction(250.0, want))


def test_energy_matches_jax(monkeypatch):
    """kernel_energy_mj with JAX's static power: JAX's value. The energy
    constants themselves are JAX's; the static power is the card's idle
    draw."""
    assert rl.PJ_PER_FLOP == jax_rl.PJ_PER_FLOP
    assert rl.PJ_PER_HBM_BYTE == jax_rl.PJ_PER_HBM_BYTE
    assert set(rl.H100_MEASURED_RATES) == set(jax_rl.V5E_MEASURED_RATES)
    monkeypatch.setattr(rl, "STATIC_POWER_W", jax_rl.STATIC_POWER_W)
    caps, jcaps = _port_record("v5e"), jax_det._CAPABILITY_TABLE["v5e"]
    for dtype in ("bf16", "int8", "int8qk", "fp8qk", "f32", "unknown"):
        cost = rl.attention_prefill_cost(2, 1024, 1024, 8, 64, causal=True, caps=caps)
        jcost = jax_rl.attention_prefill_cost(2, 1024, 1024, 8, 64, causal=True, caps=jcaps)
        _same(rl.kernel_energy_mj(cost, 0.37, dtype=dtype),
              jax_rl.kernel_energy_mj(jcost, 0.37, dtype=dtype))


def test_h100_row_does_not_derate_head_dim_64():
    """D = 64 fills a 16-deep bf16 mma; JAX's 128-wide rule halves it."""
    h100 = det._CAPABILITY_TABLE["h100"]
    assert (h100.bf16_tflops, h100.int8_tops, h100.hbm_gb, h100.hbm_gbps, h100.ici_gbps,
            h100.contraction_width) == (989.0, 1979.0, 80.0, 3350.0, 450.0, 16)
    as_jax = jax_det.TPUCapabilities(*dataclasses.astuple(h100)[:-1])
    got = rl.attention_prefill_cost(4, 2048, 2048, 12, 64, causal=True, caps=h100)
    jax_derated = jax_rl.attention_prefill_cost(4, 2048, 2048, 12, 64, causal=True, caps=as_jax)
    assert got.t_compute_us == pytest.approx(got.flops / 989e12 * 1e6, rel=REL)
    assert got.t_compute_us == pytest.approx(jax_derated.t_compute_us / 2, rel=REL)
    assert got.t_memory_us == pytest.approx(jax_derated.t_memory_us, rel=REL)
    narrow = rl.attention_prefill_cost(1, 128, 128, 1, 8, caps=h100)
    assert narrow.t_compute_us == pytest.approx(narrow.flops / (989e12 * 0.5) * 1e6, rel=REL)
    ceil = rl.attention_composite_ceiling(4, 2048, 2048, 12, 64, causal=True, rates=RATES,
                                          caps=h100)
    assert ceil["t_mxu_us"] == pytest.approx(2 * 2 * ceil["n_scores"] * 64 / 989e12 * 1e6,
                                             rel=REL)


def test_detection_on_the_cpu_matches_jax():
    info, jinfo = det.get_device_info(), jax_det.get_device_info()
    assert set(info) == set(jinfo)
    assert info["simulated"] and info["device_count"] == 1
    assert [set(d) for d in info["devices"]] == [set(d) for d in jinfo["devices"]][:1]
    (dev,) = det.detect_tpu_hardware(refresh=True)
    assert dev.platform == "cpu" and dev.is_simulated and dev.kind == "cpu"
    assert dev.capabilities == _port_record("cpu")
    assert det.get_best_tpu_device() is dev
    assert rl._caps(None) == _port_record("cpu")


@pytest.mark.parametrize("name", ["NVIDIA H100 80GB HBM3", "NVIDIA H100 SXM5 80GB"])
def test_classify_h100(name):
    assert det._classify(name) == "h100"


@pytest.mark.parametrize("name", ["NVIDIA A100-SXM4-80GB", "NVIDIA H100 PCIe", "NVIDIA H100 NVL"])
def test_a_card_not_in_the_table_raises(name):
    with pytest.raises(RuntimeError, match=name):
        det._classify(name)


@pytest.mark.parametrize("name, generation", [("NVIDIA H100 80GB HBM3", "h100"),
                                              ("NVIDIA A100-SXM4-80GB", None),
                                              ("NVIDIA H100 PCIe", None)])
def test_known_capabilities_never_raises(monkeypatch, name, generation):
    """known_capabilities (the engine's record) gives the table's row or
    None for a card it lacks, where detection itself raises."""

    class Props:
        pass

    props = Props()
    props.name = name
    monkeypatch.setattr(det.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(det.torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(det.torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(det.torch.cuda, "get_device_properties", lambda i: props)
    try:
        caps = det.known_capabilities()
        assert (caps.generation if caps else None) == generation
        if generation is None:
            with pytest.raises(RuntimeError, match=name):
                det.detect_tpu_hardware(refresh=True)
        else:
            (dev,) = det.detect_tpu_hardware(refresh=True)
            assert dev.platform == "gpu" and dev.kind == name and dev.capabilities is caps
    finally:
        monkeypatch.undo()
        det.detect_tpu_hardware(refresh=True)
    assert det.known_capabilities() == _port_record("cpu")
