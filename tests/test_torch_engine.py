"""Port parity: the adaptive attention engine behind the drop-in layer.

Counterparts of ``tests/unit/test_router.py``, ``test_autotuner.py``,
``test_timing.py`` and ``tests/integration/test_engine.py`` for the kinds
the port offers (FUSED, FLASH, FLASH_UNROLLED, PAGED_DECODE, and under
``quant_mode`` / ``enable_int8`` / ``enable_fp8`` the quantized kinds, whose
registry and heuristic are held against the JAX engine's). The router is
the port's own copy: the same workloads go to both routers and their
choices must agree. Engine outputs are held against the JAX
``attention_reference`` (plain XLA) on the same numpy inputs; the drop-in
layer and the MHA facade against the JAX Flax modules with the same
weights. Everything runs on the CPU with the kernels' plain versions, at
S <= 256 (flash thresholds lowered where a test needs the flash kinds).

The engine's roofline energy is held against the JAX engine's
``_estimate_energy_mj`` for the same workload, kind and latency (1e-9
relative, JAX's 60 W static power patched into the port for the test), and
drives the router's energy blend.

Bounds: fp32 outputs ``rel_err_norm`` <= 1e-5 (fused and flash) and
<= 1e-5 for the paged decode; module outputs <= 1e-5, also under a quant
mode when both engines run the same quantized kind at 128-key blocks;
quantized engine outputs against the oracle < 0.1 (the reference gate).
"""

import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photonic_flash_attention_tpu.config import set_global_config as jax_set_config
from photonic_flash_attention_tpu.hardware import roofline as jax_roofline
from photonic_flash_attention_tpu.core.autotuner import Autotuner as JaxAutotuner
from photonic_flash_attention_tpu.core.engine import (
    AttentionEngine as JaxEngine,
    get_engine as jax_get_engine,
    reset_engine as jax_reset_engine,
)
from photonic_flash_attention_tpu.core.router import (
    AdaptiveRouter as JaxRouter,
    KernelKind as JaxKind,
    WorkloadCharacteristics as JaxWC,
)
from photonic_flash_attention_tpu.models.attention import (
    PhotonicFlashAttention as JaxPFA,
    PhotonicMultiHeadAttention as JaxMHA,
)
from photonic_flash_attention_tpu.ops.reference import attention_reference as jax_reference
from photonic_flash_attention_tpu.utils.exceptions import ValidationError as JaxValidationError
from photonic_flash_attention_tpu.utils.validation import (
    validate_quant_mode as jax_validate_quant_mode,
)
from photonic_flash_attention_tpu_torch.config import get_config, reset_config
from photonic_flash_attention_tpu_torch.core import engine as engine_module
from photonic_flash_attention_tpu_torch.core.autotuner import (
    Autotuner,
    TuneResult,
    candidate_blocks,
)
from photonic_flash_attention_tpu_torch.core.engine import (
    AttentionEngine,
    _analyze_mask,
    get_engine,
    reset_engine,
)
from photonic_flash_attention_tpu_torch.core.router import (
    AdaptiveRouter,
    KernelKind,
    WorkloadCharacteristics,
)
from photonic_flash_attention_tpu_torch.core.timing import default_runs, measure_ms
from photonic_flash_attention_tpu_torch.hardware import roofline as port_roofline
from photonic_flash_attention_tpu_torch.hardware.roofline import (
    attention_prefill_cost,
    kernel_energy_mj,
)
from photonic_flash_attention_tpu_torch.models.attention import (
    PhotonicFlashAttention,
    PhotonicMultiHeadAttention,
)
from photonic_flash_attention_tpu_torch.ops import _build
from photonic_flash_attention_tpu_torch.utils.exceptions import ValidationError
from photonic_flash_attention_tpu_torch.utils.monitoring import (
    MetricRegistry,
    device_memory_stats,
    get_metrics,
)
from photonic_flash_attention_tpu_torch.utils.validation import (
    validate_attention_inputs,
    validate_quant_mode,
)

from .conftest import rel_err_norm


@pytest.fixture(autouse=True)
def _fresh():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    reset_config()
    reset_engine()
    yield
    reset_config()
    reset_engine()
    torch.set_num_threads(n)


def _flash_thresholds():
    """Flash kinds eligible from S=64 in both packages."""
    get_config().update(flash_threshold=64, flash_min_tokens=1)
    jax_set_config(flash_threshold=64, flash_min_tokens=1)


def make_qkv(b=2, s=128, h=4, d=64, skv=None, hkv=None, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, skv or s, hkv or h, d)).astype(np.float32)
    v = rng.standard_normal((b, skv or s, hkv or h, d)).astype(np.float32)
    return q, k, v


def _t(*arrs):
    return [None if a is None else torch.from_numpy(np.asarray(a)) for a in arrs]


def _ref(q, k, v, mask=None, causal=False):
    return np.asarray(jax_reference(*(jnp.asarray(a) for a in (q, k, v)),
                                    None if mask is None else jnp.asarray(mask),
                                    causal=causal)[0])


def _engine(**kw):
    return AttentionEngine(router=AdaptiveRouter(exploration_rate=0.0, seed=0), **kw)


# -- router: the port's copy decides as the JAX router ---------------------


def _pair(**kw):
    return WorkloadCharacteristics(**kw), JaxWC(**kw)


WORKLOADS = [
    dict(batch_size=2, q_len=128, kv_len=128, num_heads=8, head_dim=64),
    dict(batch_size=2, q_len=2048, kv_len=2048, num_heads=8, head_dim=64),
    dict(batch_size=2, q_len=2048, kv_len=2048, num_heads=8, head_dim=64, need_weights=True),
    dict(batch_size=8, q_len=1, kv_len=2048, num_heads=16, head_dim=64, is_decode=True),
    dict(batch_size=4, q_len=2048, kv_len=2048, num_heads=16, head_dim=64, mask_kind="key"),
    dict(batch_size=4, q_len=1024, kv_len=1024, num_heads=16, head_dim=64, mask_kind="dense"),
    dict(batch_size=1, q_len=300, kv_len=900, num_heads=4, head_dim=128, causal=True),
    dict(batch_size=1, q_len=32768, kv_len=32768, num_heads=4, head_dim=64, num_kv_heads=2),
]
KINDS = ("fused", "flash", "flash_unrolled", "paged_decode", "ring")


@pytest.mark.parametrize("kw", WORKLOADS, ids=lambda kw: "-".join(f"{v}" for v in kw.values()))
def test_router_gates_and_heuristic_match_jax(kw):
    w, jw = _pair(**kw)
    avail = tuple(KernelKind(k) for k in KINDS)
    javail = tuple(JaxKind(k) for k in KINDS)
    r, jr = AdaptiveRouter(seed=0), JaxRouter(seed=0)
    elig = r.eligible_kernels(w, avail)
    jelig = jr.eligible_kernels(jw, javail)
    assert [k.value for k in elig] == [k.value for k in jelig]
    assert r.heuristic_selection(w, elig).value == jr.heuristic_selection(jw, jelig).value
    assert w.bucket() == jw.bucket()


def test_router_threshold_respects_config():
    get_config().update(flash_threshold=4096)
    w = WorkloadCharacteristics(batch_size=2, q_len=2048, kv_len=2048, num_heads=8, head_dim=64)
    avail = (KernelKind.FUSED, KernelKind.FLASH)
    assert AdaptiveRouter(seed=0).heuristic_selection(w, avail) == KernelKind.FUSED


def test_router_warmup_then_exploit_matches_jax():
    """The same measurement stream gives the same choice sequence: warm-up
    nominates each unmeasured kind, then the fastest wins; new
    measurements can flip it."""
    w, jw = _pair(batch_size=2, q_len=1024, kv_len=1024, num_heads=8, head_dim=64)
    r, jr = AdaptiveRouter(exploration_rate=0.0, seed=0), JaxRouter(exploration_rate=0.0, seed=0)
    lat = {"fused": 5.0, "flash": 1.0, "flash_unrolled": 2.0}
    got, want = [], []
    for step in range(8):
        if step == 6:
            lat["fused"] = 0.1  # a new measurement flips the winner
        for router, wl, kinds, out in ((r, w, KernelKind, got), (jr, jw, JaxKind, want)):
            avail = tuple(kinds(k) for k in lat)
            k = router.select_kernel(wl, avail)
            out.append(k.value)
            router.record_measurement(k, wl, lat[k.value])
            if step == 6:
                for _ in range(10):  # the EMA follows the new latency
                    router.record_measurement(kinds("fused"), wl, lat["fused"])
    assert got == want
    assert set(got[:3]) == set(lat) and got[5] == "flash" and got[7] == "fused"


def test_router_state_loads_across_packages(tmp_path):
    """A table saved by the JAX router loads in the port's, and back."""
    w, jw = _pair(batch_size=2, q_len=512, kv_len=512, num_heads=8, head_dim=64,
                  num_kv_heads=2)
    jr = JaxRouter(seed=0)
    jr.record_measurement(JaxKind.FLASH, jw, 0.7)
    jr.save_state(str(tmp_path / "jax.json"))
    r = AdaptiveRouter(seed=0, state_path=str(tmp_path / "jax.json"))
    assert r.predicted_latency(KernelKind.FLASH, w) == pytest.approx(0.7)
    assert not r.needs_measurement(KernelKind.FLASH, w)
    r.record_measurement(KernelKind.FUSED, w, 2.5)
    r.save_state(str(tmp_path / "port.json"))
    back = JaxRouter(seed=0, state_path=str(tmp_path / "port.json"))
    assert back.predicted_latency(JaxKind.FUSED, jw) == pytest.approx(2.5)
    assert json.loads((tmp_path / "port.json").read_text())["version"] == 2
    stats = r.get_stats()
    assert set(stats) == set(jr.get_stats()) and stats["kernels"]["flash"]["buckets_measured"] == 1


def test_router_dominance_pruning_matches_jax():
    avail = (KernelKind.FUSED, KernelKind.FLASH, KernelKind.FLASH_UNROLLED)
    r = AdaptiveRouter(exploration_rate=0.0, seed=0)
    for i in range(3):
        w = WorkloadCharacteristics(batch_size=2, q_len=512 * 2 ** i, kv_len=512 * 2 ** i,
                                    num_heads=8, head_dim=64)
        for _ in range(2):
            r.update_performance(KernelKind.FLASH_UNROLLED, w, 10.0)
            r.update_performance(KernelKind.FLASH, w, 3.0)
    fresh = WorkloadCharacteristics(batch_size=2, q_len=8192, kv_len=8192, num_heads=8, head_dim=64)
    chosen = set()
    for _ in range(12):
        k = r.select_kernel(fresh, avail)
        chosen.add(k)
        r.update_performance(k, fresh, 1.0)
    assert KernelKind.FLASH_UNROLLED not in chosen
    assert r.get_stats()["measurements_pruned"]["flash_unrolled"] > 0


def test_energy_weight_needs_the_card_power():
    """energy_weight blends energy as time at the card's power limit; with
    no power figure (no card) the score is the latency alone."""
    get_config().update(energy_weight=0.5)
    w = WorkloadCharacteristics(batch_size=2, q_len=1024, kv_len=1024, num_heads=8, head_dim=64)
    avail = (KernelKind.FLASH, KernelKind.FLASH_UNROLLED)

    def router(power):
        r = AdaptiveRouter(exploration_rate=0.0, seed=0)
        r.energy_model = lambda kind, w, lat: 30.0 if kind == KernelKind.FLASH_UNROLLED else 300.0
        r.board_power_w = power
        for _ in range(3):
            r.update_performance(KernelKind.FLASH, w, 1.00)
            r.update_performance(KernelKind.FLASH_UNROLLED, w, 1.05)
        return r

    assert router(None).select_kernel(w, avail) == KernelKind.FLASH
    assert router(700.0).select_kernel(w, avail) == KernelKind.FLASH_UNROLLED


def test_roofline_energy_prefers_the_lower_byte_kind():
    """The engine's roofline energy, not a stub: at energy_weight 0.5 an
    int8-QK call 2 % slower than FLASH wins (cheaper score FLOPs, one-byte
    Q and K), while the latency alone (weight 0) keeps FLASH."""
    eng = _engine(enable_int8=True)
    w = WorkloadCharacteristics(batch_size=8, q_len=4096, kv_len=4096, num_heads=16,
                                head_dim=128, causal=True)
    avail = (KernelKind.FLASH, KernelKind.FLASH_INT8QK)
    assert (eng._estimate_energy_mj(KernelKind.FLASH_INT8QK, 1.02, w)
            < eng._estimate_energy_mj(KernelKind.FLASH, 1.00, w))

    def choice(weight):
        get_config().update(energy_weight=weight)
        r = AdaptiveRouter(exploration_rate=0.0, seed=0)
        r.energy_model, r.board_power_w = eng.router.energy_model, 700.0
        for _ in range(3):
            r.update_performance(KernelKind.FLASH, w, 1.00)
            r.update_performance(KernelKind.FLASH_INT8QK, w, 1.02)
        return r.select_kernel(w, avail)

    assert choice(0.0) == KernelKind.FLASH
    assert choice(0.5) == KernelKind.FLASH_INT8QK


def test_a_card_without_a_record_keeps_attention_running(monkeypatch):
    """On a card the roofline's table lacks (no record), attention runs and
    the energy is latency x the card's power limit."""
    monkeypatch.setattr(engine_module, "known_capabilities", lambda: None)
    eng = _engine()
    assert eng.energy_caps is None
    eng.board_power_w = 700.0
    q, k, v = _t(*make_qkv(s=32))
    out, _ = eng(q, k, v)
    assert out.shape == q.shape and bool(torch.isfinite(out).all())
    assert eng.last_energy_mj == pytest.approx(eng.last_latency_ms * 700.0)


#: (kind, Sq, Skv, Hq, Hkv, causal): the prefill kinds with their own
#: energy dtype or bytes, and a GQA decode.
ENERGY_CASES = [
    ("FLASH", 1024, 1024, 8, 8, True),
    ("FUSED", 512, 512, 8, 8, False),
    ("FLASH_INT8QK", 1024, 1024, 8, 8, True),
    ("FLASH_INT8FULL", 1024, 1024, 8, 8, True),
    ("FLASH_FP8QK", 2048, 2048, 16, 4, True),
    ("PAGED_DECODE", 1, 4096, 32, 8, False),
]


@pytest.mark.parametrize("kind, sq, skv, hq, hkv, causal", ENERGY_CASES,
                         ids=[c[0].lower() for c in ENERGY_CASES])
def test_energy_estimate_matches_jax(monkeypatch, kind, sq, skv, hq, hkv, causal):
    """The engine's roofline energy against the JAX engine's for the same
    workload, kind and latency, with JAX's static power (60 W) in the port."""
    monkeypatch.setattr(port_roofline, "STATIC_POWER_W", jax_roofline.STATIC_POWER_W)
    eng = _engine(enable_int8=True, enable_fp8=True)
    jeng = JaxEngine(router=JaxRouter(exploration_rate=0.0, seed=0), enable_int8=True,
                     enable_fp8=True)
    common = dict(batch_size=2, q_len=sq, kv_len=skv, num_heads=hq, head_dim=64, causal=causal,
                  is_decode=sq == 1, num_kv_heads=hkv)
    got = eng._estimate_energy_mj(KernelKind[kind], 0.42, WorkloadCharacteristics(**common))
    want = jeng._estimate_energy_mj(JaxKind[kind], 0.42, JaxWC(**common))
    assert got == pytest.approx(want, rel=1e-9)


# -- autotuner and timing ---------------------------------------------------


def test_autotuner_lists_k1_tiles_and_keys_like_jax(tmp_path):
    """The profile store: K1's one tile whatever the shape, the JAX profile
    keys, JSON persistence, the age limit."""
    assert candidate_blocks(2048, 2048, 64) == candidate_blocks(16, 40000, 128) == [(64, 64)]
    assert Autotuner.profile_key(1000, 3000, 64, 3, 12) == JaxAutotuner.profile_key(1000, 3000, 64, 3, 12)
    path = str(tmp_path / "tune.json")
    tuner = Autotuner(state_path=path)
    tuner.record("k", TuneResult(64, 64, 0.25))
    tuner.save_state()
    again = Autotuner(state_path=path)
    res = again.lookup("k")
    assert (res.block_q, res.block_kv, res.latency_ms) == (64, 64, 0.25)
    assert again.stats() == {"profiles": 1, "keys": ["k"]}
    stale = TuneResult(64, 64, 1.0, tuned_at=time.time() - Autotuner.MAX_PROFILE_AGE_S - 1)
    again.record("old", stale)
    assert again.lookup("old") is None


def test_measure_ms_is_positive_and_scales_with_work():
    assert default_runs(torch.device("cpu")) == (1, 3)
    assert default_runs(torch.device("cuda")) == (2, 10)
    x = torch.ones(64, 64)
    small = measure_ms(lambda a: a @ a, x, runs=5)
    big = measure_ms(lambda a: [a @ a for _ in range(200)][-1], x, runs=5)
    assert 0 < small < big and np.isfinite(big)


# -- validation and monitoring ------------------------------------------------


@pytest.mark.parametrize(
    "shapes, match",
    [
        (((2, 8, 4, 64), (2, 8, 4)), "rank-4"),
        (((2, 8, 4, 64), (3, 8, 4, 64)), "batch mismatch"),
        (((2, 8, 3, 64), (2, 8, 2, 64)), "multiple of kv heads"),
        (((2, 8, 4, 64), (2, 8, 4, 32)), "head_dim mismatch"),
    ],
)
def test_validation_rejects_bad_inputs(shapes, match):
    qs, ks = shapes
    with pytest.raises(ValidationError, match=match):
        validate_attention_inputs(torch.zeros(qs), torch.zeros(ks), torch.zeros(ks))
    with pytest.raises(ValidationError, match="dtype"):
        validate_attention_inputs(*(torch.zeros(2, 8, 4, 64, dtype=torch.int32),) * 3)


def test_metric_registry_and_memory_stats():
    reg = MetricRegistry()
    for x in (3.0, 1.0, 2.0):
        reg.record("a", x)
    s = reg.snapshot()["a"]
    assert (s["count"], s["min"], s["max"], s["last"], s["p50"]) == (3, 1.0, 3.0, 2.0, 2.0)
    assert get_metrics() is get_metrics()
    stats = device_memory_stats()
    assert stats["platform"] == ("gpu" if torch.cuda.is_available() else "cpu")


# -- engine -------------------------------------------------------------------


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [32, 128], ids=["fused_size", "flash_size"])
def test_engine_matches_the_oracle(s, causal):
    _flash_thresholds()
    q, k, v = make_qkv(s=s)
    eng = _engine()
    for _ in range(4):  # warm-up over every eligible kind, then exploit
        out, w = eng(*_t(q, k, v), causal=causal)
        assert w is None
        assert rel_err_norm(out.numpy(), _ref(q, k, v, causal=causal)) <= 1e-5


def test_need_weights_routes_to_fused():
    _flash_thresholds()
    q, k, v = make_qkv(s=128)
    eng = _engine()
    out, w = eng(*_t(q, k, v), need_weights=True)
    assert eng.last_kernel_used == "fused"
    assert torch.allclose(w.sum(-1), torch.ones(()), atol=1e-5)


def test_dense_mask_is_offered_fused_only():
    """A mask with (Sq, Skv) structure: since K1 has the dense-bias mode the
    engine offers FUSED and FLASH for it, as the JAX engine does (the name
    is kept from when the port offered FUSED only). Above the flash
    threshold the heuristic takes FLASH; measured routing warms up both;
    every result equals the oracle's, causal or not, (B,1,S,S) or per head."""
    _flash_thresholds()
    q, k, v = make_qkv(s=128, b=2)
    rng = np.random.default_rng(1)
    eng = _engine()
    w = WorkloadCharacteristics(batch_size=2, q_len=128, kv_len=128, num_heads=4,
                                head_dim=64, mask_kind="dense", dtype="float32")
    assert eng.router.eligible_kernels(w, eng._available_kernels(w)) == [
        KernelKind.FUSED, KernelKind.FLASH]
    for heads in (1, 4):
        mask = rng.random((2, heads, 128, 128)) > 0.1
        mask[..., 0] = True
        for causal in (False, True):
            get_config().update(auto_kernel_selection=False)
            out, _ = eng(*_t(q, k, v, mask), causal=causal)
            assert eng.last_kernel_used == "flash"
            assert rel_err_norm(out.numpy(), _ref(q, k, v, mask, causal)) <= 1e-5
    get_config().update(auto_kernel_selection=True)
    used = set()
    for _ in range(3):
        out, _ = eng(*_t(q, k, v, mask))
        used.add(eng.last_kernel_used)
        assert rel_err_norm(out.numpy(), _ref(q, k, v, mask)) <= 1e-5
    assert used == {"fused", "flash"}


@pytest.mark.parametrize("quant_mode", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("s", [128, 2048])
def test_dense_mask_eligibility_matches_jax_engine(s, quant_mode):
    """The port's registry and router against the JAX ``AttentionEngine``
    built with the same flags, for a dense-mask workload: the same eligible
    kinds and the same heuristic kind."""
    get_config().update(quant_mode=quant_mode)
    jax_set_config(quant_mode=quant_mode)
    kw = dict(batch_size=4, q_len=s, kv_len=s, num_heads=16, head_dim=64, causal=True,
              mask_kind="dense", dtype="bfloat16")
    w, jw = _pair(**kw)
    eng, jeng = _engine(), JaxEngine(router=JaxRouter(exploration_rate=0.0, seed=0))
    elig = eng.router.eligible_kernels(w, eng._available_kernels(w))
    jelig = jeng.router.eligible_kernels(jw, jeng._available_kernels(jw))
    assert [k.value for k in elig] == [k.value for k in jelig] == ["fused", "flash"]
    assert (eng.router.heuristic_selection(w, elig).value
            == jeng.router.heuristic_selection(jw, jelig).value
            == ("flash" if s >= 512 else "fused"))


@pytest.mark.parametrize("layout", ["prefix", "scattered"])
def test_key_mask_routes_to_flash_unrolled(layout):
    """A (B,1,1,S) key-padding mask is recognised as key padding and rides
    the unrolled kind's bias stream (heuristic), not the fused path."""
    _flash_thresholds()
    get_config().update(auto_kernel_selection=False)
    q, k, v = make_qkv(b=3, s=128)
    if layout == "prefix":
        keep = np.arange(128)[None] < np.array([128, 70, 33])[:, None]
    else:
        keep = np.random.default_rng(2).random((3, 128)) > 0.4
        keep[:, 0] = True
    mask = keep[:, None, None, :]
    kind, lens, bias = _analyze_mask(torch.from_numpy(mask), 3, 128)
    assert kind == "key" and (bias is None) == (layout == "prefix")
    assert lens.tolist() == [int(np.nonzero(r)[0].max()) + 1 for r in keep]
    eng = _engine()
    for causal in (False, True):
        out, _ = eng(*_t(q, k, v, mask), causal=causal)
        assert eng.last_kernel_used == "flash_unrolled"
        assert rel_err_norm(out.numpy(), _ref(q, k, v, mask, causal)) <= 1e-5


def test_key_mask_measured_router_uses_flash_kinds():
    """Measured routing of a key-masked bucket: warm-up over FUSED, FLASH
    and FLASH_UNROLLED, every result exact."""
    _flash_thresholds()
    q, k, v = make_qkv(b=2, s=128)
    mask = (np.arange(128)[None] < np.array([128, 90])[:, None])[:, None, None, :]
    eng = _engine()
    used = set()
    for _ in range(5):
        out, _ = eng(*_t(q, k, v, mask), causal=True)
        used.add(eng.last_kernel_used)
        assert rel_err_norm(out.numpy(), _ref(q, k, v, mask, True)) <= 1e-5
    assert used == {"fused", "flash", "flash_unrolled"}


def test_kv_lens_passthrough():
    _flash_thresholds()
    get_config().update(auto_kernel_selection=False)
    q, k, v = make_qkv(b=2, s=128)
    lens = np.array([100, 65], np.int32)
    eng = _engine()
    out, _ = eng(*_t(q, k, v), kv_lens=torch.from_numpy(lens))
    assert eng.last_kernel_used == "flash_unrolled"
    keep = (np.arange(128)[None] < lens[:, None])[:, None, None, :]
    assert rel_err_norm(out.numpy(), _ref(q, k, v, keep)) <= 1e-5
    with pytest.raises(Exception, match="either mask"):
        eng(*_t(q, k, v, keep), kv_lens=torch.from_numpy(lens))


@pytest.mark.parametrize("lens", [None, [300, 512, 129]], ids=["full", "kv_lens"])
def test_paged_decode_through_router(lens):
    """Decode (Sq = 1, Skv >= 128) dispatches to PAGED_DECODE: the K/V
    repacked into page-128 pools, paged_attention_hf (K3's plain version);
    GQA, Skv not a page multiple."""
    get_config().update(auto_kernel_selection=False)
    q, k, v = make_qkv(b=3, s=1, skv=512, h=4, hkv=2)
    k, v = k[:, :500], v[:, :500]
    kv_lens = None if lens is None else np.array([min(n, 500) for n in lens], np.int32)
    eng = _engine()
    out, _ = eng(*_t(q, k, v), kv_lens=None if kv_lens is None else torch.from_numpy(kv_lens))
    assert eng.last_kernel_used == "paged_decode"
    keep = None
    if kv_lens is not None:
        keep = (np.arange(500)[None] < kv_lens[:, None])[:, None, None, :]
    assert out.shape == (3, 1, 4, 64)
    assert rel_err_norm(out.numpy(), _ref(q, k, v, keep)) <= 1e-5


def test_paged_decode_not_offered_with_a_key_bias_or_short_cache():
    get_config().update(auto_kernel_selection=False)
    q, k, v = make_qkv(b=2, s=1, skv=256)
    bias = np.zeros((2, 256), np.float32)
    eng = _engine()
    eng(*_t(q, k, v), k_bias=torch.from_numpy(bias))
    assert eng.last_kernel_used != "paged_decode"
    eng(*_t(q, k[:, :100], v[:, :100]))
    assert eng.last_kernel_used != "paged_decode"


def test_warmup_measures_each_eligible_kind():
    _flash_thresholds()
    q, k, v = make_qkv(s=128)
    eng = _engine()
    used = set()
    for _ in range(6):
        eng(*_t(q, k, v))
        used.add(eng.last_kernel_used)
    assert used == {"fused", "flash", "flash_unrolled"}
    w = WorkloadCharacteristics(batch_size=2, q_len=128, kv_len=128, num_heads=4,
                                head_dim=64, dtype="float32")
    for kind in (KernelKind.FUSED, KernelKind.FLASH, KernelKind.FLASH_UNROLLED):
        assert eng.router.predicted_latency(kind, w) > 0
        assert not eng.router.needs_measurement(kind, w)
    key = Autotuner.profile_key(128, 128, 64, 2, 4)
    assert eng.autotuner.lookup(key).block_q == 64  # K1's tile profile recorded


def test_static_dispatch_respects_threshold():
    get_config().update(auto_kernel_selection=False, flash_threshold=128)
    eng = _engine()
    eng(*_t(*make_qkv(s=64)))
    assert eng.last_kernel_used == "fused"
    eng(*_t(*make_qkv(s=128)))
    assert eng.last_kernel_used == "flash_unrolled"


def test_stale_refresh_is_off_thread():
    """A stale measurement is served at once and refreshed by a worker."""
    _flash_thresholds()
    eng = _engine()
    q, k, v = make_qkv(b=1, s=128, h=2)
    w = WorkloadCharacteristics(batch_size=1, q_len=128, kv_len=128, num_heads=2,
                                head_dim=64, causal=True, dtype="float32")
    for kind, ms in ((KernelKind.FUSED, 5.0), (KernelKind.FLASH, 1.0),
                     (KernelKind.FLASH_UNROLLED, 3.0)):
        eng.router.record_measurement(kind, w, ms)
    ema = eng.router._latency[KernelKind.FLASH][w.bucket()]
    ema.updated_at -= eng.router.MEASUREMENT_MAX_AGE_S + 1
    old = ema.updated_at
    eng(*_t(q, k, v), causal=True)
    assert eng.last_kernel_used == "flash"
    deadline = time.time() + 60
    while ema.updated_at == old and time.time() < deadline:
        time.sleep(0.05)
    assert ema.updated_at != old


def test_stats_surface_and_singleton():
    eng = get_engine()
    assert eng is get_engine()
    # The default router explores 5 % of calls at random: the kind checked
    # below is the one its warm-up takes.
    eng.router.exploration_rate = 0.0
    eng(*_t(*make_qkv(s=32)))
    s = eng.get_performance_stats()
    assert s["total_calls"] == 1 and s["last_kernel_used"] == "fused"
    assert s["last_latency_ms"] > 0 and s["failures"] == {}
    assert {"router", "autotuner", "metrics", "board_power_w"} <= set(s)
    # The call's energy is the roofline's: FUSED's FLOPs and bytes, its
    # materialised fp32 scores written and read, the idle draw x latency.
    cost = attention_prefill_cost(2, 32, 32, 4, 64)
    cost.hbm_bytes += 4.0 * 2 * 4 * 32 * 32 * 2
    assert s["board_power_w"] is None
    assert s["last_energy_mj"] == pytest.approx(kernel_energy_mj(cost, s["last_latency_ms"]))
    # Without a workload: latency x the card's power limit, None without one.
    assert eng._estimate_energy_mj(KernelKind.FUSED, 2.0, None) is None
    eng.board_power_w = 700.0
    assert eng._estimate_energy_mj(KernelKind.FUSED, 2.0, None) == pytest.approx(1400.0)
    reset_engine()
    assert get_engine() is not eng


def test_cpu_failure_falls_back_to_fused(monkeypatch):
    """CPU tensors keep the JAX engine's failure fallback, counted; on the
    card the engine re-raises instead (no hidden fallback)."""
    _flash_thresholds()
    get_config().update(auto_kernel_selection=False)

    def broken(*a, **k):
        raise RuntimeError("kernel fault")

    monkeypatch.setattr(engine_module, "flash_attention_unrolled", broken)
    q, k, v = make_qkv(s=128)
    eng = _engine()
    out, _ = eng(*_t(q, k, v))
    assert eng.last_kernel_used == "fused" and eng.get_performance_stats()["failures"] == {
        "flash_unrolled": 1}
    assert rel_err_norm(out.numpy(), _ref(q, k, v)) <= 1e-5


@pytest.mark.parametrize(
    "make, match",
    [(lambda: _engine().set_mesh(object()), "A12")],
    ids=["mesh"],
)
def test_kinds_not_offered_raise_with_their_roadmap_item(make, match):
    with pytest.raises(NotImplementedError, match=match):
        make()


# -- the quantized kinds (quant_mode, enable_int8, enable_fp8) ------------------

QUANT_ENGINES = {  # id: (engine keyword arguments, config quant_mode)
    "quant_mode_int8": ({}, "int8"),
    "quant_mode_fp8": ({}, "fp8"),
    "enable_int8": (dict(enable_int8=True), "bf16"),
    "enable_fp8": (dict(enable_fp8=True), "bf16"),
    "enable_both": (dict(enable_fp8=True, enable_int8=True), "bf16"),
    "flags_over_quant_mode": (dict(enable_fp8=True, enable_int8=False), "int8"),
}
QUANT_WORKLOADS = [  # square (JAX's unrolled envelope), non-square, decode, key-masked
    dict(batch_size=4, q_len=2048, kv_len=2048, num_heads=16, head_dim=64, causal=True),
    dict(batch_size=4, q_len=512, kv_len=2048, num_heads=16, head_dim=64),
    dict(batch_size=8, q_len=1, kv_len=2048, num_heads=16, head_dim=64, is_decode=True),
    dict(batch_size=4, q_len=2048, kv_len=2048, num_heads=16, head_dim=64, mask_kind="key"),
]


def _quant_engines(mode):
    kw, quant_mode = QUANT_ENGINES[mode]
    get_config().update(quant_mode=quant_mode)
    jax_set_config(quant_mode=quant_mode)
    return _engine(**kw), JaxEngine(router=JaxRouter(exploration_rate=0.0, seed=0), **kw)


@pytest.mark.parametrize("mode", list(QUANT_ENGINES))
def test_quant_kinds_offered_as_in_jax(mode):
    """The registry and the router's gates give exactly the JAX engine's
    kinds, in its order, for each way of enabling the quantized families."""
    eng, jeng = _quant_engines(mode)
    assert (eng.enable_fp8, eng.enable_int8) == (jeng.enable_fp8, jeng.enable_int8)
    for wkw in QUANT_WORKLOADS:
        w, jw = _pair(**wkw)
        avail, javail = eng._available_kernels(w), jeng._available_kernels(jw)
        assert [k.value for k in avail] == [k.value for k in javail]
        assert [k.value for k in eng.router.eligible_kernels(w, avail)] == [
            k.value for k in jeng.router.eligible_kernels(jw, javail)]


@pytest.mark.parametrize("square", [True, False], ids=["square_causal", "non_square"])
@pytest.mark.parametrize("quant_mode, non_square_kind",
                         [("int8", "flash_int8full"), ("fp8", "flash_fp8qk")])
def test_quant_heuristic_picks_as_jax(quant_mode, non_square_kind, square):
    """The JAX heuristic order: a square causal call keeps flash_unrolled;
    a non-square one takes flash_int8full (int8) or flash_fp8qk (fp8)."""
    eng, jeng = _quant_engines(f"quant_mode_{quant_mode}")
    w, jw = _pair(**QUANT_WORKLOADS[0 if square else 1])
    got = eng.router.heuristic_selection(w, eng.router.eligible_kernels(w, eng._available_kernels(w)))
    want = jeng.router.heuristic_selection(
        jw, jeng.router.eligible_kernels(jw, jeng._available_kernels(jw)))
    assert got.value == want.value == ("flash_unrolled" if square else non_square_kind)


@pytest.mark.parametrize("mode", ["bf16", "fp8", "int8", "fp16", "INT8", ""])
def test_validate_quant_mode_as_jax(mode):
    if mode in ("bf16", "fp8", "int8"):
        assert validate_quant_mode(mode) == jax_validate_quant_mode(mode) == mode
        return
    with pytest.raises(ValidationError, match="quant_mode"):
        validate_quant_mode(mode)
    with pytest.raises(JaxValidationError, match="quant_mode"):
        jax_validate_quant_mode(mode)


@pytest.mark.parametrize("quant_mode", ["int8", "fp8"])
def test_quant_engine_measures_every_kind(quant_mode):
    """Measured routing under a quant mode: warm-up measures every eligible
    kind, the quantized ones included; every output inside the reference
    gate; no failure."""
    _flash_thresholds()
    get_config().update(quant_mode=quant_mode)
    q, k, v = make_qkv(s=128)
    eng = _engine()
    for _ in range(8):
        out, _ = eng(*_t(q, k, v), causal=True)
        assert rel_err_norm(out.numpy(), _ref(q, k, v, causal=True)) < 0.1
    w = WorkloadCharacteristics(batch_size=2, q_len=128, kv_len=128, num_heads=4, head_dim=64,
                                causal=True, dtype="float32")
    kinds = eng._available_kernels(w)
    assert {k.value for k in kinds} >= ({"flash_int8qk", "flash_int8full", "flash_unrolled_int8qk"}
                                        if quant_mode == "int8" else {"flash_fp8", "flash_fp8qk"})
    for kind in kinds:
        assert not eng.router.needs_measurement(kind, w), kind.value
    assert eng.get_performance_stats()["failures"] == {}


@pytest.mark.parametrize("quant_mode", ["int8", "fp8"])
def test_drop_in_layer_quant_mode_matches_jax_module(quant_mode):
    """Cross-attention through the drop-in layer under a quant mode: both
    engines' heuristics take the same quantized kind, and with the JAX
    tiles at 128 (the port's requant block) the outputs agree."""
    _flash_thresholds()
    for set_cfg in (get_config().update, jax_set_config):
        set_cfg(quant_mode=quant_mode, auto_kernel_selection=False, block_q=128, block_kv=128)
    jax_reset_engine()
    jmod, params, tmod = _module_pair()
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 64, 128)).astype(np.float32)
    y = rng.standard_normal((2, 192, 128)).astype(np.float32)
    want, _ = jmod.apply(params, jnp.asarray(x), jnp.asarray(y))
    with torch.no_grad():
        got, _ = tmod(torch.from_numpy(x), torch.from_numpy(y))
    kind = "flash_int8full" if quant_mode == "int8" else "flash_fp8qk"
    assert get_engine().last_kernel_used == jax_get_engine().last_kernel_used == kind
    jax_reset_engine()
    assert rel_err_norm(got.numpy(), np.asarray(want)) <= 1e-5


def test_cpu_engine_never_touches_the_kernel_library():
    _flash_thresholds()
    before = dict(_build.LAUNCHES)
    eng = _engine()
    for s in (1, 128):
        eng(*_t(*make_qkv(s=s, skv=256)))
    assert dict(_build.LAUNCHES) == before


# -- the drop-in layer and the MHA facade --------------------------------------


def _flax_to_linear(layer, params):
    layer.weight.data = torch.from_numpy(np.asarray(params["kernel"]).T.copy())
    layer.bias.data = torch.from_numpy(np.asarray(params["bias"]).copy())


def _module_pair(e=128, h=4, causal=False, mha=False):
    """Flax module, its params (seeded), and the port module with the same
    weights (Flax Dense kernel (in, out) -> Linear weight (out, in))."""
    x = jnp.zeros((1, 8, e), jnp.float32)
    if mha:
        jmod = JaxMHA(embed_dim=e, num_heads=h, causal=causal, dtype=jnp.float32)
        tmod = PhotonicMultiHeadAttention(e, h, causal=causal, dtype=torch.float32)
        params = jmod.init(jax.random.PRNGKey(0), x)
        inner, tinner = params["params"]["attention"], tmod.attention
    else:
        jmod = JaxPFA(embed_dim=e, num_heads=h, causal=causal, dtype=jnp.float32)
        tmod = PhotonicFlashAttention(e, h, causal=causal, dtype=torch.float32)
        params = jmod.init(jax.random.PRNGKey(0), x)
        inner, tinner = params["params"], tmod
    for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
        _flax_to_linear(getattr(tinner, name), inner[name])
    return jmod, params, tmod


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [64, 128])
def test_drop_in_layer_matches_jax_module(causal, s):
    """The port's layer (adaptive, through the engine when no gradient is
    recorded) against the JAX module with the same weights."""
    _flash_thresholds()
    jmod, params, tmod = _module_pair(causal=causal)
    x = np.random.default_rng(s).standard_normal((2, s, 128)).astype(np.float32)
    want, _ = jmod.apply(params, jnp.asarray(x))
    with torch.no_grad():
        for _ in range(3):
            got, _ = tmod(torch.from_numpy(x))
            assert rel_err_norm(got.numpy(), np.asarray(want)) <= 1e-5
    assert get_engine().get_performance_stats()["total_calls"] == 3
    assert PhotonicFlashAttention.get_performance_stats()["total_calls"] == 3


def test_drop_in_layer_self_vs_cross():
    _, _, tmod = _module_pair()
    x = torch.randn(2, 64, 128)
    y = torch.randn(2, 96, 128)
    with torch.no_grad():
        out_self, _ = tmod(x)
        out_cross, _ = tmod(x, y)
    assert out_cross.shape == x.shape and not torch.allclose(out_self, out_cross)


def test_mha_facade_key_padding_matches_jax():
    jmod, params, tmod = _module_pair(mha=True)
    x = np.random.default_rng(5).standard_normal((2, 64, 128)).astype(np.float32)
    pad = np.zeros((2, 64), bool)
    pad[:, 48:] = True
    pad[1, 30:] = True
    want, want_w = jmod.apply(params, jnp.asarray(x), key_padding_mask=jnp.asarray(pad),
                              need_weights=True)
    with torch.no_grad():
        got, w = tmod(torch.from_numpy(x), key_padding_mask=torch.from_numpy(pad),
                      need_weights=True)
        out_only, none = tmod(torch.from_numpy(x), key_padding_mask=torch.from_numpy(pad),
                              need_weights=False)
    assert w.shape == (2, 64, 64) and none is None
    assert float(w[:, :, 48:].max()) < 1e-6
    assert rel_err_norm(got.numpy(), np.asarray(want)) <= 1e-5
    assert rel_err_norm(w.numpy(), np.asarray(want_w)) <= 1e-5
    assert rel_err_norm(out_only.numpy(), np.asarray(want)) <= 1e-5


def test_mha_facade_merges_attn_mask_and_padding():
    jmod, params, tmod = _module_pair(mha=True)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 32, 128)).astype(np.float32)
    pad = np.zeros((2, 32), bool)
    pad[0, 20:] = True
    attn = np.tril(np.ones((32, 32), bool))
    want, _ = jmod.apply(params, jnp.asarray(x), key_padding_mask=jnp.asarray(pad),
                         attn_mask=jnp.asarray(attn))
    with torch.no_grad():
        got, _ = tmod(torch.from_numpy(x), key_padding_mask=torch.from_numpy(pad),
                      attn_mask=torch.from_numpy(attn))
    assert rel_err_norm(got.numpy(), np.asarray(want)) <= 1e-5


def test_gradients_flow_through_the_dispatch_route():
    """A call that records a gradient takes the static dispatch (the JAX
    traced route), not the engine; gradients reach every projection."""
    _flash_thresholds()
    _, _, tmod = _module_pair(causal=True)
    x = torch.randn(1, 128, 128)
    out, _ = tmod(x)
    (out ** 2).sum().backward()
    assert get_engine().get_performance_stats()["total_calls"] == 0
    grads = [p.grad for p in tmod.parameters()]
    assert all(g is not None and torch.isfinite(g).all() for g in grads)
    assert all(float(g.abs().max()) > 0 for g in grads)
