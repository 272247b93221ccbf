"""Port parity: ``hardware/simulator.py`` (A14).

Given the same device record (a ``TPUCapabilities`` of JAX's figures, built
in both packages, ``contraction_width`` 128 on the port's side), the port's
``KernelPipelineSimulator`` predicts JAX's numbers at rel 1e-12 and sweeps
in JAX's order, and ``TopologySimulator`` on JAX's torus computes JAX's hop
distances, collective costs, ring overlaps and description. The cases of
``tests/unit/test_simulator.py`` run on both. On the H100's record the
topology is the NVSwitch all to all (every pair one hop) and a collective's
bytes equal ``parallel/telemetry.py::collective_bytes`` for the same
collective and size.
"""

import dataclasses
import itertools

import pytest

from photonic_flash_attention_tpu.hardware import detection as jax_detection
from photonic_flash_attention_tpu.hardware import simulator as jax_sim
from photonic_flash_attention_tpu_torch.hardware import detection as port_detection
from photonic_flash_attention_tpu_torch.hardware import simulator as port_sim
from photonic_flash_attention_tpu_torch.parallel.telemetry import collective_bytes

#: A TPU v5e's figures (JAX's tests' record): generation, bf16 TFLOP/s, int8
#: TOP/s, HBM GB, HBM GB/s, VMEM MB, ICI GB/s.
V5E = ("v5e", 197.0, 394.0, 16.0, 819.0, 128.0, 200.0)
V5P = ("v5p", 459.0, 918.0, 95.0, 2765.0, 95.0, 400.0)
JAX_CAPS = {name: jax_detection.TPUCapabilities(*row) for name, row in
            (("v5e", V5E), ("v5p", V5P))}
PORT_CAPS = {name: port_detection.TPUCapabilities(*row, contraction_width=128) for name, row in
             (("v5e", V5E), ("v5p", V5P))}
H100 = port_detection._CAPABILITY_TABLE["h100"]
REL = 1e-12


def _close(a, b):
    return abs(a - b) <= REL * max(abs(a), abs(b), 1e-300)


def _same_prediction(p, j):
    pd, jd = p.as_dict(), j.as_dict()
    assert pd.keys() == jd.keys()
    for key in pd:
        if isinstance(pd[key], float):
            assert _close(pd[key], jd[key]), key
        else:
            assert pd[key] == jd[key], key


PREDICT_CASES = [
    # batch, q, kv, heads, head_dim, block_q, block_kv, causal, dtype
    (4, 2048, 2048, 12, 64, 512, 1024, True, "bf16"),
    (1, 2048, 2048, 8, 64, 256, 256, False, "bf16"),
    (1, 4096, 4096, 8, 128, 1024, 2048, False, "bf16"),
    (2, 512, 2048, 16, 128, 128, 512, True, "int8"),
    (8, 1, 4096, 32, 64, 128, 2048, False, "fp8"),
    (1, 300, 700, 4, 32, 128, 128, False, "f32"),
]


@pytest.mark.parametrize("gen", ["v5e", "v5p"])
@pytest.mark.parametrize("case", PREDICT_CASES, ids=range(len(PREDICT_CASES)))
@pytest.mark.parametrize("fraction", [0.5, 0.01])
def test_predict_matches_jax(gen, case, fraction):
    *shape, bq, bkv, causal, dtype = case
    p = port_sim.KernelPipelineSimulator(caps=PORT_CAPS[gen], vmem_budget_fraction=fraction)
    j = jax_sim.KernelPipelineSimulator(caps=JAX_CAPS[gen], vmem_budget_fraction=fraction)
    _same_prediction(p.predict(*shape, bq, bkv, causal=causal, dtype=dtype),
                     j.predict(*shape, bq, bkv, causal=causal, dtype=dtype))


SWEEP_CASES = [
    (4, 2048, 2048, 12, 64, True),
    (1, 1024, 1024, 8, 64, False),
    (1, 4096, 4096, 8, 64, False),
    (2, 256, 8192, 16, 128, False),
    (1, 100, 100, 4, 64, True),
]


@pytest.mark.parametrize("gen", ["v5e", "v5p"])
@pytest.mark.parametrize("case", SWEEP_CASES, ids=range(len(SWEEP_CASES)))
def test_sweep_order_matches_jax(gen, case):
    *shape, causal = case
    p = port_sim.KernelPipelineSimulator(caps=PORT_CAPS[gen]).sweep(*shape, causal=causal)
    j = jax_sim.KernelPipelineSimulator(caps=JAX_CAPS[gen]).sweep(*shape, causal=causal)
    assert [(x.block_q, x.block_kv) for x in p] == [(x.block_q, x.block_kv) for x in j]
    for x, y in zip(p, j):
        _same_prediction(x, y)


# -- JAX's unit cases, on both packages ------------------------------------------------


def _sims():
    return ((port_sim, PORT_CAPS["v5e"]), (jax_sim, JAX_CAPS["v5e"]))


def test_predict_basic():
    for m, caps in _sims():
        p = m.KernelPipelineSimulator(caps=caps).predict(4, 2048, 2048, 12, 64, 512, 1024,
                                                         causal=True)
        assert p.feasible and p.t_total_us > 0 and p.bound in ("dma", "mxu", "vpu")


def test_causal_halves_cells():
    for m, caps in _sims():
        s = m.KernelPipelineSimulator(caps=caps)
        full = s.predict(1, 2048, 2048, 8, 64, 256, 256, causal=False)
        caus = s.predict(1, 2048, 2048, 8, 64, 256, 256, causal=True)
        assert caus.grid_cells == full.grid_cells // 2 and caus.t_total_us < full.t_total_us


def test_longer_seq_costs_more_and_best_is_large():
    for m, caps in _sims():
        s = m.KernelPipelineSimulator(caps=caps)
        assert s.best(1, 4096, 4096, 8, 64).t_total_us > s.best(1, 1024, 1024, 8, 64).t_total_us
        best = s.best(4, 2048, 2048, 12, 64, causal=True)
        assert best.block_q >= 256 and best.block_kv >= 256


# -- the topology ------------------------------------------------------------------------

TOPOLOGIES = [((8,), True), ((4, 4), True), ((2, 2, 2), True), ((4, 2), False), ((16,), False)]
COLLECTIVE_BYTES = (1.0, 64e6, 16 * 2**20)


@pytest.mark.parametrize("shape, wrap", TOPOLOGIES, ids=[str(t) for t in TOPOLOGIES])
def test_torus_matches_jax(shape, wrap):
    p = port_sim.TopologySimulator(shape, caps=PORT_CAPS["v5e"], wrap=wrap)
    j = jax_sim.TopologySimulator(shape, caps=JAX_CAPS["v5e"], wrap=wrap)
    assert p.topology == "torus"
    coords = list(itertools.product(*(range(s) for s in shape)))
    for a, b in itertools.product(coords[:8], coords):
        assert p.hop_distance(a, b) == j.hop_distance(a, b)
    assert p.max_hops() == j.max_hops()
    pd = p.describe()
    assert {k: pd[k] for k in j.describe()} == j.describe()
    axes_sets = [None] + [[i] for i in range(len(shape))]
    for op, nbytes, axes in itertools.product(port_sim.COLLECTIVES, COLLECTIVE_BYTES, axes_sets):
        pc, jc = p.collective_cost(op, nbytes, axes), j.collective_cost(op, nbytes, axes)
        jd = dataclasses.asdict(jc)
        pdict = dataclasses.asdict(pc)
        assert {k: pdict[k] for k in jd if k != "t_us"} == {k: v for k, v in jd.items()
                                                             if k != "t_us"}
        assert _close(pc.t_us, jc.t_us)
    for local in (512, 8192):
        pr = p.ring_attention_overlap(1, local, 16, 128)
        jr = j.ring_attention_overlap(1, local, 16, 128)
        assert pr.keys() == jr.keys()
        for key in pr:
            assert (_close(pr[key], jr[key]) if isinstance(pr[key], float)
                    else pr[key] == jr[key]), key


def test_jax_topology_cases_on_both():
    for m, caps in _sims():
        t = m.TopologySimulator((4, 4), caps=caps)
        assert t.hop_distance((0, 0), (3, 0)) == 1 and t.hop_distance((0, 0), (2, 2)) == 4
        assert t.max_hops() == 4
        t8 = m.TopologySimulator((8,), caps=caps)
        psum, ag = t8.collective_cost("psum", 64e6), t8.collective_cost("all_gather", 64e6)
        assert abs(psum.t_us / ag.t_us - 2.0) < 0.01
        assert t8.collective_cost("ppermute", 64e6).hops == 1
        with pytest.raises(ValueError):
            m.TopologySimulator((4,), caps=caps).collective_cost("gossip", 1.0)
        t4 = m.TopologySimulator((4,), caps=caps)
        short, long = t4.ring_attention_overlap(1, 512, 8, 64), t4.ring_attention_overlap(1, 8192, 8, 64)
        assert long["scaling_efficiency"] >= short["scaling_efficiency"] and long["comm_hidden"]
        assert t8.ring_attention_overlap(1, 8192, 16, 128)["scaling_efficiency"] >= 0.85
        d = m.TopologySimulator((2, 2, 2), caps=caps).describe()
        assert d["devices"] == 8 and d["diameter_hops"] == 3


# -- the card: the NVSwitch all to all -----------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_switch_bytes_equal_telemetry(n):
    t = port_sim.TopologySimulator((n,), caps=H100)
    assert t.topology == "switch"
    size = 16 * 2**20
    for op in port_sim.COLLECTIVES:
        c = t.collective_cost(op, size)
        shard = size // n if op == "all_gather" else size
        assert c.bytes_moved == collective_bytes(op, shard, n), op
        assert c.t_us == pytest.approx(c.bytes_moved / (H100.ici_gbps * 1e9) * 1e6, rel=REL)
    if n == 1:  # one card moves nothing
        assert t.collective_cost("psum", size).t_us == 0.0


def test_switch_is_one_hop_everywhere():
    t = port_sim.TopologySimulator((2, 4), caps=H100)
    coords = list(itertools.product(range(2), range(4)))
    assert all(t.hop_distance(a, b) == (a != b) for a in coords for b in coords)
    assert t.max_hops() == 1 and port_sim.TopologySimulator((1,), caps=H100).max_hops() == 0
    assert t.describe()["topology"] == "switch" and t.describe()["ici_gbps_per_link"] == 450.0


def test_h100_record_feeds_the_pipeline_model():
    """On the card's record the underfill is head_dim / 16 (full at D 64)
    and the tile budget is half of ``vmem_mb`` x 1e6 bytes."""
    s = port_sim.KernelPipelineSimulator(caps=H100)
    assert s.vmem_budget == pytest.approx(H100.vmem_mb * 1e6 * 0.5, rel=REL)
    p = s.predict(4, 2048, 2048, 12, 64, 256, 128, causal=True)
    assert p.t_mxu_us_per_cell == pytest.approx(4.0 * 256 * 128 * 64 / (989e12) * 1e6, rel=REL)
    best = s.best(4, 2048, 2048, 12, 64, causal=True)
    assert best.t_total_us > 0
