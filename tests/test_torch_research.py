"""Port parity: ``research/novel_algorithms.py``.

Each Flax module is initialised (``jax.random.PRNGKey(0)``) and its params
carried into the port's ``nn.Module`` by ``models/from_jax.py::
research_params_from_jax``; on the same numpy-seeded fp32 input the
outputs agree within ``rel_err_norm`` 1e-5 (Quantum-inspired and
Hierarchical) and 1e-4 (Spectral: its FFT round trip is computed by two
libraries). The cases of ``tests/unit/test_research.py`` run on the port,
and ``ResearchBenchmark`` runs on the CPU with a seeded init.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photonic_flash_attention_tpu.research import novel_algorithms as jax_research
from photonic_flash_attention_tpu_torch.models.from_jax import research_params_from_jax
from photonic_flash_attention_tpu_torch.research import novel_algorithms as port_research

from .conftest import rel_err_norm

B, S, E, H = 2, 64, 128, 4

#: (name, constructor keyword arguments, rel_err_norm bound)
MODULES = [
    ("QuantumInspiredAttention", dict(), 1e-5),
    ("QuantumInspiredAttention", dict(entangle=False), 1e-5),
    ("SpectralAttention", dict(num_modes=16), 1e-4),
    ("SpectralAttention", dict(num_modes=64), 1e-4),
    ("HierarchicalAttention", dict(num_levels=3), 1e-5),
    ("HierarchicalAttention", dict(num_levels=4), 1e-5),
]


def _pair(name, kw, x):
    jmod = getattr(jax_research, name)(E, H, **kw)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    pmod = getattr(port_research, name)(E, H, **kw)
    pmod.load_state_dict(research_params_from_jax(jax.device_get(params)))
    return jmod, params, pmod


@pytest.mark.parametrize("name, kw, bound", MODULES,
                         ids=[f"{n}-{'-'.join(f'{k}{v}' for k, v in kw.items())}"
                              for n, kw, _ in MODULES])
def test_forward_matches_flax(rng, name, kw, bound):
    x = rng.standard_normal((B, S, E)).astype(np.float32)
    jmod, params, pmod = _pair(name, kw, x)
    ref = np.asarray(jmod.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        out = pmod(torch.from_numpy(x)).numpy()
    assert out.shape == x.shape and np.isfinite(out).all()
    assert rel_err_norm(out, ref) <= bound


def test_spectral_filter_of_a_short_sequence_loads(rng):
    """A Flax filter made at S 16 holds 9 modes; the port's 16-mode filter
    takes them in its first rows and ones after (Flax's initial value)."""
    x = rng.standard_normal((1, 16, E)).astype(np.float32)
    jmod, params, pmod = _pair("SpectralAttention", dict(num_modes=16), x)
    assert np.asarray(params["params"]["spectral_filter"]).shape == (9, E)
    assert torch.equal(pmod.spectral_filter[9:], torch.ones(7, E))
    ref = np.asarray(jmod.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        out = pmod(torch.from_numpy(x)).numpy()
    assert rel_err_norm(out, ref) <= 1e-4


def test_converter_names_and_shapes(rng):
    x = rng.standard_normal((B, S, E)).astype(np.float32)
    _, params, pmod = _pair("QuantumInspiredAttention", {}, x)
    sd = research_params_from_jax(params)
    assert set(sd) == set(pmod.state_dict())
    assert sd["q_re.weight"].shape == (E, E) and sd["head_mix"].shape == (H, H)
    np.testing.assert_array_equal(sd["q_re.weight"].numpy(),
                                  np.asarray(params["params"]["q_re"]["kernel"]).T)


@pytest.mark.parametrize(
    "module",
    [lambda: port_research.QuantumInspiredAttention(E, H),
     lambda: port_research.QuantumInspiredAttention(E, H, entangle=False),
     lambda: port_research.SpectralAttention(E, H, num_modes=16),
     lambda: port_research.HierarchicalAttention(E, H, num_levels=3)],
    ids=["quantum", "quantum_noent", "spectral", "hierarchical"],
)
def test_forward_shape_finite(module, rng):
    x = torch.from_numpy(rng.standard_normal((B, S, E)).astype(np.float32))
    with torch.no_grad():
        out = module()(x)
    assert out.shape == x.shape and bool(torch.isfinite(out).all())


def test_quantum_zero_input_stays_finite():
    mod = port_research.QuantumInspiredAttention(E, H, entangle=False)
    with torch.no_grad():
        assert bool(torch.isfinite(mod(torch.zeros(B, S, E))).all())


def test_spectral_is_sequence_dependent(rng):
    mod = port_research.SpectralAttention(E, H, num_modes=8)
    x = torch.from_numpy(rng.standard_normal((B, S, E)).astype(np.float32))
    with torch.no_grad():
        assert not torch.allclose(mod(x), mod(x.flip(1)), atol=1e-4)


def test_hierarchical_levels_reduce(rng):
    """Four levels on S 64; on S 4 the pyramid stops at 2 tokens (two
    levels), and the gate uses its first two outputs."""
    mod = port_research.HierarchicalAttention(E, H, num_levels=4)
    for s in (64, 4):
        x = torch.from_numpy(rng.standard_normal((B, s, E)).astype(np.float32))
        with torch.no_grad():
            assert mod(x).shape == x.shape


def test_gradients_flow_all(rng):
    x = torch.from_numpy(rng.standard_normal((B, S, E)).astype(np.float32))
    for mod in (port_research.QuantumInspiredAttention(E, H),
                port_research.SpectralAttention(E, H, num_modes=8),
                port_research.HierarchicalAttention(E, H)):
        (mod(x) ** 2).sum().backward()
        for name, p in mod.named_parameters():
            assert p.grad is not None and bool(torch.isfinite(p.grad).all()), name


def test_benchmark_framework():
    bench = port_research.ResearchBenchmark(batch=1, seq=32, embed=64, heads=2, device="cpu")
    results = bench.run(iters=2)
    assert [r.name for r in results] == ["quantum_inspired", "spectral", "hierarchical"]
    assert all(r.finite and r.latency_ms > 0 for r in results)
    report = port_research.ResearchBenchmark.markdown_report(results)
    assert "quantum_inspired" in report and "| algorithm |" in report
    again = bench.run(iters=2)
    assert [r.output_norm for r in again] == [r.output_norm for r in results]  # seeded


def test_markdown_report_matches_jax():
    rows = [("a", 1.5, 10.0, 0.99, True), ("b", 20.0, 5.0, 0.5, False)]
    port = [port_research.AlgorithmResult(*r) for r in rows]
    ref = [jax_research.AlgorithmResult(*r) for r in rows]
    assert [r.score() for r in port] == [r.score() for r in ref]
    assert port_research.ResearchBenchmark.markdown_report(port) == \
        jax_research.ResearchBenchmark.markdown_report(ref)
