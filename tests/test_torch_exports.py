"""The port's public names are the JAX package's, minus those not ported.

The JAX package exports its config functions in ``__all__`` and re-exports
the flash functions and the drop-in layers lazily (``__getattr__``);
``core``, ``models``, ``ops`` and ``hardware`` list their names in
``__all__``. The port must resolve every one of them except the names of
ROADMAP items still open (listed below), and export nothing the JAX
package does not.
"""

import ast
import inspect

import pytest

import photonic_flash_attention_tpu as jax_pkg
import photonic_flash_attention_tpu.core as jax_core
import photonic_flash_attention_tpu.hardware as jax_hardware
import photonic_flash_attention_tpu.models as jax_models
import photonic_flash_attention_tpu.ops as jax_ops
import photonic_flash_attention_tpu_torch as port
import photonic_flash_attention_tpu_torch.core as port_core
import photonic_flash_attention_tpu_torch.hardware as port_hardware
import photonic_flash_attention_tpu_torch.models as port_models
import photonic_flash_attention_tpu_torch.ops as port_ops

#: Top-level names not ported yet: none.
NOT_PORTED: set = set()
#: ``models`` names not ported yet: none.
MODELS_NOT_PORTED: set = set()

#: ``hardware`` names not ported yet: the design-space simulators (A14, later).
HARDWARE_NOT_PORTED = {"CollectiveCost", "KernelPipelineSimulator", "PipelinePrediction",
                       "TopologySimulator"}


def _lazy_names(module) -> set:
    """The string constants the module's ``__getattr__`` compares a name
    with: the names it re-exports lazily."""
    tree = ast.parse(inspect.getsource(module))
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "__getattr__")
    return {c.value for c in ast.walk(fn) if isinstance(c, ast.Constant) and isinstance(c.value, str)
            and c.value.isidentifier()}


def test_top_level_names_match_jax():
    assert port.__all__ == jax_pkg.__all__
    jax_names = set(jax_pkg.__all__) | _lazy_names(jax_pkg)
    assert "PhotonicFlashAttention" in jax_names and "get_config" in jax_names
    for name in sorted(jax_names - NOT_PORTED):
        assert getattr(port, name) is not None, name
    for name in NOT_PORTED:
        with pytest.raises(AttributeError):
            getattr(port, name)
    assert _lazy_names(port) <= jax_names


def test_models_names_match_jax():
    assert set(port_models.__all__) == set(jax_models.__all__) - MODELS_NOT_PORTED
    for name in port_models.__all__:
        assert getattr(port_models, name) is not None, name


def test_ops_names_match_jax():
    assert set(port_ops.__all__) == set(jax_ops.__all__)
    for name in port_ops.__all__:
        obj = getattr(port_ops, name)
        assert obj is not None and obj.__module__.startswith(port_ops.__name__), name
    for name in ("fused_softmax", "fused_layer_norm", "fused_rms_norm", "apply_nonlinearity",
                 "NonlinearityType", "QuantizedTensor", "quantize", "dequantize", "quantize_kv",
                 "quantization_error"):
        assert name in port_ops.__all__, name


def test_hardware_names_match_jax():
    assert port_hardware.__all__ == [n for n in jax_hardware.__all__
                                     if n not in HARDWARE_NOT_PORTED]
    assert HARDWARE_NOT_PORTED <= set(jax_hardware.__all__)
    for name in port_hardware.__all__:
        obj = getattr(port_hardware, name)
        assert obj.__module__.startswith(port_hardware.__name__), name


def test_parallel_names_match_jax():
    import photonic_flash_attention_tpu.parallel as jax_parallel
    import photonic_flash_attention_tpu_torch.parallel as port_parallel

    assert port_parallel.__all__ == jax_parallel.__all__
    for name in port_parallel.__all__:
        obj = getattr(port_parallel, name)
        assert obj is not None, name
        assert isinstance(obj, str) or obj.__module__.startswith(port_parallel.__name__), name


def test_core_names_match_jax():
    assert port_core.__all__ == jax_core.__all__
    for name in port_core.__all__:
        obj = getattr(port_core, name)
        assert obj.__module__.startswith(port_core.__name__), name


def test_exported_objects_are_the_ports():
    from photonic_flash_attention_tpu_torch.config import GlobalConfig, get_config
    from photonic_flash_attention_tpu_torch.models.attention import PhotonicFlashAttention
    from photonic_flash_attention_tpu_torch.ops.flash import flash_attention

    assert port.GlobalConfig is GlobalConfig and port.get_config is get_config
    assert port.PhotonicFlashAttention is PhotonicFlashAttention
    assert port.flash_attention is flash_attention
    assert port.set_global_config(flash_threshold=77).flash_threshold == 77
    port.reset_config()
    assert port.get_config().flash_threshold == 512


#: Each port experiment module, its JAX file under ``benchmarks/`` and the
#: entry functions they share (the pipeline file has six).
EXPERIMENTS = [
    ("flash_fixedmax_experiment", "flash_fixedmax"),
    ("flash_aug_experiment", "flash_aug"),
    ("flash_pair_experiment", "flash_pair"),
    ("flash_pipeline_experiment", "flash_unrolled"),
    ("flash_pipeline_experiment", "flash_chunked"),
    ("flash_pipeline_experiment", "flash_triangular"),
    ("flash_pipeline_experiment", "flash_tri_i8"),
    ("flash_pipeline_experiment", "flash_segmented"),
    ("flash_pipeline_experiment", "flash_fulltri"),
    ("flash_bwd_unrolled_experiment", "flash_bwd_unrolled"),
]
#: Entries with no kernel of their own, so no ``*_plain`` version: the
#: segmented variant runs K1 (or its plain version) per segment.
NO_KERNEL = ("flash_segmented",)


def _jax_functions(name: str) -> dict:
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "benchmarks" / f"{name}.py"
    tree = ast.parse(path.read_text())
    return {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}


@pytest.mark.parametrize("module, entry", sorted(EXPERIMENTS))
def test_experiment_entries_match_the_jax_files(module, entry):
    import importlib

    from photonic_flash_attention_tpu_torch import experiments

    port_mod = importlib.import_module(f"{experiments.__name__}.{module}")
    jax_fns = _jax_functions(module)
    assert entry in jax_fns and "main" in jax_fns
    assert getattr(experiments, entry) is getattr(port_mod, entry)
    # The same arguments, by name, in the same order, and the same defaults.
    jax_args = jax_fns[entry].args
    names = [a.arg for a in jax_args.args + jax_args.kwonlyargs]
    # (kw_defaults holds None for a keyword-only argument without a default.)
    defaults = [ast.literal_eval(d) for d in jax_args.defaults + jax_args.kw_defaults
                if d is not None]
    params = inspect.signature(getattr(port_mod, entry)).parameters
    assert list(params) == names
    assert [p.default for p in params.values() if p.default is not inspect.Parameter.empty] \
        == defaults
    assert callable(port_mod.main)
    assert entry in NO_KERNEL or callable(getattr(port_mod, f"{entry}_plain"))


def test_experiments_export_the_four_entries():
    from photonic_flash_attention_tpu_torch import experiments

    assert sorted(experiments.__all__) == sorted(entry for _, entry in EXPERIMENTS)
