"""The port imports no JAX: the machine with the GPU has none.

Every module of ``photonic_flash_attention_tpu_torch`` (and ``chip_smoke.py``)
must import in a process where ``jax``, ``flax``, the JAX package and the
JAX experiment files under ``benchmarks/`` are blocked, and no source line
of the port may import them. That includes the
port's own copy of ``core/router.py``, whose JAX original imports no JAX
but belongs to the JAX package.
"""

import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest

import photonic_flash_attention_tpu_torch as port

ROOT = Path(__file__).resolve().parent.parent
PORT_DIR = Path(port.__file__).resolve().parent
BLOCKED = ("jax", "jaxlib", "flax", "photonic_flash_attention_tpu", "benchmarks")
IMPORT_RE = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|flax|photonic_flash_attention_tpu|benchmarks)\b"
    r"(?!_torch)",
    re.MULTILINE,
)


def _port_modules():
    names = [port.__name__]
    for info in pkgutil.walk_packages([str(PORT_DIR)], prefix=port.__name__ + "."):
        names.append(info.name)
    return names


#: The modules of the model families and the HF conversion, whose
#: ``transfer_hf_*`` / ``load_hf_*`` / ``convert_to_photonic`` alone use
#: ``transformers`` (imported inside the call).
MODEL_MODULES = ("models.llama", "models.llama_serving", "models.bert", "models.convert",
                 "models.gpt2", "models.t5", "core.serving")


def _import_blocked(modules, blocked) -> subprocess.CompletedProcess:
    """Import ``modules`` in a fresh interpreter where ``blocked`` cannot be
    imported; fails if any of them was imported all the same."""
    code = (
        "import sys\n"
        f"for name in {blocked!r}:\n"
        "    sys.modules[name] = None  # any import of it raises ImportError\n"
        "import importlib\n"
        f"for mod in {modules!r}:\n"
        "    importlib.import_module(mod)\n"
        f"leaked = [m for m in sys.modules if m.split('.')[0] in {blocked!r} "
        "and sys.modules[m] is not None]\n"
        "assert not leaked, leaked\n"
    )
    return subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )


def test_every_module_imports_with_jax_blocked():
    modules = _port_modules() + ["chip_smoke"]
    proc = _import_blocked(modules, BLOCKED)
    assert proc.returncode == 0, proc.stderr
    assert len(_port_modules()) >= 30
    for name in ("config", "ops.fused", "ops.flash_bwd", "ops.flash_fp8", "training.data",
                 "training.trainer", "core.router", "core.engine", "core.timing",
                 "core.autotuner", "utils.validation", "utils.monitoring", "cli",
                 "ops.nonlinearity", "ops.quantization", "ops.hbm_bw", "ops.device_probes",
                 "hardware", "hardware.detection", "hardware.roofline", "experiments",
                 "experiments.flash_fixedmax_experiment", "experiments.flash_aug_experiment",
                 "experiments.flash_pair_experiment", "experiments.flash_pipeline_experiment",
                 "core.kv_cache", "core.native_alloc", "core.native_sched", "core.checkpoint",
                 "core.error_recovery", "parallel", "parallel.mesh", "parallel.multihost",
                 "parallel.telemetry", "parallel.collectives", "parallel.ring",
                 "parallel.ulysses", "parallel.pipeline", "hardware.simulator",
                 "utils.security", "globalization.compliance", "globalization.deployment",
                 "globalization.i18n", "intelligence.adaptive_learning", "monitoring.health",
                 "monitoring.dashboard", "optimization.caching",
                 "optimization.performance_optimizer", "research.novel_algorithms",
                 "resilience.fault_tolerance", "scaling.autoscaler", "scaling.load_balancer",
                 "scaling.workload_balancer", *MODEL_MODULES):
        assert f"{port.__name__}.{name}" in modules


def test_model_modules_import_with_transformers_blocked():
    """The card has no ``transformers``: every module (the new model
    families and the conversion among them) and ``chip_smoke.py`` import
    without it, JAX blocked as well."""
    modules = _port_modules() + ["chip_smoke"]
    assert all(f"{port.__name__}.{name}" in modules for name in MODEL_MODULES)
    proc = _import_blocked(modules, BLOCKED + ("transformers",))
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize(
    "path",
    sorted(PORT_DIR.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_jax_import_in_source(path):
    assert not IMPORT_RE.search(path.read_text()), f"{path} imports JAX"


def test_import_pattern_catches_jax_imports():
    for line in ("import jax", "from jax import numpy", "import flax.linen as nn",
                 "from photonic_flash_attention_tpu.ops import flash",
                 "from benchmarks.flash_aug_experiment import flash_aug", "import benchmarks"):
        assert IMPORT_RE.search(line), line
    assert not IMPORT_RE.search("from photonic_flash_attention_tpu_torch.ops import flash")
