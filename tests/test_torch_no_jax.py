"""The port imports no JAX: the machine with the GPU has none.

Every module of ``photonic_flash_attention_tpu_torch`` (and ``chip_smoke.py``)
must import in a process where ``jax``, ``flax`` and the JAX package are
blocked, and no source line of the port may import them.
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
BLOCKED = ("jax", "jaxlib", "flax", "photonic_flash_attention_tpu")
IMPORT_RE = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|flax|photonic_flash_attention_tpu)\b(?!_torch)",
    re.MULTILINE,
)


def _port_modules():
    names = [port.__name__]
    for info in pkgutil.walk_packages([str(PORT_DIR)], prefix=port.__name__ + "."):
        names.append(info.name)
    return names


def test_every_module_imports_with_jax_blocked():
    modules = _port_modules() + ["chip_smoke"]
    code = (
        "import sys\n"
        f"for name in {BLOCKED!r}:\n"
        "    sys.modules[name] = None  # any import of it raises ImportError\n"
        "import importlib\n"
        f"for mod in {modules!r}:\n"
        "    importlib.import_module(mod)\n"
        f"leaked = [m for m in sys.modules if m.split('.')[0] in {BLOCKED!r} "
        "and sys.modules[m] is not None]\n"
        "assert not leaked, leaked\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert len(_port_modules()) >= 24
    for name in ("config", "ops.fused", "ops.flash_bwd", "training.data", "training.trainer"):
        assert f"{port.__name__}.{name}" in modules


@pytest.mark.parametrize(
    "path",
    sorted(PORT_DIR.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_jax_import_in_source(path):
    assert not IMPORT_RE.search(path.read_text()), f"{path} imports JAX"


def test_import_pattern_catches_jax_imports():
    for line in ("import jax", "from jax import numpy", "import flax.linen as nn",
                 "from photonic_flash_attention_tpu.ops import flash"):
        assert IMPORT_RE.search(line), line
    assert not IMPORT_RE.search("from photonic_flash_attention_tpu_torch.ops import flash")
