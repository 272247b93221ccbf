"""Load the JAX package's GPT-2 weights into the port.

``params_from_jax`` turns the Flax ``GPT2LMHead`` parameter tree (scanned
layout: every layer leaf stacked on a leading (L,) axis, leaves as numpy
arrays or anything ``np.asarray`` takes) into a ``state_dict`` for
``models/gpt2.py::GPT2LMHead``. Flax ``Dense.kernel`` is (in, out) and
``nn.Linear.weight`` is (out, in), so kernels are transposed; LayerNorm
``scale`` becomes ``weight``. No JAX import: the tree is plain data.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

_DENSE = {
    "attn": ("q_proj", "k_proj", "v_proj", "out_proj"),
    "mlp": ("c_fc", "c_proj"),
}


def _t(x: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32, order="C"))  # writable C-order copy


def params_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax GPT2LMHead params (with or without the outer ``{"params": ...}``)
    -> GPT2LMHead state_dict (float32 CPU tensors)."""
    p = tree.get("params", tree)
    sd = {
        "wte": _t(p["wte"]),
        "wpe": _t(p["wpe"]),
        "ln_f.weight": _t(p["ln_f"]["scale"]),
        "ln_f.bias": _t(p["ln_f"]["bias"]),
    }
    blk = p["h"]["block"]
    n_layer = np.asarray(blk["ln_1"]["scale"]).shape[0]
    for i in range(n_layer):
        pre = f"h.{i}."
        for ln in ("ln_1", "ln_2"):
            sd[f"{pre}{ln}.weight"] = _t(np.asarray(blk[ln]["scale"])[i])
            sd[f"{pre}{ln}.bias"] = _t(np.asarray(blk[ln]["bias"])[i])
        for group, names in _DENSE.items():
            for name in names:
                leaf = blk[group][name]
                sd[f"{pre}{group}.{name}.weight"] = _t(np.asarray(leaf["kernel"])[i].T)
                sd[f"{pre}{group}.{name}.bias"] = _t(np.asarray(leaf["bias"])[i])
    return sd
