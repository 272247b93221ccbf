"""Load the JAX package's GPT-2 and T5 weights into the port.

``params_from_jax`` turns the Flax ``GPT2LMHead`` parameter tree (scanned
layout: every layer leaf stacked on a leading (L,) axis, leaves as numpy
arrays or anything ``np.asarray`` takes) into a ``state_dict`` for
``models/gpt2.py::GPT2LMHead``; ``t5_params_from_jax`` does the same for
the Flax ``T5ForConditionalGeneration`` tree (``{"model": {"shared",
"encoder", "decoder"}}``, blocks stacked on L) and ``models/t5.py``. Flax
``Dense.kernel`` is (in, out) and ``nn.Linear.weight`` is (out, in), so
kernels are transposed; a norm's ``scale`` becomes ``weight``; T5's
``rel_embedding`` stays (num_buckets, H). No JAX import: the tree is plain
data.

Any tree shaped like the Flax params maps the same way, so the tests also
use it to carry JAX **gradients** (``jax.grad`` of the loss over the
params) onto the port's parameter names and compare them with the port's
``param.grad``.
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


def t5_params_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax T5ForConditionalGeneration params (with or without the outer
    ``{"params": ...}``) -> ``models/t5.py::T5ForConditionalGeneration``
    state_dict (float32 CPU tensors)."""
    m = tree.get("params", tree)["model"]
    sd = {"model.shared": _t(m["shared"])}
    for stack in ("encoder", "decoder"):
        p = m[stack]
        pre = f"model.{stack}."
        sd[pre + "rel_bias.rel_embedding"] = _t(p["rel_bias"]["rel_embedding"])
        sd[pre + "final_ln.weight"] = _t(p["final_ln"]["scale"])
        blk = p["blocks"]["block"]
        n_layer = np.asarray(blk["self_attn_ln"]["scale"]).shape[0]
        for i in range(n_layer):
            for name, leaf in blk.items():
                for sub, arr in leaf.items():  # {"scale": x} or {"q": {"kernel": x}, ...}
                    if sub == "scale":
                        sd[f"{pre}blocks.{i}.{name}.weight"] = _t(np.asarray(arr)[i])
                    else:
                        sd[f"{pre}blocks.{i}.{name}.{sub}.weight"] = _t(
                            np.asarray(arr["kernel"])[i].T)
    return sd
