"""Load the JAX package's GPT-2, T5, Llama and BERT weights into the port.

``params_from_jax``, ``llama_params_from_jax`` and ``bert_params_from_jax``
turn the Flax ``GPT2LMHead`` (``h/block`` scanned), ``LlamaForCausalLM``
(``layers/layer``) and ``BertModel`` (``encoder/layer``) parameter trees
(every layer leaf stacked on a leading (L,) axis, leaves as numpy arrays
or anything ``np.asarray`` takes) into state_dicts for
``models/gpt2.py::GPT2LMHead``, ``models/llama.py`` and ``models/bert.py``
through one walker: layer i of the scanned subtree ``name/<inner>``
becomes ``name.{i}``, every other leaf keeps its path.
``t5_params_from_jax`` does the same for the Flax
``T5ForConditionalGeneration`` tree (``{"model": {"shared", "encoder",
"decoder"}}``, blocks stacked on L) and ``models/t5.py``. Flax
``Dense.kernel`` is (in, out) and ``nn.Linear.weight`` is (out, in), so
kernels are transposed; a norm's ``scale`` becomes ``weight``; T5's
``rel_embedding`` stays (num_buckets, H). ``research_params_from_jax``
maps the Flax research modules (``research/novel_algorithms.py``: Dense
layers, ``head_mix``, ``spectral_filter``) the same way. No JAX import: the
tree is plain data.

Any tree shaped like the Flax params maps the same way, so the tests also
use it to carry JAX **gradients** (``jax.grad`` of the loss over the
params) onto the port's parameter names and compare them with the port's
``param.grad``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch


def _t(x: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32, order="C"))  # writable C-order copy


def params_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax GPT2LMHead params (with or without the outer ``{"params": ...}``)
    -> GPT2LMHead state_dict (float32 CPU tensors)."""
    return _scanned_params_from_jax(tree, "h")


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


def _add_subtree(sd: Dict[str, torch.Tensor], pre: str, node: Mapping[str, Any],
                 layer: Optional[int] = None) -> None:
    """A Flax subtree (layer ``layer`` of its scanned leaves) into ``sd``
    under ``pre``: ``kernel`` -> ``weight`` transposed, ``scale`` ->
    ``weight``, ``bias`` and raw parameters by name."""
    for name, leaf in node.items():
        if isinstance(leaf, Mapping):
            _add_subtree(sd, f"{pre}{name}.", leaf, layer)
            continue
        arr = np.asarray(leaf) if layer is None else np.asarray(leaf)[layer]
        key = "weight" if name in ("kernel", "scale") else name
        sd[pre + key] = _t(arr.T if name == "kernel" else arr)


def _scanned_params_from_jax(tree: Mapping[str, Any], stack: str) -> Dict[str, torch.Tensor]:
    """A Flax tree whose ``stack/<inner>`` subtree is scanned on L ->
    state_dict with that subtree as ``stack.{i}``."""
    p = dict(tree.get("params", tree))
    (scanned,) = p.pop(stack).values()
    sd: Dict[str, torch.Tensor] = {}
    _add_subtree(sd, "", p)
    n_layer = np.asarray(next(iter(_leaves(scanned)))).shape[0]
    for i in range(n_layer):
        _add_subtree(sd, f"{stack}.{i}.", scanned, i)
    return sd


def _leaves(node: Mapping[str, Any]):
    for leaf in node.values():
        if isinstance(leaf, Mapping):
            yield from _leaves(leaf)
        else:
            yield leaf


def llama_params_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax LlamaForCausalLM params (with or without the outer
    ``{"params": ...}``) -> ``models/llama.py::LlamaForCausalLM`` state_dict
    (float32 CPU tensors). The untied head's (E, V) ``lm_head`` becomes
    ``lm_head.weight`` (V, E)."""
    sd = _scanned_params_from_jax(tree, "layers")
    if "lm_head" in sd:
        sd["lm_head.weight"] = sd.pop("lm_head").T.contiguous()
    return sd


def bert_params_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax BertModel params (with or without the outer ``{"params": ...}``)
    -> ``models/bert.py::BertModel`` state_dict (float32 CPU tensors)."""
    return _scanned_params_from_jax(tree, "encoder")


def research_params_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ``QuantumInspiredAttention``, ``SpectralAttention`` or
    ``HierarchicalAttention`` params (with or without the outer
    ``{"params": ...}``) -> the port module's state_dict (float32 CPU
    tensors): each Dense ``kernel`` (in, out) becomes the ``nn.Linear``'s
    ``weight`` (out, in), its ``bias`` stays, ``head_mix`` and
    ``spectral_filter`` keep their names and shapes."""
    sd: Dict[str, torch.Tensor] = {}
    _add_subtree(sd, "", tree.get("params", tree))
    return sd
