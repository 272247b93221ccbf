"""HF-model conversion: ``convert_to_photonic`` for the port.

Port of ``photonic_flash_attention_tpu/models/convert.py``: detect the
source model's attention layers (class-name pattern and q/k/v attribute
sniffing), detect its family, build the port's model of that family (GPT-2,
BERT, T5 or Llama, on the port's attention kernels), transfer every weight
(GPT-2's fused ``c_attn`` split, BERT's separate projections) through the
family's ``transfer_hf_*``, and report what was done
(``ConversionReport``).

``convert_to_photonic(model_name_or_model)`` takes an HF model name (a
download, through ``transformers``) or a loaded ``transformers`` PyTorch
model and returns ``(module, state_dict, report)``: the port's
``nn.Module`` with its weights on ``device`` (the card unless the caller
passes another), its state_dict, the report. Every layer is converted
(JAX's ``strategy`` option, which no code reads, is not ported). An unknown
family raises ``ConfigurationError``. ``transformers`` is imported only
where a name is given: the port itself never needs it.
"""

from __future__ import annotations

import dataclasses
import re
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..utils.exceptions import ConfigurationError
from ..utils.logging import get_logger
from .attention import model_device

logger = get_logger("convert")

# Attention-layer detection tactics.
_ATTENTION_CLASS_RE = re.compile(r"(attention|attn|multihead|mha|selfattention)", re.IGNORECASE)
_QKV_ATTRS = (
    ("q_proj", "k_proj", "v_proj"),
    ("query", "key", "value"),
    ("q_lin", "k_lin", "v_lin"),
    ("c_attn",),  # GPT-2 fused
    ("qkv_proj",),
    ("in_proj_weight",),
)


@dataclasses.dataclass
class PhotonicConfig:
    """Conversion gates: below them a model converts with a warning."""

    min_heads: int = 8
    min_embed_dim: int = 512
    dtype: torch.dtype = torch.bfloat16


@dataclasses.dataclass
class ConversionReport:
    """What the conversion did."""

    model_family: str
    total_attention_layers: int
    converted_layers: int
    skipped_layers: int
    parameters_transferred: int
    warnings: List[str]
    elapsed_s: float

    @property
    def conversion_rate(self) -> float:
        if self.total_attention_layers == 0:
            return 0.0
        return self.converted_layers / self.total_attention_layers

    def summary(self) -> str:
        return (
            f"{self.model_family}: converted {self.converted_layers}/"
            f"{self.total_attention_layers} attention layers "
            f"({self.conversion_rate:.0%}), {self.parameters_transferred:,} "
            f"params transferred in {self.elapsed_s:.1f}s"
        )


class AttentionLayerDetector:
    """Find attention layers in a torch module tree."""

    @staticmethod
    def is_attention_layer(module: Any) -> bool:
        if _ATTENTION_CLASS_RE.search(type(module).__name__):
            return True
        return any(all(hasattr(module, a) for a in attrs) for attrs in _QKV_ATTRS)

    @classmethod
    def find_attention_layers(cls, model: Any) -> List[Tuple[str, Any]]:
        found: List[Tuple[str, Any]] = []
        for path, module in model.named_modules():
            if not path:
                continue
            if cls.is_attention_layer(module):
                # Keep only the outermost attention wrappers.
                if found and path.startswith(found[-1][0] + "."):
                    continue
                found.append((path, module))
        return found


def _detect_family(model: Any) -> str:
    cfg = getattr(model, "config", None)
    mt = getattr(cfg, "model_type", "") if cfg is not None else ""
    if mt:
        return mt
    name = type(model).__name__.lower()
    for fam in ("gpt2", "bert", "t5", "llama", "gpt_neox"):
        if fam in name:
            return fam
    return "unknown"


def _gate_warning(heads: int, embed: int, config: PhotonicConfig) -> List[str]:
    if heads < config.min_heads or embed < config.min_embed_dim:
        return [f"model below conversion gates (heads={heads}, embed={embed}); "
                f"converting anyway per strategy"]
    return []


def convert_to_photonic(
    model: Any, config: Optional[PhotonicConfig] = None, device: Any = "cuda"
) -> Tuple[torch.nn.Module, Dict[str, torch.Tensor], ConversionReport]:
    """Convert an HF model (name or loaded torch module) to the port.

    Returns (the port's module with the weights on ``device``, its
    state_dict, the report) for the gpt2, bert, t5 and llama families; any
    other family raises ``ConfigurationError`` naming what the detector
    found."""
    config = config or PhotonicConfig()
    device = model_device(device)
    t0 = time.time()
    warnings: List[str] = []

    if isinstance(model, str):
        from transformers import AutoModel, AutoModelForCausalLM

        name = model
        try:
            model = AutoModelForCausalLM.from_pretrained(name)
        except (OSError, ValueError):
            model = AutoModel.from_pretrained(name)

    family = _detect_family(model)
    layers = AttentionLayerDetector.find_attention_layers(model)
    logger.info("detected %d attention layers in %s model", len(layers), family)

    if family == "gpt2":
        from .gpt2 import transfer_hf_gpt2

        warnings += _gate_warning(model.config.n_head, model.config.n_embd, config)
        module, state, _ = transfer_hf_gpt2(model, config.dtype, device)
    elif family == "bert":
        from .bert import transfer_hf_bert

        warnings += _gate_warning(model.config.num_attention_heads, model.config.hidden_size,
                                  config)
        module, state, _ = transfer_hf_bert(model, config.dtype, device)
    elif family == "t5":
        from .t5 import transfer_hf_t5

        module, state, _ = transfer_hf_t5(model, config.dtype, device)
    elif family == "llama":
        from .llama import transfer_hf_llama

        module, state, _ = transfer_hf_llama(model, config.dtype, device)
    else:
        raise ConfigurationError(
            f"unsupported model family {family!r} "
            f"(detected {len(layers)} attention layers: {[p for p, _ in layers[:4]]}...)"
        )

    report = ConversionReport(
        model_family=family,
        total_attention_layers=len(layers),
        converted_layers=len(layers),
        skipped_layers=0,
        parameters_transferred=sum(int(t.numel()) for t in state.values()),
        warnings=warnings,
        elapsed_s=time.time() - t0,
    )
    logger.info(report.summary())
    return module, state, report
