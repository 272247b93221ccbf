"""Training: train-step builder, trainer loop, data pipeline.

Port of ``photonic_flash_attention_tpu/training`` on one device, with the
same exported names.
"""

from .data import DataPipeline, synthetic_lm_batches
from .trainer import Trainer, TrainState, make_train_step

__all__ = [
    "DataPipeline",
    "Trainer",
    "TrainState",
    "make_train_step",
    "synthetic_lm_batches",
]
