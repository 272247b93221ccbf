"""Trainer: train steps with gradient accumulation and remat, fit, eval.

Port of ``photonic_flash_attention_tpu/training/trainer.py`` on one device.

* The JAX step is a pure function over a params pytree, compiled once; the
  port's step runs eagerly on an ``nn.Module`` and a ``torch.optim``
  optimizer and updates both in place (``TrainState`` carries them).
* Accumulation is a Python loop over the leading microbatch axis (the JAX
  ``lax.scan``), each microbatch's loss divided by ``accum_steps`` before
  its backward, so the summed gradient is the JAX mean.
* ``remat`` wraps the loss in ``torch.utils.checkpoint.checkpoint``
  (non-reentrant), the JAX ``jax.checkpoint``.
* Parameters stay float32 (master weights); compute runs in the model's
  ``dtype`` (bf16 needs no loss scaling).

Attention gradients go through ``ops/flash.py`` (K1 with lse, K4/K5 on
CUDA). Not in this slice: the mesh and sharded parameters (ROADMAP A12)
and train-mode dropout (A10); both raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..utils.logging import get_logger

logger = get_logger("training")

Batch = Dict[str, Any]


@dataclasses.dataclass
class TrainState:
    """Carried training state: the step count, and the model and optimizer
    that the step updates in place."""

    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer


def lm_loss(model: nn.Module, batch: Batch) -> torch.Tensor:
    """Next-token cross entropy in float32 with an optional loss mask."""
    logits = model(batch["input_ids"].long())
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(-1, batch["labels"].long()[..., None])[..., 0]
    mask = batch.get("loss_mask")
    if mask is None:
        return -ll.mean()
    mask = mask.float()
    return -(ll * mask).sum() / mask.sum().clamp_min(1.0)


def _global_norm(grads) -> torch.Tensor:
    """L2 norm over every gradient (``optax.global_norm``)."""
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads])
    )


def make_train_step(
    model: nn.Module,
    optimizer: torch.optim.Optimizer,
    *,
    loss_fn: Optional[Callable] = None,
    accum_steps: int = 1,
    remat: bool = False,
    dropout_rng: Optional[torch.Generator] = None,
):
    """Build a ``(state, batch) -> (state, metrics)`` step.

    ``batch`` tensors have a leading microbatch axis when
    ``accum_steps > 1``: shape (accum, per_step_batch, ...). ``metrics`` are
    ``{"loss", "grad_norm"}``, ``grad_norm`` the global L2 norm of the
    gradient before the update.
    """
    if dropout_rng is not None:
        raise NotImplementedError("train-mode dropout is not ported yet (ROADMAP A10)")
    base_loss = loss_fn or lm_loss

    def one_loss(micro: Batch) -> torch.Tensor:
        if remat:
            return checkpoint(base_loss, model, micro, use_reentrant=False)
        return base_loss(model, micro)

    params = [p for p in model.parameters() if p.requires_grad]

    def step(state: TrainState, batch: Batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        optimizer.zero_grad(set_to_none=True)
        if accum_steps == 1:
            loss = one_loss(batch)
            loss.backward()
            loss = loss.detach()
        else:
            n_micro = next(iter(batch.values())).shape[0]
            loss = torch.zeros((), device=params[0].device)
            for i in range(n_micro):
                micro_loss = one_loss({k: v[i] for k, v in batch.items()}) / accum_steps
                micro_loss.backward()
                loss += micro_loss.detach()
        gnorm = _global_norm([p.grad for p in params if p.grad is not None])
        optimizer.step()
        state.step += 1
        return state, {"loss": loss, "grad_norm": gnorm}

    return step


class Trainer:
    """Training loop with metrics and checkpoint hooks.

    Args:
      model: an ``nn.Module`` mapping input ids to logits, on its device.
      optimizer: a ``torch.optim`` optimizer over the model's parameters.
      mesh, param_specs: sharded training; not ported yet (ROADMAP A12).
    """

    def __init__(
        self,
        model: nn.Module,
        optimizer: torch.optim.Optimizer,
        *,
        mesh: Any = None,
        param_specs: Any = None,
        accum_steps: int = 1,
        remat: bool = False,
        loss_fn: Optional[Callable] = None,
    ) -> None:
        if mesh is not None or param_specs is not None:
            raise NotImplementedError("mesh-sharded training is not ported yet (ROADMAP A12)")
        self.model = model
        self.optimizer = optimizer
        self.accum_steps = accum_steps
        self._step_fn = make_train_step(
            model, optimizer, accum_steps=accum_steps, remat=remat, loss_fn=loss_fn
        )
        self.history: list = []

    # -- state management ---------------------------------------------------

    def init_state(self) -> TrainState:
        return TrainState(step=0, model=self.model, optimizer=self.optimizer)

    def _place_batch(self, batch: Batch) -> Dict[str, torch.Tensor]:
        device = next(self.model.parameters()).device
        return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}

    # -- loops ---------------------------------------------------------------

    def train_step(self, state: TrainState, batch: Batch) -> Tuple[TrainState, Dict]:
        return self._step_fn(state, self._place_batch(batch))

    def fit(
        self,
        state: TrainState,
        batches: Iterable[Batch],
        *,
        steps: Optional[int] = None,
        log_every: int = 10,
        checkpoint_fn: Optional[Callable[[TrainState, int], None]] = None,
        checkpoint_every: int = 0,
    ) -> TrainState:
        t0 = time.time()
        for i, batch in enumerate(batches):
            if steps is not None and i >= steps:
                break
            state, metrics = self.train_step(state, batch)
            if (i + 1) % log_every == 0:
                loss = float(metrics["loss"])
                self.history.append({"step": state.step, "loss": loss})
                logger.info(
                    "step %d loss %.4f grad_norm %.3f (%.2f s)",
                    state.step, loss, float(metrics["grad_norm"]), time.time() - t0,
                )
            if checkpoint_fn and checkpoint_every and (i + 1) % checkpoint_every == 0:
                checkpoint_fn(state, state.step)
        return state

    @torch.no_grad()
    def evaluate(
        self, state: TrainState, batches: Iterable[Batch],
        loss_fn: Optional[Callable] = None,
    ) -> float:
        """Mean loss over ``batches`` in eval mode (no gradient)."""
        fn = loss_fn or lm_loss
        was_training = state.model.training
        state.model.eval()
        try:
            total, n = 0.0, 0
            for batch in batches:
                total += float(fn(state.model, self._place_batch(batch)))
                n += 1
        finally:
            state.model.train(was_training)
        return total / max(n, 1)
