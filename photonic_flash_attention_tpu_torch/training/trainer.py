"""Trainer: train steps with gradient accumulation and remat, fit, eval.

Port of ``photonic_flash_attention_tpu/training/trainer.py``.

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
* ``dropout_rng`` (a CPU ``torch.Generator``) gives the run its dropout
  seeds, as JAX's key: one base seed is drawn from it when the step is
  built, step ``n`` takes ``fold_seed(base, n)`` and microbatch ``i`` of it
  ``fold_seed(step_seed, i)`` (``ops/dropout.py``), and the loss passes the
  seed to the model (``model(ids, dropout_seed=...)``), which derives one
  per layer. No layer advances a generator, so a remat recompute draws the
  same masks. The schedule is the port's own: Flax's ``fold_in`` and
  ``make_rng`` streams are not reproduced.

Attention gradients go through ``ops/flash.py`` (K1 with lse, K4/K5 on
CUDA).

With a mesh (``parallel/mesh.py``; JAX ``training/trainer.py:155-225``),
every rank builds the same model from the same init and the trainer
places it, with explicit collectives where JAX's GSPMD inserts them:

* ``data`` axis: each rank takes its block of the batch; the loss of each
  rank is weighted by its share of the tokens (of ``loss_mask`` where the
  batch has one), and one all-reduce a step sums the gradients over the
  axis, so loss and gradient are the global batch's;
* ``param_specs`` (``models.gpt2.param_sharding_rules``): each parameter
  is cut to the rank's block in place (the optimizer sees the shards);
  specs that name a model axis make the model's forward tensor parallel
  over that axis: the model owns that forward, set up by its
  ``tensor_parallel(group, specs, model_axis)`` (``models/gpt2.py``: an
  all-reduce after each row-parallel dense, ``wte``'s shard gathered);
* sequence parallel: the model's attention asks the engine at every call
  (``core/engine.py::AttentionEngine.seq_parallel_attention``); when the
  engine has a mesh whose seq axis can take the rank's heads and
  sequence, attention runs over it: Ulysses (its backward is K4/K5) or
  ring attention (``parallel/``). A mesh set or cleared after the trainer
  was built is seen at the next step.

``grad_norm`` is the global norm of the full gradient (the model-sharded
parameters' squares summed over the model axis).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.dropout import fold_seed
from ..parallel import collectives as C
from ..parallel.mesh import axis_group, axis_index, mesh_shape, shard_tensor
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


def lm_loss(model: nn.Module, batch: Batch, dropout_seed: Optional[int] = None) -> torch.Tensor:
    """Next-token cross entropy in float32 with an optional loss mask;
    ``dropout_seed`` reaches the model's train-mode dropout."""
    ids = batch["input_ids"].long()
    logits = model(ids) if dropout_seed is None else model(ids, dropout_seed=dropout_seed)
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(-1, batch["labels"].long()[..., None])[..., 0]
    mask = batch.get("loss_mask")
    if mask is None:
        return -ll.mean()
    mask = mask.float()
    return -(ll * mask).sum() / mask.sum().clamp_min(1.0)


def _global_norm(grads, placement: Optional["_Placement"] = None) -> torch.Tensor:
    """L2 norm over every gradient (``optax.global_norm``); the gradients
    of model-sharded parameters are blocks of the full gradient, so their
    squares are summed over the model axis (of more than one rank)."""
    norms = [torch.linalg.vector_norm(g.float()) for g in grads]
    group = placement.model_group if placement else None
    if group is None or dist.get_world_size(group) == 1:
        return torch.linalg.vector_norm(torch.stack(norms))
    sharded = {id(p.grad) for p in placement.model_sharded}
    sq = torch.stack([n for g, n in zip(grads, norms) if id(g) not in sharded]).square().sum()
    part = torch.stack([n for g, n in zip(grads, norms) if id(g) in sharded]).square().sum()
    return torch.sqrt(sq + C.all_reduce_sum(part, group))


def _token_count(micro: Batch) -> torch.Tensor:
    """What a rank's loss averages over: the loss mask's sum, else the
    label count, else the rows."""
    if "loss_mask" in micro:
        return micro["loss_mask"].float().sum()
    ref = micro.get("labels", next(iter(micro.values())))
    return torch.tensor(float(ref.numel() if "labels" in micro else ref.shape[0]),
                        device=ref.device)


def _data_share(micro: Batch, group) -> torch.Tensor:
    """This rank's share of the data axis's tokens: its loss times the
    share, summed over the axis, is the global batch's loss."""
    mine = _token_count(micro)
    return mine / C.all_reduce_sum(mine, group).clamp_min(1.0)


@dataclasses.dataclass
class _Placement:
    """Where a sharded step's collectives run: the data axis's group (None:
    no data parallelism) and the model axis's group with the parameters it
    shards (their squares are summed over it for the norm)."""

    data_group: Any = None
    model_group: Any = None
    model_sharded: Tuple[nn.Parameter, ...] = ()


def make_train_step(
    model: nn.Module,
    optimizer: torch.optim.Optimizer,
    *,
    loss_fn: Optional[Callable] = None,
    accum_steps: int = 1,
    remat: bool = False,
    dropout_rng: Optional[torch.Generator] = None,
    placement: Optional[_Placement] = None,
):
    """Build a ``(state, batch) -> (state, metrics)`` step.

    ``batch`` tensors have a leading microbatch axis when
    ``accum_steps > 1``: shape (accum, per_step_batch, ...). ``metrics`` are
    ``{"loss", "grad_norm"}``, ``grad_norm`` the global L2 norm of the
    gradient before the update. With ``dropout_rng`` the loss is called as
    ``loss_fn(model, batch, dropout_seed=seed)`` with the step's (and
    microbatch's) seed; without it, as ``loss_fn(model, batch)``.
    """
    base_loss = loss_fn or lm_loss
    base_seed = (int(torch.randint(0, 2**31 - 1, (1,), generator=dropout_rng))
                 if dropout_rng is not None else None)

    def one_loss(micro: Batch, seed: Optional[int]) -> torch.Tensor:
        kw = {} if seed is None else {"dropout_seed": seed}
        if remat:
            return checkpoint(base_loss, model, micro, use_reentrant=False, **kw)
        return base_loss(model, micro, **kw)

    params = [p for p in model.parameters() if p.requires_grad]
    place = placement or _Placement()
    data_group = place.data_group
    data_size = 1 if data_group is None else dist.get_world_size(data_group)

    def step(state: TrainState, batch: Batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        optimizer.zero_grad(set_to_none=True)
        step_seed = fold_seed(base_seed, state.step) if base_seed is not None else None
        micros = [batch] if accum_steps == 1 else [
            {k: v[i] for k, v in batch.items()} for i in range(next(iter(batch.values())).shape[0])]
        loss = None
        for i, micro in enumerate(micros):
            seed = step_seed if accum_steps == 1 or step_seed is None else fold_seed(step_seed, i)
            micro_loss = one_loss(micro, seed)
            if accum_steps > 1:
                micro_loss = micro_loss / accum_steps
            if data_size > 1:
                micro_loss = micro_loss * _data_share(micro, data_group)
            micro_loss.backward()
            loss = micro_loss.detach() if loss is None else loss + micro_loss.detach()
        grads = [p.grad for p in params if p.grad is not None]
        if data_size > 1:
            # One all-reduce a step, in place on one flat buffer: the global
            # batch's loss and gradient.
            flat = C.all_reduce_(torch.cat([loss[None]] + [g.reshape(-1) for g in grads]),
                                 data_group)
            loss = flat[0]
            offset = 1
            for g in grads:
                g.copy_(flat[offset:offset + g.numel()].view_as(g))
                offset += g.numel()
        gnorm = _global_norm(grads, place)
        optimizer.step()
        state.step += 1
        return state, {"loss": loss, "grad_norm": gnorm}

    return step


class Trainer:
    """Training loop with metrics and checkpoint hooks.

    Args:
      model: an ``nn.Module`` mapping input ids to logits, on its device;
        with a mesh, the same full model (same init) on every rank.
      optimizer: a ``torch.optim`` optimizer over the model's parameters
        (it must hold no state yet when a mesh shards them).
      mesh: a ``parallel.mesh.create_mesh`` mesh; batches shard on
        ``data_axis`` where the mesh has it.
      param_specs: {parameter name: PartitionSpec} (e.g.
        ``models.param_sharding_rules(model.state_dict())``); a name left out
        is replicated. Specs that shard over a model axis make the step
        tensor parallel through the model's ``tensor_parallel`` (GPT-2's
        checks that they are its rules' layout).
      dropout_rng: a CPU ``torch.Generator`` seeding train-mode dropout
        (``make_train_step``); None leaves the model's own convention.
    """

    def __init__(
        self,
        model: nn.Module,
        optimizer: torch.optim.Optimizer,
        *,
        mesh: Any = None,
        param_specs: Optional[Dict[str, Any]] = None,
        data_axis: str = "data",
        accum_steps: int = 1,
        remat: bool = False,
        loss_fn: Optional[Callable] = None,
        dropout_rng: Optional[torch.Generator] = None,
    ) -> None:
        if param_specs is not None and mesh is None:
            raise ValueError("param_specs place parameters on a mesh; pass mesh= as well")
        self.model = model
        self.optimizer = optimizer
        self.mesh = mesh
        self.param_specs = param_specs
        self.data_axis = data_axis
        self.accum_steps = accum_steps
        self._data_block = None
        placement = None
        if mesh is not None:
            placement = self._place(model, mesh, param_specs or {}, data_axis)
        self._placement = placement
        self._step_fn = make_train_step(
            model, optimizer, accum_steps=accum_steps, remat=remat, loss_fn=loss_fn,
            dropout_rng=dropout_rng, placement=placement,
        )
        self.history: list = []

    def _place(self, model: nn.Module, mesh, specs: Dict[str, Any], data_axis: str):
        """Shard the parameters by ``specs`` and set the model's forward
        tensor parallel where they name a model axis: the step's
        placement."""
        axes = mesh_shape(mesh)
        model_axes = {a for spec in specs.values() for a in spec if a is not None}
        if not model_axes <= set(axes) or len(model_axes) > 1:
            raise ValueError(f"param_specs shard over {sorted(model_axes)}; the mesh has "
                             f"{sorted(axes)} (one model axis at most)")
        placement = _Placement()
        if data_axis in axes:
            placement.data_group = axis_group(mesh, data_axis)
            self._data_block = (axis_index(mesh, data_axis), axes[data_axis])
        if not model_axes:
            return placement
        model_axis = model_axes.pop()
        attach = getattr(model, "tensor_parallel", None)
        if attach is None:
            raise ValueError(f"{type(model).__name__} has no tensor-parallel forward (a "
                             "tensor_parallel(group, specs, model_axis) method)")
        placement.model_group = axis_group(mesh, model_axis)
        attach(placement.model_group, specs, model_axis)
        sharded = []
        with torch.no_grad():
            for name, p in model.named_parameters():
                spec = specs.get(name, ())
                if any(a is not None for a in spec):
                    p.data = shard_tensor(p.data, spec, mesh)
                    sharded.append(p)
        placement.model_sharded = tuple(sharded)
        return placement

    # -- state management ---------------------------------------------------

    def init_state(self) -> TrainState:
        return TrainState(step=0, model=self.model, optimizer=self.optimizer)

    def _place_batch(self, batch: Batch) -> Dict[str, torch.Tensor]:
        """The batch on the model's device; with a data axis, this rank's
        block of it (the leading axis, after the microbatch axis)."""
        device = next(self.model.parameters()).device
        out = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
        if self._data_block is not None:
            i, n = self._data_block
            dim = 1 if self.accum_steps > 1 else 0
            out = {k: v.tensor_split(n, dim=dim)[i] for k, v in out.items()}
        return out

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
        """Mean loss over ``batches`` in eval mode (no gradient); with a
        mesh, every rank of it calls this with the same batches."""
        fn = loss_fn or lm_loss
        was_training = state.model.training
        state.model.eval()
        try:
            total, n = 0.0, 0
            group = self._placement.data_group if self._placement else None
            for batch in batches:
                placed = self._place_batch(batch)
                loss = fn(self.model, placed)
                if group is not None:
                    loss = C.all_reduce_sum(loss * _data_share(placed, group), group)
                total += float(loss)
                n += 1
        finally:
            state.model.train(was_training)
        return total / max(n, 1)
