"""Pipeline parallelism: the GPipe microbatch schedule over a stage axis.

Port of ``photonic_flash_attention_tpu/parallel/pipeline.py``
(``_pipeline_body`` :34, ``make_pipeline`` :86). Each rank of the ``stage``
axis holds one stage's parameters; M microbatches flow stage to stage in
M + S - 1 ticks (the usual (S - 1) / (M + S - 1) bubble). Stage i at tick t
works on microbatch t - i when 0 <= t - i < M: stage 0 takes it from the
input, a later stage receives it from stage i - 1 (``dist.recv``), and
each stage but the last sends its result on (``dist.isend``, waited at the
end); the last stage banks it. JAX's ``fori_loop`` computes every tick on
every stage and masks the invalid ones; here a stage idles on those
ticks. The output is replicated: the last stage broadcasts it (JAX: a
``psum`` with zeros elsewhere). Forward only, as JAX's tests use it.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from ..utils.exceptions import DistributionError
from .mesh import axis_group, axis_index, mesh_shape


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _first_leaf(tree) -> torch.Tensor:
    if isinstance(tree, dict):
        return _first_leaf(next(iter(tree.values())))
    if isinstance(tree, (list, tuple)):
        return _first_leaf(tree[0])
    return tree


def _pipeline_body(stage_params, x_micro: torch.Tensor, *, fn: Callable, group, idx: int,
                   num_stages: int, num_microbatches: int) -> torch.Tensor:
    """Run the GPipe schedule on stage ``idx``: (M, Bm, ...) microbatches
    in, the (M, Bm, ...) outputs of the last stage out, on every rank."""
    m, s = num_microbatches, num_stages
    prev = dist.get_global_rank(group, idx - 1) if idx > 0 else None
    nxt = dist.get_global_rank(group, idx + 1) if idx < s - 1 else None
    out = torch.empty_like(x_micro)
    sends = []
    for t in range(m + s - 1):
        mb = t - idx
        if not 0 <= mb < m:
            continue
        if prev is None:
            inp = x_micro[mb]
        else:
            inp = torch.empty_like(x_micro[0])
            dist.recv(inp, prev, group=group)
        y = fn(stage_params, inp)
        if y.shape != inp.shape or y.dtype != inp.dtype:
            raise DistributionError(f"a stage must keep its input's shape and dtype: "
                                    f"{tuple(inp.shape)} {inp.dtype} -> {tuple(y.shape)} {y.dtype}")
        if nxt is not None:
            y = y.contiguous()
            sends.append((dist.isend(y, nxt, group=group), y))
        else:
            out[mb] = y
    for req, _ in sends:
        req.wait()
    dist.broadcast(out, dist.get_global_rank(group, s - 1), group=group)
    return out


def make_pipeline(mesh, fn: Callable, num_microbatches: int, *, stage_axis: str = "stage"):
    """A pipeline callable over ``mesh`` (JAX ``make_pipeline``).

    ``fn(stage_params, x) -> y`` is one stage's forward; ``y`` keeps ``x``'s
    shape and dtype. Returns ``pipe(stage_params_stacked, x)``: every rank
    passes the parameters of all stages stacked on a leading (num_stages,)
    axis (a tensor or a dict/list tree of them; the rank keeps its stage's
    slice) and the full batch ``x``, which must divide into
    ``num_microbatches``; the output is the full batch on every rank."""
    axes = mesh_shape(mesh)
    if stage_axis not in axes:
        raise DistributionError(f"mesh has no axis {stage_axis!r}")
    s = axes[stage_axis]
    group = axis_group(mesh, stage_axis)
    idx = axis_index(mesh, stage_axis)

    def pipe(stage_params, x: torch.Tensor) -> torch.Tensor:
        leading = _first_leaf(stage_params).shape[0]
        if leading != s:
            raise DistributionError(f"stage_params leading axis {leading} != {s} stages")
        b = x.shape[0]
        if b % num_microbatches:
            raise DistributionError(
                f"batch {b} not divisible by {num_microbatches} microbatches")
        xm = x.reshape((num_microbatches, b // num_microbatches) + tuple(x.shape[1:]))
        mine = _tree_map(lambda a: a[idx], stage_params)
        out = _pipeline_body(mine, xm.contiguous(), fn=fn, group=group, idx=idx, num_stages=s,
                             num_microbatches=num_microbatches)
        return out.reshape(x.shape)

    return pipe
