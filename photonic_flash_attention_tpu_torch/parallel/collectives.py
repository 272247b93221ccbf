"""Collectives over one mesh axis, differentiable where autograd crosses them.

A JAX ``shard_map`` body names its collectives (``ppermute``, ``all_to_all``,
``psum``) and XLA inserts the others where a sharding changes; autograd
through them is JAX's. Here every collective is a ``torch.distributed`` call
on an axis's process group (``parallel/mesh.py::axis_group``): NCCL on the
card, gloo on the CPU. The autograd functions below carry a gradient across
them under the port's SPMD convention: a tensor is either replicated (every
rank of the axis holds the same value, and after the backward the same
gradient) or sharded (each rank its block).

* :func:`scatter` — replicated to sharded: forward this rank's block,
  backward an all-gather of the blocks' gradients;
* :func:`gather` — sharded to replicated: forward an all-gather, backward
  this rank's block of the (replicated) gradient;
* :func:`gather_partial` — an all-gather whose consumers are sharded (each
  rank's gradient is a partial sum): backward an all-reduce, then the block;
* :func:`copy_to` / :func:`reduce_from` — Megatron's f and g around a
  tensor-parallel region: identity forward and all-reduce backward, and
  all-reduce forward and identity backward; :func:`first_rank_only` adds a
  replicated bias to such a partial sum once;
* :func:`column_linear` / :func:`row_linear` — the tensor-parallel dense
  layers built on them (training and serving share them);
* :func:`all_to_all` — re-shard one dim onto another (Ulysses), backward
  the inverse exchange;
* :func:`rotate_start` — the ring's neighbour exchange
  (``jax.lax.ppermute`` with ``i -> i + 1``), issued and waited apart so a
  step's compute overlaps it.

A sum or a rotation over a group of one rank is the identity, and issues no
collective.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F


def _size(group) -> int:
    return dist.get_world_size(group)


def _rank(group) -> int:
    return dist.get_rank(group)


def block(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's contiguous block of ``x`` along ``dim`` (a copy)."""
    n = _size(group)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} does not divide over {n} ranks")
    step = x.shape[dim] // n
    return x.narrow(dim, _rank(group) * step, step).contiguous()


def all_gather_cat(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' blocks concatenated along ``dim`` in rank order."""
    parts = [torch.empty_like(x, memory_format=torch.contiguous_format) for _ in range(_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """In-place sum of a contiguous ``x`` over the group; returns ``x``."""
    if _size(group) > 1:
        dist.all_reduce(x, group=group)
    return x


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group into a new tensor (``x`` itself for one rank)."""
    return x if _size(group) == 1 else all_reduce_(x.contiguous().clone(), group)


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return block(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather_cat(g, ctx.dim, ctx.group), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_cat(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return block(g, ctx.dim, ctx.group), None, None


class _GatherPartial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_cat(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return block(all_reduce_sum(g, ctx.group), ctx.dim, ctx.group), None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return x.view_as(x) if _size(group) == 1 else all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _exchange(x: torch.Tensor, split_dim: int, cat_dim: int, group) -> torch.Tensor:
    """Split ``x`` into n blocks along ``split_dim``, send block j to rank j,
    and concatenate the blocks received along ``cat_dim`` in rank order
    (``jax.lax.all_to_all(..., tiled=True)``)."""
    n = _size(group)
    send = torch.stack(x.chunk(n, dim=split_dim)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=cat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, cat_dim, group):
        ctx.dims, ctx.group = (split_dim, cat_dim), group
        return _exchange(x, split_dim, cat_dim, group)

    @staticmethod
    def backward(ctx, g):
        split_dim, cat_dim = ctx.dims
        return _exchange(g, cat_dim, split_dim, ctx.group), None, None, None


class _FirstRankOnly(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return x.clone() if _rank(group) == 0 else torch.zeros_like(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


def first_rank_only(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` on the group's first rank and zeros elsewhere, with the
    (replicated) gradient on every rank: a replicated bias that enters a
    partial sum once, before :func:`reduce_from`."""
    return _FirstRankOnly.apply(x, group)


def scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return _Scatter.apply(x, dim, group)


def gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return _Gather.apply(x, dim, group)


def gather_partial(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return _GatherPartial.apply(x, dim, group)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFrom.apply(x, group)


def all_to_all(x: torch.Tensor, split_dim: int, cat_dim: int, group) -> torch.Tensor:
    return _AllToAll.apply(x, split_dim, cat_dim, group)


def column_linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                  group) -> torch.Tensor:
    """Column-parallel dense: ``weight`` holds this rank's output rows; a
    replicated bias is cut to them. ``x`` is replicated (under
    :func:`copy_to` where autograd crosses the group)."""
    if bias is not None and bias.shape[0] != weight.shape[0]:
        bias = scatter(bias, 0, group)
    return F.linear(x, weight, bias)


def row_linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
               group) -> torch.Tensor:
    """Row-parallel dense: ``weight`` holds this rank's input columns, the
    partial sums are all-reduced (the collective XLA inserts after a
    row-sharded kernel) and the replicated bias enters once, on the group's
    first rank. No group, or one rank: a plain dense."""
    if group is None or _size(group) == 1:
        return F.linear(x, weight, bias)
    bias = first_rank_only(bias, group) if bias is not None else None
    return reduce_from(F.linear(x, weight, bias), group)


def rotate_start(tensors: Sequence[Optional[torch.Tensor]], group
                 ) -> Tuple[List, List[Optional[torch.Tensor]]]:
    """Send each tensor to the next rank of the group and receive the
    previous rank's into a new buffer: (requests to wait on, buffers;
    None stays None). A group of one rank keeps its tensors."""
    n, me = _size(group), _rank(group)
    if n == 1:
        return [], list(tensors)
    nxt = dist.get_global_rank(group, (me + 1) % n)
    prv = dist.get_global_rank(group, (me - 1) % n)
    ops, outs = [], []
    for t in tensors:
        if t is None:
            outs.append(None)
            continue
        buf = torch.empty_like(t)
        ops += [dist.P2POp(dist.isend, t, nxt, group), dist.P2POp(dist.irecv, buf, prv, group)]
        outs.append(buf)
    return (dist.batch_isend_irecv(ops) if ops else []), outs


def rotate_finish(reqs: List) -> None:
    for r in reqs:
        r.wait()
