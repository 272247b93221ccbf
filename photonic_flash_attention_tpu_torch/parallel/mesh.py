"""Device meshes over the process group, axis conventions and specs.

Port of ``photonic_flash_attention_tpu/parallel/mesh.py`` (``create_mesh``
:26, ``default_axis_names`` :60). The JAX mesh arranges the devices of one
process; here each device is one process (one rank a card, NCCL on the
card, gloo on the CPU), so a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the
initialised world (``parallel/multihost.py::initialize_multihost``), rank
``r`` at row-major position ``r``. Axis convention: ``data`` (batch),
``model`` (heads, tensor parallel), ``seq`` (sequence, ring / Ulysses).

What a JAX ``shard_map`` does implicitly is explicit here:
:func:`axis_group` is the process group of one axis (the ``axis_name`` of
a JAX collective), :func:`axis_index` the rank's coordinate on it
(``jax.lax.axis_index``) and :func:`shard_tensor` cuts this rank's block
of a replicated tensor by a :class:`PartitionSpec` (``NamedSharding``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..config import get_config
from ..utils.exceptions import DistributionError

AXIS_DATA = "data"
AXIS_MODEL = "model"
AXIS_SEQ = "seq"


class PartitionSpec(tuple):
    """Which mesh axis shards each dim of a tensor (None: not sharded), as
    ``jax.sharding.PartitionSpec``; ``PartitionSpec()`` is replicated."""

    def __new__(cls, *axes: Optional[str]) -> "PartitionSpec":
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def _device_type() -> str:
    """The mesh's device type: ``cuda`` under NCCL, ``cpu`` under gloo."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _world() -> int:
    if not dist.is_initialized():
        raise DistributionError("no process group: call initialize_multihost() first")
    return dist.get_world_size()


def resolve_shape(shape: Optional[Sequence[int]], n_axes: int, n: int) -> list:
    """JAX's checks on a mesh shape over ``n`` ranks: None puts every rank
    on the first axis, at most one ``-1`` (inferred like reshape), the
    product covers ``n``, one entry per axis name."""
    if shape is None:
        shape = (n,) + (1,) * (n_axes - 1)
    shape = list(shape)
    if shape.count(-1) > 1:
        raise DistributionError("at most one -1 axis allowed")
    if -1 in shape:
        known = int(np.prod([s for s in shape if s != -1]))
        if n % known:
            raise DistributionError(f"{n} devices not divisible by {known}")
        shape[shape.index(-1)] = n // known
    if int(np.prod(shape)) != n:
        raise DistributionError(f"mesh shape {tuple(shape)} does not cover {n} devices")
    if len(shape) != n_axes:
        raise DistributionError(f"shape rank {len(shape)} != axis_names {n_axes}")
    return shape


def mesh_from_ranks(ranks: np.ndarray, axis_names: Sequence[str]) -> DeviceMesh:
    """A DeviceMesh over an array of global ranks, one dim per axis name."""
    return DeviceMesh(_device_type(), torch.as_tensor(ranks, dtype=torch.int64),
                      mesh_dim_names=tuple(axis_names))


def create_mesh(
    shape: Optional[Sequence[int]] = None,
    axis_names: Tuple[str, ...] = (AXIS_DATA, AXIS_MODEL),
) -> DeviceMesh:
    """A mesh over every rank of the world. ``shape=None`` puts every rank
    on the first axis; a ``-1`` entry is inferred from the world size.
    Collective: every rank calls it with the same arguments. Raises
    ``DistributionError`` where JAX's does."""
    n = _world()
    shape = resolve_shape(shape, len(axis_names), n)
    return mesh_from_ranks(np.arange(n).reshape(shape), axis_names)


def default_axis_names() -> Tuple[str, str, str]:
    cfg = get_config()
    return (cfg.mesh_data_axis, cfg.mesh_seq_axis, cfg.mesh_model_axis)


def mesh_shape(mesh: DeviceMesh) -> Dict[str, int]:
    """{axis name: size}, JAX's ``mesh.shape``."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh_shape(mesh)[axis]


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate on ``axis`` (``jax.lax.axis_index``)."""
    return mesh.get_local_rank(axis)


def axis_group(mesh: DeviceMesh, axis: str) -> dist.ProcessGroup:
    """The process group of the ranks that share every coordinate but
    ``axis``: the group a JAX collective over ``axis_name=axis`` spans."""
    if axis not in mesh.mesh_dim_names:
        raise DistributionError(f"mesh has no axis {axis!r}")
    return mesh.get_group(axis)


def require_layout(specs: Dict[str, Sequence[Optional[str]]],
                   rules: Dict[str, Sequence[Optional[str]]], rules_name: str) -> None:
    """Raise ``ValueError`` unless ``specs`` place every parameter of
    ``rules`` as ``rules`` do (a name missing from ``specs`` is
    replicated): a model's tensor-parallel forward is written for one
    layout."""
    if {n: tuple(specs.get(n, ())) for n in rules} != {n: tuple(r) for n, r in rules.items()}:
        raise ValueError(f"a tensor-parallel forward needs the layout of {rules_name}")


def shard_tensor(x: torch.Tensor, spec: Sequence[Optional[str]], mesh: DeviceMesh) -> torch.Tensor:
    """This rank's block of a tensor replicated on every rank, cut as
    ``spec`` places it (dims past the spec are not sharded). A copy."""
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n, i = axis_size(mesh, axis), axis_index(mesh, axis)
        if x.shape[dim] % n:
            raise DistributionError(
                f"dim {dim} of size {x.shape[dim]} does not divide over axis {axis!r} ({n})")
        step = x.shape[dim] // n
        x = x.narrow(dim, i * step, step)
    return x.clone(memory_format=torch.contiguous_format)
