"""Process-group initialisation and meshes that span hosts.

Port of ``photonic_flash_attention_tpu/parallel/multihost.py``
(``initialize_multihost`` :34, ``pod_mesh`` :69, ``process_summary`` :133).
JAX runs one process a host over all its chips; the port runs one process
(rank) a card, so "devices" below are ranks:

* :func:`initialize_multihost` calls ``torch.distributed.init_process_group``:
  NCCL with the rank on ``cuda:LOCAL_RANK`` by default, gloo only when the
  caller passes ``device="cpu"``; without CUDA and without ``device="cpu"``
  it raises (there is no fallback to gloo). A no-op when the group is up,
  as JAX's is. The coordinator is ``coordinator_address`` (``host:port`` or
  any ``init_method`` URL such as ``file:///path``), else torchrun's
  ``MASTER_ADDR``/``MASTER_PORT`` (``env://``); a world of one needs none
  (an in-process store).
* :func:`pod_mesh` — a mesh over every rank with ``dcn_axis`` striding the
  hosts (ranks are host-major, as torchrun numbers them), so the axis that
  crosses hosts is the one whose collectives leave the NVLink domain.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..utils.exceptions import DistributionError
from ..utils.logging import get_logger
from .mesh import mesh_from_ranks, resolve_shape

logger = get_logger("multihost")


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device: str = "cuda",
) -> dict:
    """Join (or create) the process group; safe to call again. World size
    and rank default to ``WORLD_SIZE``/``RANK`` (else 1 and 0); the card is
    ``LOCAL_RANK`` (else the rank modulo the cards of the host).
    Returns :func:`process_summary`'s keys plus the world's."""
    if not dist.is_initialized():
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise DistributionError("initialize_multihost runs NCCL on the card and CUDA is not "
                                    "available; pass device='cpu' for gloo on the CPU")
        if dev.type not in ("cuda", "cpu"):
            raise DistributionError(f"unsupported device {device!r}")
        world = num_processes if num_processes is not None else _env_int("WORLD_SIZE", 1)
        rank = process_id if process_id is not None else _env_int("RANK", 0)
        kw = {}
        if coordinator_address:
            kw["init_method"] = (coordinator_address if "://" in coordinator_address
                                 else f"tcp://{coordinator_address}")
        elif "MASTER_ADDR" in os.environ:
            kw["init_method"] = "env://"
        elif world == 1:
            kw["store"] = dist.HashStore()
        else:
            raise DistributionError(f"a world of {world} processes needs a coordinator address")
        if dev.type == "cuda":
            torch.cuda.set_device(_env_int("LOCAL_RANK", rank % torch.cuda.device_count()))
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                rank=rank, world_size=world, **kw)
        logger.info("process group up: rank %d of %d (%s)", rank, world, dist.get_backend())
    return {
        **process_summary(),
        "global_devices": dist.get_world_size(),
        "backend": dist.get_backend(),
    }


def pod_mesh(
    axis_shapes: Sequence[int],
    axis_names: Sequence[str],
    *,
    dcn_axis: Optional[str] = None,
) -> DeviceMesh:
    """Mesh over every rank. ``dcn_axis`` names the axis that crosses hosts
    (data parallel is the usual choice: gradients leave the host once a
    step); its extent splits into (hosts, ranks a host), the hosts
    outermost. With one host it is :func:`~.mesh.create_mesh`'s layout.
    ``LOCAL_WORLD_SIZE`` (torchrun's) gives the ranks a host, else the
    host's card count."""
    n = dist.get_world_size()
    shapes = resolve_shape(axis_shapes, len(axis_names), n)
    per_host = _env_int("LOCAL_WORLD_SIZE", torch.cuda.device_count() or n)
    hosts = max(n // per_host, 1)
    ranks = np.arange(n)
    if hosts > 1 and dcn_axis is not None:
        idx = list(axis_names).index(dcn_axis)
        if shapes[idx] % hosts:
            raise DistributionError(f"dcn axis {dcn_axis} extent {shapes[idx]} not divisible "
                                    f"by {hosts} hosts")
        rest = [s for i, s in enumerate(shapes) if i != idx]
        tmp = ranks.reshape([hosts, shapes[idx] // hosts] + rest)
        perm, rest_axis = [], 2
        for i in range(len(shapes)):
            if i == idx:
                perm += [0, 1]
            else:
                perm.append(rest_axis)
                rest_axis += 1
        ranks = tmp.transpose(perm)
    return mesh_from_ranks(ranks.reshape(shapes), axis_names)


def process_summary() -> dict:
    """This rank, the world size, and the devices this process drives."""
    if not dist.is_initialized():
        raise DistributionError("no process group: call initialize_multihost() first")
    dev = (f"cuda:{torch.cuda.current_device()}" if dist.get_backend() == "nccl" else "cpu")
    return {
        "process_index": dist.get_rank(),
        "process_count": dist.get_world_size(),
        "local_devices": [dev],
    }
