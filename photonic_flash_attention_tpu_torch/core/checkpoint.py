"""Checkpoint / resume: trees of tensors, the KV cache and engine state.

Port of ``photonic_flash_attention_tpu/core/checkpoint.py``:

* **trees of tensors** (a model's and an optimizer's ``state_dict``, the
  step): ``CheckpointManager`` keeps step-numbered directories with
  retention, writes atomically and ignores directories whose save did not
  finish. The tree is one ``torch.save`` file (JAX: an orbax tree) and is
  read back with ``torch.load(map_location=...)``;
* **the paged KV cache** (``core/kv_cache.py``): the page pools as
  ``pages.npz`` (bf16 stored as its ``uint16`` bits) and the host page
  tables as ``tables.json``, JAX's file format with one more key,
  ``"layout": "token_major"``. A directory without that key was written by
  the JAX package: its pools are token-minor and are transposed on load, so
  a cache saved by JAX restores here;
* **engine state**: the router's latency tables and the autotuner's
  profiles as JSON.

JSON and npz files are written to a temporary name and renamed.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..utils.exceptions import CheckpointError
from ..utils.logging import get_logger

logger = get_logger("checkpoint")

_STEP_RE = re.compile(r"^step_(\d+)$")
#: The port's pool layout, named in ``tables.json``.
TOKEN_MAJOR = "token_major"


def atomic_write_json(path: str, payload: Dict) -> None:
    """``json.dump`` to a temporary name, then rename to ``path``."""
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)


def atomic_savez(path: str, arrays: Dict[str, np.ndarray]) -> None:
    """``np.savez`` to a temporary name, then rename to ``path``."""
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def tensor_to_np(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy on the host; bf16 as its ``uint16`` bits (npz has
    no bfloat16), as the JAX package stores it."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def np_to_tensor(a: np.ndarray, dtype: torch.dtype, device: Any) -> torch.Tensor:
    """The inverse of :func:`tensor_to_np` for a tensor of ``dtype``."""
    if dtype == torch.bfloat16:
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)


class CheckpointManager:
    """Step-numbered checkpoints under one directory.

    Layout::

        <root>/step_<N>/params.pt      torch.save of the tree
        <root>/step_<N>/engine.json    router + autotuner state
        <root>/step_<N>/meta.json      step, timestamp, user metadata
    """

    def __init__(self, root: str, max_to_keep: int = 3) -> None:
        self.root = root
        self.max_to_keep = max_to_keep
        os.makedirs(root, exist_ok=True)

    # -- step bookkeeping ---------------------------------------------------

    def all_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.root):
            m = _STEP_RE.match(name)
            # only completed checkpoints (meta.json is written last)
            if m and os.path.exists(os.path.join(self.root, name, "meta.json")):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step}")

    def _enforce_retention(self) -> None:
        steps = self.all_steps()
        while len(steps) > self.max_to_keep:
            victim = steps.pop(0)
            shutil.rmtree(self._step_dir(victim), ignore_errors=True)
            logger.info("retention: removed checkpoint step_%d", victim)

    # -- trees --------------------------------------------------------------

    def save(
        self,
        step: int,
        params: Any,
        engine_state: Optional[Dict] = None,
        metadata: Optional[Dict] = None,
    ) -> str:
        """Save a checkpoint of ``params`` (any tree of tensors, dicts,
        lists and numbers, e.g. ``{"model": model.state_dict(), "optimizer":
        opt.state_dict()}``); returns its directory."""
        d = self._step_dir(step)
        if os.path.exists(d):
            shutil.rmtree(d)
        os.makedirs(d)
        path = os.path.join(d, "params.pt")
        torch.save(params, f"{path}.tmp")
        os.replace(f"{path}.tmp", path)
        if engine_state is not None:
            atomic_write_json(os.path.join(d, "engine.json"), engine_state)
        # meta.json last: its presence marks the checkpoint complete.
        atomic_write_json(
            os.path.join(d, "meta.json"),
            {"step": step, "saved_at": time.time(), **(metadata or {})},
        )
        self._enforce_retention()
        logger.info("saved checkpoint step_%d -> %s", step, d)
        return d

    def restore(self, step: Optional[int] = None, target: Any = None) -> Dict[str, Any]:
        """Restore ``{"params", "engine_state", "meta"}`` of ``step`` (the
        latest by default). ``target``: the device every tensor is loaded
        onto (``torch.load``'s ``map_location``); None keeps each tensor's
        saved device."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise CheckpointError(f"no checkpoints under {self.root}")
        d = self._step_dir(step)
        if not os.path.exists(os.path.join(d, "meta.json")):
            raise CheckpointError(f"checkpoint step_{step} is incomplete")
        params = torch.load(os.path.join(d, "params.pt"), map_location=target)
        engine_state = None
        epath = os.path.join(d, "engine.json")
        if os.path.exists(epath):
            with open(epath) as f:
                engine_state = json.load(f)
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        return {"params": params, "engine_state": engine_state, "meta": meta}


# ---------------------------------------------------------------------------
# Engine (router + autotuner) state
# ---------------------------------------------------------------------------


def engine_state_dict(engine: Any) -> Dict:
    """Serializable router latency tables + autotuner profiles."""
    router = engine.router
    with router._lock:
        latency = {
            kernel.value: [
                {"bucket": list(bucket), "value": ema.value, "count": ema.count}
                for bucket, ema in table.items()
            ]
            for kernel, table in router._latency.items()
        }
    tuner = engine.autotuner
    with tuner._lock:
        profiles = {k: dataclasses.asdict(v) for k, v in tuner._profiles.items()}
    return {
        "version": 1,
        "router_latency": latency,
        "autotuner_profiles": profiles,
    }


def restore_engine_state(engine: Any, state: Dict) -> None:
    """Load state saved by :func:`engine_state_dict` into a live engine."""
    from .autotuner import TuneResult
    from .router import KernelKind, _EMA

    router = engine.router
    with router._lock:
        for kernel_name, entries in state.get("router_latency", {}).items():
            try:
                kernel = KernelKind(kernel_name)
            except ValueError:
                continue
            for e in entries:
                ema = _EMA()
                ema.value = float(e["value"])
                ema.count = int(e["count"])
                router._latency[kernel][tuple(e["bucket"])] = ema
    tuner = engine.autotuner
    with tuner._lock:
        for k, v in state.get("autotuner_profiles", {}).items():
            tuner._profiles[k] = TuneResult(**v)


# ---------------------------------------------------------------------------
# KV-cache save / restore (preemption-resilient serving)
# ---------------------------------------------------------------------------


def save_kv_cache(cache: Any, path: str) -> None:
    """Persist a :class:`~.kv_cache.PagedKVCache`: the page pools (numpy
    .npz) and the host page tables (JSON)."""
    from .kv_cache import dtype_name

    os.makedirs(path, exist_ok=True)
    arrays = {"k_pages": tensor_to_np(cache.k_pages), "v_pages": tensor_to_np(cache.v_pages)}
    if cache.quantized:
        arrays["k_scales"] = tensor_to_np(cache.k_scales)
        arrays["v_scales"] = tensor_to_np(cache.v_scales)
    atomic_savez(os.path.join(path, "pages.npz"), arrays)
    with cache._lock:
        host = {
            "version": 1,
            "layout": TOKEN_MAJOR,
            "num_pages": cache.num_pages,
            "page_size": cache.page_size,
            "num_kv_heads": cache.num_kv_heads,
            "head_dim": cache.head_dim,
            "dtype": dtype_name(cache.dtype),
            "max_pages_per_seq": cache.max_pages_per_seq,
            "free": list(cache._free),
            "next_seq_id": cache._next_seq_id,
            "sequences": {
                str(sid): {"page_ids": info.page_ids, "length": info.length}
                for sid, info in cache._sequences.items()
            },
        }
    atomic_write_json(os.path.join(path, "tables.json"), host)
    logger.info("saved KV cache (%d seqs, %d pages) -> %s", len(host["sequences"]),
                cache.num_pages, path)


def restore_kv_cache(path: str, device: Any = "cuda") -> Any:
    """Rebuild a PagedKVCache exactly as saved, on ``device`` (the card by
    default). A cache saved by the JAX package (no ``layout`` key) is
    token-minor and is transposed into the port's layout."""
    from .kv_cache import PagedKVCache, SequenceInfo

    with open(os.path.join(path, "tables.json")) as f:
        host = json.load(f)
    data = np.load(os.path.join(path, "pages.npz"))
    cache = PagedKVCache(
        num_pages=host["num_pages"],
        page_size=host["page_size"],
        num_kv_heads=host["num_kv_heads"],
        head_dim=host["head_dim"],
        dtype=getattr(torch, host["dtype"]),
        max_pages_per_seq=host["max_pages_per_seq"],
        device=device,
    )
    token_minor = host.get("layout") != TOKEN_MAJOR
    for name in ("k_pages", "v_pages"):
        pool = np_to_tensor(data[name], cache.dtype, cache.device)
        if token_minor:
            pool = pool.transpose(-1, -2)  # (H, P, D, page) -> (H, P, page, D)
        getattr(cache, name).copy_(pool)
    if cache.quantized:
        cache.k_scales.copy_(np_to_tensor(data["k_scales"], torch.float32, cache.device))
        cache.v_scales.copy_(np_to_tensor(data["v_scales"], torch.float32, cache.device))
    with cache._lock:
        cache._free = list(host["free"])
        cache._next_seq_id = host["next_seq_id"]
        cache._sequences = {
            int(sid): SequenceInfo(int(sid), rec["page_ids"], rec["length"])
            for sid, rec in host["sequences"].items()
        }
    return cache
