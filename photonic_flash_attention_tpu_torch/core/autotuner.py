"""Kernel autotuner: the measured tile profile store.

Port of ``photonic_flash_attention_tpu/core/autotuner.py``: ``TuneResult``,
``Autotuner`` (``profile_key``, ``lookup`` with its age limit, ``record``,
JSON ``save_state``/``load_state``, ``stats``) and the
process-wide ``get_autotuner`` (``PFA_AUTOTUNE_PATH`` persists it). The
JAX ``candidate_blocks`` sweeps the (block_q, block_kv) tiles that fit a
TPU core's VMEM budget; on the H100 it lists the tiles K1 is compiled with,
which is one, (64, 64), so there is nothing to sweep (the JAX ``tune``
has no counterpart). The engine's first contact with a flash bucket
records that tile's measured time, so the profile surface is the same.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple
from ..utils.logging import get_logger

logger = get_logger("autotuner")

#: The (query rows, keys) tiles of K1 (csrc/flash_fwd.cu BQ, BKV).
K1_TILES: Tuple[Tuple[int, int], ...] = ((64, 64),)


def _p2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


@dataclasses.dataclass
class TuneResult:
    block_q: int
    block_kv: int
    latency_ms: float
    tuned_at: float = dataclasses.field(default_factory=time.time)


def candidate_blocks(
    q_len: int, kv_len: int, head_dim: int, dtype_bytes: int = 2
) -> List[Tuple[int, int]]:
    """The (block_q, block_kv) tiles K1 is compiled with, whatever the
    shape (K1 masks its ragged edges)."""
    return list(K1_TILES)


class Autotuner:
    """The measured tile profile store, persisted as JSON."""

    #: re-tune when a profile is older than this (reference re-optimizes on
    #: age > 1h, autonomous_optimizer.py:167-191)
    MAX_PROFILE_AGE_S = 3600.0

    def __init__(self, state_path: Optional[str] = None) -> None:
        self._profiles: Dict[str, TuneResult] = {}
        self._lock = threading.RLock()
        self.state_path = state_path
        if state_path and os.path.exists(state_path):
            try:
                self.load_state(state_path)
            except (OSError, ValueError, KeyError) as e:
                logger.warning("failed to load autotuner state: %s", e)

    @staticmethod
    def profile_key(
        q_len: int, kv_len: int, head_dim: int, batch: int, heads: int, tag: str = "flash"
    ) -> str:
        return f"{tag}:b{_p2(batch)}h{heads}q{_p2(q_len)}k{_p2(kv_len)}d{head_dim}"

    def lookup(self, key: str) -> Optional[TuneResult]:
        with self._lock:
            res = self._profiles.get(key)
            if res and (time.time() - res.tuned_at) < self.MAX_PROFILE_AGE_S:
                return res
            return None

    def record(self, key: str, result: TuneResult) -> None:
        with self._lock:
            self._profiles[key] = result

    def save_state(self, path: Optional[str] = None) -> None:
        path = path or self.state_path
        if not path:
            return
        with self._lock:
            payload = {
                "version": 1,
                "profiles": {k: dataclasses.asdict(v) for k, v in self._profiles.items()},
            }
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=1)
        os.replace(tmp, path)

    def load_state(self, path: str) -> None:
        with open(path) as f:
            payload = json.load(f)
        with self._lock:
            for k, v in payload.get("profiles", {}).items():
                self._profiles[k] = TuneResult(**v)

    def stats(self) -> Dict:
        with self._lock:
            return {
                "profiles": len(self._profiles),
                "keys": sorted(self._profiles),
            }


# Process-wide default store shared by every engine; ``PFA_AUTOTUNE_PATH``
# persists it across processes.
_default_autotuner: Optional["Autotuner"] = None
_default_lock = threading.Lock()


def get_autotuner() -> "Autotuner":
    global _default_autotuner
    if _default_autotuner is None:
        with _default_lock:
            if _default_autotuner is None:
                _default_autotuner = Autotuner(
                    state_path=os.environ.get("PFA_AUTOTUNE_PATH")
                )
    return _default_autotuner
