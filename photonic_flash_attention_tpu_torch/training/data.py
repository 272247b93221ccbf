"""Host-side data pipeline: background prefetch + device placement.

Port of ``photonic_flash_attention_tpu/training/data.py``. Batches are
prepared on the host by a worker thread and staged into a small bounded
queue; on a CUDA device the worker copies each batch from pinned memory
with ``non_blocking=True``, so step N+1's input is on the card when step N
finishes. :func:`synthetic_lm_batches` makes the same numpy arrays as the
JAX function for the same seed (same ``np.random.default_rng`` calls, int32
token ids); ``training/trainer.py`` widens ids to int64 where torch's
indexing and ``gather`` need them.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterable, Iterator, Optional, Union

import numpy as np
import torch


def synthetic_lm_batches(
    *,
    batch: int,
    seq: int,
    vocab: int,
    accum_steps: int = 1,
    seed: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Endless synthetic LM batches (benchmark / smoke-test input)."""
    rng = np.random.default_rng(seed)
    lead = (accum_steps,) if accum_steps > 1 else ()
    while True:
        ids = rng.integers(0, vocab, lead + (batch, seq), dtype=np.int32)
        labels = np.roll(ids, -1, axis=-1)
        yield {"input_ids": ids, "labels": labels}


def to_tensors(
    batch: Dict[str, np.ndarray], device: Union[str, torch.device] = "cpu"
) -> Dict[str, torch.Tensor]:
    """Each leaf as a tensor on ``device``; for a CUDA device, copied from
    pinned host memory without blocking the host."""
    device = torch.device(device)
    out = {}
    for name, value in batch.items():
        t = torch.as_tensor(value)
        if device.type == "cuda":
            t = t.pin_memory()
        out[name] = t.to(device, non_blocking=True)
    return out


class DataPipeline:
    """Bounded background prefetcher over any batch iterable.

    Args:
      source: iterable of dict[str, np.ndarray] batches.
      prefetch: queue depth (2 is enough to hide host latency).
      to_device: optional placement fn; default :func:`to_tensors` onto
        ``device``.
      device: where the default placement puts the tensors.
    """

    _DONE = object()

    def __init__(
        self,
        source: Iterable[Dict[str, np.ndarray]],
        *,
        prefetch: int = 2,
        to_device: Optional[Callable] = None,
        device: Union[str, torch.device] = "cpu",
    ) -> None:
        self._source = source
        self._q: queue.Queue = queue.Queue(maxsize=max(1, prefetch))
        self._to_device = to_device or (lambda b: to_tensors(b, device))
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        try:
            for batch in self._source:
                if self._stop.is_set():
                    return
                # The host-to-device copy runs here, beside the compute.
                self._q.put(self._to_device(batch))
        except BaseException as e:  # surfaced on the consumer side
            self._err = e
        finally:
            self._q.put(self._DONE)

    def __iter__(self) -> Iterator:
        while True:
            item = self._q.get()
            if item is self._DONE:
                if self._err is not None:
                    raise self._err
                return
            yield item

    def close(self) -> None:
        self._stop.set()
        # Drain so the worker's blocked put() can finish.
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    def __enter__(self) -> "DataPipeline":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
