"""Continuous-batching serving engine over the paged KV pool (PyTorch).

Port of ``photonic_flash_attention_tpu/core/serving.py`` for one device and
the GPT-2, Llama and T5 families (``_model_adapter``):

* sequences join the running batch as soon as a slot and pages are free
  (admission), leave on EOS/max-tokens (retirement), pages are recycled;
* prefills run per sequence, right-padded to power-of-two buckets, through
  the flash forward (kernel K1); with ``prefill_chunk`` a longer prompt
  prefills one chunk per ``step()`` (K1 with its key-bias stream over the
  paged history), so decode advances between its chunks;
* a decode window runs up to ``decode_window`` decode steps over a fixed
  slot batch (kernels K2 and K3 in every layer) with argmax or sampling on
  the device; tokens reach the host once per window. Inactive slots write
  to the reserved trash page 0 and attend over nothing;
* encoder-decoder (T5): ``submit`` takes the ENCODER prompt (at most
  ``enc_max_len`` tokens); a prefill runs the encoder, pins the decoder's
  cross-attention K/V in the request's slot and consumes the decoder start
  token; only decoder tokens (start + generated) take pages, and decode
  positions count decoder tokens (``models/t5_serving.py``);
* Llama (``models/llama_serving.py``): a pool of ``num_key_value_heads``
  heads, RoPE at the tokens' absolute positions. GPT-2 alone refuses a
  request longer than its position table (``n_positions``); JAX refuses
  no Llama request by length, and neither does the port.

* pages come from the native (C++) allocator and requests queue in the
  native scheduler where the host can build them (``core/native_alloc.py``,
  ``core/native_sched.py``), from their Python twins otherwise;
* ``save`` persists a server mid-generation (every pool tensor, T5's
  pinned cross buffers among them, as ``pages.npz``; the sequences, the
  queue, the slots, the stats and the sampling counter as ``state.json``)
  and ``restore`` resumes it on the same random stream: the tokens equal
  an uninterrupted run's.

* ``mesh`` (a ``parallel/mesh.py`` mesh with ``model_axis``; GPT-2 only, as
  in JAX): tensor-parallel serving. Every rank of the mesh runs the same
  engine on the same requests; each holds its head shard of the paged
  pools (int8 scales included) and its TP shards of the weights
  (``models/gpt2_serving.py::serving_param_specs``); prefill, chunked
  prefill and K3's fused decode run on the rank's heads with two
  all-reduces a layer, and the host state, page tables and sampled tokens
  are the same on every rank (JAX ``_init_sharded``,
  ``_make_sharded_decode_window``). ``save`` then writes each rank's pool
  shard to its own file and ``restore`` needs the mesh.

A decode window (JAX: one compiled ``lax.scan`` of ``n_steps`` steps,
``_make_decode_window``) hands the step a page table cut to the window's
occupancy bucket, as JAX does: the smallest power of two of pages that
covers the batch's longest sequence plus the window, at most
``max_pages_per_seq`` (one contiguous (B, w_pages) device table a width).
On the card each decode step of the window is one replay of a CUDA graph
(the flat slots, the model's step, sampling, then positions and lengths
advanced in place), captured once for each (w_pages, sampling, top_k) after
one eager step on the capture stream; the engine's graphs share one memory
pool, and a replay's kernels count in ``ops/_build.py::LAUNCHES`` as the
card runs them. A capture or replay that fails raises: there is no eager
fallback. On the CPU the same step runs eagerly. Under a mesh the graph
holds the step's all-reduces (at world 1 there are none). The engine runs
on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import json
import os
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..models import gpt2_serving, llama_serving, t5_serving
from ..models.gpt2 import GPT2Config
from ..models.llama import LlamaConfig
from ..models.t5 import T5Config
from ..ops import _build
from ..ops.paged import POOL_DTYPES
from ..parallel.mesh import axis_group, axis_index, axis_size, mesh_shape, shard_tensor
from ..utils.exceptions import KVCacheError
from .checkpoint import atomic_savez, atomic_write_json, np_to_tensor, tensor_to_np
from .error_recovery import on_clear_plan_caches
from .native_alloc import NativePageAllocator, native_available
from .native_sched import make_scheduler

_TRASH_PAGE = 0  # page 0 is never allocated; padded/inactive writes land here
_KV_NAMES = {torch.int8: "int8", torch.bfloat16: "bf16", torch.float32: "fp32"}


@dataclasses.dataclass(frozen=True)
class _Adapter:
    """A family's step functions (JAX ``_model_adapter``): ``create_pages(
    num_pages, page_size, dtype, device)``, ``prepare_params(state_dict,
    cfg, device)``, ``prefill``, ``decode``, ``prefill_chunk`` (None without
    a chunked-prefill step) and ``family``: "causal" (prompt tokens live in
    the paged pool) or "encdec" (the prompt lives in pinned cross buffers;
    only decoder tokens take pages)."""

    create_pages: Any
    prepare_params: Any
    prefill: Any
    decode: Any
    prefill_chunk: Any
    family: str


def _model_adapter(cfg, *, max_batch: int = 8, enc_max_len: int = 512) -> _Adapter:
    if isinstance(cfg, GPT2Config):
        return _Adapter(
            lambda n, page, dtype, device: gpt2_serving.KVPages.create(cfg, n, page, dtype, device),
            gpt2_serving.prepare_params, gpt2_serving.prefill_step, gpt2_serving.decode_step,
            gpt2_serving.prefill_chunk_step, "causal",
        )
    if isinstance(cfg, LlamaConfig):
        return _Adapter(
            lambda n, page, dtype, device: llama_serving.create_llama_pages(
                cfg, n, page, dtype, device),
            llama_serving.prepare_params, llama_serving.llama_prefill_step,
            llama_serving.llama_decode_step, llama_serving.llama_prefill_chunk_step, "causal",
        )
    if isinstance(cfg, T5Config):
        return _Adapter(
            lambda n, page, dtype, device: t5_serving.create_t5_pages(
                cfg, n, page, dtype, max_batch=max_batch, enc_max_len=enc_max_len, device=device),
            t5_serving.prepare_params, t5_serving.t5_prefill_step, t5_serving.t5_decode_step,
            None, "encdec",
        )
    raise TypeError(f"no serving adapter for config type {type(cfg).__name__}")


class _PyPageAllocator:
    """Pure-Python page allocator with the native allocator's interface
    (``core/native_alloc.py``); page 0 reserved as trash."""

    def __init__(self, num_pages: int, page_size: int, max_pages_per_seq: int) -> None:
        self.num_pages = num_pages
        self.page_size = page_size
        self.max_pages_per_seq = max_pages_per_seq
        self._free = list(range(num_pages - 1, 0, -1))
        self._pages: Dict[int, List[int]] = {}
        self._next = 0

    def _reserve(self, pages: List[int], total_tokens: int) -> None:
        need = -(-total_tokens // self.page_size) - len(pages)
        if need <= 0:
            return
        if len(pages) + need > self.max_pages_per_seq:
            raise KVCacheError("request exceeds max_pages_per_seq")
        if need > len(self._free):
            raise KVCacheError("KV cache out of pages")
        for _ in range(need):
            pages.append(self._free.pop())

    def allocate_sequence(self, reserve_tokens: int = 0) -> int:
        pages: List[int] = []
        if reserve_tokens:
            self._reserve(pages, reserve_tokens)
        sid = self._next
        self._next += 1
        self._pages[sid] = pages
        return sid

    def extend(self, sid: int, new_total_tokens: int) -> None:
        self._reserve(self._pages[sid], new_total_tokens)

    def adopt(self, pages: List[int]) -> int:
        """A new sequence holding ``pages`` (taken out of the free list);
        ``ServingEngine.restore`` rebuilds a saved engine's accounting so."""
        taken = set(pages)
        self._free = [p for p in self._free if p not in taken]
        sid = self._next
        self._next += 1
        self._pages[sid] = list(pages)
        return sid

    def free_sequence(self, sid: int) -> None:
        self._free.extend(self._pages.pop(sid))

    def page_ids(self, sid: int) -> List[int]:
        return list(self._pages[sid])

    def stats(self) -> Dict[str, int]:
        used = self.num_pages - 1 - len(self._free)
        return {"pages_used": used, "pages_free": len(self._free)}


def _make_allocator(num_pages: int, page_size: int, max_pages_per_seq: int):
    """The native allocator where the host can build it, else the Python one."""
    if native_available():
        return NativePageAllocator(num_pages, page_size, max_pages_per_seq)
    return _PyPageAllocator(num_pages, page_size, max_pages_per_seq)


@dataclasses.dataclass
class _WindowBuffers:
    """The device buffers a decode window's steps read and update in place
    (a step graph's inputs and outputs)."""

    state: torch.Tensor  # (3, B) int32: ids / positions / lengths
    upload: torch.Tensor  # (3, B) int32 on the host (pinned for the card): the window's upload
    toks: torch.Tensor  # (decode_window, B) int64: row i takes step i's tokens
    step: torch.Tensor  # (1,) int64: the step about to run
    rows: torch.Tensor  # (B,) int64
    tables: Dict[int, torch.Tensor]  # w_pages -> (B, w_pages) int32 page tables


@dataclasses.dataclass
class _StepGraph:
    """One decode step captured as a CUDA graph."""

    graph: Any  # torch.cuda.CUDAGraph
    captured: collections.Counter  # kernel calls recorded: launches a replay
    capture_ms: float


@dataclasses.dataclass
class _Sequence:
    seq_id: int
    tokens: List[int]  # full token history (prompt + generated)
    prompt_len: int
    max_new_tokens: int
    page_ids: List[int] = dataclasses.field(default_factory=list)
    alloc_id: Optional[int] = None  # allocator-side sequence handle
    slot: Optional[int] = None  # decode batch slot
    priority: int = 0
    prefilled: int = 0  # prompt tokens whose KV is already cached
    done: bool = False
    submitted_at: float = dataclasses.field(default_factory=time.time)
    finished_at: Optional[float] = None

    @property
    def length(self) -> int:
        return len(self.tokens)

    @property
    def new_tokens(self) -> int:
        return self.length - self.prompt_len


class ServingEngine:
    """Continuous batching (GPT-2, Llama and T5 families; GPT-2 also
    tensor-parallel over a mesh's model axis).

    ``params`` is a ``models.gpt2.GPT2LMHead``,
    ``models.llama.LlamaForCausalLM`` or
    ``models.t5.T5ForConditionalGeneration`` state_dict; the engine keeps
    the weights on ``device`` (the card by default) in the serving dtypes,
    cast once (a weight already in its dtype there is not copied).
    ``prefill_chunk`` (a positive multiple of ``page_size``, or None;
    GPT-2 and Llama): prompts longer than it prefill in
    chunks of that many tokens, one chunk per ``step()``. ``enc_max_len``
    (T5) bounds the encoder prompt and sizes the pinned cross buffers."""

    ADMIT_SKIP_AHEAD = 4

    def __init__(
        self,
        cfg,
        params: Mapping[str, torch.Tensor],
        *,
        device: Any = "cuda",
        num_pages: int = 128,
        page_size: int = 128,
        max_batch: int = 8,
        max_pages_per_seq: int = 64,
        kv_dtype: torch.dtype = torch.bfloat16,
        eos_token_id: Optional[int] = None,
        decode_window: int = 64,
        prefill_chunk: Optional[int] = None,
        temperature: float = 0.0,
        top_k: int = 0,
        seed: int = 0,
        mesh=None,
        model_axis: str = "model",
        admission: str = "fifo",
        enc_max_len: int = 512,
    ) -> None:
        adapter = _model_adapter(cfg, max_batch=max_batch, enc_max_len=enc_max_len)
        if mesh is not None:
            adapter = self._sharded_adapter(cfg, adapter, mesh, model_axis)
        if prefill_chunk is not None:
            if adapter.prefill_chunk is None:
                raise ValueError(
                    f"{type(cfg).__name__} has no chunked-prefill step; use prefill_chunk=None"
                )
            if prefill_chunk <= 0 or prefill_chunk % page_size:
                raise ValueError(
                    f"prefill_chunk must be a positive multiple of page_size ({page_size}); "
                    f"got {prefill_chunk}"
                )
        if torch.device(device).type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ServingEngine runs on the card by default and CUDA is not "
                               "available; pass device='cpu' to run on the CPU")
        if admission not in ("fifo", "best-fit"):
            raise ValueError(f"admission must be 'fifo' or 'best-fit', got {admission!r}")
        if kv_dtype not in POOL_DTYPES:
            raise ValueError(f"kv_dtype must be one of {POOL_DTYPES}, got {kv_dtype}")
        self.cfg = cfg
        self.device = torch.device(device)
        self._family = adapter.family
        self._prefill_step, self._decode_step = adapter.prefill, adapter.decode
        self._chunk_step = adapter.prefill_chunk
        self.enc_max_len = enc_max_len
        self._mesh = mesh
        self._model_axis = model_axis if mesh is not None else None
        self.params = adapter.prepare_params(params, cfg, self.device)
        self.page_size = page_size
        self.num_pages = num_pages
        self.max_batch = max_batch
        self.max_pages_per_seq = max_pages_per_seq
        self.kv_dtype = kv_dtype
        self.quantized = kv_dtype == torch.int8
        self.eos_token_id = eos_token_id
        self.admission = admission
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self._sample_seed = int(seed)
        self.decode_window = max(1, decode_window)
        self.prefill_chunk = prefill_chunk
        self.pages = adapter.create_pages(num_pages, page_size, kv_dtype, self.device)
        self._alloc = _make_allocator(num_pages, page_size, max_pages_per_seq)
        self._slots: List[Optional[int]] = [None] * max_batch  # slot -> seq_id
        self._sequences: Dict[int, _Sequence] = {}
        self._sched = make_scheduler()
        self._next_id = 0
        self._host_tables = np.zeros((max_batch, max_pages_per_seq), np.int32)
        self._tables_dirty = True
        self._win: Optional[_WindowBuffers] = None
        self._graphs: Dict[tuple, _StepGraph] = {}
        self._graph_pool = None
        self._graph_stream = None
        # One generator for every decode window, reseeded each window (a
        # graph replays it through its registered state).
        self._gen = torch.Generator(device=self.device)
        on_clear_plan_caches(self._drop_window_state)
        # stats
        self._prefill_tokens = 0
        self._decode_tokens = 0
        self._prefill_time = 0.0
        self._decode_time = 0.0
        self._steps = 0
        self._prefill_chunks = 0
        # Decode steps ever sampled. It seeds the sampling generators and is
        # never reset: reset_performance_stats() must not replay a sampling
        # stream (the JAX engine seeds its keys from _steps, which that
        # reset zeroes).
        self._sample_steps = 0

    # -- sharded serving ---------------------------------------------------

    @staticmethod
    def _sharded_adapter(cfg, adapter: _Adapter, mesh, model_axis: str) -> _Adapter:
        """GPT-2's steps over the mesh's model axis (JAX ``_init_sharded``):
        the weights cut to the rank's TP shards once, pools of the rank's
        heads, every step given the axis's process group. One rank drives
        one card, so K3's split counters, one set a device
        (``csrc/paged_decode_sm90.cu:60-63``), serve one rank's launches
        as on one card."""
        if not isinstance(cfg, GPT2Config):
            raise ValueError("sharded serving currently supports the GPT-2 family only")
        axes = mesh_shape(mesh)
        if model_axis not in axes:
            raise ValueError(f"mesh has no axis {model_axis!r}")
        n_model = axes[model_axis]
        if cfg.n_head % n_model:
            raise ValueError(f"n_head ({cfg.n_head}) must divide over the model axis ({n_model})")
        group = axis_group(mesh, model_axis)
        d = cfg.n_embd // cfg.n_head

        def create_pages(n, page, dtype, device):
            return gpt2_serving.KVPages.zeros(cfg.n_layer, cfg.n_head // n_model, n, page, d,
                                              dtype, device)

        def prepare(state, cfg_, device):
            return gpt2_serving.shard_params(gpt2_serving.prepare_params(state, cfg_, device),
                                             mesh, model_axis)

        return dataclasses.replace(
            adapter, create_pages=create_pages, prepare_params=prepare,
            prefill=functools.partial(gpt2_serving.prefill_step, tp_group=group),
            decode=functools.partial(gpt2_serving.decode_step, tp_group=group),
            prefill_chunk=functools.partial(gpt2_serving.prefill_chunk_step, tp_group=group),
        )

    def _pages_file(self) -> str:
        """This rank's pool file: ``pages.npz``, or under a mesh its shard's
        ``pages.<axis><i>-of-<n>.npz``."""
        if self._mesh is None:
            return "pages.npz"
        i = axis_index(self._mesh, self._model_axis)
        n = axis_size(self._mesh, self._model_axis)
        return f"pages.{self._model_axis}{i}-of-{n}.npz"

    def _writes_checkpoint(self) -> bool:
        """Under a mesh, the ranks at coordinate 0 of every other axis write
        (the model axis's ranks hold the distinct shards)."""
        if self._mesh is None:
            return True
        return all(axis_index(self._mesh, a) == 0
                   for a in self._mesh.mesh_dim_names if a != self._model_axis)

    # -- admission ---------------------------------------------------------

    def submit(
        self, prompt_ids: Sequence[int], max_new_tokens: int = 16, priority: int = 0
    ) -> int:
        """Queue a request. Higher ``priority`` admits first; FIFO within a
        priority level. Decoder-only families: ``prompt_ids`` are the causal
        prompt. Encoder-decoder (T5): ``prompt_ids`` are the ENCODER input;
        only decoder tokens (start + generated) take KV pages."""
        if self._family == "encdec":
            if len(prompt_ids) > self.enc_max_len:
                raise KVCacheError(
                    f"encoder prompt ({len(prompt_ids)}) exceeds enc_max_len ({self.enc_max_len})"
                )
            needed = 1 + max_new_tokens
        else:
            needed = len(prompt_ids) + max_new_tokens
        if needed > self.max_pages_per_seq * self.page_size:
            raise KVCacheError("request exceeds max sequence capacity")
        if isinstance(self.cfg, GPT2Config) and needed > self.cfg.n_positions:
            raise KVCacheError(
                f"request needs {needed} positions; the model has {self.cfg.n_positions}"
            )
        seq = _Sequence(
            seq_id=self._next_id,
            tokens=list(map(int, prompt_ids)),
            prompt_len=len(prompt_ids),
            max_new_tokens=max_new_tokens,
            priority=priority,
        )
        self._next_id += 1
        self._sequences[seq.seq_id] = seq
        self._sched.submit(seq.seq_id, priority)
        return seq.seq_id

    def cancel(self, seq_id: int) -> bool:
        """Drop a still-waiting request (admitted ones run to term)."""
        if self._sched.cancel(seq_id):
            self._sequences.pop(seq_id, None)
            return True
        return False

    def _pages_needed(self, tokens: int) -> int:
        return -(-tokens // self.page_size)

    def _total_tokens(self, seq: _Sequence) -> int:
        """Paged tokens a sequence needs: prompt + generation for causal
        families; start token + generation for encoder-decoder (the encoder
        prompt lives in the pinned cross buffers)."""
        if self._family == "encdec":
            return 1 + seq.max_new_tokens
        return seq.prompt_len + seq.max_new_tokens

    def _pick_admittable(self) -> Optional[int]:
        """Next sequence to admit under the configured policy."""
        head = self._sched.peek()
        if head is None:
            return None
        if self.admission == "fifo":
            return head
        for sid in self._sched.waiting_ids()[: self.ADMIT_SKIP_AHEAD + 1]:
            need = self._pages_needed(self._total_tokens(self._sequences[sid]))
            if need <= self._alloc.stats()["pages_free"]:
                return sid
        return head  # nothing fits; report the head (admission will stall)

    def _try_admit(self) -> None:
        """Move waiting sequences into free slots when pages suffice."""
        for slot in range(self.max_batch):
            if self._slots[slot] is not None:
                continue
            sid = self._pick_admittable()
            if sid is None:
                break
            seq = self._sequences[sid]
            try:
                seq.alloc_id = self._alloc.allocate_sequence(self._total_tokens(seq))
            except KVCacheError:
                break  # nothing admittable; wait for pages
            self._sched.pop(sid)
            seq.page_ids = self._alloc.page_ids(seq.alloc_id)
            seq.slot = slot
            self._slots[slot] = sid
            self._tables_dirty = True
            if self.prefill_chunk is not None and seq.prompt_len > self.prefill_chunk:
                seq.prefilled = 0  # chunks advance one per step()
            else:
                self._prefill(seq)

    def _flat_slot(self, seq: _Sequence, token_idx: int) -> int:
        page = seq.page_ids[token_idx // self.page_size]
        return page * self.page_size + token_idx % self.page_size

    # -- prefill -----------------------------------------------------------

    @staticmethod
    def _bucket(n: int) -> int:
        return max(16, 1 << (n - 1).bit_length())

    def _prefill(self, seq: _Sequence) -> None:
        if self._family == "encdec":
            self._prefill_encdec(seq)
            return
        s_pad = self._bucket(seq.prompt_len)
        ids = np.zeros((1, s_pad), np.int64)
        ids[0, : seq.prompt_len] = seq.tokens[: seq.prompt_len]
        slots = np.full((1, s_pad), _TRASH_PAGE * self.page_size, np.int32)
        for i in range(seq.prompt_len):
            slots[0, i] = self._flat_slot(seq, i)
        t0 = time.perf_counter()
        logits = self._prefill_step(
            self.params,
            self.cfg,
            torch.from_numpy(ids).to(self.device),
            torch.tensor([seq.prompt_len], device=self.device),
            self.pages,
            torch.from_numpy(slots).to(self.device),
            self.quantized,
        )
        token = self._pick_token(logits[0], seq)  # waits for the device
        self._prefill_time += time.perf_counter() - t0
        self._prefill_tokens += seq.prompt_len
        seq.prefilled = seq.prompt_len
        self._append_token(seq, token)

    def _prefill_encdec(self, seq: _Sequence) -> None:
        """T5 prefill: encoder forward, cross-KV pin into the slot, decoder
        start token (``models/t5_serving.py::t5_prefill_step``). The prompt
        is padded to its bucket but never past ``enc_max_len`` (the JAX
        engine pads past it and the prefill then refuses the request)."""
        s_pad = min(self._bucket(seq.prompt_len), self.enc_max_len)
        ids = np.zeros((1, s_pad), np.int64)
        ids[0, : seq.prompt_len] = seq.tokens[: seq.prompt_len]
        tables = np.zeros((1, self.max_pages_per_seq), np.int32)
        tables[0, : len(seq.page_ids)] = seq.page_ids
        t0 = time.perf_counter()
        logits = self._prefill_step(
            self.params,
            self.cfg,
            torch.from_numpy(ids).to(self.device),
            torch.tensor([seq.prompt_len], dtype=torch.int32, device=self.device),
            self.pages,
            torch.tensor([self._flat_slot(seq, 0)], dtype=torch.int32, device=self.device),
            torch.from_numpy(tables).to(self.device),
            self.quantized,
            seq.slot,
        )
        token = self._pick_token(logits[0], seq)  # waits for the device
        self._prefill_time += time.perf_counter() - t0
        self._prefill_tokens += seq.prompt_len
        seq.prefilled = seq.prompt_len
        self._append_token(seq, token)

    def _advance_prefill(self, seq: _Sequence) -> None:
        """Run ONE prefill chunk of ``seq`` (bounded decode stall). The
        history window is the power-of-two page count covering the tokens
        already cached, its dead tail masked by the chunk step's key bias."""
        c, page = self.prefill_chunk, self.page_size
        start = seq.prefilled
        end = min(start + c, seq.prompt_len)
        n = end - start
        ids = np.zeros((1, c), np.int64)
        ids[0, :n] = seq.tokens[start:end]
        slots = np.full((1, c), _TRASH_PAGE * page, np.int32)
        for i in range(n):
            slots[0, i] = self._flat_slot(seq, start + i)
        s_hist = 0
        if start:
            hp = -(-start // page)
            s_hist = min(1 << (hp - 1).bit_length(), self.max_pages_per_seq) * page
        tables = np.zeros((1, self.max_pages_per_seq), np.int32)
        tables[0, : len(seq.page_ids)] = seq.page_ids
        t0 = time.perf_counter()
        logits = self._chunk_step(
            self.params,
            self.cfg,
            torch.from_numpy(ids).to(self.device),
            torch.tensor([start], device=self.device),
            torch.tensor([n], device=self.device),
            self.pages,
            torch.from_numpy(slots).to(self.device),
            torch.from_numpy(tables).to(self.device),
            self.quantized,
            s_hist,
        )
        token = self._pick_token(logits[0], seq) if end == seq.prompt_len else None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._prefill_time += time.perf_counter() - t0
        self._prefill_tokens += n
        self._prefill_chunks += 1
        seq.prefilled = end
        if token is not None:
            # Prefill complete: the slot joins the decode batch.
            self._tables_dirty = True
            self._append_token(seq, token)

    def _seed_of(self, *salt: int) -> int:
        return hash((self._sample_seed,) + salt) & 0x7FFF_FFFF_FFFF_FFFF

    def _generator(self, *salt: int) -> torch.Generator:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self._seed_of(*salt))
        return gen

    def _sample(self, logits: torch.Tensor, gen: Optional[torch.Generator]) -> torch.Tensor:
        """(B, V) logits -> (B,) tokens on the device: argmax at temperature
        0, else temperature (+ top-k) sampling from ``gen``."""
        if self.temperature <= 0:
            return torch.argmax(logits, dim=-1)
        lg = logits / max(self.temperature, 1e-6)
        if self.top_k:
            kth = torch.topk(lg, self.top_k, dim=-1).values[:, -1:]
            lg = lg.masked_fill(lg < kth, -1e30)
        return torch.multinomial(torch.softmax(lg, dim=-1), 1, generator=gen)[:, 0]

    def _pick_token(self, logits_row: torch.Tensor, seq: _Sequence) -> int:
        """Sample/argmax one token from (V,) logits (prefill boundary)."""
        gen = self._generator(0, seq.seq_id) if self.temperature > 0 else None
        return int(self._sample(logits_row[None], gen)[0])

    def _append_token(self, seq: _Sequence, token: int) -> None:
        seq.tokens.append(token)
        if seq.new_tokens >= seq.max_new_tokens or (
            self.eos_token_id is not None and token == self.eos_token_id
        ):
            self._retire(seq)

    def _retire(self, seq: _Sequence) -> None:
        seq.done = True
        seq.finished_at = time.time()
        if seq.slot is not None:
            self._slots[seq.slot] = None
            seq.slot = None
            self._tables_dirty = True
        if seq.alloc_id is not None:
            self._alloc.free_sequence(seq.alloc_id)
            seq.alloc_id = None
        seq.page_ids = []

    # -- decode ------------------------------------------------------------

    def _window_steps(self, active: List[int]) -> int:
        """Effective window: largest power of two <= every active
        sequence's remaining budget, capped at ``decode_window`` (so no
        sequence writes KV past its allocated pages mid-window)."""
        budget = min(
            self._sequences[sid].max_new_tokens - self._sequences[sid].new_tokens
            for sid in active
        )
        w = max(1, min(self.decode_window, budget))
        return 1 << (w.bit_length() - 1)

    def _ready(self, seq: _Sequence) -> bool:
        """Prefill complete and first token sampled: in the decode batch."""
        return seq.new_tokens > 0 and not seq.done

    def _width(self, active: List[int], n_steps: int) -> int:
        """The window's page-table width (JAX's occupancy bucket): the
        smallest power of two of pages covering the longest active sequence
        plus the window, at most ``max_pages_per_seq``."""
        max_len = max(self._sequences[sid].length for sid in active)
        need = -(-(max_len + n_steps) // self.page_size)
        return min(1 << (need - 1).bit_length(), self.max_pages_per_seq)

    def _window_buffers(self) -> _WindowBuffers:
        if self._win is None:
            b, dev = self.max_batch, self.device
            self._win = _WindowBuffers(
                state=torch.zeros(3, b, dtype=torch.int32, device=dev),
                upload=torch.zeros(3, b, dtype=torch.int32, pin_memory=dev.type == "cuda"),
                toks=torch.zeros(self.decode_window, b, dtype=torch.long, device=dev),
                step=torch.zeros(1, dtype=torch.long, device=dev),
                rows=torch.arange(b, device=dev),
                tables={},
            )
        return self._win

    def _tables(self, win: _WindowBuffers, w_pages: int) -> torch.Tensor:
        """The (B, w_pages) device page tables, refreshed in place (a graph
        holds their address) when admission or retirement changed the rows.
        Stale rows after retirement MUST be zeroed or an empty slot would
        keep writing its trash token into pages recycled to a new sequence;
        mid-prefill rows stay zeroed too (their decode writes land in trash,
        not in the pages their chunks fill)."""
        if self._tables_dirty:
            self._host_tables[:] = 0
            for slot, sid in enumerate(self._slots):
                if sid is not None and self._ready(self._sequences[sid]):
                    pages = self._sequences[sid].page_ids
                    self._host_tables[slot, : len(pages)] = pages
            for w, t in win.tables.items():
                t.copy_(torch.from_numpy(self._host_tables[:, :w]))
            self._tables_dirty = False
        if w_pages not in win.tables:
            win.tables[w_pages] = torch.from_numpy(
                np.ascontiguousarray(self._host_tables[:, :w_pages])).to(self.device)
        return win.tables[w_pages]

    @torch.no_grad()
    def _decode_one(self, win: _WindowBuffers, tables: torch.Tensor, do_sample: bool) -> None:
        """One decode step over the window's buffers, in place (JAX's scan
        body): the flat slot of the token consumed (written at pos; empty
        slots map to the zeroed table row, the trash page), the model's
        step, the next token into row ``step`` of ``toks`` and ``ids``, then
        pos + 1, lengths + 1 (empty slots stay at length 0) and step + 1."""
        ids, pos, lens = win.state[0], win.state[1], win.state[2]
        page_col = (pos // self.page_size).clamp(max=tables.shape[1] - 1).long()
        flat = (tables[win.rows, page_col] * self.page_size + pos % self.page_size).int()
        logits = self._decode_step(
            self.params, self.cfg, ids, pos, self.pages, flat, lens, tables, self.quantized,
        )
        nxt = self._sample(logits, self._gen if do_sample else None)
        win.toks.index_copy_(0, win.step, nxt[None])
        ids.copy_(nxt)
        pos.add_(1)
        lens.add_((lens > 0).int())
        win.step.add_(1)

    def _window_eager(self, win: _WindowBuffers, tables: torch.Tensor, n_steps: int,
                      do_sample: bool) -> None:
        """The window as eager steps: the CPU's path, and the plain version
        the card's graphs are held against."""
        for _ in range(n_steps):
            self._decode_one(win, tables, do_sample)

    def _window_graphed(self, win: _WindowBuffers, tables: torch.Tensor, n_steps: int,
                        do_sample: bool) -> None:
        """The window on the card: each step one replay of the step graph of
        (w_pages, do_sample, top_k). At a new key the first step runs
        eagerly on the capture stream (it allocates what the capture must
        find: K3's arrival counters, cuBLAS's workspace, T5's bias vector),
        then the step is captured and the remaining steps replay it."""
        key = (tables.shape[1], do_sample, self.top_k)
        entry = self._graphs.get(key)
        replays = n_steps
        if entry is None:
            entry = self._capture(win, tables, do_sample)
            self._graphs[key] = entry
            replays -= 1
        for _ in range(replays):
            entry.graph.replay()
        _build.count_replays(entry.captured, replays)

    def _capture(self, win: _WindowBuffers, tables: torch.Tensor, do_sample: bool) -> _StepGraph:
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
            self._graph_stream = torch.cuda.Stream(self.device)
        stream = self._graph_stream
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            self._decode_one(win, tables, do_sample)  # the window's first step
        torch.cuda.current_stream(self.device).wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        if do_sample:
            graph.register_generator_state(self._gen)
        before = collections.Counter(_build.CAPTURED)
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, pool=self._graph_pool, stream=stream):
            self._decode_one(win, tables, do_sample)
        capture_ms = 1e3 * (time.perf_counter() - t0)
        return _StepGraph(graph, collections.Counter(_build.CAPTURED) - before, capture_ms)

    def _drop_window_state(self) -> None:
        """Forget the window's graphs and buffers (each graph holds the
        addresses of the buffers, the pools and the weights it was captured
        on); the next window builds them again."""
        self._graphs.clear()
        self._win = None
        self._graph_pool = None
        self._tables_dirty = True

    def window_graph_stats(self) -> Dict[str, Any]:
        """The decode window's CUDA graphs: how many, each one's capture ms,
        and the bytes of the memory pool they share (0 on the CPU, where
        the window runs eagerly)."""
        pool_bytes = 0
        if self._graph_pool is not None:
            pool_bytes = sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                             if seg.get("segment_pool_id") == self._graph_pool)
        return {"graphs": len(self._graphs),
                "capture_ms": [g.capture_ms for g in self._graphs.values()],
                "pool_bytes": pool_bytes}

    def step(self) -> int:
        """One scheduler iteration: admit (prefilling each newcomer whole
        or deferring it to chunks), advance at most ONE pending prefill
        chunk, then run one decode window over every ready slot. Returns
        the number of sequences decoded, or, when none is ready, the
        number still prefilling (0 only when nothing can progress)."""
        self._try_admit()
        for sid in self._slots:
            if sid is None:
                continue
            seq = self._sequences[sid]
            if not seq.done and seq.prefilled < seq.prompt_len:
                self._advance_prefill(seq)
                break
        active = [
            sid for sid in self._slots
            if sid is not None and self._ready(self._sequences[sid])
        ]
        if not active:
            return sum(
                1 for sid in self._slots
                if sid is not None and not self._sequences[sid].done
            )

        b = self.max_batch
        n_steps = self._window_steps(active)
        host = np.zeros((3, b), np.int32)  # ids / positions / lengths
        for slot in range(b):
            sid = self._slots[slot]
            if sid is None or not self._ready(self._sequences[sid]):
                continue  # length 0: attends over nothing; writes land in trash
            seq = self._sequences[sid]
            # The model consumes the LAST token (already appended) and
            # writes its K/V at position length-1. Encoder-decoder families
            # count DECODER positions only: the decoder sequence is [start]
            # + generated, so the consumed token sits at index new_tokens.
            host[0, slot] = seq.tokens[seq.length - 1]
            if self._family == "encdec":
                host[1, slot] = seq.new_tokens
                host[2, slot] = seq.new_tokens + 1
            else:
                host[1, slot] = seq.length - 1
                host[2, slot] = seq.length
        w_pages = self._width(active, n_steps)
        win = self._window_buffers()
        tables = self._tables(win, w_pages)
        win.upload.numpy()[:] = host
        win.state.copy_(win.upload, non_blocking=True)  # the window's one upload
        win.step.zero_()
        do_sample = self.temperature > 0
        if do_sample:
            self._gen.manual_seed(self._seed_of(1, self._sample_steps))
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            self._window_graphed(win, tables, n_steps, do_sample)
        else:
            self._window_eager(win, tables, n_steps, do_sample)
        toks = win.toks[:n_steps].cpu().numpy()  # (n_steps, B); waits for the device
        self._decode_time += time.perf_counter() - t0
        self._steps += n_steps
        if do_sample:
            self._sample_steps += n_steps

        for step_i in range(n_steps):
            for slot in range(b):
                sid = self._slots[slot]
                if sid is None:
                    continue
                seq = self._sequences[sid]
                if seq.done or seq.new_tokens == 0:
                    continue  # EOS mid-window: discard
                self._append_token(seq, int(toks[step_i, slot]))
                self._decode_tokens += 1
        return len(active)

    # -- high level ---------------------------------------------------------

    def generate(
        self, prompts: Sequence[Sequence[int]], max_new_tokens: int = 16
    ) -> List[List[int]]:
        """Blocking batch generation."""
        sids = [self.submit(p, max_new_tokens) for p in prompts]
        while any(not self._sequences[s].done for s in sids):
            if self.step() == 0 and any(not self._sequences[s].done for s in sids):
                # nothing active but work remains -> admission is stuck
                raise KVCacheError("scheduler stalled: not enough pages")
        return [self._sequences[s].tokens[self._sequences[s].prompt_len :] for s in sids]

    # -- checkpoint / resume -------------------------------------------------

    def save(self, path: str) -> None:
        """Persist the engine mid-generation into directory ``path``: every
        pool tensor (T5's cross buffers and encoder lengths too) as
        ``pages.npz``, bf16 as its ``uint16`` bits, and the host state as
        ``state.json`` (each written to a temporary name and renamed). A
        preempted process resumes with :meth:`restore`. Under a mesh every
        rank calls it: each model-axis shard's pools go to their own file
        (``_pages_file``), ``state.json`` comes from shard 0, and it
        returns when all are written."""
        if self._writes_checkpoint():
            self._save_files(path)
        if self._mesh is not None:
            dist.barrier()  # every shard is on disk when any rank returns

    def _save_files(self, path: str) -> None:
        """This rank's pool file, and ``state.json`` unless another rank of
        the model axis writes it (the shard-0 rank)."""
        os.makedirs(path, exist_ok=True)
        arrays = {
            f.name: tensor_to_np(getattr(self.pages, f.name))
            for f in dataclasses.fields(self.pages)
            if getattr(self.pages, f.name) is not None
        }
        atomic_savez(os.path.join(path, self._pages_file()), arrays)
        if self._mesh is not None and axis_index(self._mesh, self._model_axis) != 0:
            return
        host = {
            "version": 1,
            "ctor": {
                "num_pages": self.num_pages,
                "page_size": self.page_size,
                "max_batch": self.max_batch,
                "max_pages_per_seq": self.max_pages_per_seq,
                "kv_dtype": _KV_NAMES[self.kv_dtype],
                "eos_token_id": self.eos_token_id,
                "decode_window": self.decode_window,
                "prefill_chunk": self.prefill_chunk,
                "admission": self.admission,
                "temperature": self.temperature,
                "top_k": self.top_k,
                "seed": self._sample_seed,
                "enc_max_len": self.enc_max_len,
                "sharded": self._mesh is not None,
                "model_axis": self._model_axis,
                "model_shards": (axis_size(self._mesh, self._model_axis)
                                 if self._mesh is not None else 1),
            },
            "next_id": self._next_id,
            "waiting": self._sched.waiting_ids(),
            "slots": list(self._slots),
            "sample_steps": self._sample_steps,
            "stats": {
                "prefill_tokens": self._prefill_tokens,
                "decode_tokens": self._decode_tokens,
                "prefill_time": self._prefill_time,
                "decode_time": self._decode_time,
                "steps": self._steps,
                "prefill_chunks": self._prefill_chunks,
            },
            "sequences": {
                str(sid): {
                    "tokens": seq.tokens,
                    "prompt_len": seq.prompt_len,
                    "max_new_tokens": seq.max_new_tokens,
                    "page_ids": seq.page_ids,
                    "slot": seq.slot,
                    "priority": seq.priority,
                    "prefilled": seq.prefilled,
                    "done": seq.done,
                }
                for sid, seq in self._sequences.items()
            },
        }
        atomic_write_json(os.path.join(path, "state.json"), host)

    @classmethod
    def restore(cls, path: str, cfg, params: Mapping[str, torch.Tensor], *,
                device: Any = "cuda", mesh=None) -> "ServingEngine":
        """Rebuild an engine saved by :meth:`save` on ``device`` (the card
        by default) from the same ``cfg`` and ``params``.

        Page accounting resumes on the Python allocator holding the saved
        page ids (the native allocator cannot be told which pages to hold);
        the device page tables are rebuilt at the next step; the waiting
        requests are queued again in their saved order. A checkpoint of a
        sharded engine needs ``mesh`` (a model axis of the saved size; each
        rank reads its shard's file) and raises ``ValueError`` without it,
        as JAX's does; an unsharded one restored with a mesh is cut to the
        rank's shard."""
        with open(os.path.join(path, "state.json")) as f:
            host = json.load(f)
        ctor = host["ctor"]
        if ctor.get("sharded") and mesh is None:
            raise ValueError(
                f"checkpoint was saved from a TP-sharded engine (model_axis="
                f"{ctor.get('model_axis')!r}); pass mesh= to restore it sharded"
            )
        model_axis = ctor.get("model_axis") or "model"
        kv_dtype = {name: dtype for dtype, name in _KV_NAMES.items()}[ctor["kv_dtype"]]
        eng = cls(
            cfg, params, device=device, mesh=mesh, model_axis=model_axis,
            num_pages=ctor["num_pages"],
            page_size=ctor["page_size"], max_batch=ctor["max_batch"],
            max_pages_per_seq=ctor["max_pages_per_seq"], kv_dtype=kv_dtype,
            eos_token_id=ctor["eos_token_id"], decode_window=ctor["decode_window"],
            prefill_chunk=ctor["prefill_chunk"], temperature=ctor["temperature"],
            top_k=ctor["top_k"], seed=ctor["seed"], admission=ctor["admission"],
            enc_max_len=ctor["enc_max_len"],
        )
        whole = mesh is not None and not ctor.get("sharded")
        if ctor.get("sharded") and ctor.get("model_shards") != axis_size(mesh, model_axis):
            raise ValueError(f"checkpoint holds {ctor.get('model_shards')} shards on "
                             f"{model_axis!r}; the mesh has {axis_size(mesh, model_axis)}")
        data = np.load(os.path.join(path, "pages.npz" if whole else eng._pages_file()))
        specs = gpt2_serving.serving_pages_specs(eng.quantized, model_axis) if whole else {}
        for f in dataclasses.fields(eng.pages):
            fresh = getattr(eng.pages, f.name)
            if fresh is None:
                continue
            saved = data[f.name]
            if whole:
                saved = tensor_to_np(shard_tensor(np_to_tensor(saved, fresh.dtype, "cpu"),
                                                  specs[f.name], mesh))
            if tuple(saved.shape) != tuple(fresh.shape):
                raise ValueError(f"{f.name}: saved shape {saved.shape}, engine's "
                                 f"{tuple(fresh.shape)}")
            fresh.copy_(np_to_tensor(saved, fresh.dtype, eng.device))

        eng._next_id = host["next_id"]
        eng._slots = list(host["slots"])
        eng._sample_steps = host["sample_steps"]
        st = host["stats"]
        eng._prefill_tokens = st["prefill_tokens"]
        eng._decode_tokens = st["decode_tokens"]
        eng._prefill_time = st["prefill_time"]
        eng._decode_time = st["decode_time"]
        eng._steps = st["steps"]
        eng._prefill_chunks = st["prefill_chunks"]

        alloc = _PyPageAllocator(eng.num_pages, eng.page_size, eng.max_pages_per_seq)
        for sid_str, rec in host["sequences"].items():
            seq = _Sequence(
                seq_id=int(sid_str),
                tokens=list(rec["tokens"]),
                prompt_len=rec["prompt_len"],
                max_new_tokens=rec["max_new_tokens"],
                page_ids=list(rec["page_ids"]),
                slot=rec["slot"],
                priority=rec["priority"],
                prefilled=rec["prefilled"],
                done=rec["done"],
            )
            if seq.page_ids:
                seq.alloc_id = alloc.adopt(seq.page_ids)
            eng._sequences[seq.seq_id] = seq
        eng._alloc = alloc
        eng._drop_window_state()  # the pools were replaced: tables and graphs are rebuilt
        # The saved order is already priority-then-FIFO: submitting in it
        # with the saved priorities reproduces it.
        for sid in host["waiting"]:
            eng._sched.submit(sid, eng._sequences[sid].priority)
        return eng

    # -- stats ---------------------------------------------------------------

    def status(self) -> Dict:
        return {
            "active": sum(1 for s in self._slots if s is not None),
            "waiting": len(self._sched),
            "finished": sum(1 for s in self._sequences.values() if s.done),
            "pages_free": self._alloc.stats()["pages_free"],
            "pages_total": self.num_pages - 1,
            "allocator": type(self._alloc).__name__,
            "scheduler": type(self._sched).__name__,
            "queue": self._sched.stats(),
            "kv_dtype": _KV_NAMES[self.kv_dtype],
            "family": self._family,
            "enc_max_len": self.enc_max_len,
        }

    def reset_performance_stats(self) -> None:
        """Zero the token/time counters (NOT the sequence/page state, and
        not the sampling counter)."""
        self._prefill_tokens = 0
        self._decode_tokens = 0
        self._prefill_time = 0.0
        self._decode_time = 0.0
        self._steps = 0
        self._prefill_chunks = 0

    def get_performance_stats(self) -> Dict:
        return {
            "prefill_tokens": self._prefill_tokens,
            "decode_tokens": self._decode_tokens,
            "decode_steps": self._steps,
            "prefill_chunks": self._prefill_chunks,
            "prefill_time": self._prefill_time,
            "decode_time": self._decode_time,
            "prefill_tokens_per_s": (
                self._prefill_tokens / self._prefill_time if self._prefill_time else 0.0
            ),
            "decode_tokens_per_s": (
                self._decode_tokens / self._decode_time if self._decode_time else 0.0
            ),
            **self.status(),
        }
