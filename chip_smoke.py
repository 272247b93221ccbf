"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

Run from the repository root:

    python3 chip_smoke.py

Phases (each prints its lines; any failure raises and exits non-zero):

1. device: CUDA must be available (there is no CPU path);
2. build: compile the port's kernels (csrc/*.cu) with nvcc; then the
   proof that K1's and K4/K5's bf16 kernels are the Hopper design: every
   instantiation (K1: D 64 and 128, six modes, and D 256 plain and
   streams; K4 and K5: D 64 and 128,
   plain, window, dropout) must show HGMMA and UTMALDG and no HMMA in the
   library's SASS (``cuobjdump -sass``), printed with its registers and
   stack (``cuobjdump -res-usage``; K4/K5 must have none), tiles, ring
   stages, shared memory and CTAs a SM; that each of the quantized
   forward's ten instantiations (K1's int8-QK, fp8-QK and int8-full
   modes and K6 int8 and fp8, D 64 and 128) holds exactly its mode's GMMA
   kinds (IGMMA s8, QGMMA e4m3, HGMMA bf16/f16) and UTMALDG, no HMMA or
   IMMA and no stack; that K3's 44 instantiations (22 at a head dim of
   the width, 22 narrower) stage pages by the TMA's bulk copy (UBLKCP)
   with no stack; that K21's bf16 instantiation
   of K4's body and K20's of K5's (D 64 and 128) do as K4's and K5's; that
   K10's ring copies by the bulk copy with no stack; and that K13-K19's bf16 body
   (K16/K18, K17 at unroll 2 and 4, K19, K13 in both exp modes; D 64 and
   128; K14 and K15 at D 64) holds HGMMA and UTMALDG, no HMMA and no
   stack;
3. kernels: each kernel and mode against its plain PyTorch version on the
   card, at the shapes the main paths give it, with kernel, plain and
   library times and the card's bound: K1 (flash forward, its lse, and its
   kv_lens/k_bias streams), K2 (the token write alone), K3 (paged decode:
   the read-only attend, and the fused decode that writes the token and
   attends in one launch, pools bit-exact with K2's plain write), K3's
   paged_attention_hf entry (float and int8 compute), K4/K5 (flash backward), K1's quantized
   modes (int8-QK, fp8-QK, int8-full) and K6 (fp8, int8), these also
   against the fp32 oracle under the JAX tests' gates, with the whole
   call's time (quantization passes included) and bf16 K1's; K1's
   relative-bias mode (T5 buckets both directions, Sq < Skv, ALiBi) and
   dense-bias mode (a (B,1,S,S) random-hole mask, a real (B,H,S,S) bias),
   K3's token-bias mode (bf16 and int8 pools; read-only and fused), each
   against SDPA given the same dense float bias (K3: no library call); K1's dropout stream (B4
   S2048 H12 causal bf16, rate 0.1; fp32, GQA, Sq 512 / Skv 2048) and
   window stream (B1 S8192 H12 against the plain version and SDPA with the
   same band mask; bench.py's B1 S65536 window (-4095, 0) row against its
   in-band bound), K4/K5's dropout and window streams (B4 S2048 H12), and
   K1's relative-bias mode writing lse (T5 both directions, ALiBi); the
   bf16 K1's edges (every Sq != Skv among 1, 127, 129, 300, GQA 12/4 and
   32/8, a lens row of 0, window rows with no key, dense bias on both
   sides of its TMA / cp.async choice, dropout at 0.1), output and lse;
   then K1's table: each bf16 mode of PERF.md's table and the training
   geometry B2 S4096 Hq32/Hkv8 D128 causal with lse, by CUDA events and by
   the graph fit, beside SDPA timed both ways, the bound and the share;
   the bf16 K4/K5's edges (every Sq != Skv among 1, 127, 129, 300 at D 64
   and 128, GQA 12/4 and 32/8 through the autograd Function, window rows
   with no key, dropout 0.1; dq, dk, dv against the plain backward, two
   launches bit-identical) and the K4/K5 table (K4, K5 with di and K5 + K4
   by CUDA events and the graph fit beside SDPA's backward both ways, the
   pair's bound and share: B4 S2048 H12, GPT-2 medium's B8 S1024 H16,
   dropout 0.1, window (-255, 0), B1 S8192, and B2 S4096 Hq32/Hkv8 D128 on
   native K/V, with the autograd Function's backward and K4 by slices);
   then the K3 table (``time_k3_modes``): GPT-2 medium's int8 decode fused
   and read-only, K2 alone, T5's decode with the token bias (bf16 and int8
   pools), paged_attention_hf float and int8, B14's two rows and B1 H32
   D128 at 32768 tokens, each by CUDA events, the graph fit and the host
   time a call, beside its bound and share (``--k3-table`` prints only
   this table and GPT-2 medium's decode step, with public calls, so a copy
   of the script times another tree of the repository); then the quant
   table (``time_quant_modes``): every quantized mode at the quantized
   checks' two shapes and B2 S4096 Hq32/Hkv8 D128 causal, the kernel by
   CUDA events and the graph fit, the whole call, bf16 K1 both ways, the
   bound and the share (``--quant-table`` prints only this table, the
   same way); then Llama-2-70B's GQA geometry: K1 bf16 at B1 S2048
   Hq64/Hkv8 D128 causal (beside SDPA with ``enable_gqa``) and K3's fused
   decode at B8 Hq64/Hkv8 D128 over an int8 pool, lengths 1-4096, against
   their plain versions, by CUDA events and the graph fit; then K4/K5 at
   the same B1 S2048 Hq64/Hkv8 D128 causal bf16, as Llama training gives
   them (``check_llama_bwd``, K/V with their 8 heads): the gradients
   through the autograd Function (one K5 and one K4 launch) against the
   plain backward, two calls bit-equal, K5 with di and K4 alone (K4 also
   by slices of the group) and the Function's whole backward, the plain
   backward and SDPA's backward with ``enable_gqa``, beside the bounds;
   then the head dims: every kernel and mode at d 16-112 and the d-80
   timings (``check_head_dims``, ``time_head_dims``), and past 128 K1's
   plain and key-stream modes and K3's every mode at d 136-256 against
   their plain versions, one call each of what the card refuses there (a
   ValueError naming d and A17, no launch), and K1 and K3's fused decode
   timed at Gemma-2B's attention (8 query heads over 1 KV head, d 256)
   (``check_wide_head_dims``, ``time_wide_head_dims``);
4. roofline: the card's record (``hardware.detection``), K9/K10 (HBM read
   and copy) bit for bit and K11 (exp) and K12 (the softmax stream, both
   modes) within their bounds against their plain versions; then, as a
   path of its own, the measure functions (read, copy, exp and stream
   rates, the stream's linear fit) at the card's shapes and at JAX's, each
   beside its data-sheet bound; K1's share of the composite ceiling built
   from the measured rates (its time by CUDA events and by the graph fit); the profiler's time of K11 and K12 in one
   graph replay against the graph fit (within 10 %);
5. experiments: K13-K19 (the flash-forward design-space experiments:
   fixed-max in both exp modes, augmented V, paired chains at nchain 1 to
   4, the pipelined KV loop, chunked K/V staging at unroll 2 and 4, one
   launch per q row-block in bf16 and with int8 Q.K, one CTA per head over
   the whole triangle; K13-K19 in bf16 on their TMA + wgmma body of
   csrc/flash_experiments_sm90.cu, K16-K19 in fp32 on the mma.sync bodies
   of csrc/flash_experiments.cu, counted as modes of their own and timed at
   K1's headline shape in fp32) against their plain versions at small,
   ragged and full shapes, the full ones every geometry the experiments
   path gives them, each plain version timed once at K1's headline shape,
   and a K13 call (both modes), a K15 call and a K18 call (its chain of
   programmatic dependent launches) captured into a CUDA graph and
   replayed on new inputs; then, as a
   path of its own, the experiments' mains on the card (the four files'
   and the pipeline file's five others: parity, then each variant and K1
   at JAX's geometries by the graph fit), each variant printed with its
   TFLOP/s, K1's time and the ratio, SDPA's (none for int8 Q.K), its share
   of the data-sheet bound and of the composite ceiling from the
   roofline's measured rates, and its error against the fp32 oracle, which
   must stay within its bound; every K13-K19 kernel and mode must launch,
   the segmented variant's rows must have run each segment on K1, and the
   kernels line takes each kernel's time from its main's headline row.
   K20/K21 (the unrolled backward: dQ once per row-block, dK/dV once per
   key block; in bf16 on K5's and K4's TMA + wgmma bodies, in fp32 on
   their mma.sync bodies, counted as modes of their own and timed at K1's
   headline shape in fp32) join both halves: checked against their plain
   versions (small shapes at blocks of 64 and 128, D 128, fp32 inputs, and
   every geometry and block of their main, each with its launch count;
   K20's dq equal to K5's at K1's headline shape; a bf16 K20 and K21 call
   replayed from a CUDA graph), then the
   backward's main (parity against K4 + K5 under JAX's 3e-2, each row timed
   beside K4 + K5, SDPA's backward and the data-sheet bound; K20, K21, K4
   and K5 alone on the headline row); the calls its graphs captured must
   be one K20 a row-block and one K21 a key block;
6. serving path: GPT-2 medium (random weights, seed 0) served through
   ``ServingEngine.generate`` with an int8 paged KV cache (decode: K3's
   fused write + attend, one launch a layer a step); every kernel's
   launch count must grow; the first step must agree with the dense model;
   then the same requests with ``prefill_chunk=256`` (K1 with the key-bias
   stream): the same first tokens, last-prompt logits within a bound;
6a. durable path: a ``PagedKVCache`` on the card at Llama-2-7B's decode
   width (Hkv 32, D 128, page 128; int8 and bf16 pools; 8 sequences, each
   prompt appended as one run, then four single tokens): K3
   (``paged_attention``) on the cache's tensors against its plain version,
   ``gather_kv`` against the appended inputs within the pool's rounding,
   ``save_kv_cache``/``restore_kv_cache`` bit-exact; GPT-2 medium at full
   width (int8 pool, page 128, 8 requests of 17-992 tokens, 32 new
   tokens) on the native allocator and scheduler, then stopped after 12
   steps, saved, restored into a fresh engine and finished: its tokens
   equal the uninterrupted run's, greedy and sampled; the same at
   T5-large's width cut to 2+2 layers (the pinned cross buffers); save
   and restore ms and checkpoint bytes printed; GPT-2 medium's width cut
   to 4 layers trained 2 AdamW steps, saved through ``CheckpointManager``,
   restored into a fresh model and optimizer: step 3's loss and parameters
   bit-equal to the uninterrupted step 3;
6a2. parallel path: a real NCCL process group of world size 1 (a file
   store; ``initialize_multihost``, ``create_mesh``, ``process_summary``),
   then: ring attention at Llama-2-70B's attention width (B1 S32768
   Hq64/Hkv8 D128 causal bf16, ``kv_lens`` and a ``k_bias``) bit-equal to
   one K1-with-lse call; the ring's 4-rank step schedule played in one
   process (each rank's steps through ``ring_step`` on the shards the
   rotation brings it, S_local 8192: clipped lengths, bias shards, skipped
   blocks), merged, against the same call; the ring's gradient at GPT-2
   medium's width (S8192) against autograd through K4/K5; Ulysses at
   Llama-2-7B's width (S32768) forward and gradient; the engine's
   ``set_mesh`` with one forced call each of RING and ULYSSES; GPT-2
   medium trained 3 steps on a (data 1, model 1) mesh with
   ``param_sharding_rules`` against the unsharded trainer (losses, and
   whether bit-equal); Llama at Llama-2-70B's widths cut to 2 layers
   (2.24 B fp32 parameters, bf16 compute) trained 4 AdamW steps at B1
   S2048 unsharded and then on the mesh with ``llama_param_sharding_rules``
   (each run counted alone: K1, K4 and K5 once a layer and step; the loss
   falls; the mesh run within 1e-3 of the unsharded one), and its first
   layer's gradient (1 layer, B1 S256) on the card against the CPU fp32
   plain run (5e-2); GPT-2 medium served on one (int8 pool, 8 requests) with the
   unsharded engine's tokens, a sharded save/restore round trip and the
   restore without a mesh refused; the telemetry's bytes and NCCL's
   world-1 collective times; K1 (plain and streams), K4/K5 and K3's fused
   decode must launch;
6b. llama path: Llama-2-7B at full width and depth (32 layers; random bf16
   weights from seed 0, made on the card), then GQA at Llama-2-70B's width
   (64 query heads over 8 KV heads) cut to 2 layers, each served through
   ``ServingEngine`` (int8 pool, page 128, decode window 32): 8 requests of
   17-2000 tokens (redrawn while the dense fp32 forward's top-2 logits
   tie), 33 new tokens each, K1 once a layer a prefill and K3's
   fused decode once a layer a step asserted, decode tokens/s and ms a
   step printed; every last-prompt logit row against the dense fp32
   ``LlamaForCausalLM`` forward of the same weights on the card, the
   shortest and the longest prompt's also against the dense bf16 one; the
   same requests with ``prefill_chunk=256`` (K1 with its key-bias stream)
   against the whole prefill, first tokens equal; decode steps 1-4
   over a bf16 pool against the dense forward over the same tokens;
6c. bert path: BERT-base (random weights from seed 0, bf16 compute) on a
   padded batch B8 S512 with two token types: K1's key streams once a
   layer, the kept rows and the pooled output against the same weights in
   fp32 on the card;
7. engine path: the drop-in ``PhotonicFlashAttention`` layer at GPT-2
   medium's width, eager calls through the adaptive engine (prefill, key
   padding, a dense (B,1,S,S) mask on K1's dense-bias mode, decode over
   2048 keys, a short call), first with the heuristic
   (kinds asserted), then measured (the router's table printed); outputs
   against the fp32 fused oracle, K1 and K3 launches, no failures; then
   the same under ``quant_mode`` "int8" and "fp8" (a square causal and a
   cross-attention call): heuristic kinds asserted, the measured warm-up
   must launch K1's int8-QK, int8-full and fp8-QK modes and K6 fp8;
8. training path: GPT-2 medium (random weights, seed 0) takes AdamW steps
   through ``Trainer.train_step`` at B8 S1024 on one fixed batch; the loss
   must fall, K1/K4/K5 must launch once per layer and step; the gradient of
   the first 4 layers of the same weights must agree with a CPU run; then
   the same with ``attn_pdrop`` 0.1 through ``Trainer(dropout_rng=...)``,
   on K1/K4/K5's dropout modes (the gradient check with one fixed dropout
   seed on both sides);
9. T5 path at T5-large width (random weights from a seeded generator):
   (a) ``T5ForConditionalGeneration`` cut to 2+2 layers, B1, encoder 1024,
   decoder 512, unmasked (K1's relative-bias mode), against the same
   weights in fp32 on the CPU (plain versions); (b) ``ServingEngine`` at
   full depth, 8 requests of 64-512 encoder tokens, 32 new tokens, with a
   bf16 and an int8 pool (K3's fused decode with the token bias every
   decode step),
   the model computing in fp32: every first token equal to the dense
   model's argmax on the card, two trajectories under the JAX test's
   greedy-parity rule; then bf16 compute over a bf16 pool, timed; (c) the
   full-depth bf16 forward at B2, encoder 2048, decoder 512, timed;
10. T5 training path: T5-large at full depth, bf16 compute, B2, encoder
   1024, decoder 512, three AdamW steps through ``Trainer`` with a seq2seq
   cross entropy: the loss must fall, K1's relative-bias mode with lse must
   launch for every self-attention and K1/K4/K5 for every cross-attention;
   the 2+2-layer cut's gradient (fp32 on the card) must match the CPU's on
   every parameter, both ``rel_embedding`` tables included;
11. ops and CLI: K7 (``fused_softmax``: attention scores (4, 12, 2048, 2048)
   bf16, GPT-2's vocabulary row (8, 1024, 50257) fp32) and K8 (GPT-2
   medium's LayerNorm (8, 1024, 1024) bf16, Llama-2-7B's RMSNorm (8, 2048,
   4096) bf16), with small and ragged rows, against their plain versions
   and timed against torch.softmax / F.layer_norm / F.rms_norm; the
   LayerNorm backward on the card against the CPU; ``paged_attention`` (the
   B14 entry on K3) at GPT-2 medium (int8 rank-5 pool) and Llama-2-7B
   decode (bf16 pool, lengths to 4096) against its plain version; then the
   main path: the public ops at those shapes (every kind of
   ``apply_nonlinearity``, ``paged_attention_auto`` must take K3, the
   quantization round trip of GPT-2 medium's K/V) and the CLI in process
   (``calibrate`` with every gate passing, ``benchmark``, ``serve-bench``,
   ``device-info --json``), each path counted from 0; K7, K8 in both modes
   and the B14 entry must launch in the ops path;
12. shell path: the ops shell at full width, no kernel of its own, the
   engine under the heuristic: the workload balancer's 16 tasks (B8 S1024
   H16 D64 causal bf16, one local node) through the engine, each output
   bit-equal to a direct engine call; GPT-2 medium served (int8 pool,
   max_batch 4, ``examples/serve_gpt2.py``'s three prompts and one more,
   16 new tokens) beside a live ``MetricsServer`` on 127.0.0.1, its tokens
   equal to the serving path's engine's on the same prompts at max_batch 4
   (at the serving path's max_batch 8: the first tokens equal, the rest
   counted, each divergence's dense logit gap printed), ``/metrics``
   (the engine's and HBM's series) and ``/health`` read once, the health
   monitor's checks (one CUDA device, HBM use read from the card);
   ``ResilientAttentionWrapper`` around the engine (bit-equal), an
   injected ``KernelLaunchError`` raised three times with no last resort
   and no KERNEL_FAILURE rung, the next call launching K1, and the
   QUANT_ACCURACY rung moving a cross-attention call off K1's int8 modes
   onto K1 bf16 and back; ``AdaptiveOptimizer``'s profiled K1 beside its
   CUDA-event median, a cached hit launching nothing, the
   ``AdaptiveDecisionEngine``'s pick among the router's eligible kinds fed
   their measured times, beside the router's; the pipeline simulator's
   best tile on the card's record beside K1's time, the topology
   simulator's collective costs (NVSwitch, 1-8 cards) beside NCCL's
   world-1 times; ``ResearchBenchmark`` at GPT-2 medium's width; the
   sanitizer refusing a CUDA tensor with a NaN, ``sanitize_state_dict``
   passing GPT-2 medium on the card. K1 and K3's fused decode must launch.

After the serving path come the head-dim paths: ``gpt2_d80`` (GPT-2 at
Cerebras-GPT-2.7B's widths, d 80, served at 32 layers and trained at 4)
and ``gemma_d256`` (Llama at Gemma-2B's widths, d 256 over one KV head,
served at 18 layers through the llama path's checks: every Llama path's
prompts are redrawn off dense fp32 top-2 ties, its served logits held
against the dense fp32 forward and its chunked run's first tokens to the
whole prefill's). ``--head-dims`` runs only the head-dim
checks, timings and these two paths; ``--head-dim-table`` times the D 64
and D 128 rows the D 256 slice must not slow, then the D 256 rows, with
public calls (a copy of the script times another tree).

Every decode path (serving, durable, parallel, llama, T5, shell and the
CLI's ``serve-bench`` rows) runs its windows as the engine does on the
card: each decode step one replay of a CUDA graph, whose captured kernel
calls count as launches once a replay (``ops/_build.py::count_replays``),
so each path's launch checks count what the card ran. Each path holds the
graphed windows against an engine whose windows run eagerly
(``_eager_windows``: ``_window_eager``, the window's plain version) at the
same widths: greedy tokens bit-equal (the durable path's sampled runs
too), decode ms a step of both, the graphs' count, capture ms and pool
bytes printed (``check_window_graphs``); the serving path, Llama-2-7B and
T5 profile one window of each (the card's busy and idle share).

The device phase prints the card's idle draw before any work (the
roofline's static power); the engine phase each measured call's roofline
energy. The last lines are the per-kernel JSON summary (each kernel's launches in
all main paths together, and by path), the card's name and power limit
and, last of all, ``{"ok": true, "device": {...}}``. The script
imports nothing of JAX. ``--profile DIR`` adds a torch.profiler breakdown
of three single training steps and of one T5-large serving run (bf16
compute and pool) (device activity only: busy time, idle share of each
call's wall time, time by kernel group) and writes the traces and a
per-kernel table into DIR. ``--exp-table`` only builds and prints the exp
table (K13 in both exp modes, K14, K15, K16, K17 at unroll 2 and 4, K18
at each of its blocks and K19 at the mains' geometries by the graph fit,
beside K1 bf16, SDPA and the bound; then K18's int8-QK mode, the kernel
alone, at the int8 main's geometries beside K1's int8-QK kernel alone and
the bound; then K20, K21 and the whole call at the unrolled backward's
geometries and blocks beside K5 alone, K4 alone, K4 + K5, SDPA's backward
and the bound, with K20's levers: the other launch order and the chaining
off), ``--bwd-table`` only those backward rows and the copy table (K10
beside ``y.copy_(x)`` and K10's other rings), ``--probe-table`` only K12
in both modes (ms, elements/s, its bound, its SASS instructions a value)
and K1's share of the composite ceiling from the measured rates, with
public calls, so a copy of the script in an unpacked tree of another
commit times that tree. ``--sass-diff LIB`` compares the normalised SASS
of every Hopper attention instantiation and of the probes with another
build's.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import functools
import json
import re
import statistics
import subprocess
import time
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from photonic_flash_attention_tpu_torch.core.timing import fit_seconds, graph_ms
from photonic_flash_attention_tpu_torch.ops import _build
from photonic_flash_attention_tpu_torch.ops import flash as flash_ops
from photonic_flash_attention_tpu_torch.ops import flash_bwd as bwd_ops
from photonic_flash_attention_tpu_torch.ops import paged as paged_ops
from photonic_flash_attention_tpu_torch.ops.reference import DEFAULT_MASK_VALUE

#: K1's bf16 kernel (every mode the main paths run); fp32 stays in
#: csrc/flash_fwd.cu, the quantized modes are _QUANT90.
_FWD90 = "photonic_flash_attention_tpu_torch/csrc/flash_fwd_sm90.cu"
_PAGED = "photonic_flash_attention_tpu_torch/csrc/paged_decode.cu"
#: K3 in every mode and the fused decode (K2's write folded in); K2 alone
#: stays in _PAGED.
_PAGED90 = "photonic_flash_attention_tpu_torch/csrc/paged_decode_sm90.cu"
_BWD = "photonic_flash_attention_tpu_torch/csrc/flash_bwd.cu"
#: K4/K5's bf16 kernels (every mode the main paths run); fp32 stays in _BWD.
_BWD90 = "photonic_flash_attention_tpu_torch/csrc/flash_bwd_sm90.cu"
#: K1's quantized modes and K6: one Hopper body (TMA, 8-bit wgmma).
_QUANT90 = "photonic_flash_attention_tpu_torch/csrc/flash_quant_sm90.cu"
_ROWNORM = "photonic_flash_attention_tpu_torch/csrc/rownorm.cu"
_PROBES = "photonic_flash_attention_tpu_torch/csrc/probes.cu"
_EXPERIMENTS = "photonic_flash_attention_tpu_torch/csrc/flash_experiments.cu"
#: K13-K19's bf16 body (TMA, wgmma); K16-K19's fp32 inputs stay on the
#: mma.sync bodies of _EXPERIMENTS.
_EXPERIMENTS90 = "photonic_flash_attention_tpu_torch/csrc/flash_experiments_sm90.cu"
#: K20's and K21's fp32 inputs (in bf16 K20 is K5's body and K21 K4's,
#: _BWD90).
_BWD_EXPERIMENTS = "photonic_flash_attention_tpu_torch/csrc/flash_bwd_experiments.cu"
_B1 = "photonic_flash_attention_tpu/ops/flash.py:59"
#: Every kernel and mode (the launch counter's name): its source.
SOURCES = {
    "pfa_flash_fwd_dropout": _FWD90,
    "pfa_flash_bwd_dkv_dropout": _BWD90,
    "pfa_flash_bwd_dq_dropout": _BWD90,
    "pfa_flash_fwd_relbias_lse": _FWD90,
    "pfa_flash_fwd_alibi_lse": _FWD90,
    "pfa_flash_fwd_window": _FWD90,
    "pfa_flash_bwd_dkv_window": _BWD90,
    "pfa_flash_bwd_dq_window": _BWD90,
    "pfa_flash_fwd_relbias": _FWD90,
    "pfa_flash_fwd_alibi": _FWD90,
    "pfa_flash_fwd_densebias": _FWD90,
    "pfa_paged_decode_attend_tbias": _PAGED90,
    "pfa_paged_decode_fused_tbias": _PAGED90,
    "pfa_flash_fwd": _FWD90,
    "pfa_flash_fwd_streams": _FWD90,
    "pfa_paged_token_write": _PAGED,
    "pfa_paged_decode_fused": _PAGED90,
    "pfa_paged_decode_attend": _PAGED90,
    "pfa_paged_hf": _PAGED90,
    "pfa_paged_hf_int8": _PAGED90,
    "pfa_flash_bwd_dkv": _BWD90,
    "pfa_flash_bwd_dq": _BWD90,
    "pfa_flash_fwd_int8qk": _QUANT90,
    "pfa_flash_fwd_fp8qk": _QUANT90,
    "pfa_flash_fwd_int8full": _QUANT90,
    "pfa_flash_quant_fp8": _QUANT90,
    "pfa_flash_quant_int8": _QUANT90,
    "pfa_softmax": _ROWNORM,
    "pfa_layer_norm": _ROWNORM,
    "pfa_rms_norm": _ROWNORM,
    "pfa_paged_attention": _PAGED90,
    "pfa_hbm_read": _PROBES,
    "pfa_hbm_copy": _PROBES,
    "pfa_exp_probe": _PROBES,
    "pfa_softmax_probe": _PROBES,
    "pfa_softmax_probe_unmasked": _PROBES,
    "pfa_flash_fixedmax": _EXPERIMENTS90,
    "pfa_flash_fixedmax_fast": _EXPERIMENTS90,
    "pfa_flash_aug": _EXPERIMENTS90,
    "pfa_flash_pair": _EXPERIMENTS90,
    "pfa_flash_pipelined": _EXPERIMENTS90,
    "pfa_flash_pipelined_fp32": _EXPERIMENTS,
    "pfa_flash_chunked": _EXPERIMENTS90,
    "pfa_flash_chunked_fp32": _EXPERIMENTS,
    "pfa_flash_tri": _EXPERIMENTS90,
    "pfa_flash_tri_fp32": _EXPERIMENTS,
    "pfa_flash_tri_i8": _QUANT90,
    "pfa_flash_tri_i8_fp32": _EXPERIMENTS,
    "pfa_flash_fulltri": _EXPERIMENTS90,
    "pfa_flash_fulltri_fp32": _EXPERIMENTS,
    "pfa_flash_bwd_dq_rowblock": _BWD90,
    "pfa_flash_bwd_dq_rowblock_fp32": _BWD_EXPERIMENTS,
    "pfa_flash_bwd_dkv_colblock": _BWD90,
    "pfa_flash_bwd_dkv_colblock_fp32": _BWD_EXPERIMENTS,
}
#: The kernels and entries of the ops-and-CLI phase (measured there).
OPS_KERNELS = ("pfa_softmax", "pfa_layer_norm", "pfa_rms_norm", "pfa_paged_attention")
_B3 = "photonic_flash_attention_tpu/ops/flash_bwd.py"
_B11 = "photonic_flash_attention_tpu/ops/nonlinearity.py"
REPLACES = {
    "pfa_flash_fwd_dropout": f"{_B1} (seed_ref :372-391)",
    "pfa_flash_bwd_dkv_dropout": f"{_B3}:167 (seed_ref, _dropout_mscale_t :144)",
    "pfa_flash_bwd_dq_dropout": f"{_B3}:248 (seed_ref, _dropout_mscale_t :144)",
    "pfa_flash_fwd_relbias_lse": f"{_B1} (tab_ref, t5, lse_ref), photonic_flash_attention_tpu/ops/flash.py:1446",
    "pfa_flash_fwd_alibi_lse": f"{_B1} (tab_ref, alibi, lse_ref)",
    "pfa_flash_fwd_window": f"{_B1} (window :139-154, :309-327, banded grid :478-491)",
    "pfa_flash_bwd_dkv_window": f"{_B3}:167 (window, _tile_masks :59)",
    "pfa_flash_bwd_dq_window": f"{_B3}:248 (window, _tile_masks :59)",
    "pfa_flash_fwd_relbias": f"{_B1} (tab_ref, t5), photonic_flash_attention_tpu/ops/flash.py:1092",
    "pfa_flash_fwd_alibi": f"{_B1} (tab_ref, alibi)",
    "pfa_flash_fwd_densebias": f"{_B1} (qkbias_ref)",
    "pfa_paged_decode_attend_tbias": "photonic_flash_attention_tpu/ops/paged.py:407 (bias_ref)",
    "pfa_paged_decode_fused_tbias": "photonic_flash_attention_tpu/ops/paged.py:407 (bias_ref)",
    "pfa_flash_fwd": "photonic_flash_attention_tpu/ops/flash.py:59, "
                     "photonic_flash_attention_tpu/ops/flash_unrolled.py:144",
    "pfa_flash_fwd_streams": "photonic_flash_attention_tpu/ops/flash.py:59, "
                             "photonic_flash_attention_tpu/ops/flash_unrolled.py:144",
    "pfa_paged_token_write": "photonic_flash_attention_tpu/ops/paged.py:407",
    "pfa_paged_decode_fused": "photonic_flash_attention_tpu/ops/paged.py:407",
    "pfa_paged_decode_attend": "photonic_flash_attention_tpu/ops/paged.py:407",
    "pfa_paged_hf": "photonic_flash_attention_tpu/ops/paged.py:902",
    "pfa_paged_hf_int8": "photonic_flash_attention_tpu/ops/paged.py:902",
    "pfa_flash_bwd_dkv": "photonic_flash_attention_tpu/ops/flash_bwd.py:167, "
                         "photonic_flash_attention_tpu/ops/flash_bwd.py:609",
    "pfa_flash_bwd_dq": "photonic_flash_attention_tpu/ops/flash_bwd.py:248, "
                        "photonic_flash_attention_tpu/ops/flash_bwd.py:569",
    "pfa_flash_fwd_int8qk": f"{_B1}, photonic_flash_attention_tpu/ops/flash_unrolled.py:144",
    "pfa_flash_fwd_fp8qk": _B1,
    "pfa_flash_fwd_int8full": _B1,
    "pfa_flash_quant_fp8": "photonic_flash_attention_tpu/ops/flash_fp8.py:81",
    "pfa_flash_quant_int8": "photonic_flash_attention_tpu/ops/flash_fp8.py:81",
    "pfa_softmax": f"{_B11}:76",
    "pfa_layer_norm": f"{_B11}:136",
    "pfa_rms_norm": f"{_B11}:136 (rms)",
    "pfa_paged_attention": "photonic_flash_attention_tpu/ops/paged.py:101",
    "pfa_hbm_read": "photonic_flash_attention_tpu/ops/hbm_bw.py:45",
    "pfa_hbm_copy": "photonic_flash_attention_tpu/ops/hbm_bw.py:98",
    "pfa_exp_probe": "photonic_flash_attention_tpu/ops/device_probes.py:35",
    "pfa_softmax_probe": "photonic_flash_attention_tpu/ops/device_probes.py:76",
    "pfa_softmax_probe_unmasked": "photonic_flash_attention_tpu/ops/device_probes.py:76 "
                                  "(masked=False)",
    "pfa_flash_fixedmax": "benchmarks/flash_fixedmax_experiment.py:45",
    "pfa_flash_fixedmax_fast": "benchmarks/flash_fixedmax_experiment.py:45 (fast_exp)",
    "pfa_flash_aug": "benchmarks/flash_aug_experiment.py:28",
    "pfa_flash_pair": "benchmarks/flash_pair_experiment.py:28",
    "pfa_flash_pipelined": "benchmarks/flash_pipeline_experiment.py:49",
    "pfa_flash_pipelined_fp32": "benchmarks/flash_pipeline_experiment.py:49 (fp32 inputs)",
    "pfa_flash_chunked": "benchmarks/flash_pipeline_experiment.py:226",
    "pfa_flash_chunked_fp32": "benchmarks/flash_pipeline_experiment.py:226 (fp32 inputs)",
    "pfa_flash_tri": "benchmarks/flash_pipeline_experiment.py:407",
    "pfa_flash_tri_fp32": "benchmarks/flash_pipeline_experiment.py:407 (fp32 inputs)",
    "pfa_flash_tri_i8": "benchmarks/flash_pipeline_experiment.py:548",
    "pfa_flash_tri_i8_fp32": "benchmarks/flash_pipeline_experiment.py:548 (fp32 V)",
    "pfa_flash_fulltri": "benchmarks/flash_pipeline_experiment.py:821",
    "pfa_flash_fulltri_fp32": "benchmarks/flash_pipeline_experiment.py:821 (fp32 inputs)",
    "pfa_flash_bwd_dq_rowblock": "benchmarks/flash_bwd_unrolled_experiment.py:41",
    "pfa_flash_bwd_dq_rowblock_fp32": "benchmarks/flash_bwd_unrolled_experiment.py:41 "
                                      "(fp32 inputs)",
    "pfa_flash_bwd_dkv_colblock": "benchmarks/flash_bwd_unrolled_experiment.py:83",
    "pfa_flash_bwd_dkv_colblock_fp32": "benchmarks/flash_bwd_unrolled_experiment.py:83 "
                                       "(fp32 inputs)",
}
#: Modes that no main path runs, reported under their kernel's entry (main
#: fails if one of them launches there): K3's int8 compute (engine decode
#: repacks bf16 K/V; serving decode is K3's float mode over the int8 pool),
#: K3's read-only attend (with and without the token bias) and K2 alone
#: (serving decodes through K3's fused write + attend),
#: ALiBi (no model of the port uses it), the sliding window of K1, K4
#: and K5 (no model of the port sets one) and K16-K19's, K20's and K21's fp32
#: inputs and K18 int8's fp32 V (the experiments' mains run bf16; their
#: mma.sync bodies are checked and timed in the experiments phase). K6's int8 mode has its own entry: the
#: CLI's ``calibrate`` runs it.
NESTED_MODES = {"pfa_paged_hf_int8": ("pfa_paged_hf", "int8_compute"),
                "pfa_paged_decode_attend": ("pfa_paged_decode_fused", "attend_only"),
                "pfa_paged_decode_attend_tbias": ("pfa_paged_decode_fused_tbias", "attend_only"),
                "pfa_paged_token_write": ("pfa_paged_decode_fused", "write_only (K2)"),
                "pfa_flash_fwd_alibi": ("pfa_flash_fwd_relbias", "alibi"),
                "pfa_flash_fwd_alibi_lse": ("pfa_flash_fwd_relbias_lse", "alibi"),
                "pfa_flash_fwd_window": ("pfa_flash_fwd", "window"),
                "pfa_flash_bwd_dkv_window": ("pfa_flash_bwd_dkv", "window"),
                "pfa_flash_bwd_dq_window": ("pfa_flash_bwd_dq", "window"),
                "pfa_flash_pipelined_fp32": ("pfa_flash_pipelined", "fp32 (mma.sync body)"),
                "pfa_flash_chunked_fp32": ("pfa_flash_chunked", "fp32 (mma.sync body)"),
                "pfa_flash_tri_fp32": ("pfa_flash_tri", "fp32 (mma.sync body)"),
                "pfa_flash_tri_i8_fp32": ("pfa_flash_tri_i8", "fp32 V (mma.sync body)"),
                "pfa_flash_fulltri_fp32": ("pfa_flash_fulltri", "fp32 (mma.sync body)"),
                "pfa_flash_bwd_dq_rowblock_fp32": ("pfa_flash_bwd_dq_rowblock",
                                                   "fp32 (mma.sync body)"),
                "pfa_flash_bwd_dkv_colblock_fp32": ("pfa_flash_bwd_dkv_colblock",
                                                    "fp32 (mma.sync body)")}
TIMED_RUNS = 20
# H100 SXM data sheet (dense, at its 700 W limit): the bound of each kernel
# is the larger of its operations over the peak rate for their type and
# its bytes (each input read once, each output written once) over HBM.
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12, torch.int8: 1979e12,
            torch.float8_e4m3fn: 1979e12}
HBM_BYTES_PER_S = 3.35e12


def card_bound(ops: float, nbytes: float, dtype) -> dict:
    """bound_ms and bound_by for ``ops`` operations of ``dtype`` and
    ``nbytes`` bytes of device memory traffic."""
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def attention_pairs(b: int, sq: int, skv: int, causal: bool, lens=None, window=None) -> int:
    """(query, key) pairs the kernel computes: keys below each row's
    length, inside the window (lo, hi) on rel = col - (row + Skv - Sq) and,
    when causal, on or below the end-aligned diagonal."""
    lo, hi = window if window is not None else (None, None)
    if causal:
        hi = 0 if hi is None else min(hi, 0)
    lens = [skv] * b if lens is None else [min(max(int(n), 0), skv) for n in lens]
    rows = torch.arange(sq, dtype=torch.int64) + (skv - sq)
    first = torch.zeros_like(rows) if lo is None else (rows + lo).clamp(min=0)
    total = 0
    for n in lens:
        last = torch.full_like(rows, n - 1) if hi is None else (rows + hi).clamp(max=n - 1)
        total += int((last - first + 1).clamp(min=0).sum())
    return total


def flash_fwd_bound(q, k, causal, lens=None, with_lse=False, with_bias=False, window=None) -> dict:
    """K1's bound: 4 D operations per (query, key) pair; q, o and the K/V
    rows below each length, plus lse and the streams when present."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    pairs = attention_pairs(b, sq, skv, causal, lens, window)
    kv_rows = b * skv if lens is None else sum(min(max(int(n), 0), skv) for n in lens)
    elt = q.element_size()
    nbytes = elt * (2 * b * sq * hq * d + 2 * kv_rows * hkv * d)
    nbytes += 4 * b * hq * sq * with_lse + 4 * b * skv * with_bias + 4 * b * (lens is not None)
    return card_bound(4.0 * d * hq * pairs, nbytes, q.dtype)


def sdpa_bwd_ms(q, k, v, do, **kw) -> float:
    """The backward of one F.scaled_dot_product_attention call (dq, dk and
    dv together; causal unless ``kw`` says otherwise), its forward outside
    the timing."""
    import torch.nn.functional as F

    leaves = [t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves, **(kw or dict(is_causal=True)))
    g = do.transpose(1, 2).contiguous()
    return median_ms(lambda: torch.autograd.grad(out, leaves, g, retain_graph=True))


def sdpa_ms(q, k, v, causal: bool, bias=None, scale=None, dropout_p: float = 0.0) -> float:
    """One F.scaled_dot_product_attention call on the same function, in its
    (B, H, S, D) layout (the transposes are outside the timing); with
    ``dropout_p`` it draws its own mask, not the port's."""
    import torch.nn.functional as F

    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    if bias is None:
        return median_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                                scale=scale, dropout_p=dropout_p))
    return median_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=bias, scale=scale))


def rel_err_norm(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float(torch.linalg.norm(a - b) / max(float(torch.linalg.norm(b)), 1e-9))


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def median_ms(fn, runs: int = TIMED_RUNS, warmup: int = 3) -> float:
    """Median CUDA-event time of ``fn`` over ``runs`` launches."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, runs: int = TIMED_RUNS, warmup: int = 3) -> float:
    """Device time of one call of ``fn``: CUDA events around ``runs``
    back-to-back calls, so the host's launch overhead hides behind the
    queue (for kernels that finish before the host can launch the next)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / runs


def nvidia_smi(query: str, *, units: bool = True) -> str:
    """The first card's ``nvidia-smi --query-gpu=<query>`` line."""
    fmt = "csv,noheader" if units else "csv,noheader,nounits"
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", f"--format={fmt}"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def phase_device() -> str:
    """The card's name and power limit; its idle draw, read before any work
    (the roofline's static power, ``hardware/roofline.py::STATIC_POWER_W``)."""
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: chip_smoke.py runs only on a GPU")
    smi = nvidia_smi("name,power.limit")
    idle = nvidia_smi("power.draw,clocks.sm,clocks.max.sm,temperature.gpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    print(f"device: idle before any work: power.draw, clocks.sm, clocks.max.sm, temperature: "
          f"{idle}", flush=True)
    return smi


def phase_build(sass: bool = True) -> None:
    t0 = time.perf_counter()
    path = _build.build()
    _build.lib()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {path.name}", flush=True)
    if not sass:
        return
    t0 = time.perf_counter()
    counts, usage = sm90_sass(path)
    check_k1_sass(counts, usage)
    check_bwd_sass(counts, usage)
    check_quant_sass(counts, usage)
    check_exp_sass(counts, usage)
    check_k10_sass(counts, usage)
    check_k3_sass(path)
    print(f"K1 SASS, K4/K5 SASS, quant SASS, exp SASS, K10 SASS, K3 SASS: checked in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)


#: K1's bf16 kernel in the library: one instantiation per head dim and mode
#: (csrc/flash_fwd_sm90.cuh::K1Mode, in this order).
K1_SM90 = re.compile(r"flash_fwd_sm90ILi(\d+)ELi(\d)E")
K1_MODES = ("plain", "streams", "rel", "dense", "window", "dropout")
#: The modes K1 is also compiled for at D 256: the bf16 K1 entries of
#: ops/_build.py::WIDE_KERNELS (csrc/flash_fwd_sm90.cu::wide_mode is the C
#: side's statement of the same).
K1_WIDE_MODES = tuple(sorted(K1_MODES.index(name.split()[1] if " " in name else "plain")
                             for name, elts in _build.WIDE_KERNELS.items()
                             if name.split()[0] == "K1" and 2 in elts))
#: K4's and K5's bf16 kernels: one instantiation per kernel, head dim and
#: stream mode (csrc/flash_bwd_sm90.cuh::StreamMode, in this order); K21's
#: is K4's plain one with COLBLOCK true (``Lb1E``), K20's K5's with
#: ROWBLOCK true.
BWD_SM90 = re.compile(r"flash_bwd_(dkv|dq)_sm90ILi(\d+)ELi(\d)E(Lb1E)?")
BWD_MODES = ("plain", "window", "dropout")
#: The quantized forward (K1's 8-bit modes and K6): one instantiation per
#: head dim and mode (csrc/flash_quant_sm90.cu::QuantMode, in this order),
#: and the GMMA kinds each must hold (cuobjdump's names: IGMMA s8, QGMMA
#: e4m3, HGMMA bf16/f16): Q.K^T in its payload type, P.V in bf16 or 8-bit;
#: K6 fp8's Q.K^T runs in f16 over widened e4m3 (its sums must be fp32).
#: K18 int8's is the int8-QK one with ROWBLOCK true (``Lb1E``), keyed
#: ("K18i8", D, 0).
QUANT_SM90 = re.compile(r"flash_quant_sm90ILi(\d+)ELi(\d)E(Lb1E)?")
QUANT_SASS_MODES = (("int8-QK", {"IGMMA", "HGMMA"}), ("fp8-QK", {"QGMMA", "HGMMA"}),
                    ("int8-full", {"IGMMA"}), ("K6 int8", {"IGMMA"}), ("K6 fp8", {"HGMMA", "QGMMA"}))
GMMA_OPS = ("HGMMA", "IGMMA", "QGMMA")
#: K16-K19's bf16 body: one instantiation per head dim and unroll (0: K19,
#: 1: K16 and K18; csrc/flash_experiments_sm90.cu::flash_exp_sm90<D, U>).
EXP_SM90 = re.compile(r"flash_exp_sm90ILi(\d+)ELi(\d)E")
EXP_UNROLLS = (0, 1, 2, 4)
EXP_LABELS = {0: "K19", 1: "K16/K18", 2: "K17 unroll 2", 4: "K17 unroll 4"}
#: K14's and K15's instantiations of the same body (D 64): flash_aug_sm90,
#: flash_pair_sm90<nchain>; keyed ("aug_pair", 64, nchain), nchain 0 for K14.
AUG_PAIR_SM90 = re.compile(r"flash_(aug|pair)_sm90(?:ILi(\d)E)?")
#: K13's instantiations (flash_fixedmax_sm90<D, FAST>); keyed ("fixed", D,
#: 1 in the fast_exp mode).
FIXED_SM90 = re.compile(r"flash_fixedmax_sm90ILi(\d+)ELb([01])E")
#: The probes K9-K12 (csrc/probes.cu): keyed ("probe", 0, n) with n 0 for
#: K9, 1 K11, 2 K10's ring (3 its parent's grid-stride body), and K12's
#: instantiations ("probe", columns, 1 masked).
PROBE_SASS = re.compile(r"\d(hbm_read|exp_chain|hbm_copy_ring|hbm_copy)E|"
                        r"softmax_streamILi(\d+)ELi(\d+)ELb([01])E")
PROBE_KERNELS = ("hbm_read", "exp_chain", "hbm_copy_ring", "hbm_copy")
#: The instantiations ``--sass-diff`` compares: every Hopper attention body
#: and the probes.
SASS_DIFF_KINDS = ("K1", "K4", "K5", "K20", "K21", "quant", "K18i8", "exp", "aug_pair", "fixed",
                   "probe", "K3")


@functools.lru_cache(maxsize=None)
def _cuobjdump(flag: str, path: Path) -> str:
    """``cuobjdump flag path``'s output, dumped once a library: the SASS
    checks all read the same dump."""
    return subprocess.run(["cuobjdump", flag, str(path)], check=True, capture_output=True,
                          text=True).stdout


def _sm90_key(name: str):
    """(kind, D, mode) of a Hopper kernel instantiation's name: kind "K1",
    "K4", "K5", "K20", "K21", "quant", "K18i8", "exp", "aug_pair", "fixed",
    "probe" (PROBE_SASS) or "K3" (its mode a string: pool, heads a CTA, int8
    compute, narrower head dims)."""
    if m := K3_SM90.search(name):
        return "K3", int(m.group(2)), (f"{K3_POOLS[m.group(1)]} {m.group(3)}h"
                                       f"{' i8c' if m.group(4) == '1' else ''}"
                                       f"{'' if m.group(5) == '1' else ' narrow'}")
    if m := K1_SM90.search(name):
        return "K1", int(m.group(1)), int(m.group(2))
    if m := BWD_SM90.search(name):
        kind = {"dkv": "K4", "dq": "K5"}[m.group(1)]
        if m.group(4):
            kind = "K21" if kind == "K4" else "K20"
        return kind, int(m.group(2)), int(m.group(3))
    if m := FIXED_SM90.search(name):
        return "fixed", int(m.group(1)), int(m.group(2))
    if m := QUANT_SM90.search(name):
        return "K18i8" if m.group(3) else "quant", int(m.group(1)), int(m.group(2))
    if m := EXP_SM90.search(name):
        return "exp", int(m.group(1)), int(m.group(2))
    if m := AUG_PAIR_SM90.search(name):
        return "aug_pair", 64, int(m.group(2) or 0)
    if m := PROBE_SASS.search(name):
        if m.group(1):
            return "probe", 0, PROBE_KERNELS.index(m.group(1))
        return "probe", int(m.group(2)) * int(m.group(3)), int(m.group(4))
    return None


def sm90_sass(path: Path) -> tuple:
    """Every Hopper instantiation's GMMA (wgmma: HGMMA, IGMMA, QGMMA),
    UTMALDG (TMA load) and HMMA/IMMA (mma.sync) counts in the built
    library's SASS (``cuobjdump -sass``) and its registers, stack, shared
    and local bytes (``cuobjdump -res-usage``; stack = spills), keyed by
    ``_sm90_key``."""
    ops = (*GMMA_OPS, "UTMALDG", "UBLKCP", "HMMA", "IMMA")
    op_re = re.compile(rf"\b({'|'.join(ops)})\b")
    counts, cur = {}, None
    for line in _cuobjdump("-sass", path).splitlines():
        if "Function :" in line:
            cur = _sm90_key(line)
            if cur:
                counts[cur] = collections.Counter(dict.fromkeys(ops, 0))
        elif cur:
            counts[cur].update(op_re.findall(line))
    usage = {}
    for m in re.finditer(r"Function ([^\s:]+):\s*REG:(\d+) STACK:(\d+) SHARED:(\d+) LOCAL:(\d+)",
                         _cuobjdump("-res-usage", path)):
        if key := _sm90_key(m.group(1)):
            usage[key] = tuple(int(x) for x in m.groups()[1:])
    return counts, usage


#: K3's instantiations (csrc/paged_decode_sm90.cu::k3_kernel<pool, D,
#: heads a CTA, int8 compute, head dim D>): 3 pools x 2 widths (D 64, 128)
#: and the pools ops/_build.py::WIDE_KERNELS gives K3 at D 256, and the
#: int8 pool's int8-compute mode at each width that takes int8; each x 2
#: head counts, and for a head dim of the width and for a narrower one.
K3_SM90 = re.compile(r"k3_kernelI(a|f|13__nv_bfloat16)Li(\d+)ELi(\d+)ELb([01])ELb([01])E")
K3_POOLS = {"a": "int8", "f": "fp32", "13__nv_bfloat16": "bf16"}
K3_INSTANTIATIONS = 2 * 2 * (3 * 2 + len(_build.WIDE_KERNELS["K3"])
                             + 2 + (1 in _build.WIDE_KERNELS["K3"]))


def check_k3_sass(path: Path) -> None:
    """Proof that every K3 instantiation stages its pages by the TMA's bulk
    copy (UBLKCP in the SASS) and waits on mbarriers (SYNCS): prints each
    one's counts, registers and stack; all K3_INSTANTIATIONS must be there,
    each with a bulk copy and no stack."""
    op_re = re.compile(r"\b(UBLKCP|SYNCS)\b")
    ops, cur = {}, None
    for line in _cuobjdump("-sass", path).splitlines():
        if "Function :" in line:
            m = K3_SM90.search(line)
            cur = (K3_POOLS[m.group(1)], int(m.group(2)), int(m.group(3)), m.group(4) == "1",
                   m.group(5) == "1") if m else None
            if cur:
                ops[cur] = collections.Counter(UBLKCP=0, SYNCS=0)
        elif cur:
            ops[cur].update(op_re.findall(line))
    usage = {}
    for m in re.finditer(r"Function ([^\s:]+):\s*REG:(\d+) STACK:(\d+)", _cuobjdump("-res-usage", path)):
        if k := K3_SM90.search(m.group(1)):
            usage[(K3_POOLS[k.group(1)], int(k.group(2)), int(k.group(3)), k.group(4) == "1",
                   k.group(5) == "1")] = (int(m.group(2)), int(m.group(3)))
    for key in sorted(ops):
        pool, d, heads, i8c, full = key
        reg, stack = usage.get(key, (-1, -1))
        line = (f"K3 SASS {pool} pool D{d}{'' if full else ' (narrower head dims)'} {heads} "
                f"head(s) a CTA{' int8 compute' if i8c else ''}: "
                f"UBLKCP {ops[key]['UBLKCP']}, SYNCS {ops[key]['SYNCS']}, {reg} registers, "
                f"stack {stack}")
        print(line, flush=True)
        if not ops[key]["UBLKCP"] or stack != 0:
            raise AssertionError(f"{line}: no bulk copy, or a stack")
    if len(ops) != K3_INSTANTIATIONS:
        raise AssertionError(f"K3 SASS: {len(ops)} instantiations found, expected "
                             f"{K3_INSTANTIATIONS}")


def check_k1_sass(counts: dict, usage: dict) -> None:
    """Proof that every bf16 K1 instantiation is the Hopper design: each
    must hold HGMMA and UTMALDG and no HMMA. Prints each one's counts, its
    registers and stack bytes and, from the kernel's own constants, keys a
    tile, dynamic shared memory, threads and CTAs a SM."""
    import ctypes

    want = {("K1", d, mode) for d in (64, 128) for mode in range(len(K1_MODES))}
    want |= {("K1", 256, mode) for mode in K1_WIDE_MODES}
    got = {key for key in counts if key[0] == "K1"}
    if got != want:
        raise AssertionError(f"K1 SASS: bf16 instantiations {sorted(got)}, want {sorted(want)}")
    for _, d, mode in sorted(want):
        c = counts[("K1", d, mode)]
        info = (ctypes.c_int * 7)()
        err = _build.lib().pfa_k1_sm90_info(d, mode, info)
        if err:
            raise RuntimeError(f"pfa_k1_sm90_info: CUDA error {err}")
        reg = usage.get(("K1", d, mode))
        line = (f"K1 SASS D{d} {K1_MODES[mode]}: HGMMA {c['HGMMA']}, UTMALDG {c['UTMALDG']}, "
                f"HMMA {c['HMMA']}; " + (f"registers {reg[0]} at launch (setmaxnreg: producer "
                                         f"{info[5]}, consumers {info[6]}), stack {reg[1]} B, "
                                         f"local {reg[3]} B"
                                         if reg else "cuobjdump -res-usage: no entry") +
                f"; {info[0]}-key tiles, {info[4]} stages, {info[1]} B shared, {info[2]} threads, "
                f"{info[3]} CTA(s) a SM")
        if not c["HGMMA"] or not c["UTMALDG"] or c["HMMA"]:
            raise AssertionError(f"{line}: the bf16 kernel must run on wgmma and TMA only")
        print(line, flush=True)


def check_bwd_sass(counts: dict, usage: dict) -> None:
    """The same proof for K4 and K5 (every bf16 instantiation: D 64 and
    128, each stream mode), K21 (K4's plain body with its key range and
    chained launches, D 64 and 128) and K20 (K5's plain body with its row
    range and chained launches): each must hold HGMMA and UTMALDG, no HMMA,
    and no stack (no spills). Prints the counts, registers, stack and local
    bytes and, from ``pfa_bwd_sm90_info`` (K21: K4's plain design, K20:
    K5's), the work tile, the ring's tile and stages, shared memory,
    threads and CTAs a SM."""
    import ctypes

    kinds = ("K4", "K5", "K20", "K21")
    want = ({(k, d, mode) for k in ("K4", "K5") for d in (64, 128)
             for mode in range(len(BWD_MODES))} | {(k, d, 0) for k in ("K20", "K21")
                                                   for d in (64, 128)})
    got = {key for key in counts if key[0] in kinds}
    if got != want:
        raise AssertionError(f"K4/K5 SASS: bf16 instantiations {sorted(got)}, want {sorted(want)}")
    rows = {"K4": ("key", "query"), "K5": ("query", "key"), "K20": ("query", "key"),
            "K21": ("key", "query")}
    for kern, d, mode in sorted(want):
        c = counts[(kern, d, mode)]
        info = (ctypes.c_int * 16)()
        err = _build.lib().pfa_bwd_sm90_info(d, mode, info)
        if err:
            raise RuntimeError(f"pfa_bwd_sm90_info: CUDA error {err}")
        i = info[0:8] if kern in ("K4", "K21") else info[8:16]
        reg = usage.get((kern, d, mode))
        line = (f"K4/K5 SASS {kern} D{d} {BWD_MODES[mode]}: HGMMA {c['HGMMA']}, UTMALDG "
                f"{c['UTMALDG']}, HMMA {c['HMMA']}; " +
                (f"registers {reg[0]} at launch (setmaxnreg: producer {i[6]}, consumers {i[7]}), "
                 f"stack {reg[1]} B, local {reg[3]} B" if reg else "cuobjdump -res-usage: no entry") +
                f"; {i[0]}-{rows[kern][0]} work tiles, {i[1]}-{rows[kern][1]} ring tiles, {i[5]} "
                f"stages, {i[2]} B shared, {i[3]} threads, {i[4]} CTA(s) a SM")
        if not c["HGMMA"] or not c["UTMALDG"] or c["HMMA"] or not reg or reg[1] or reg[3]:
            raise AssertionError(f"{line}: the bf16 kernel must run on wgmma and TMA only, "
                                 "with no stack")
        print(line, flush=True)


def check_quant_sass(counts: dict, usage: dict) -> None:
    """The same proof for the quantized forward (K1's int8-QK, fp8-QK and
    int8-full modes, K6 int8 and fp8, and K18's int8 mode, the int8-QK
    body with its row range; D 64 and 128): each instantiation must hold
    exactly the GMMA kinds of its mode (QUANT_SASS_MODES) and UTMALDG, no
    HMMA or IMMA, and no stack or local bytes. Prints the counts,
    registers, stack and, from ``pfa_quant_sm90_info`` /
    ``pfa_flash_tri_i8_sm90_info``, the key tile, ring stages, shared
    memory, threads, CTAs a SM, the setmaxnreg split and whether tile j's
    Q.K^T overlaps tile j-1's P.V."""
    import ctypes

    want = {("quant", d, mode) for d in (64, 128) for mode in range(len(QUANT_SASS_MODES))}
    want |= {("K18i8", d, 0) for d in (64, 128)}
    got = {key for key in counts if key[0] in ("quant", "K18i8")}
    if got != want:
        raise AssertionError(f"quant SASS: instantiations {sorted(got)}, want {sorted(want)}")
    for kind, d, mode in sorted(want):
        c = counts[(kind, d, mode)]
        name, kinds = QUANT_SASS_MODES[mode]
        info = (ctypes.c_int * 8)()
        if kind == "K18i8":
            name = "K18 int8-QK (row range, chained)"
            err = _build.lib().pfa_flash_tri_i8_sm90_info(d, info)
        else:
            err = _build.lib().pfa_quant_sm90_info(d, mode, info)
        if err:
            raise RuntimeError(f"quant SASS D{d} {name}: info CUDA error {err}")
        reg = usage.get((kind, d, mode))
        line = (f"quant SASS D{d} {name}: " + ", ".join(f"{op} {c[op]}" for op in GMMA_OPS) +
                f", UTMALDG {c['UTMALDG']}, HMMA {c['HMMA']}, IMMA {c['IMMA']}; " +
                (f"registers {reg[0]} at launch (setmaxnreg: producer {info[5]}, consumers "
                 f"{info[6]}), stack {reg[1]} B, local {reg[3]} B" if reg
                 else "cuobjdump -res-usage: no entry") +
                f"; {info[0]}-key tiles, {info[4]} stages, {info[1]} B shared, {info[2]} threads, "
                f"{info[3]} CTA(s) a SM, Q.K^T over P.V overlap {'on' if info[7] else 'off'}")
        if ({op for op in GMMA_OPS if c[op]} != kinds or not c["UTMALDG"] or c["HMMA"] or c["IMMA"]
                or not reg or reg[1] or reg[3]):
            raise AssertionError(f"{line}: must run on {sorted(kinds)} and TMA only, with no stack")
        print(line, flush=True)


def check_exp_sass(counts: dict, usage: dict) -> None:
    """The same proof for the experiments' bf16 body: K16-K19 (K16 and K18,
    K17 at unroll 2 and 4, K19; D 64 and 128), K13 (both exp modes, D 64
    and 128), K14 and K15 at every nchain of ``CARD_NCHAINS``. Each
    instantiation must hold HGMMA and UTMALDG, no HMMA, and no stack or
    local bytes. Prints the counts, registers, stack and, from
    ``pfa_exp_sm90_info`` / ``pfa_aug_pair_sm90_info`` /
    ``pfa_fixedmax_sm90_info``, the key tile, the ring's stages and shared
    memory, threads, CTAs a SM, the setmaxnreg split, whether the next
    stage's Q.K^T overlaps this stage's last P.V and whether the
    warpgroups take turns."""
    import ctypes

    from photonic_flash_attention_tpu_torch.experiments import flash_pair_experiment as px

    lib = _build.lib()
    families = (  # (key, its instantiations (D, x), label, info call)
        ("exp", {(d, u) for d in (64, 128) for u in EXP_UNROLLS},
         lambda d, u: f"{EXP_LABELS[u]} D{d}",
         lambda d, u, out: lib.pfa_exp_sm90_info(u, d, out)),
        ("aug_pair", {(64, n) for n in (0, *px.CARD_NCHAINS)},
         lambda d, n: f"{'K14 aug' if n == 0 else f'K15 nchain {n}'} D{d}",
         lambda d, n, out: lib.pfa_aug_pair_sm90_info(n, out)),
        ("fixed", {(d, f) for d in (64, 128) for f in (0, 1)},
         lambda d, f: f"K13 fixed-max{' fast_exp' if f else ''} D{d}",
         lambda d, f, out: lib.pfa_fixedmax_sm90_info(d, f, out)),
    )
    for family, want, label, info_of in families:
        got = {key[1:] for key in counts if key[0] == family}
        if got != want:
            raise AssertionError(f"exp SASS: {family} instantiations {sorted(got)}, "
                                 f"want {sorted(want)}")
        for d, x in sorted(want):
            c, reg = counts[(family, d, x)], usage.get((family, d, x))
            info = (ctypes.c_int * 9)()
            if err := info_of(d, x, info):
                raise RuntimeError(f"exp SASS {label(d, x)}: info: CUDA error {err}")
            line = (f"exp SASS {label(d, x)}: HGMMA {c['HGMMA']}, "
                    f"UTMALDG {c['UTMALDG']}, HMMA {c['HMMA']}; " +
                    (f"registers {reg[0]} at launch (setmaxnreg: producer {info[5]}, consumers "
                     f"{info[6]}), stack {reg[1]} B, local {reg[3]} B" if reg
                     else "cuobjdump -res-usage: no entry") +
                    f"; {info[0]}-key tiles, {info[1]} stages ({info[2]} B shared), "
                    f"{info[3]} threads, {info[4]} CTA(s) a SM, cross-stage overlap "
                    f"{'on' if info[7] else 'off'}, ping-pong {'on' if info[8] else 'off'}")
            if not c["HGMMA"] or not c["UTMALDG"] or c["HMMA"] or not reg or reg[1] or reg[3]:
                raise AssertionError(f"{line}: the bf16 body must run on wgmma and TMA only, "
                                     "with no stack")
            print(line, flush=True)


def check_k10_sass(counts: dict, usage: dict) -> None:
    """Proof that K10 is the ring of bulk copies: its kernel must hold the
    TMA's bulk copy (UBLKCP: at least the load and a store) and no stack or
    local bytes."""
    key = ("probe", 0, PROBE_KERNELS.index("hbm_copy_ring"))
    c, reg = counts.get(key), usage.get(key)
    line = (f"K10 SASS hbm_copy_ring: UBLKCP {c['UBLKCP'] if c else 'no entry'}; " +
            (f"registers {reg[0]}, stack {reg[1]} B, local {reg[3]} B" if reg
             else "cuobjdump -res-usage: no entry"))
    if not c or c["UBLKCP"] < 2 or not reg or reg[1] or reg[3]:
        raise AssertionError(f"{line}: K10 must copy by the TMA's bulk copy, with no stack")
    print(line, flush=True)


def _normalised_sass(path: Path) -> dict:
    """The instantiations of every Hopper attention body and the probes in a
    built library (or object file; SASS_DIFF_KINDS: K1's bf16, K4/K5's,
    K20/K21's, K13-K19's, K9-K12's):
    each one's instructions, keyed by ``_sm90_key``, with the addresses and
    encodings dropped and every hex immediate (constant-bank offsets,
    branch targets) replaced, so that two builds compare by code."""
    funcs, cur = {}, None
    for line in _cuobjdump("-sass", path).splitlines():
        if "Function :" in line:
            key = _sm90_key(line)
            cur = key if key and key[0] in SASS_DIFF_KINDS else None
            if cur:
                funcs[cur] = []
        elif cur and (m := re.search(r"/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", line)):
            funcs[cur].append(re.sub(r"0x[0-9a-f]+", "0x?", m.group(1)))
    return funcs


def sass_diff(this: Path, other: Path) -> None:
    """Prints, per instantiation of ``_normalised_sass``, how many
    normalised SASS lines differ between this tree's library and ``other``
    (another tree's build, e.g. the parent commit's): 0 means the same
    code."""
    import difflib

    mine, theirs = _normalised_sass(this), _normalised_sass(other)
    for key in sorted(set(mine) | set(theirs)):
        a, b = theirs.get(key), mine.get(key)
        if a is None or b is None:
            print(f"sass diff {key}: only in {'this tree' if a is None else other}", flush=True)
            continue
        changed = sum(1 for d in difflib.ndiff(a, b) if d[0] in "+-")
        print(f"sass diff {key}: {len(a)} -> {len(b)} instructions, {changed} lines differ",
              flush=True)


#: K12's instantiations (csrc/probes.cu::softmax_stream<G, VPT, MASKED>).
K12_SASS = re.compile(r"softmax_streamILi(\d+)ELi(\d+)ELb([01])E")


def k12_sass_counts(path: Path) -> dict:
    """Per K12 instantiation, keyed (columns, masked): the SASS
    instructions of its update loop a value besides MUFU.EX2, and the
    updates the loop body holds. The loop is the span from the target of
    the function's longest backward branch to that branch; its updates are
    its MUFU.EX2 count over VPT + 1 (each value's p and the row's alpha),
    its values VPT a thread an update."""
    funcs, cur = {}, None
    for line in _cuobjdump("-sass", path).splitlines():
        if "Function :" in line:
            m = K12_SASS.search(line)
            cur = (int(m.group(1)), int(m.group(2)), m.group(3) == "1") if m else None
            if cur:
                funcs[cur] = []
        elif cur and (m := re.search(r"/\*([0-9a-f]{4,})\*/\s*(.*?)\s*;", line)):
            funcs[cur].append((int(m.group(1), 16), m.group(2)))
    out = {}
    for (g, vpt, masked), ins in funcs.items():
        loop = []
        for addr, text in ins:
            if (b := re.search(r"\bBRA\b.*?0x([0-9a-f]+)", text)) and int(b.group(1), 16) < addr:
                span = [t for a, t in ins if int(b.group(1), 16) <= a <= addr]
                loop = span if len(span) > len(loop) else loop
        mufu = sum("MUFU.EX2" in t for t in loop)
        if mufu:
            updates = mufu / (vpt + 1)
            out[(g * vpt, masked)] = ((len(loop) - mufu) / (updates * vpt), updates)
    return out


def check_flash(results: dict) -> None:
    """K1 against its plain version: causal bf16 at the prefill shapes,
    plus the rest of its contract (fp32, D=128, GQA, Sq < Skv)."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = [  # (B, Sq, Skv, Hq, Hkv, D, dtype, causal, bound)
        (1, 16, 16, 16, 16, 64, torch.bfloat16, True, 1e-2),
        (1, 128, 128, 16, 16, 64, torch.bfloat16, True, 1e-2),
        (1, 512, 512, 16, 16, 64, torch.bfloat16, True, 1e-2),
        (1, 1024, 1024, 16, 16, 64, torch.bfloat16, True, 1e-2),
        (4, 2048, 2048, 12, 12, 64, torch.bfloat16, True, 1e-2),
        (2, 40, 100, 4, 2, 128, torch.bfloat16, True, 1e-2),
        (2, 100, 100, 4, 2, 128, torch.bfloat16, False, 1e-2),
        (2, 40, 100, 4, 2, 64, torch.float32, True, 1e-4),
        (2, 256, 256, 4, 4, 128, torch.float32, False, 1e-4),
    ]
    worst = 0.0
    for b, sq, skv, hq, hkv, d, dtype, causal, bound in cases:
        q = torch.randn(b, sq, hq, d, device="cuda", generator=gen).to(dtype)
        k = torch.randn(b, skv, hkv, d, device="cuda", generator=gen).to(dtype)
        v = torch.randn(b, skv, hkv, d, device="cuda", generator=gen).to(dtype)
        out = flash_ops.flash_attention(q, k, v, causal=causal)
        ref = flash_ops.flash_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = rel_err_norm(out, ref)
        worst = max(worst, max_abs_err(out, ref))
        line = (f"K1 flash_fwd B{b} Sq{sq} Skv{skv} H{hq}/{hkv} D{d} {str(dtype)[6:]} "
                f"causal={causal}: rel_err_norm {err:.3e} (bound {bound})")
        if err > bound or not torch.isfinite(out).all():
            raise AssertionError(line)
        if dtype == torch.bfloat16 and causal and hq == hkv:
            ms = median_ms(lambda: flash_ops.flash_attention(q, k, v, causal=True))
            plain = median_ms(lambda: flash_ops.flash_attention_plain(q, k, v, causal=True))
            lib = sdpa_ms(q, k, v, True)
            bnd = flash_fwd_bound(q, k, True)
            line += (f" | kernel {ms:.4f} ms, plain {plain:.4f} ms, SDPA {lib:.4f} ms, "
                     f"bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
            # last: B4 S2048
            results["pfa_flash_fwd"].update(ms=ms, plain_ms=plain, library_ms=lib, **bnd)
        print(line, flush=True)
    results["pfa_flash_fwd"]["max_abs_err"] = worst


def _serving_pools(dtype, gen, L=24, hkv=16, num_pages=256, page=128, d=64):
    shape = (L, hkv, num_pages, page, d)
    if dtype == torch.int8:
        k = torch.randint(-127, 128, shape, device="cuda", generator=gen, dtype=torch.int8)
        v = torch.randint(-127, 128, shape, device="cuda", generator=gen, dtype=torch.int8)
        ks = torch.rand(shape[:4], device="cuda", generator=gen) * 0.05 + 1e-3
        vs = torch.rand(shape[:4], device="cuda", generator=gen) * 0.05 + 1e-3
        return k, v, ks, vs
    k = torch.randn(shape, device="cuda", generator=gen).to(dtype)
    v = torch.randn(shape, device="cuda", generator=gen).to(dtype)
    return k, v, None, None


def check_token_write(results: dict) -> None:
    """K2 against its plain version: bit-exact pools and scales."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    b, hkv, d, page, layer = 8, 16, 64, 128, 5
    # 7 sequences on distinct pages, one empty slot writing to trash page 0.
    slots = torch.tensor([0] + [p * page + (13 * p) % page for p in (3, 9, 40, 77, 120, 200, 255)],
                         dtype=torch.int32, device="cuda")
    for pool_dtype in (torch.int8, torch.bfloat16):
        k_new = torch.randn(b, hkv, d, device="cuda", generator=gen).to(torch.bfloat16)
        v_new = torch.randn(b, hkv, d, device="cuda", generator=gen).to(torch.bfloat16)
        k_new[3, 2] = 0.0  # an all-zero token takes scale 1
        pools = _serving_pools(pool_dtype, gen)
        ref = [p.clone() if p is not None else None for p in pools]
        paged_ops.paged_token_write(k_new, v_new, *pools, slots, layer)
        paged_ops.paged_token_write_plain(k_new, v_new, *ref, slots, layer)
        torch.cuda.synchronize()
        for name, got, want in zip(("k", "v", "k_scales", "v_scales"), pools, ref):
            if got is not None and not torch.equal(got, want):
                bad = got != want
                raise AssertionError(
                    f"K2 {pool_dtype}: {name} differs from the plain version at "
                    f"{int(bad.sum())} entries, max |diff| "
                    f"{float((got.float() - want.float()).abs().max())}"
                )
        err = max(max_abs_err(got[layer], want[layer])
                  for got, want in zip(pools, ref) if got is not None)
        ms = median_ms(lambda: paged_ops.paged_token_write(k_new, v_new, *pools, slots, layer))
        plain = median_ms(
            lambda: paged_ops.paged_token_write_plain(k_new, v_new, *ref, slots, layer)
        )
        print(f"K2 paged_token_write B{b} Hkv{hkv} D{d} page{page} pool {str(pool_dtype)[6:]}: "
              f"bit-exact | kernel {ms:.4f} ms, plain {plain:.4f} ms", flush=True)
        if pool_dtype == torch.int8:
            # Reads k_new and v_new, writes their int8 rows and fp32 scales;
            # absmax, divide and round per element.
            nbytes = 2 * b * hkv * d * (k_new.element_size() + 1) + 2 * 4 * b * hkv + 4 * b
            results["pfa_paged_token_write"].update(
                ms=ms, plain_ms=plain, max_abs_err=err, library_ms=None,
                **card_bound(3.0 * 2 * b * hkv * d, nbytes, torch.float32))


GPT2_DECODE_LENS = (0, 1, 17, 128, 129, 700, 1000, 2000)


def _decode_case(gen, pool_dtype=torch.int8, lengths=GPT2_DECODE_LENS, hq=16, pps=64, L=24,
                 d=64):
    """GPT-2 medium's decode shape (B8 H16 D64, page 128, 256 pages of
    ``L`` layers; another head count or head dim ``d`` where given):
    pools, scattered tables, q fp32, the new token's K/V (bf16) and the
    slot of position lengths[b] - 1 (trash page 0 for 0)."""
    b, page = len(lengths), 128
    k, v, ks, vs = _serving_pools(pool_dtype, gen, L=L, hkv=hq, d=d)
    need = max(-(-n // page) for n in lengths)
    perm = torch.randperm(255, device="cuda", generator=gen)[: b * need] + 1
    tables = torch.zeros(b, pps, dtype=torch.int32, device="cuda")
    tables[:, :need] = perm.view(b, need).to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    slots = torch.zeros(b, dtype=torch.int32, device="cuda")
    for i, n in enumerate(lengths):
        if n:
            slots[i] = tables[i, (n - 1) // page] * page + (n - 1) % page
    q = torch.randn(b, hq, d, device="cuda", generator=gen)
    k_new, v_new = (torch.randn(b, hq, d, device="cuda", generator=gen).to(torch.bfloat16)
                    for _ in range(2))
    return q, k, v, ks, vs, lens, tables, slots, k_new, v_new


def k3_bound(b: int, hq: int, hkv: int, d: int, elt: int, tokens: int, pps: int, q_bytes: int,
             quant: bool, *, bias: bool = False, fused_in: int = 0, int8_ops: bool = False) -> dict:
    """K3's bound: 4 D operations per (query head, valid token) pair in
    fp32 (int8 compute: int8); the valid tokens' K/V rows (and int8 scales)
    read once, q read, o written (fp32), lengths and the page table; the
    token bias of the valid tokens; the fused decode's new K/V read
    (``fused_in`` bytes an element) and written with its scales."""
    nbytes = (2 * tokens * hkv * d * elt + 2 * 4 * tokens * hkv * quant + b * hq * d * q_bytes
              + 4 * b * hq * d + 4 * b + 4 * b * pps + 4 * tokens * hkv * bias)
    if fused_in:
        nbytes += 2 * b * hkv * d * (fused_in + elt) + 2 * 4 * b * hkv * quant + 4 * b
    return card_bound(4.0 * d * hq * tokens, nbytes, torch.int8 if int8_ops else torch.float32)


def check_decode_attend(results: dict) -> None:
    """K3 against its plain versions on GPT-2 medium's int8 decode shape,
    lengths mixed with 0: the read-only attend (bound 1e-3), then the fused
    decode (one pfa_paged_decode_fused launch) against K2's plain write then
    the plain attend: pools and scales bit-exact, output within 1e-4."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v, ks, vs, lengths, tables, slots, k_new, v_new = _decode_case(gen)
    b, hq, d = q.shape
    layer, pps = 7, tables.shape[1]
    out = paged_ops.paged_decode_attend(q, k, v, lengths, tables, layer, ks, vs)
    ref = paged_ops.paged_decode_attend_plain(q, k, v, lengths, tables, layer, ks, vs, d ** -0.5)
    torch.cuda.synchronize()
    err = rel_err_norm(out, ref)
    line = (f"K3 paged_decode_attend B{b} H{hq} D{d} page128 int8 lengths "
            f"{lengths.tolist()}: rel_err_norm {err:.3e} (bound 1e-3)")
    if err > 1e-3 or not torch.isfinite(out).all() or out[0].abs().max() != 0:
        raise AssertionError(line)
    ms = median_ms(lambda: paged_ops.paged_decode_attend(q, k, v, lengths, tables, layer, ks, vs))
    plain = median_ms(lambda: paged_ops.paged_decode_attend_plain(
        q, k, v, lengths, tables, layer, ks, vs, d ** -0.5))
    tokens = int(lengths.sum())
    bnd = k3_bound(b, hq, hq, d, 1, tokens, pps, 4, True)
    print(f"{line} | kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {bnd['bound_ms']:.4f} ms "
          f"({bnd['bound_by']})", flush=True)
    results["pfa_paged_decode_attend"].update(ms=ms, plain_ms=plain, library_ms=None,
                                              max_abs_err=max_abs_err(out, ref), **bnd)

    pools = [k, v, ks, vs]
    ref_pools = [t.clone() for t in pools]
    before = _build.LAUNCHES["pfa_paged_decode_fused"]
    out = paged_ops.paged_decode_attention(q, k_new, v_new, k, v, lengths, tables, slots, layer,
                                           ks, vs)
    paged_ops.paged_token_write_plain(k_new, v_new, *ref_pools, slots, layer)
    ref = paged_ops.paged_decode_attend_plain(q, *ref_pools[:2], lengths, tables, layer,
                                              *ref_pools[2:], d ** -0.5)
    torch.cuda.synchronize()
    err = rel_err_norm(out, ref)
    exact = all(torch.equal(a, w) for a, w in zip(pools, ref_pools))
    line = (f"K3 fused decode (write + attend, one launch) B{b} H{hq} D{d} page128 int8 lengths "
            f"{lengths.tolist()}: pools and scales bit-exact with K2's plain write: {exact}; "
            f"rel_err_norm {err:.3e} (bound 1e-4)")
    if (not exact or err > 1e-4 or not torch.isfinite(out).all() or out[0].abs().max() != 0
            or _build.LAUNCHES["pfa_paged_decode_fused"] != before + 1):
        raise AssertionError(line)

    def call():
        return paged_ops.paged_decode_attention(q, k_new, v_new, k, v, lengths, tables, slots,
                                                layer, ks, vs)

    def plain_call():
        paged_ops.paged_token_write_plain(k_new, v_new, *ref_pools, slots, layer)
        return paged_ops.paged_decode_attend_plain(q, *ref_pools[:2], lengths, tables, layer,
                                                   *ref_pools[2:], d ** -0.5)

    ms, plain = median_ms(call), median_ms(plain_call)
    bnd = k3_bound(b, hq, hq, d, 1, tokens, pps, 4, True, fused_in=2)
    print(f"{line} | kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {bnd['bound_ms']:.4f} ms "
          f"({bnd['bound_by']})", flush=True)
    results["pfa_paged_decode_fused"].update(ms=ms, plain_ms=plain, library_ms=None,
                                             max_abs_err=max_abs_err(out, ref), **bnd)
    del k, v, ks, vs, ref_pools
    torch.cuda.empty_cache()


STREAM_LENS = (2048, 1500, 700, 0)


def _key_bias(b: int, skv: int, gen, holes: float = 0.1) -> torch.Tensor:
    """(B, Skv) fp32 key bias: real values with ~10% mask-value holes; key 0
    kept in every row."""
    bias = torch.randn(b, skv, device="cuda", generator=gen)
    holes = torch.rand(b, skv, device="cuda", generator=gen) < holes
    bias = torch.where(holes, torch.full_like(bias, DEFAULT_MASK_VALUE), bias)
    bias[:, 0] = 0.0
    return bias


def _sdpa_stream_mask(b, sq, skv, causal, lens, bias) -> torch.Tensor:
    """The streams as one additive (B, 1, Sq, Skv) mask for SDPA."""
    col = torch.arange(skv, device="cuda")
    keep = (col[None] < lens[:, None].long())[:, None, None, :]
    if causal:
        keep = keep & (col[None, :] <= torch.arange(sq, device="cuda")[:, None] + (skv - sq))
    return torch.where(keep, bias[:, None, None, :], float("-inf"))


def check_flash_streams(results: dict) -> None:
    """K1 with the key-padding streams (kv_lens, k_bias) against its plain
    version, output and lse, at the engine's prefill shape with lengths
    STREAM_LENS (bf16 bound 1e-2, fp32 1e-4; lse 1e-4); a row masked by the
    bias alone must average its keys (finite), a row of length 0 give o = 0
    and lse = -inf."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    cases = [  # (B, Sq, Skv, Hq, Hkv, D, dtype, causal, lens)
        (4, 2048, 2048, 12, 12, 64, torch.bfloat16, True, STREAM_LENS),
        (4, 2048, 2048, 12, 12, 64, torch.bfloat16, False, STREAM_LENS),
        (2, 256, 1280, 16, 16, 64, torch.bfloat16, True, (1280, 700)),  # a prefill chunk
        (2, 100, 300, 4, 2, 128, torch.bfloat16, True, (300, 0)),
        (2, 200, 300, 4, 2, 64, torch.float32, True, (300, 1)),
        (3, 128, 256, 4, 4, 128, torch.float32, False, (256, 256, 0)),
    ]
    worst = 0.0
    for b, sq, skv, hq, hkv, d, dtype, causal, lens_t in cases:
        q = torch.randn(b, sq, hq, d, device="cuda", generator=gen).to(dtype)
        k = torch.randn(b, skv, hkv, d, device="cuda", generator=gen).to(dtype)
        v = torch.randn(b, skv, hkv, d, device="cuda", generator=gen).to(dtype)
        lens = torch.tensor(lens_t, dtype=torch.int32, device="cuda")
        bias = _key_bias(b, skv, gen)
        if not causal:
            bias[1] = DEFAULT_MASK_VALUE  # row 1: every key masked by the bias alone
        kw = dict(causal=causal, kv_lens=lens, k_bias=bias)
        out, lse = flash_ops.flash_attention_with_lse(q, k, v, **kw)
        ref, ref_lse = flash_ops.flash_attention_with_lse_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        bound_err = 1e-2 if dtype == torch.bfloat16 else 1e-4
        err = rel_err_norm(out, ref)
        live = torch.isfinite(ref_lse)
        lse_err = rel_err_norm(lse[live], ref_lse[live])
        empty = lens == 0
        line = (f"K1 streams B{b} Sq{sq} Skv{skv} H{hq}/{hkv} D{d} {str(dtype)[6:]} "
                f"causal={causal} lens {list(lens_t)}: rel_err_norm {err:.3e} (bound {bound_err}), "
                f"lse {lse_err:.3e} (bound 1e-4)")
        if (err > bound_err or lse_err > 1e-4 or not torch.isfinite(out).all()
                or not torch.equal(torch.isneginf(lse), torch.isneginf(ref_lse))
                or (out[empty] != 0).any()):
            raise AssertionError(line)
        worst = max(worst, max_abs_err(out, ref))
        if dtype == torch.bfloat16 and sq == 2048 and causal:
            ms = median_ms(lambda: flash_ops.flash_attention(q, k, v, **kw))
            plain = median_ms(lambda: flash_ops.flash_attention_plain(q, k, v, **kw))
            lib = sdpa_ms(q, k, v, False, _sdpa_stream_mask(b, sq, skv, causal, lens, bias))
            bnd = flash_fwd_bound(q, k, causal, lens_t, with_bias=True)
            line += (f" | kernel {ms:.4f} ms, plain {plain:.4f} ms, SDPA with the mask "
                     f"{lib:.4f} ms, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
            results["pfa_flash_fwd_streams"].update(ms=ms, plain_ms=plain, library_ms=lib, **bnd)
        print(line, flush=True)
    results["pfa_flash_fwd_streams"]["max_abs_err"] = worst


HF_LENS = (2048, 2000, 1500, 1024, 1000, 700, 1, 0)


def check_paged_hf(results: dict) -> None:
    """K3's paged_attention_hf entry against its plain version at B8, kv
    2048, H16, D64, page 128, pages_per_block 8: float compute over a bf16
    pool (bound 1e-4) and int8 compute over an int8 pool (bound 1e-3 to its
    plain version, 3e-2 to the float oracle)."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    b, hq, d, page, pps, layer = 8, 16, 64, 128, 16, 3
    lengths = torch.tensor(HF_LENS, dtype=torch.int32, device="cuda")
    perm = torch.randperm(255, device="cuda", generator=gen)[: b * pps] + 1
    tables = perm.view(b, pps).to(torch.int32)
    q = torch.randn(b, hq, d, device="cuda", generator=gen).to(torch.bfloat16)
    kv_bytes = sum(HF_LENS) * hq * d  # payload bytes per element byte, all rows
    for pool_dtype, name, tol in ((torch.bfloat16, "pfa_paged_hf", 1e-4),
                                  (torch.int8, "pfa_paged_hf_int8", 1e-3)):
        k, v, ks, vs = _serving_pools(pool_dtype, gen, L=4, hkv=hq)
        int8 = pool_dtype == torch.int8
        args = (q, k, v, lengths, tables, ks, vs)
        out = paged_ops.paged_attention_hf(*args, layer=layer)
        ref = paged_ops.paged_attention_hf_plain(
            q, k, v, lengths, tables, layer, ks, vs, d ** -0.5, 8, int8).to(q.dtype)
        oracle = paged_ops.paged_decode_attend_plain(
            q.float(), k, v, lengths, tables, layer, ks, vs, d ** -0.5)
        torch.cuda.synchronize()
        err, err_oracle = rel_err_norm(out, ref), rel_err_norm(out, oracle)
        line = (f"K3 paged_attention_hf B{b} H{hq} D{d} page{page} pool {str(pool_dtype)[6:]} "
                f"{'int8' if int8 else 'float'} compute, lengths {list(HF_LENS)}: rel_err_norm "
                f"{err:.3e} (bound {tol}), to the float oracle {err_oracle:.3e} (bound 3e-2)")
        if err > tol or err_oracle > 3e-2 or not torch.isfinite(out).all() or out[-1].abs().max() != 0:
            raise AssertionError(line)
        ms = median_ms(lambda: paged_ops.paged_attention_hf(*args, layer=layer))
        plain = median_ms(lambda: paged_ops.paged_attention_hf_plain(
            q, k, v, lengths, tables, layer, ks, vs, d ** -0.5, 8, int8))
        elt = k.element_size()
        nbytes = 2 * kv_bytes * elt + 2 * 2 * b * hq * d + 4 * b + 4 * b * pps
        nbytes += 2 * 4 * sum(HF_LENS) * hq * int8  # per-token K and V scales
        bnd = card_bound(4.0 * d * hq * sum(HF_LENS), nbytes, torch.int8 if int8 else torch.float32)
        print(f"{line} | kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {bnd['bound_ms']:.4f} ms "
              f"({bnd['bound_by']})", flush=True)
        results[name].update(ms=ms, plain_ms=plain, library_ms=None,
                             max_abs_err=max_abs_err(out, ref), **bnd)


def check_flash_lse() -> None:
    """K1's lse output against the plain lse (natural log, fp32)."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    cases = [  # (B, Sq, Skv, Hq, Hkv, D, dtype, causal)
        (8, 1024, 1024, 16, 16, 64, torch.bfloat16, True),
        (2, 200, 200, 4, 2, 64, torch.float32, True),
        (1, 64, 320, 4, 1, 128, torch.float32, False),
    ]
    for b, sq, skv, hq, hkv, d, dtype, causal in cases:
        q = torch.randn(b, sq, hq, d, device="cuda", generator=gen).to(dtype)
        k = torch.randn(b, skv, hkv, d, device="cuda", generator=gen).to(dtype)
        v = torch.randn(b, skv, hkv, d, device="cuda", generator=gen).to(dtype)
        _, lse = flash_ops.flash_attention_with_lse(q, k, v, causal=causal)
        _, ref = flash_ops.flash_attention_with_lse_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = rel_err_norm(lse, ref)
        line = (f"K1 lse B{b} Sq{sq} Skv{skv} H{hq}/{hkv} D{d} {str(dtype)[6:]} "
                f"causal={causal}: rel_err_norm {err:.3e} (bound 1e-4)")
        if err > 1e-4 or not torch.isfinite(lse).all() or lse.shape != (b, hq, sq):
            raise AssertionError(line)
        print(line, flush=True)


def _plain_grads(q, k, v, do, causal):
    """The plain backward on the plain forward's residuals (native GQA:
    it repeats K/V and sums dk/dv over the group in fp32 inside)."""
    o, lse = flash_ops.flash_attention_with_lse_plain(q, k, v, causal=causal)
    grads = bwd_ops.flash_attention_bwd_plain(q, k, v, o, lse, do, sm_scale=q.shape[-1] ** -0.5,
                                              causal=causal)
    return grads, (o, lse)


def check_flash_bwd(results: dict, smi: str) -> None:
    """K5 (dQ and di) and K4 (dK/dV) through ``flash_attention_bwd`` against
    the plain backward on the same inputs: the training shapes timed, then
    the rest of the contract (unaligned S, Sq < Skv, native GQA 4/2, 8/1
    (MQA) and 64/8 at D 128, GQA at Sq < Skv, D 128, fp32), each with its
    launches (one K5 and one K4 a call); K5's di against ``flash_bwd_di``
    (fp32 1e-6 rel_err_norm)."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [  # (B, Sq, Skv, Hq, Hkv, D, dtype, causal)
        (8, 1024, 1024, 16, 16, 64, bf16, True),
        (4, 2048, 2048, 12, 12, 64, bf16, True),
        (2, 200, 200, 4, 4, 64, bf16, True),
        (2, 256, 384, 4, 4, 64, bf16, True),
        (2, 512, 512, 4, 2, 64, bf16, True),
        (2, 512, 512, 8, 1, 64, bf16, True),
        (1, 1024, 1024, 64, 8, 128, bf16, True),
        (2, 256, 384, 8, 2, 128, bf16, True),
        (2, 512, 512, 4, 4, 128, bf16, False),
        (2, 256, 256, 4, 4, 64, f32, True),
        (2, 200, 200, 4, 2, 64, f32, True),
        (2, 256, 384, 8, 2, 128, f32, True),
        (2, 256, 256, 4, 4, 128, f32, False),
    ]
    worst = {"pfa_flash_bwd_dkv": 0.0, "pfa_flash_bwd_dq": 0.0}
    for b, sq, skv, hq, hkv, d, dtype, causal in cases:
        q = torch.randn(b, sq, hq, d, device="cuda", generator=gen).to(dtype)
        k = torch.randn(b, skv, hkv, d, device="cuda", generator=gen).to(dtype)
        v = torch.randn(b, skv, hkv, d, device="cuda", generator=gen).to(dtype)
        do = torch.randn(b, sq, hq, d, device="cuda", generator=gen).to(dtype)
        want, (o, lse) = _plain_grads(q, k, v, do, causal)
        before = [_build.LAUNCHES[n] for n in ("pfa_flash_bwd_dq", "pfa_flash_bwd_dkv")]
        got = bwd_ops.flash_attention_bwd(q, k, v, o, lse, do, sm_scale=d ** -0.5, causal=causal)
        di = bwd_ops.flash_bwd_dq(q, k, v, o.contiguous(), lse, do, sm_scale=d ** -0.5,
                                  causal=causal)[1]
        torch.cuda.synchronize()
        bound = 1e-2 if dtype == bf16 else 1e-4
        errs = [rel_err_norm(g, w) for g, w in zip(got, want)]
        di_err = rel_err_norm(di, bwd_ops.flash_bwd_di(o, do))
        launched = [_build.LAUNCHES[n] - c for n, c in zip(("pfa_flash_bwd_dq", "pfa_flash_bwd_dkv"),
                                                           before)]
        line = (f"K4/K5 flash_bwd B{b} Sq{sq} Skv{skv} H{hq}/{hkv} D{d} {str(dtype)[6:]} "
                f"causal={causal}: rel_err_norm dq {errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e} "
                f"(bound {bound}), K5's di {di_err:.3e} (bound 1e-6); K5, K4 launches {launched}")
        if (max(errs) > bound or di_err > 1e-6 or launched != [2, 1]
                or not all(torch.isfinite(g).all() for g in got)):
            raise AssertionError(line)
        worst["pfa_flash_bwd_dq"] = max(worst["pfa_flash_bwd_dq"], max_abs_err(got[0], want[0]))
        worst["pfa_flash_bwd_dkv"] = max(worst["pfa_flash_bwd_dkv"],
                                         max_abs_err(got[1], want[1]), max_abs_err(got[2], want[2]))
        if dtype == bf16 and causal and hq == hkv and sq >= 1024:
            kw = dict(sm_scale=d ** -0.5, causal=True)
            oc = o.contiguous()
            ms_dkv = median_ms(lambda: bwd_ops.flash_bwd_dkv(q, k, v, do, lse, di, **kw))
            ms_dq = median_ms(lambda: bwd_ops.flash_bwd_dq(q, k, v, oc, lse, do, **kw))
            plain = median_ms(lambda: bwd_ops.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw))
            lib = sdpa_bwd_ms(q, k, v, do)
            bnd_dkv, bnd_dq = bwd_bounds(q, k, True)
            line += (f" | K4 {ms_dkv:.4f} ms (bound {bnd_dkv['bound_ms']:.4f}), K5 with di "
                     f"{ms_dq:.4f} ms (bound {bnd_dq['bound_ms']:.4f}), plain backward (dq, dk, dv) "
                     f"{plain:.4f} ms, SDPA backward {lib:.4f} ms ({smi})")
            # last: B4 S2048
            results["pfa_flash_bwd_dkv"].update(ms=ms_dkv, plain_ms=plain, library_ms=lib, **bnd_dkv)
            results["pfa_flash_bwd_dq"].update(ms=ms_dq, plain_ms=plain, library_ms=lib, **bnd_dq)
        print(line, flush=True)
    for name, err in worst.items():
        results[name]["max_abs_err"] = err


#: (B, Sq, Skv, H, D, causal) of the quantized checks: the engine's prefill
#: at GPT-2-medium width, and a non-causal cross-attention call (timed);
#: then the JAX tests' shape (tests/unit/test_flash_quant.py), where the
#: whole call must hold the JAX tests' gates.
QUANT_SHAPES = ((4, 2048, 2048, 16, 64, True), (4, 512, 2048, 16, 64, False))
QUANT_GATE_SHAPES = ((2, 256, 256, 4, 64, False), (2, 256, 256, 4, 64, True))
#: Kernel against its plain version on the same payloads (bf16 output).
QUANT_PLAIN_BOUND = 1e-2
#: The reference's gate for quantized paths (BASELINE.md), held at the
#: timed shapes: the JAX tests' tighter gates are set at S 256, and P's
#: requantization error grows with the keys a row spreads over.
QUANT_REFERENCE_GATE = 0.1


def _quant_modes():
    """name -> (public function, payload function (q, k, v, causal) ->
    (kernel call, plain call), Q.K type, P.V type, fp32-oracle gate). The
    gates are the JAX tests' (tests/unit/test_flash_quant.py)."""
    from photonic_flash_attention_tpu_torch.ops import flash_fp8 as fp8

    def per_tensor(qdt, qmax, pv_int8):
        def prepare(q, k, v, causal):
            q8, k8, sc = fp8._qk_per_tensor(q, k, qdt, qmax, q.shape[-1] ** -0.5)
            vin, vs = fp8._col_quantize(v, torch.int8, 127.0) if pv_int8 else (v, None)
            kw = dict(causal=causal, v_scales=vs, out_dtype=torch.bfloat16)
            return (lambda: flash_ops.flash_attention_qk_quant(q8, k8, vin, sc, **kw),
                    lambda: flash_ops.flash_attention_qk_quant_plain(q8, k8, vin, sc, **kw),
                    4 + (4 * vs.numel() if pv_int8 else 0))
        return prepare

    def block(qdtype):
        def prepare(q, k, v, causal):
            qdt, qmax = fp8._QPARAMS[qdtype]
            q8, qs = fp8._row_block_quantize(q, qdt, qmax)
            k8, ks = fp8._row_block_quantize(k, qdt, qmax)
            v8, vs = fp8._col_quantize(v, qdt, qmax)
            kw = dict(qdtype=qdtype, causal=causal, sm_scale=q.shape[-1] ** -0.5,
                      out_dtype=torch.bfloat16)
            return (lambda: fp8.flash_attention_block_quant(q8, k8, v8, qs, ks, vs, **kw),
                    lambda: fp8.flash_attention_block_quant_plain(q8, k8, v8, qs, ks, vs, **kw),
                    4 * (qs.numel() + ks.numel() + vs.numel()))
        return prepare

    i8, e4, bf = torch.int8, torch.float8_e4m3fn, torch.bfloat16
    return {
        "pfa_flash_fwd_int8qk": (fp8.flash_attention_int8qk, per_tensor(i8, 127.0, False), i8, bf, 0.05),
        "pfa_flash_fwd_fp8qk": (fp8.flash_attention_fp8qk, per_tensor(e4, 448.0, False), e4, bf, 0.05),
        "pfa_flash_fwd_int8full": (fp8.flash_attention_int8full, per_tensor(i8, 127.0, True), i8, i8,
                                   0.03),
        "pfa_flash_quant_fp8": (fp8.flash_attention_fp8, block("fp8"), e4, e4, 0.06),
        "pfa_flash_quant_int8": (fp8.flash_attention_int8, block("int8"), i8, i8, 0.03),
    }


def quant_bound(q, k, causal, qk_dtype, pv_dtype, scale_bytes, v_elt=None, out_elt=2) -> dict:
    """The bound of a quantized call: Q.K at its 8-bit peak plus P.V at its
    type's peak (2 D operations per (query, key) pair each), against the
    bytes of the 8-bit Q/K payloads, V (1 B, or 2 B when bf16; ``v_elt``
    where V is stored wider than P.V runs), the scales and the output
    (``out_elt`` bytes a value, bf16)."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    ops = 2.0 * d * hq * attention_pairs(b, sq, skv, causal)
    t_ops = (ops / PEAK_OPS[qk_dtype] + ops / PEAK_OPS[pv_dtype]) * 1e3
    if v_elt is None:
        v_elt = 2 if pv_dtype == torch.bfloat16 else 1
    nbytes = b * sq * hq * d * (1 + out_elt) + b * skv * hkv * d * (1 + v_elt) + scale_bytes
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def check_flash_quant(results: dict) -> None:
    """K1's int8-QK, fp8-QK and int8-full modes and K6's fp8 and int8 modes
    (bf16 inputs): each kernel against its plain version on the same
    payloads (rel_err_norm <= QUANT_PLAIN_BOUND), the whole call against the
    fp32 oracle (and the plain version, the JAX arithmetic, beside it). At
    QUANT_SHAPES the whole call must hold the reference's gate and the line
    says whether it holds the JAX tests' gate; it is timed: the kernel, the
    whole call (the quantization passes included), the plain version, bf16
    K1 at the same shape, and the bound. At QUANT_GATE_SHAPES it must hold
    the JAX tests' gates. The JSON keeps the first shape's numbers (the
    engine's prefill)."""
    from photonic_flash_attention_tpu_torch.ops.reference import attention_reference

    gen = torch.Generator(device="cuda").manual_seed(8)
    modes = _quant_modes()
    worst = dict.fromkeys(modes, 0.0)
    for b, sq, skv, h, d, causal in QUANT_SHAPES + QUANT_GATE_SHAPES:
        timed = (b, sq, skv, h, d, causal) in QUANT_SHAPES
        q = torch.randn(b, sq, h, d, device="cuda", generator=gen).to(torch.bfloat16)
        k = torch.randn(b, skv, h, d, device="cuda", generator=gen).to(torch.bfloat16)
        v = torch.randn(b, skv, h, d, device="cuda", generator=gen).to(torch.bfloat16)
        oracle = attention_reference(q.float(), k.float(), v.float(), causal=causal)[0]
        if timed:
            bf16_ms = median_ms(lambda: flash_ops.flash_attention(q, k, v, causal=causal))
        for name, (public, prepare, qk_dtype, pv_dtype, gate) in modes.items():
            kernel, plain, scale_bytes = prepare(q, k, v, causal)
            out, ref, whole = kernel(), plain(), public(q, k, v, causal=causal)
            torch.cuda.synchronize()
            err, err_oracle = rel_err_norm(out, ref), rel_err_norm(whole, oracle)
            worst[name] = max(worst[name], max_abs_err(out, ref))
            limit = QUANT_REFERENCE_GATE if timed else gate
            line = (f"{name} B{b} Sq{sq} Skv{skv} H{h} D{d} bf16 causal={causal}: vs plain "
                    f"rel_err_norm {err:.3e}, max abs {max_abs_err(out, ref):.3e} (bound "
                    f"{QUANT_PLAIN_BOUND}); whole call vs fp32 oracle {err_oracle:.3e}, plain "
                    f"version {rel_err_norm(ref, oracle):.3e} (gate {limit}")
            line += (f"; JAX tests' gate {gate} {'held' if err_oracle < gate else 'exceeded'})"
                     if timed else ", the JAX tests')")
            if (err > QUANT_PLAIN_BOUND or err_oracle >= limit or not torch.isfinite(out).all()
                    or whole.dtype != torch.bfloat16):
                raise AssertionError(line)
            if not timed:
                print(line, flush=True)
                continue
            ms = median_ms(kernel)
            whole_ms = median_ms(lambda: public(q, k, v, causal=causal))
            plain_ms = median_ms(plain)
            bnd = quant_bound(q, k, causal, qk_dtype, pv_dtype, scale_bytes)
            line += (f" | kernel {ms:.4f} ms, whole call {whole_ms:.4f} ms (quantization passes "
                     f"{100 * (whole_ms - ms) / whole_ms:.1f}%), plain {plain_ms:.4f} ms, bf16 K1 "
                     f"{bf16_ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}), "
                     f"library none")
            print(line, flush=True)
            if (b, sq, skv, h, d, causal) == QUANT_SHAPES[0]:
                results[name].update(ms=ms, plain_ms=plain_ms, library_ms=None, whole_call_ms=whole_ms,
                                     **bnd)
    for name, err in worst.items():
        results[name]["max_abs_err"] = err


#: (B, Sq, Skv, Hq, Hkv, D, causal) of the quant table: QUANT_SHAPES, and
#: the K1 table's D 128 geometry (training, B2 S4096 Hq32/Hkv8 causal).
QUANT_TABLE_SHAPES = tuple((b, sq, skv, h, h, d, c) for b, sq, skv, h, d, c in QUANT_SHAPES) + (
    (2, 4096, 4096, 32, 8, 128, True),)


def time_quant_modes(results: dict, smi: str, strict: bool = True) -> list:
    """The quant table: every quantized mode (K1's int8-QK, fp8-QK and
    int8-full, K6 fp8 and int8) at QUANT_TABLE_SHAPES, bf16 inputs: the
    kernel on its payloads by CUDA events and by the graph fit (2, 10), the
    whole public call (the quantization passes included) by events, bf16 K1
    at the same shape both ways, the bound (``quant_bound``) and the
    kernel's share of it; the kernel against its plain version and the
    whole call against the fp32 oracle beside them. Public calls only, so
    ``strict=False`` times a parent tree with the same script
    (``--quant-table``); ``strict`` holds QUANT_PLAIN_BOUND and
    QUANT_REFERENCE_GATE and keeps the first shape's fit in ``results``."""
    from photonic_flash_attention_tpu_torch.ops.reference import attention_reference

    gen = torch.Generator(device="cuda").manual_seed(23)
    modes = _quant_modes()
    table = []
    for b, sq, skv, hq, hkv, d, causal in QUANT_TABLE_SHAPES:
        q = torch.randn(b, sq, hq, d, device="cuda", generator=gen).to(torch.bfloat16)
        k, v = (torch.randn(b, skv, hkv, d, device="cuda", generator=gen).to(torch.bfloat16)
                for _ in range(2))
        oracle = attention_reference(q.float(), k.float(), v.float(), causal=causal)[0]
        k1_ev, k1_fit = _both_ms(lambda: flash_ops.flash_attention(q, k, v, causal=causal))
        shape = f"B{b} Sq{sq} Skv{skv} H{hq}/{hkv} D{d} causal={causal}"
        for name, (public, prepare, qk_dtype, pv_dtype, _) in modes.items():
            kernel, plain, scale_bytes = prepare(q, k, v, causal)
            out, ref, whole = kernel(), plain(), public(q, k, v, causal=causal)
            torch.cuda.synchronize()
            err, err_oracle = rel_err_norm(out, ref), rel_err_norm(whole, oracle)
            del ref, whole
            ev, fit = _both_ms(kernel)
            whole_ev = median_ms(lambda: public(q, k, v, causal=causal))
            bnd = quant_bound(q, k, causal, qk_dtype, pv_dtype, scale_bytes)
            row = dict(name=name, shape=shape, ms=ev, fit_ms=fit, whole_call_ms=whole_ev,
                       bf16_k1_ms=k1_ev, bf16_k1_fit_ms=k1_fit, rel_err_plain=err,
                       rel_err_oracle=err_oracle, **bnd)
            table.append(row)
            line = (f"quant table: {name} {shape}: kernel {ev:.4f} ms (CUDA events), {fit:.4f} ms "
                    f"(graph fit); whole call {whole_ev:.4f} ms (events); bf16 K1 {k1_ev:.4f} / "
                    f"{k1_fit:.4f} ms; kernel / bf16 K1 {ev / k1_ev:.3f} (events), "
                    f"{fit / k1_fit:.3f} (fit); bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}), "
                    f"kernel at {100 * bnd['bound_ms'] / ev:.2f} % (events), "
                    f"{100 * bnd['bound_ms'] / fit:.2f} % (fit) of it; vs plain rel_err_norm "
                    f"{err:.3e} (bound {QUANT_PLAIN_BOUND}), whole call vs fp32 oracle "
                    f"{err_oracle:.3e} (gate {QUANT_REFERENCE_GATE}) ({smi})")
            print(line, flush=True)
            if strict and (err > QUANT_PLAIN_BOUND or err_oracle >= QUANT_REFERENCE_GATE
                           or not torch.isfinite(out).all()):
                raise AssertionError(line)
            if strict and (b, sq, skv, hq, d, causal) == QUANT_SHAPES[0]:
                results[name]["fit_ms"] = fit
        del q, k, v, oracle
        torch.cuda.empty_cache()
    return table


#: Bound on rel_err_norm of each structured-bias mode against its plain
#: version on the same inputs (the bf16 bound of the other K1 checks).
BIAS_MODE_BOUND = 1e-2


def _sdpa_bias(bias: torch.Tensor, sq: int, skv: int, causal: bool) -> torch.Tensor:
    """A dense additive bias with the end-aligned causal mask folded in
    (-inf above the diagonal), as SDPA's attn_mask (materialised before the
    timing)."""
    if not causal:
        return bias
    keep = torch.arange(skv, device="cuda")[None] <= torch.arange(sq, device="cuda")[:, None] + skv - sq
    return torch.where(keep, bias, float("-inf"))


def _bias_case(name, q, k, v, causal, kw, counter, results, *, timed, record, extra_bytes,
               bias_heads, sdpa_bias, scale):
    """One structured-bias case: kernel against plain (bound
    BIAS_MODE_BOUND), its launch counted once. ``timed``: kernel, plain,
    SDPA given the dense bias (``sdpa_bias``, materialised before) and the
    bound, kept in the JSON when ``record``. The bound's bytes: q, k, v, o,
    ``extra_bytes`` and 4 bytes per computed score and bias head
    (``bias_heads``). Returns the max abs error."""
    before = _build.LAUNCHES[counter]
    out = flash_ops.flash_attention(q, k, v, causal=causal, sm_scale=scale, **kw)
    ref = flash_ops.flash_attention_plain(q, k, v, causal=causal, sm_scale=scale, **kw)
    torch.cuda.synchronize()
    err = rel_err_norm(out, ref)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    line = (f"{counter} {name} B{b} Sq{sq} Skv{skv} H{hq}/{hkv} D{d} {str(q.dtype)[6:]} "
            f"causal={causal}: rel_err_norm {err:.3e}, max abs {max_abs_err(out, ref):.3e} "
            f"(bound {BIAS_MODE_BOUND})")
    if err > BIAS_MODE_BOUND or not torch.isfinite(out).all() or _build.LAUNCHES[counter] != before + 1:
        raise AssertionError(line)
    if timed:
        ms = median_ms(lambda: flash_ops.flash_attention(q, k, v, causal=causal, sm_scale=scale, **kw))
        plain = median_ms(lambda: flash_ops.flash_attention_plain(q, k, v, causal=causal,
                                                                  sm_scale=scale, **kw))
        lib = sdpa_ms(q, k, v, False, sdpa_bias, scale=scale)
        pairs = attention_pairs(b, sq, skv, causal)
        elt = q.element_size()
        nbytes = elt * (2 * b * sq * hq * d + 2 * b * skv * hkv * d) + extra_bytes + 4 * pairs * bias_heads
        bnd = card_bound(4.0 * d * hq * pairs, nbytes, q.dtype)
        line += (f" | kernel {ms:.4f} ms, plain {plain:.4f} ms, SDPA with the dense bias "
                 f"{lib:.4f} ms, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
        if record:
            results[counter].update(ms=ms, plain_ms=plain, library_ms=lib, **bnd)
    print(line, flush=True)
    return max_abs_err(out, ref)


def check_flash_relbias(results: dict) -> None:
    """K1's relative-bias mode against its plain version (the materialised
    bias through the plain oracle): T5 buckets bidirectional and causal at
    B2 S2048 H16 D64 (T5-large's heads), causal at Sq 512 Skv 2048 (the
    sequence-end alignment), ALiBi causal at B2 S2048, then fp32, GQA and
    D 128. Timed at the bf16 shapes against SDPA given the materialised
    bias (untimed) as its float attn_mask; the JSON keeps the bidirectional
    case (the T5 encoder's) and ALiBi's."""
    from photonic_flash_attention_tpu_torch.ops.rel_bias import (
        ALiBi, T5RelBias, alibi_slopes, materialize,
    )

    gen = torch.Generator(device="cuda").manual_seed(9)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [  # (name, B, Sq, Skv, Hq, Hkv, D, dtype, causal, timed)
        ("t5", 2, 2048, 2048, 16, 16, 64, bf16, False, True),
        ("t5", 2, 2048, 2048, 16, 16, 64, bf16, True, True),
        ("t5", 2, 512, 2048, 16, 16, 64, bf16, True, True),
        ("alibi", 2, 2048, 2048, 16, 16, 64, bf16, True, True),
        ("t5", 2, 300, 300, 4, 2, 128, bf16, False, False),
        ("t5", 2, 200, 333, 4, 4, 64, f32, True, False),
        ("alibi", 1, 256, 256, 8, 8, 128, f32, True, False),
    ]
    worst = {"pfa_flash_fwd_relbias": 0.0, "pfa_flash_fwd_alibi": 0.0}
    for name, b, sq, skv, hq, hkv, d, dtype, causal, timed in cases:
        q = torch.randn(b, sq, hq, d, device="cuda", generator=gen).to(dtype)
        k = torch.randn(b, skv, hkv, d, device="cuda", generator=gen).to(dtype)
        v = torch.randn(b, skv, hkv, d, device="cuda", generator=gen).to(dtype)
        if name == "t5":
            table = torch.randn(32, hq, device="cuda", generator=gen) * 0.5
            spec, counter, scale = T5RelBias(table, not causal), "pfa_flash_fwd_relbias", 1.0
        else:
            spec, counter, scale = ALiBi(alibi_slopes(hq).cuda()), "pfa_flash_fwd_alibi", None
        record = timed and not results[counter]
        sdpa_bias = _sdpa_bias(materialize(spec, sq, skv), sq, skv, causal) if timed else None
        err = _bias_case(name, q, k, v, causal, dict(rel_bias=spec), counter, results, timed=timed,
                         record=record, extra_bytes=4 * hq * (sq + skv - 1), bias_heads=0,
                         sdpa_bias=sdpa_bias, scale=scale)
        worst[counter] = max(worst[counter], err)
    for counter, err in worst.items():
        results[counter]["max_abs_err"] = err


def check_flash_densebias(results: dict) -> None:
    """K1's dense-bias mode against its plain version at B4 S2048 H16 D64
    bf16: a (B,1,S,S) random-hole mask as 0/mask-value bias (non-causal,
    the engine's dense-mask case; kept in the JSON) and a real-valued
    (B,H,S,S) bias with holes, causal (tiles above the diagonal read
    nothing); then fp32, GQA and D 128. SDPA is given the same float bias."""
    gen = torch.Generator(device="cuda").manual_seed(10)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [  # (name, B, Sq, Skv, Hq, Hkv, D, dtype, causal, Hb, real, timed)
        ("mask", 4, 2048, 2048, 16, 16, 64, bf16, False, 1, False, True),
        ("real bias", 4, 2048, 2048, 16, 16, 64, bf16, True, 16, True, True),
        ("real bias", 2, 100, 300, 4, 2, 128, bf16, True, 1, True, False),
        ("mask", 2, 200, 200, 4, 4, 64, f32, False, 4, False, False),
    ]
    worst = 0.0
    for name, b, sq, skv, hq, hkv, d, dtype, causal, hb, real, timed in cases:
        q = torch.randn(b, sq, hq, d, device="cuda", generator=gen).to(dtype)
        k = torch.randn(b, skv, hkv, d, device="cuda", generator=gen).to(dtype)
        v = torch.randn(b, skv, hkv, d, device="cuda", generator=gen).to(dtype)
        bias = (torch.randn(b, hb, sq, skv, device="cuda", generator=gen) if real
                else torch.zeros(b, hb, sq, skv, device="cuda"))
        holes = torch.rand(b, hb, sq, skv, device="cuda", generator=gen) < 0.1
        bias = torch.where(holes, torch.full_like(bias, DEFAULT_MASK_VALUE), bias)
        bias[..., 0] = 0.0
        record = timed and not results["pfa_flash_fwd_densebias"]
        sdpa_bias = _sdpa_bias(bias, sq, skv, causal) if timed else None
        err = _bias_case(f"{name} (B,{hb},Sq,Skv)", q, k, v, causal, dict(attn_bias=bias),
                         "pfa_flash_fwd_densebias", results, timed=timed, record=record,
                         extra_bytes=0, bias_heads=hb, sdpa_bias=sdpa_bias, scale=None)
        worst = max(worst, err)
        del bias, sdpa_bias
    results["pfa_flash_fwd_densebias"]["max_abs_err"] = worst


TBIAS_LENS = (1, 17, 128, 129, 700, 1000, 1500, 2000)


def check_token_bias(results: dict) -> None:
    """K3's token-bias mode against its plain version at B8 H16 D64 page
    128, lengths 1-2000, over a bf16 and an int8 pool (sm_scale 1, the T5
    decode's; pages in random order, so the bias must follow the logical
    position); bound BIAS_MODE_BOUND. Then the fused decode with the bias
    (T5's decode step; pools bit-exact with K2's plain write). No PyTorch
    call computes either (library none). The JSON keeps the bf16 pool's
    numbers."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    b, hq, d, page, pps, layer = 8, 16, 64, 128, 16, 5
    lengths = torch.tensor(TBIAS_LENS, dtype=torch.int32, device="cuda")
    perm = torch.randperm(255, device="cuda", generator=gen)[: b * pps] + 1
    tables = perm.view(b, pps).to(torch.int32)
    q = torch.randn(b, hq, d, device="cuda", generator=gen)
    bias = torch.randn(b, hq, pps * page, device="cuda", generator=gen) * 2.0
    tokens = int(lengths.sum())
    worst = worst_fused = 0.0
    for pool_dtype in (torch.bfloat16, torch.int8):
        k, v, ks, vs = _serving_pools(pool_dtype, gen, L=8, hkv=hq)
        args = (q, k, v, lengths, tables, layer, ks, vs)
        before = _build.LAUNCHES["pfa_paged_decode_attend_tbias"]
        out = paged_ops.paged_decode_attend(*args, sm_scale=1.0, token_bias=bias)
        ref = paged_ops.paged_decode_attend_plain(*args, 1.0, bias)
        torch.cuda.synchronize()
        err = rel_err_norm(out, ref)
        line = (f"K3 token_bias B{b} H{hq} D{d} page{page} pool {str(pool_dtype)[6:]} lengths "
                f"{list(TBIAS_LENS)}: rel_err_norm {err:.3e} (bound {BIAS_MODE_BOUND})")
        if (err > BIAS_MODE_BOUND or not torch.isfinite(out).all()
                or _build.LAUNCHES["pfa_paged_decode_attend_tbias"] != before + 1):
            raise AssertionError(line)
        ms = median_ms(lambda: paged_ops.paged_decode_attend(*args, sm_scale=1.0, token_bias=bias))
        plain = median_ms(lambda: paged_ops.paged_decode_attend_plain(*args, 1.0, bias))
        elt = k.element_size()
        nbytes = (2 * tokens * hq * d * elt + 2 * 4 * tokens * hq * (pool_dtype == torch.int8)
                  + 4 * tokens * hq + 2 * 4 * b * hq * d + 4 * b + 4 * b * pps)
        bnd = card_bound(4.0 * d * hq * tokens, nbytes, torch.float32)
        print(f"{line} | kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {bnd['bound_ms']:.4f} ms "
              f"({bnd['bound_by']}), library none", flush=True)
        worst = max(worst, max_abs_err(out, ref))
        if pool_dtype == torch.bfloat16:
            results["pfa_paged_decode_attend_tbias"].update(ms=ms, plain_ms=plain, library_ms=None,
                                                            **bnd)
        # The fused decode with the bias (T5's decode step): one launch,
        # pools bit-exact with K2's plain write, then the attend.
        slots = torch.zeros(b, dtype=torch.int32, device="cuda")
        for i, n in enumerate(TBIAS_LENS):
            slots[i] = tables[i, (n - 1) // page] * page + (n - 1) % page
        k_new, v_new = (torch.randn(b, hq, d, device="cuda", generator=gen).to(torch.bfloat16)
                        for _ in range(2))
        pools = [t for t in (k, v, ks, vs) if t is not None]
        ref_pools = [t.clone() if t is not None else None for t in (k, v, ks, vs)]
        before = _build.LAUNCHES["pfa_paged_decode_fused_tbias"]

        def fused():
            return paged_ops.paged_decode_attention(q, k_new, v_new, k, v, lengths, tables, slots,
                                                    layer, ks, vs, sm_scale=1.0, token_bias=bias)

        def fused_plain():
            paged_ops.paged_token_write_plain(k_new, v_new, *ref_pools, slots, layer)
            return paged_ops.paged_decode_attend_plain(q, *ref_pools[:2], lengths, tables, layer,
                                                       *ref_pools[2:], 1.0, bias)

        out, ref = fused(), fused_plain()
        torch.cuda.synchronize()
        err = rel_err_norm(out, ref)
        exact = all(torch.equal(a, w) for a, w in zip(pools, ref_pools))
        line = (f"K3 fused decode with token_bias B{b} H{hq} D{d} page{page} pool "
                f"{str(pool_dtype)[6:]}: pools bit-exact with K2's plain write: {exact}; "
                f"rel_err_norm {err:.3e} (bound {BIAS_MODE_BOUND})")
        if (not exact or err > BIAS_MODE_BOUND or not torch.isfinite(out).all()
                or _build.LAUNCHES["pfa_paged_decode_fused_tbias"] != before + 1):
            raise AssertionError(line)
        ms, plain = median_ms(fused), median_ms(fused_plain)
        bnd = k3_bound(b, hq, hq, d, k.element_size(), tokens, pps, 4, pool_dtype == torch.int8,
                       bias=True, fused_in=2)
        print(f"{line} | kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {bnd['bound_ms']:.4f} ms "
              f"({bnd['bound_by']}), library none", flush=True)
        worst_fused = max(worst_fused, max_abs_err(out, ref))
        if pool_dtype == torch.bfloat16:
            results["pfa_paged_decode_fused_tbias"].update(ms=ms, plain_ms=plain, library_ms=None,
                                                           **bnd)
        del k, v, ks, vs, pools, ref_pools
    results["pfa_paged_decode_attend_tbias"]["max_abs_err"] = worst
    results["pfa_paged_decode_fused_tbias"]["max_abs_err"] = worst_fused


DROPOUT_RATE, DROPOUT_SEED = 0.1, 1234


def check_flash_dropout(results: dict) -> None:
    """K1's dropout stream against its plain version (the same positional
    mask, so only K1's own rounding differs): GPT-2 training's shape class
    at B4 S2048 H12 D64 causal bf16, rate 0.1 (timed; SDPA with
    dropout_p=0.1 as the library time, which draws its own mask), then
    fp32, GQA and Sq 512 / Skv 2048."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [  # (B, Sq, Skv, Hq, Hkv, D, dtype, causal, timed)
        (4, 2048, 2048, 12, 12, 64, bf16, True, True),
        (2, 512, 2048, 16, 16, 64, bf16, True, False),
        (2, 300, 300, 8, 2, 128, bf16, False, False),
        (2, 200, 333, 4, 2, 64, f32, True, False),
    ]
    kw = dict(dropout_rate=DROPOUT_RATE, dropout_seed=DROPOUT_SEED)
    worst = 0.0
    for b, sq, skv, hq, hkv, d, dtype, causal, timed in cases:
        q = torch.randn(b, sq, hq, d, device="cuda", generator=gen).to(dtype)
        k = torch.randn(b, skv, hkv, d, device="cuda", generator=gen).to(dtype)
        v = torch.randn(b, skv, hkv, d, device="cuda", generator=gen).to(dtype)
        before = _build.LAUNCHES["pfa_flash_fwd_dropout"]
        out = flash_ops.flash_attention(q, k, v, causal=causal, **kw)
        ref = flash_ops.flash_attention_plain(q, k, v, causal=causal, **kw)
        torch.cuda.synchronize()
        bound = 1e-2 if dtype == bf16 else 1e-4
        err = rel_err_norm(out, ref)
        worst = max(worst, max_abs_err(out, ref))
        line = (f"K1 dropout B{b} Sq{sq} Skv{skv} H{hq}/{hkv} D{d} {str(dtype)[6:]} causal={causal} "
                f"rate {DROPOUT_RATE}: rel_err_norm {err:.3e}, max abs {max_abs_err(out, ref):.3e} "
                f"(bound {bound})")
        if (err > bound or not torch.isfinite(out).all()
                or _build.LAUNCHES["pfa_flash_fwd_dropout"] != before + 1):
            raise AssertionError(line)
        if timed:
            ms = median_ms(lambda: flash_ops.flash_attention(q, k, v, causal=causal, **kw))
            plain = median_ms(lambda: flash_ops.flash_attention_plain(q, k, v, causal=causal, **kw))
            lib = sdpa_ms(q, k, v, causal, dropout_p=DROPOUT_RATE)
            bnd = flash_fwd_bound(q, k, causal)
            line += (f" | kernel {ms:.4f} ms (K1 without dropout "
                     f"{median_ms(lambda: flash_ops.flash_attention(q, k, v, causal=causal)):.4f} ms), "
                     f"plain {plain:.4f} ms, SDPA dropout_p={DROPOUT_RATE} (its own mask) {lib:.4f} ms, "
                     f"bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
            results["pfa_flash_fwd_dropout"].update(ms=ms, plain_ms=plain, library_ms=lib, **bnd)
        print(line, flush=True)
    results["pfa_flash_fwd_dropout"]["max_abs_err"] = worst


#: bench.py's long-window row (flash_bf16_causal_window4096_b1_s65536).
WINDOW_LONG = (1, 65536, 12, 64, (-4095, 0))
#: K1's window against the plain version at B1 S8192 H12 D64 bf16, where the
#: plain version fits: (window, causal, timed and kept in the JSON).
WINDOW_CASES = (((-4095, 0), True, True), ((-256, 256), False, True), ((-1000, None), True, False))


def _band_mask(sq: int, skv: int, causal: bool, window) -> torch.Tensor:
    """The causal mask and the window as one (Sq, Skv) boolean mask (True =
    attend), SDPA's attn_mask."""
    from photonic_flash_attention_tpu_torch.ops.reference import window_keep

    return window_keep(sq, skv, causal, window, "cuda")


def check_flash_window(results: dict) -> None:
    """K1's window stream: against its plain version at B1 S8192 H12 D64
    bf16 (WINDOW_CASES; SDPA given the same boolean band mask as the
    library time), fp32 and GQA at small shapes; then bench.py's long row,
    B1 S65536 H12 causal with window (-4095, 0), timed against its bound,
    which counts only the in-band pairs (no plain version or SDPA mask fits
    there)."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(1, 8192, 8192, 12, 12, 64, bf16, causal, window, timed)
             for window, causal, timed in WINDOW_CASES]
    cases += [(2, 300, 333, 4, 2, 128, bf16, True, (-100, 0), False),
              (2, 200, 200, 4, 4, 64, f32, False, (-30, 50), False)]
    worst = 0.0
    for b, sq, skv, hq, hkv, d, dtype, causal, window, timed in cases:
        q = torch.randn(b, sq, hq, d, device="cuda", generator=gen).to(dtype)
        k = torch.randn(b, skv, hkv, d, device="cuda", generator=gen).to(dtype)
        v = torch.randn(b, skv, hkv, d, device="cuda", generator=gen).to(dtype)
        before = _build.LAUNCHES["pfa_flash_fwd_window"]
        out = flash_ops.flash_attention(q, k, v, causal=causal, window=window)
        ref = flash_ops.flash_attention_plain(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        bound = 1e-2 if dtype == bf16 else 1e-4
        err = rel_err_norm(out, ref)
        worst = max(worst, max_abs_err(out, ref))
        line = (f"K1 window {window} B{b} Sq{sq} Skv{skv} H{hq}/{hkv} D{d} {str(dtype)[6:]} "
                f"causal={causal}: rel_err_norm {err:.3e}, max abs {max_abs_err(out, ref):.3e} "
                f"(bound {bound})")
        if (err > bound or not torch.isfinite(out).all()
                or _build.LAUNCHES["pfa_flash_fwd_window"] != before + 1):
            raise AssertionError(line)
        if timed:
            ms = median_ms(lambda: flash_ops.flash_attention(q, k, v, causal=causal, window=window))
            plain = median_ms(lambda: flash_ops.flash_attention_plain(q, k, v, causal=causal,
                                                                      window=window), runs=5)
            lib = sdpa_ms(q, k, v, False, _band_mask(sq, skv, causal, window))
            bnd = flash_fwd_bound(q, k, causal, window=window)
            line += (f" | kernel {ms:.4f} ms, plain {plain:.4f} ms, SDPA with the band mask "
                     f"{lib:.4f} ms, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}, "
                     f"{attention_pairs(b, sq, skv, causal, window=window)} pairs)")
            if not results["pfa_flash_fwd_window"]:
                results["pfa_flash_fwd_window"].update(ms=ms, plain_ms=plain, library_ms=lib, **bnd)
        print(line, flush=True)
        del q, k, v, out, ref
    results["pfa_flash_fwd_window"]["max_abs_err"] = worst
    torch.cuda.empty_cache()
    b, s, h, d, window = WINDOW_LONG
    q, k, v = (torch.randn(b, s, h, d, device="cuda", generator=gen).to(bf16) for _ in range(3))
    out = flash_ops.flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        raise AssertionError("K1 window S65536: non-finite output")
    ms = median_ms(lambda: flash_ops.flash_attention(q, k, v, causal=True, window=window))
    full = median_ms(lambda: flash_ops.flash_attention(q, k, v, causal=True), runs=3, warmup=1)
    bnd = flash_fwd_bound(q, k, True, window=window)
    print(f"K1 window {window} B{b} S{s} H{h} D{d} bf16 causal (bench.py's "
          f"flash_bf16_causal_window4096_b1_s65536): kernel {ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms "
          f"({bnd['bound_by']}, {attention_pairs(b, s, s, True, window=window)} pairs), "
          f"{bnd['bound_ms'] / ms * 100:.1f}% of the bound's rate; causal K1 without the window "
          f"{full:.4f} ms", flush=True)
    results["pfa_flash_fwd_window"].update(s65536_ms=ms, s65536_bound_ms=bnd["bound_ms"])
    del q, k, v, out
    torch.cuda.empty_cache()


def bwd_bounds(q, k, causal, window=None):
    """K4's and K5's bounds: 8 and 6 D operations per (query, key) pair
    and query head (K4: s, dp, dv, dk; K5: s, dp, dq, with the exp shared;
    K5 also 2 D a row for di), each input read once and each output
    written once: K4 reads q, dO (Hq heads), k, v (Hkv), lse and di and
    writes dk, dv (Hkv); K5 reads q, o, dO, k, v and lse and writes dq and
    di."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    pairs = attention_pairs(b, sq, skv, causal, window=window)
    elt = q.element_size()
    rows_q, rows_kv, vec = elt * b * sq * hq * d, elt * b * skv * hkv * d, 4 * b * hq * sq
    return (card_bound(8.0 * d * hq * pairs, 2 * rows_q + 4 * rows_kv + 2 * vec, q.dtype),
            card_bound(6.0 * d * hq * pairs + 2.0 * d * b * sq * hq,
                       4 * rows_q + 2 * rows_kv + 2 * vec, q.dtype))


def check_flash_bwd_streams(results: dict, smi: str) -> None:
    """K4/K5's dropout and window streams against the plain backward on the
    same inputs (the forward's lse from the plain version): B4 S2048 H12
    D64 causal bf16 with dropout 0.1 and with window (-255, 0), timed (SDPA's
    backward with dropout_p=0.1, its own mask, or with the same band mask
    as the library time), then fp32, Sq < Skv, and dropout and a window at
    GQA group 4 (native K/V)."""
    gen = torch.Generator(device="cuda").manual_seed(14)
    bf16, f32 = torch.bfloat16, torch.float32
    drop = dict(dropout_rate=DROPOUT_RATE, dropout_seed=DROPOUT_SEED)
    win = dict(window=(-255, 0))
    cases = [  # (B, Sq, Skv, Hq, Hkv, D, dtype, causal, streams, timed)
        (4, 2048, 2048, 12, 12, 64, bf16, True, drop, True),
        (4, 2048, 2048, 12, 12, 64, bf16, True, win, True),
        (2, 256, 384, 4, 4, 128, bf16, False, dict(window=(-90, 40)), False),
        (2, 200, 333, 4, 4, 64, f32, True, drop, False),
        (2, 256, 256, 4, 4, 64, f32, False, dict(window=(-30, 50)), False),
        (2, 300, 300, 8, 2, 64, bf16, True, drop, False),
        (2, 256, 384, 16, 4, 128, bf16, True, dict(window=(-90, 0)), False),
    ]
    worst = collections.Counter()
    for b, sq, skv, h, hkv, d, dtype, causal, streams, timed in cases:
        q = torch.randn(b, sq, h, d, device="cuda", generator=gen).to(dtype)
        k = torch.randn(b, skv, hkv, d, device="cuda", generator=gen).to(dtype)
        v = torch.randn(b, skv, hkv, d, device="cuda", generator=gen).to(dtype)
        do = torch.randn(b, sq, h, d, device="cuda", generator=gen).to(dtype)
        o, lse = flash_ops.flash_attention_with_lse_plain(q, k, v, causal=causal, **streams)
        mode = "dropout" if "dropout_rate" in streams else "window"
        names = (f"pfa_flash_bwd_dkv_{mode}", f"pfa_flash_bwd_dq_{mode}")
        before = dict(_build.LAUNCHES)
        kw = dict(sm_scale=d ** -0.5, causal=causal, **streams)
        got = bwd_ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        want = bwd_ops.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        bound = 1e-2 if dtype == bf16 else 1e-4
        errs = [rel_err_norm(g, w) for g, w in zip(got, want)]
        line = (f"K4/K5 {mode} {streams.get('window', DROPOUT_RATE)} B{b} Sq{sq} Skv{skv} H{h}/{hkv} D{d} "
                f"{str(dtype)[6:]} causal={causal}: rel_err_norm dq {errs[0]:.3e} dk {errs[1]:.3e} "
                f"dv {errs[2]:.3e} (bound {bound})")
        if (max(errs) > bound or not all(torch.isfinite(g).all() for g in got)
                or any(_build.LAUNCHES[n] != before.get(n, 0) + 1 for n in names)):
            raise AssertionError(line)
        worst[names[1]] = max(worst[names[1]], max_abs_err(got[0], want[0]))
        worst[names[0]] = max(worst[names[0]], max_abs_err(got[1], want[1]), max_abs_err(got[2], want[2]))
        if timed:
            oc = o.contiguous()
            di = bwd_ops.flash_bwd_dq(q, k, v, oc, lse, do, **kw)[1]
            ms_dkv = median_ms(lambda: bwd_ops.flash_bwd_dkv(q, k, v, do, lse, di, **kw))
            ms_dq = median_ms(lambda: bwd_ops.flash_bwd_dq(q, k, v, oc, lse, do, **kw))
            plain = median_ms(lambda: bwd_ops.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw),
                              runs=5)
            lib_kw = (dict(is_causal=causal, dropout_p=DROPOUT_RATE) if mode == "dropout"
                      else dict(attn_mask=_band_mask(sq, skv, causal, streams["window"])))
            lib = sdpa_bwd_ms(q, k, v, do, **lib_kw)
            bnd_dkv, bnd_dq = bwd_bounds(q, k, causal, streams.get("window"))
            line += (f" | K4 {ms_dkv:.4f} ms (bound {bnd_dkv['bound_ms']:.4f}), K5 with di {ms_dq:.4f} "
                     f"ms (bound {bnd_dq['bound_ms']:.4f}), plain backward (dq, dk, dv) {plain:.4f} ms, "
                     f"SDPA backward {'dropout_p=0.1 (its own mask)' if mode == 'dropout' else 'with the band mask'} "
                     f"{lib:.4f} ms ({smi})")
            results[names[0]].update(ms=ms_dkv, plain_ms=plain, library_ms=lib, **bnd_dkv)
            results[names[1]].update(ms=ms_dq, plain_ms=plain, library_ms=lib, **bnd_dq)
        print(line, flush=True)
    for name, err in worst.items():
        results[name]["max_abs_err"] = err


def check_flash_rel_lse(results: dict) -> None:
    """K1's relative-bias mode writing lse (the residual of the T5 gradient)
    against the plain version, output and lse: T5 buckets both directions at
    B2 S2048 H16 D64 bf16 (timed, the bidirectional case kept in the JSON;
    SDPA given the materialised bias as the library time), causal at Sq 512
    / Skv 2048, ALiBi, fp32. Also times the plain relative-bias backward
    (``flash_attention_bwd_masked_plain``, the port of JAX's XLA backward)
    at the T5 training shapes."""
    from photonic_flash_attention_tpu_torch.ops.rel_bias import (
        ALiBi, T5RelBias, alibi_slopes, materialize,
    )

    gen = torch.Generator(device="cuda").manual_seed(15)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [  # (kind, B, Sq, Skv, H, D, dtype, causal, timed)
        ("t5", 2, 2048, 2048, 16, 64, bf16, False, True),
        ("t5", 2, 512, 2048, 16, 64, bf16, True, False),
        ("t5", 2, 1024, 1024, 16, 64, f32, True, False),
        ("alibi", 2, 2048, 2048, 16, 64, bf16, True, True),
        ("alibi", 1, 300, 300, 8, 128, f32, True, False),
    ]
    worst = collections.Counter()
    for kind, b, sq, skv, h, d, dtype, causal, timed in cases:
        q = torch.randn(b, sq, h, d, device="cuda", generator=gen).to(dtype)
        k = torch.randn(b, skv, h, d, device="cuda", generator=gen).to(dtype)
        v = torch.randn(b, skv, h, d, device="cuda", generator=gen).to(dtype)
        if kind == "t5":
            spec = T5RelBias(torch.randn(32, h, device="cuda", generator=gen) * 0.5, not causal)
            counter, scale = "pfa_flash_fwd_relbias", 1.0
        else:
            spec, counter, scale = ALiBi(alibi_slopes(h).cuda()), "pfa_flash_fwd_alibi", d ** -0.5
        name = f"{counter}_lse"
        vec = flash_ops._rel_vector(spec, sq, skv)
        dense = flash_ops.vector_bias(vec, sq, skv)
        before = _build.LAUNCHES[name]
        out, lse = flash_ops._flash_fwd_bias_cuda(q, k, v, causal, scale, counter, vec=vec, save_lse=True)
        ref, ref_lse = flash_ops.flash_attention_with_lse_plain(q, k, v, causal=causal, sm_scale=scale,
                                                                bias=dense)
        torch.cuda.synchronize()
        bound = 1e-2 if dtype == bf16 else 1e-4
        err, lse_err = rel_err_norm(out, ref), rel_err_norm(lse, ref_lse)
        worst[name] = max(worst[name], max_abs_err(out, ref))
        line = (f"{name} B{b} Sq{sq} Skv{skv} H{h} D{d} {str(dtype)[6:]} causal={causal}: rel_err_norm "
                f"{err:.3e} (bound {bound}), lse {lse_err:.3e} (bound 1e-4)")
        if (err > bound or lse_err > 1e-4 or not torch.isfinite(lse).all()
                or _build.LAUNCHES[name] != before + 1):
            raise AssertionError(line)
        if timed:
            ms = median_ms(lambda: flash_ops._flash_fwd_bias_cuda(q, k, v, causal, scale, counter,
                                                                  vec=vec, save_lse=True))
            plain = median_ms(lambda: flash_ops.flash_attention_with_lse_plain(
                q, k, v, causal=causal, sm_scale=scale, bias=dense))
            lib = sdpa_ms(q, k, v, False, _sdpa_bias(materialize(spec, sq, skv), sq, skv, causal),
                          scale=scale)
            pairs = attention_pairs(b, sq, skv, causal)
            elt = q.element_size()
            nbytes = (elt * (2 * b * sq * h * d + 2 * b * skv * h * d) + 4 * h * (sq + skv - 1)
                      + 4 * b * h * sq)
            bnd = card_bound(4.0 * d * h * pairs, nbytes, dtype)
            line += (f" | kernel {ms:.4f} ms, plain {plain:.4f} ms, SDPA with the dense bias "
                     f"{lib:.4f} ms, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
            results[name].update(ms=ms, plain_ms=plain, library_ms=lib, **bnd)
            if kind == "t5":
                do = torch.randn_like(q)
                bwd_kw = dict(sm_scale=scale, causal=causal, rel_vec=vec)
                bwd = median_ms(lambda: flash_ops.flash_attention_bwd_masked_plain(
                    q, k, v, out, lse, do, **bwd_kw), runs=5)
                line += f"; plain relative-bias backward (dq, dk, dv, d vec) {bwd:.4f} ms"
        print(line, flush=True)
    for name, err in worst.items():
        results[name]["max_abs_err"] = err


#: Sequence lengths of the bf16 kernel's ragged edge cases: every pair with
#: Sq != Skv, causal aligned to the sequence end.
EDGE_LENGTHS = (1, 127, 129, 300)


def check_k1_edges() -> None:
    """The bf16 kernel's edges against the plain version, output and lse,
    each launch under its mode's counter (bf16 bound 1e-2, lse 1e-4 on the
    rows with a key, -inf where the plain lse is): every (Sq, Skv) pair of
    EDGE_LENGTHS with Sq != Skv at D 64 and 128, GQA 12/4 and 32/8, a lens
    row of 0 (o = 0, lse = -inf), a window with rows that see no key (o = 0),
    dense bias at Skv 301 (the cp.async side) and 300 (the TMA side) with Hb
    1 and Hq, the relative bias at a ragged Sq, and dropout at 0.1 against
    the plain version fed the same seed."""
    gen = torch.Generator(device="cuda").manual_seed(16)
    cases = [(f"ragged Sq{sq} Skv{skv}", 2, sq, skv, 4, 2, d, True, {}, "pfa_flash_fwd")
             for sq in EDGE_LENGTHS for skv in EDGE_LENGTHS if sq != skv for d in (64, 128)]
    cases += [  # (label, B, Sq, Skv, Hq, Hkv, D, causal, streams, counter)
        ("GQA 12/4", 2, 300, 300, 12, 4, 64, True, {}, "pfa_flash_fwd"),
        ("GQA 32/8", 1, 513, 513, 32, 8, 128, True, {}, "pfa_flash_fwd"),
        ("lens (300, 0, 129)", 3, 129, 300, 4, 2, 64, True, dict(kv_lens=(300, 0, 129)),
         "pfa_flash_fwd_streams"),
        ("lens (0, 300) and k_bias", 2, 300, 300, 4, 4, 128, False,
         dict(kv_lens=(0, 300), k_bias=True), "pfa_flash_fwd_streams"),
        ("window (-20, -5): rows 0-4 see no key", 2, 300, 300, 4, 4, 64, False,
         dict(window=(-20, -5)), "pfa_flash_fwd_window"),
        ("window (-40, 0) causal", 2, 129, 300, 4, 2, 128, True, dict(window=(-40, 0)),
         "pfa_flash_fwd_window"),
        ("dropout 0.1", 2, 300, 300, 4, 2, 64, True, dict(dropout_rate=0.1, dropout_seed=77),
         "pfa_flash_fwd_dropout"),
        ("dropout 0.1", 1, 129, 301, 8, 8, 128, False, dict(dropout_rate=0.1, dropout_seed=5),
         "pfa_flash_fwd_dropout"),
    ]
    for skv in (301, 300):  # the cp.async and the TMA side of the dense bias
        for hb in (1, 4):
            for d in (64, 128):
                cases.append((f"dense bias Hb{hb} ({'TMA' if skv % 4 == 0 else 'cp.async'} side)",
                              2, 129, skv, 4, 2, d, hb == 1, dict(dense_heads=hb),
                              "pfa_flash_fwd_densebias_lse"))
    cases.append(("relative bias (T5, ragged)", 2, 129, 300, 4, 2, 64, True, dict(rel=True),
                  "pfa_flash_fwd_relbias_lse"))
    for case in cases:
        _k1_case(gen, *case)


def _k1_case(gen, label, b, sq, skv, hq, hkv, d, causal, streams, counter,
             save_lse: bool = True) -> float:
    """One bf16 K1 launch against the plain version (check_k1_edges' bounds:
    output 1e-2, lse 1e-4 on the rows with a key, -inf where the plain lse
    is, o = 0 on rows with no key, one launch under ``counter``); without
    ``save_lse``, the inference call, which writes no lse. Returns the
    output's max abs error."""
    q = torch.randn(b, sq, hq, d, device="cuda", generator=gen).to(torch.bfloat16)
    k = torch.randn(b, skv, hkv, d, device="cuda", generator=gen).to(torch.bfloat16)
    v = torch.randn(b, skv, hkv, d, device="cuda", generator=gen).to(torch.bfloat16)
    scale = d ** -0.5
    kw, plain_kw = {}, {}
    if "kv_lens" in streams:
        kw["kv_lens"] = torch.tensor(streams["kv_lens"], dtype=torch.int32, device="cuda")
        if streams.get("k_bias"):
            kw["k_bias"] = _key_bias(b, skv, gen)
        plain_kw = dict(kw)
    for key in ("window", "dropout_rate", "dropout_seed"):
        if key in streams:
            kw[key] = plain_kw[key] = streams[key]
    before = _build.LAUNCHES[counter]
    if "dense_heads" in streams or "rel" in streams or "alibi" in streams:
        if "dense_heads" not in streams:
            from photonic_flash_attention_tpu_torch.ops.rel_bias import (
                ALiBi, T5RelBias, alibi_slopes,
            )

            if "alibi" in streams:
                spec = ALiBi(alibi_slopes(hq).cuda())
            else:
                spec = T5RelBias(torch.randn(32, hq, device="cuda", generator=gen) * 0.5,
                                 not causal)
            vec = flash_ops._rel_vector(spec, sq, skv)
            bias, bkw = flash_ops.vector_bias(vec, sq, skv), dict(vec=vec)
            name = flash_ops._rel_counter(spec)
        else:
            bias = torch.randn(b, streams["dense_heads"], sq, skv, device="cuda", generator=gen)
            holes = torch.rand(bias.shape, device="cuda", generator=gen) < 0.1
            bias = torch.where(holes, torch.full_like(bias, DEFAULT_MASK_VALUE), bias)
            bkw, name = dict(dense=bias), "pfa_flash_fwd_densebias"
        out, lse = flash_ops._flash_fwd_bias_cuda(q, k, v, causal, scale, name, save_lse=save_lse,
                                                  **bkw)
        plain_kw["bias"] = bias
    else:
        out, lse = flash_ops._flash_fwd_cuda(q, k, v, causal, scale, save_lse, **kw)
    ref, ref_lse = flash_ops.flash_attention_with_lse_plain(q, k, v, causal=causal,
                                                            sm_scale=scale, **plain_kw)
    torch.cuda.synchronize()
    err = rel_err_norm(out, ref)
    live = torch.isfinite(ref_lse)
    empty = ~live.transpose(1, 2)  # (B, Sq, Hq): rows with no key
    lse_err = 0.0
    if save_lse:
        lse_err = rel_err_norm(lse[live], ref_lse[live]) if live.any() else 0.0
    line = (f"K1 edge {label} B{b} Sq{sq} Skv{skv} H{hq}/{hkv} D{d} bf16 causal={causal}: "
            f"rel_err_norm {err:.3e} (bound 1e-2), "
            + (f"lse {lse_err:.3e} (bound 1e-4), " if save_lse else "no lse written, ")
            + f"{int(empty.sum())} (row, head) pairs with no key")
    if (err > 1e-2 or lse_err > 1e-4 or not torch.isfinite(out).all() or out.shape != q.shape
            or (save_lse and not torch.equal(torch.isneginf(lse), torch.isneginf(ref_lse)))
            or (out[empty] != 0).any() or _build.LAUNCHES[counter] != before + 1):
        raise AssertionError(line)
    print(line, flush=True)
    return max_abs_err(out, ref)


def _sdpa_call(q, k, v, **kw):
    """One F.scaled_dot_product_attention call on (B, S, H, D) inputs in its
    (B, H, S, D) layout, K/V repeated over a GQA group; the transposes and
    repeats are made here, outside any timing."""
    import torch.nn.functional as F

    group = q.shape[2] // k.shape[2]
    qt, kt, vt = (t.repeat_interleave(n, dim=2).transpose(1, 2).contiguous()
                  for t, n in ((q, 1), (k, group), (v, group)))
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, **kw)


#: The graph fit of the K1 table (two replays of CUDA graphs of 2 and 10
#: calls, as the experiments' mains).
K1_TABLE_FIT = (2, 10)
#: The probe table's fixed row count: one wave at 512 columns in both of
#: K12's layouts (three 128-thread blocks of 32 rows, a quad a row, or six
#: of 16, eight threads a row, on each of 132 SMs).
PROBE_TABLE_ROWS = 12672


def time_k1_modes(results: dict, smi: str) -> None:
    """K1's bf16 modes at the shapes of PERF.md's table against SDPA on the
    same function, each by CUDA events (``median_ms``) and by the graph fit
    (``fit_seconds``), in this run: plain B4 S2048 H12 D64 causal (the
    headline), the (B,1,S,S) dense mask at B4 S2048 H16, T5's relative bias
    at B2 S2048 H16 (the call building its vector, and the vector prebuilt
    with lse), ALiBi causal with and without lse, dropout 0.1 (SDPA draws
    its own mask) and the training geometry B2 S4096 Hq32/Hkv8 D128 causal
    with lse; each beside its bound and K1's share of it. The headline's
    graph-fit time goes to the roofline phase's composite-ceiling line."""
    from photonic_flash_attention_tpu_torch.ops.rel_bias import (
        ALiBi, T5RelBias, alibi_slopes, materialize,
    )

    gen = torch.Generator(device="cuda").manual_seed(17)
    dev = torch.device("cuda")

    def qkv(b, s, hq, hkv, d):
        return [torch.randn(b, s, h, d, device="cuda", generator=gen).to(torch.bfloat16)
                for h in (hq, hkv, hkv)]

    def bias_bound(q, k, causal, extra_bytes, bias_heads):
        b, sq, hq, d = q.shape
        skv, hkv = k.shape[1], k.shape[2]
        pairs = attention_pairs(b, sq, skv, causal)
        nbytes = 2 * (2 * b * sq * hq * d + 2 * b * skv * hkv * d) + extra_bytes + 4 * pairs * bias_heads
        return card_bound(4.0 * d * hq * pairs, nbytes, torch.bfloat16)

    rows = []
    q, k, v = qkv(4, 2048, 12, 12, 64)
    rows.append(("plain B4 S2048 H12 D64 causal", lambda: flash_ops.flash_attention(q, k, v, causal=True),
                 _sdpa_call(q, k, v, is_causal=True), flash_fwd_bound(q, k, True), "SDPA"))
    rows.append(("dropout 0.1, the same shape",
                 lambda: flash_ops.flash_attention(q, k, v, causal=True, dropout_rate=0.1,
                                                   dropout_seed=DROPOUT_SEED),
                 _sdpa_call(q, k, v, is_causal=True, dropout_p=0.1), flash_fwd_bound(q, k, True),
                 "SDPA dropout_p=0.1, its own mask"))
    qd, kd, vd = qkv(4, 2048, 16, 16, 64)
    mask = torch.where(torch.rand(4, 1, 2048, 2048, device="cuda", generator=gen) < 0.1,
                       DEFAULT_MASK_VALUE, 0.0)
    mask[..., 0] = 0.0
    rows.append(("dense bias, (B,1,S,S) mask, B4 S2048 H16 D64",
                 lambda: flash_ops.flash_attention(qd, kd, vd, attn_bias=mask),
                 _sdpa_call(qd, kd, vd, attn_mask=mask), bias_bound(qd, kd, False, 0, 1),
                 "SDPA, same bias"))
    qr, kr, vr = qkv(2, 2048, 16, 16, 64)
    t5 = T5RelBias(torch.randn(32, 16, device="cuda", generator=gen) * 0.5, True)
    dense_t5 = materialize(t5, 2048, 2048)
    vec = flash_ops._rel_vector(t5, 2048, 2048)
    rel_bytes = 4 * 16 * (2 * 2048 - 1)
    rows.append(("T5 relative bias, B2 S2048 H16 D64 bidirectional (the call builds the vector)",
                 lambda: flash_ops.flash_attention(qr, kr, vr, sm_scale=1.0, rel_bias=t5),
                 _sdpa_call(qr, kr, vr, attn_mask=dense_t5, scale=1.0),
                 bias_bound(qr, kr, False, rel_bytes, 0), "SDPA, dense bias"))
    rows.append(("relative bias with lse, the vector prebuilt",
                 lambda: flash_ops._flash_fwd_bias_cuda(qr, kr, vr, False, 1.0, "pfa_flash_fwd_relbias",
                                                        vec=vec, save_lse=True),
                 _sdpa_call(qr, kr, vr, attn_mask=dense_t5, scale=1.0),
                 bias_bound(qr, kr, False, rel_bytes + 4 * 2 * 16 * 2048, 0), "SDPA, dense bias"))
    alibi = ALiBi(alibi_slopes(16).cuda())
    avec = flash_ops._rel_vector(alibi, 2048, 2048)
    dense_alibi = _sdpa_bias(materialize(alibi, 2048, 2048), 2048, 2048, True)
    rows.append(("ALiBi, B2 S2048 H16 D64 causal",
                 lambda: flash_ops.flash_attention(qr, kr, vr, causal=True, rel_bias=alibi),
                 _sdpa_call(qr, kr, vr, attn_mask=dense_alibi), bias_bound(qr, kr, True, rel_bytes, 0),
                 "SDPA, dense bias"))
    rows.append(("ALiBi with lse, the vector prebuilt",
                 lambda: flash_ops._flash_fwd_bias_cuda(qr, kr, vr, True, 64 ** -0.5,
                                                        "pfa_flash_fwd_alibi", vec=avec, save_lse=True),
                 _sdpa_call(qr, kr, vr, attn_mask=dense_alibi),
                 bias_bound(qr, kr, True, rel_bytes + 4 * 2 * 16 * 2048, 0), "SDPA, dense bias"))
    qt, kt, vt = qkv(2, 4096, 32, 8, 128)
    rows.append(("training geometry B2 S4096 Hq32/Hkv8 D128 causal with lse",
                 lambda: flash_ops.flash_attention_with_lse(qt, kt, vt, causal=True),
                 _sdpa_call(qt, kt, vt, is_causal=True), flash_fwd_bound(qt, kt, True, with_lse=True),
                 "SDPA (K/V repeated over the group outside the timing)"))
    table = []
    for name, k1, lib, bnd, lib_name in rows:
        ev, fit = median_ms(k1), fit_seconds(k1, K1_TABLE_FIT, dev) * 1e3
        lib_ev, lib_fit = median_ms(lib), fit_seconds(lib, K1_TABLE_FIT, dev) * 1e3
        row = dict(name=name, k1_ms=ev, k1_fit_ms=fit, sdpa_ms=lib_ev, sdpa_fit_ms=lib_fit, **bnd)
        table.append(row)
        print(f"K1 table: {name}: K1 {ev:.4f} ms (CUDA events), {fit:.4f} ms (graph fit); "
              f"{lib_name} {lib_ev:.4f} / {lib_fit:.4f} ms; K1 / SDPA {ev / lib_ev:.3f} (events), "
              f"{fit / lib_fit:.3f} (fit); bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}), "
              f"K1 at {100 * bnd['bound_ms'] / ev:.2f} % (events), "
              f"{100 * bnd['bound_ms'] / fit:.2f} % (fit) of it ({smi})", flush=True)
    results["pfa_flash_fwd"]["fit_ms"] = table[0]["k1_fit_ms"]
    results["k1_table"] = table
    del q, k, v, qd, kd, vd, mask, qr, kr, vr, dense_t5, dense_alibi, qt, kt, vt
    torch.cuda.empty_cache()


def check_bwd_edges() -> None:
    """K4 and K5's bf16 bodies at their edges against the plain backward
    (1e-2 rel_err_norm on dq, dk and dv), each launch under its mode's
    counters, and every case launched twice on the same inputs with
    bit-identical dq, dk and dv (no atomic additions of values): every
    (Sq, Skv) pair of EDGE_LENGTHS with Sq != Skv at D 64 and 128, causal
    where Sq < Skv; GQA 12/4 and 32/8 through flash_attention's autograd
    (K1 with lse, then K5 and K4 on native K/V, whose planner cuts the
    group into slices) against the plain versions; window rows that see no
    key (their dq 0); a
    causal window at Sq < Skv; dropout 0.1 (the plain version fed the same
    seed). With one key (Skv 1) and no dropout, o = V[0] exactly, P = 1 and
    dP = di up to fp32 rounding, so the exact dq and dk are 0 and both
    sides hold only that rounding: there they must stay below 1e-3 of dv's
    norm instead."""
    gen = torch.Generator(device="cuda").manual_seed(19)
    cases = [(f"ragged Sq{sq} Skv{skv}", 2, sq, skv, 4, 4, d, sq < skv, {})
             for sq in EDGE_LENGTHS for skv in EDGE_LENGTHS if sq != skv for d in (64, 128)]
    cases += [  # (label, B, Sq, Skv, Hq, Hkv, D, causal, streams)
        ("GQA 12/4 (autograd)", 2, 300, 300, 12, 4, 64, True, {}),
        ("GQA 32/8 (autograd)", 1, 513, 513, 32, 8, 128, True, {}),
        ("window (-20, -5): rows 0-4 see no key", 2, 300, 300, 4, 4, 64, False,
         dict(window=(-20, -5))),
        ("window (-20, -5): rows 0-4 see no key", 2, 300, 300, 4, 4, 128, False,
         dict(window=(-20, -5))),
        ("window (-40, 0) causal", 2, 129, 300, 4, 4, 128, True, dict(window=(-40, 0))),
        ("dropout 0.1", 2, 300, 300, 4, 4, 64, True, dict(dropout_rate=0.1, dropout_seed=77)),
        ("dropout 0.1", 1, 129, 301, 8, 8, 128, False, dict(dropout_rate=0.1, dropout_seed=5)),
    ]
    for case in cases:
        _bwd_case(gen, *case)


def _bwd_case(gen, label, b, sq, skv, hq, hkv, d, causal, streams) -> float:
    """One case of check_bwd_edges (its bounds and its two bit-identical
    launches); returns the worst max abs error of dq, dk and dv."""
    q, do = (torch.randn(b, sq, hq, d, device="cuda", generator=gen).to(torch.bfloat16)
             for _ in range(2))
    k, v = (torch.randn(b, skv, hkv, d, device="cuda", generator=gen).to(torch.bfloat16)
            for _ in range(2))
    mode = ("dropout" if "dropout_rate" in streams else "window" if "window" in streams
            else None)
    names = [f"pfa_flash_bwd_{n}" + (f"_{mode}" if mode else "") for n in ("dkv", "dq")]
    before = [_build.LAUNCHES[n] for n in names]
    if hq != hkv:
        want, _ = _plain_grads(q, k, v, do, causal)

        def run():
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            return torch.autograd.grad(flash_ops.flash_attention(*leaves, causal=causal),
                                       leaves, do)
    else:
        o, lse = flash_ops.flash_attention_with_lse_plain(q, k, v, causal=causal, **streams)
        kw = dict(sm_scale=d ** -0.5, causal=causal, **streams)
        want = bwd_ops.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)

        def run():
            return bwd_ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    got, again = run(), run()
    torch.cuda.synchronize()
    same = all(torch.equal(a, g) for a, g in zip(again, got))
    if skv == 1 and "dropout_rate" not in streams:  # the exact dq and dk are 0
        dv_norm = float(torch.linalg.norm(want[2].float()))
        errs = [float(torch.linalg.norm(g.float())) / dv_norm / 0.1 for g in got[:2]]
        errs.append(rel_err_norm(got[2], want[2]))
        what = "|dq|, |dk| / (0.1 |dv|)"
    else:
        errs = [rel_err_norm(g, w) for g, w in zip(got, want)]
        what = "rel_err_norm"
    line = (f"K4/K5 edge {label} B{b} Sq{sq} Skv{skv} H{hq}/{hkv} D{d} bf16 causal={causal}: "
            f"{what} dq {errs[0]:.3e} dk {errs[1]:.3e}, rel_err_norm dv {errs[2]:.3e} (bound "
            f"1e-2); two launches bit-identical: {same}")
    if (max(errs) > 1e-2 or not same or not all(torch.isfinite(g).all() for g in got)
            or [_build.LAUNCHES[n] for n in names] != [n + 2 for n in before]
            or ("window" in streams and sq == skv and (got[0][:, :5] != 0).any())):
        raise AssertionError(line)
    print(line, flush=True)
    return max(max_abs_err(g, w) for g, w in zip(got, want))


def _sdpa_bwd_calls(q, k, v, do, **kw) -> tuple:
    """SDPA's backward as timed calls, on (B, S, H, D) inputs in its (B, H,
    S, D) layout, K/V repeated over a GQA group (outside any timing), from
    one forward: torch.autograd.grad of its output (for CUDA events), and
    its autograd node called directly, i.e. the aten backward op on the
    forward's saved outputs (for the graph fit: autograd's engine cannot be
    captured into a CUDA graph here), with the node's name (the backend)."""
    import torch.nn.functional as F

    group = q.shape[2] // k.shape[2]
    leaves = [t.repeat_interleave(n, dim=2).transpose(1, 2).contiguous().requires_grad_()
              for t, n in ((q, 1), (k, group), (v, group))]
    g = do.transpose(1, 2).contiguous()
    out = F.scaled_dot_product_attention(*leaves, **kw)
    node = out.grad_fn
    if not node.name().startswith("ScaledDotProduct"):
        raise RuntimeError(f"SDPA's output comes from {node.name()}, not its backward node")
    return (lambda: torch.autograd.grad(out, leaves, g, retain_graph=True), lambda: node(g),
            node.name())


def _fit_ms(fn) -> float:
    """The graph fit of one call, ms (the K1 table's fit)."""
    return fit_seconds(fn, K1_TABLE_FIT, torch.device("cuda")) * 1e3


def _both_ms(fn) -> tuple:
    """(CUDA-event median, graph fit) of one call, ms."""
    return median_ms(fn), _fit_ms(fn)


def time_bwd_modes(results: dict, smi: str) -> None:
    """The K4/K5 table: K5 alone (its prologue computes di), K4 alone (on
    K5's di) and the whole flash_attention_bwd
    (K5 then K4), each by CUDA events and by the graph fit, beside SDPA's
    backward (events around torch.autograd.grad; the fit of its autograd
    node called directly, the aten backward op on the forward's saved
    outputs), the pair's bound (K4's + K5's) and its share of it: plain
    B4 S2048 H12 D64 causal (the headline), GPT-2 medium's training
    geometry B8 S1024 H16, dropout 0.1 (SDPA draws its own mask), window
    (-255, 0) (SDPA with the band mask), B1 S8192 H12, and B2 S4096
    Hq32/Hkv8 D128 causal on native K/V (SDPA with K/V repeated), whose
    autograd Function's backward is timed too (nothing but K5 and K4), and
    K4 at 1, 2 and 4 slices of the group beside the planner's choice
    (``k4_slices``)."""
    gen = torch.Generator(device="cuda").manual_seed(29)
    drop = dict(dropout_rate=DROPOUT_RATE, dropout_seed=DROPOUT_SEED)
    rows = [  # (name, B, S, Hq, Hkv, D, streams)
        ("plain B4 S2048 H12 D64 causal", 4, 2048, 12, 12, 64, {}),
        ("GPT-2 medium training B8 S1024 H16 D64 causal", 8, 1024, 16, 16, 64, {}),
        ("dropout 0.1, B4 S2048 H12 D64 causal", 4, 2048, 12, 12, 64, drop),
        ("window (-255, 0), B4 S2048 H12 D64 causal", 4, 2048, 12, 12, 64, dict(window=(-255, 0))),
        ("B1 S8192 H12 D64 causal", 1, 8192, 12, 12, 64, {}),
        ("B2 S4096 Hq32/Hkv8 D128 causal, native GQA", 2, 4096, 32, 8, 128, {}),
    ]
    table = []
    for name, b, s, hq, hkv, d, streams in rows:
        q, do = (torch.randn(b, s, hq, d, device="cuda", generator=gen).to(torch.bfloat16)
                 for _ in range(2))
        k, v = (torch.randn(b, s, hkv, d, device="cuda", generator=gen).to(torch.bfloat16)
                for _ in range(2))
        group = hq // hkv
        o, lse = flash_ops._fwd_with_lse(q, k, v, True, d ** -0.5, **streams)
        kw = dict(sm_scale=d ** -0.5, causal=True, **streams)
        di = bwd_ops.flash_bwd_dq(q, k, v, o, lse, do, **kw)[1]
        row = dict(name=name)
        row["k4_ms"], row["k4_fit_ms"] = _both_ms(lambda: bwd_ops.flash_bwd_dkv(q, k, v, do, lse,
                                                                                 di, **kw))
        row["k5_ms"], row["k5_fit_ms"] = _both_ms(lambda: bwd_ops.flash_bwd_dq(q, k, v, o, lse, do,
                                                                                **kw))
        row["bwd_ms"], row["bwd_fit_ms"] = _both_ms(
            lambda: bwd_ops.flash_attention_bwd(q, k, v, o, lse, do, **kw))
        if "window" in streams:
            lib_kw, lib_name = dict(attn_mask=_band_mask(s, s, True, streams["window"])), "band mask"
        elif "dropout_rate" in streams:
            lib_kw, lib_name = dict(is_causal=True, dropout_p=DROPOUT_RATE), "dropout_p=0.1, its own mask"
        else:
            lib_kw, lib_name = dict(is_causal=True), "causal"
        bwd_alone, bwd_node, node_name = _sdpa_bwd_calls(q, k, v, do, **lib_kw)
        row["sdpa_ms"], row["sdpa_fit_ms"] = median_ms(bwd_alone), _fit_ms(bwd_node)
        lib_name += f"; {node_name}"
        extra = ""
        if group > 1:
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            out = flash_ops.flash_attention(*leaves, causal=True)
            row["autograd_ms"] = median_ms(lambda: torch.autograd.grad(out, leaves, do,
                                                                       retain_graph=True))
            # The Function's backward called on its saved tensors, as SDPA's node.
            row["autograd_fit_ms"] = _fit_ms(lambda: out.grad_fn.apply(do))
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            row["slices"] = bwd_ops.k4_slices(b, s, s, hq, hkv, True, None, sms)
            row["k4_fit_ms_by_slices"] = {n: _fit_ms(lambda: bwd_ops.flash_bwd_dkv(
                q, k, v, do, lse, di, slices=n, **kw)) for n in (1, 2, 4) if group % n == 0}
            extra = (f"; the autograd Function's backward {row['autograd_ms']:.4f} / "
                     f"{row['autograd_fit_ms']:.4f} ms; K4 by slices of the group (fit) "
                     + ", ".join(f"{n}: {t:.4f}" for n, t in row["k4_fit_ms_by_slices"].items())
                     + f" ms, the planner's {row['slices']}")
        bnd_dkv, bnd_dq = bwd_bounds(q, k, True, streams.get("window"))
        row["bound_ms"] = bnd_dkv["bound_ms"] + bnd_dq["bound_ms"]
        by = "operations" if "operations" in (bnd_dkv["bound_by"], bnd_dq["bound_by"]) else "bytes"
        table.append(row)
        print(f"K4/K5 table: {name}: K4 {row['k4_ms']:.4f} / {row['k4_fit_ms']:.4f} ms, K5 with di "
              f"{row['k5_ms']:.4f} / {row['k5_fit_ms']:.4f} ms, K5 + K4 {row['bwd_ms']:.4f} / "
              f"{row['bwd_fit_ms']:.4f} ms (CUDA events / graph fit); SDPA backward ({lib_name}) "
              f"{row['sdpa_ms']:.4f} / {row['sdpa_fit_ms']:.4f} ms; (K5 + K4) / SDPA "
              f"{row['bwd_ms'] / row['sdpa_ms']:.3f} (events), {row['bwd_fit_ms'] / row['sdpa_fit_ms']:.3f} "
              f"(fit); the pair's bound {row['bound_ms']:.4f} ms ({by}; K4 {bnd_dkv['bound_ms']:.4f}, "
              f"K5 {bnd_dq['bound_ms']:.4f}), K5 + K4 at {100 * row['bound_ms'] / row['bwd_ms']:.2f} % "
              f"(events), {100 * row['bound_ms'] / row['bwd_fit_ms']:.2f} % (fit) of it{extra} ({smi})",
              flush=True)
        del q, k, v, do, o, lse, di
        torch.cuda.empty_cache()
    for counter, row in (("pfa_flash_bwd_dkv", table[0]), ("pfa_flash_bwd_dkv_dropout", table[2])):
        results[counter]["fit_ms"] = row["k4_fit_ms"]
        results[counter.replace("dkv", "dq")]["fit_ms"] = row["k5_fit_ms"]
    results["k45_table"] = table


def host_us(fn, calls: int = 200) -> float:
    """Host microseconds a call of ``fn``: the wrapper's validation and
    launch, ``calls`` back to back on the host clock, the card not waited
    for (its queue holds them)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * t / calls


def _launches_of(fn) -> dict:
    """The launches, by counter, of one call of ``fn``."""
    before = collections.Counter(_build.LAUNCHES)
    fn()
    torch.cuda.synchronize()
    return {k: n for k, n in (collections.Counter(_build.LAUNCHES) - before).items() if n}


def time_k3_modes(results: dict, smi: str, strict: bool = True) -> list:
    """The K3 table: each main-path shape of K3 (and K2) by CUDA events and
    by the graph fit (2, 10), its bound and share, and its launches a call:
    GPT-2 medium's int8 decode (B8 H16 D64, lengths 0-2000) fused (write +
    attend, what serving runs) and read-only; T5's decode with the token
    bias over a bf16 and an int8 pool (fused); paged_attention_hf float
    (bf16 pool) and int8 compute (int8 pool) at B8 kv 2048; B14's two rows
    (paged_attention); B1 H32 D128 bf16 at 32768 tokens; K2 alone. Only
    public calls, so ``strict=False`` times a parent tree with the same
    script (``--k3-table``); there the fused rows are K2 + K3."""
    gen = torch.Generator(device="cuda").manual_seed(31)
    rows = []
    q, k, v, ks, vs, lens, tables, slots, k_new, v_new = _decode_case(gen)
    tok = int(lens.sum())
    rows.append(("GPT-2 medium int8 decode B8 H16 D64, lengths 0-2000: fused (write + attend)",
                 lambda: paged_ops.paged_decode_attention(q, k_new, v_new, k, v, lens, tables,
                                                          slots, 7, ks, vs),
                 k3_bound(8, 16, 16, 64, 1, tok, 64, 4, True, fused_in=2)))
    rows.append(("the same, read-only attend",
                 lambda: paged_ops.paged_decode_attend(q, k, v, lens, tables, 7, ks, vs),
                 k3_bound(8, 16, 16, 64, 1, tok, 64, 4, True)))
    rows.append(("K2 alone (the token write), the same pool",
                 lambda: paged_ops.paged_token_write(k_new, v_new, k, v, ks, vs, slots, 7),
                 card_bound(3.0 * 2 * 8 * 16 * 64, 2 * 8 * 16 * 64 * 3 + 2 * 4 * 8 * 16 + 4 * 8,
                            torch.float32)))
    for pool_dtype in (torch.bfloat16, torch.int8):
        c = _decode_case(gen, pool_dtype, TBIAS_LENS, pps=16, L=4)
        bias = torch.randn(8, 16, 16 * 128, device="cuda", generator=gen) * 2.0
        qb, kb, vb, ksb, vsb, lb, tb, sb, knb, vnb = c
        rows.append((f"T5 decode with the token bias, {str(pool_dtype)[6:]} pool, B8 H16 D64, "
                     f"lengths 1-2000: fused",
                     (lambda qb=qb, kb=kb, vb=vb, ksb=ksb, vsb=vsb, lb=lb, tb=tb, sb=sb, knb=knb,
                      vnb=vnb, bias=bias: paged_ops.paged_decode_attention(
                          qb, knb, vnb, kb, vb, lb, tb, sb, 1, ksb, vsb, sm_scale=1.0,
                          token_bias=bias)),
                     k3_bound(8, 16, 16, 64, kb.element_size(), int(lb.sum()), 16, 4,
                              pool_dtype == torch.int8, bias=True, fused_in=2)))
    for pool_dtype in (torch.bfloat16, torch.int8):
        c = _decode_case(gen, pool_dtype, HF_LENS, pps=16, L=4)
        qh = c[0].to(torch.bfloat16)
        int8 = pool_dtype == torch.int8
        rows.append((f"paged_attention_hf B8 H16 D64 kv 2048, {str(pool_dtype)[6:]} pool, "
                     f"{'int8' if int8 else 'float'} compute",
                     (lambda qh=qh, c=c: paged_ops.paged_attention_hf(
                         qh, c[1], c[2], c[5], c[6], c[3], c[4], layer=3)),
                     k3_bound(8, 16, 16, 64, c[1].element_size(), int(c[5].sum()), 16, 2, int8,
                              int8_ops=int8)))
    for what, b, hq, hkv, d, pool_dtype, lengths, layer in PAGED_ATTENTION_CASES:
        c = _paged_attention_case(gen, b, hq, hkv, d, pool_dtype, lengths, layer)
        rows.append((f"B14 paged_attention {what} B{b} H{hq}/{hkv} D{d} {str(pool_dtype)[6:]}, "
                     f"lengths {min(lengths)}-{max(lengths)}",
                     (lambda c=c, layer=layer: paged_ops.paged_attention(*c, layer=layer)),
                     k3_bound(b, hq, hkv, d, c[1].element_size(), sum(lengths), c[4].shape[1],
                              c[0].element_size(), pool_dtype == torch.int8)))
    long_case = _paged_attention_case(gen, 1, 32, 32, 128, torch.bfloat16, (32768,), None)
    rows.append(("B1 H32 D128 bf16, one row of 32768 tokens (paged_attention)",
                 lambda: paged_ops.paged_attention(*long_case),
                 k3_bound(1, 32, 32, 128, 2, 32768, 256, 2, False)))
    table = []
    for name, call, bnd in rows:
        launched = _launches_of(call)
        # The parent's int8-compute wrapper reads its scale on the host, which
        # a CUDA graph cannot capture: no fit there.
        ev, host = median_ms(call), host_us(call)
        fit = None if not strict and "int8 compute" in name else _fit_ms(call)
        row = dict(name=name, ms=ev, fit_ms=fit, host_us=host, launches=launched, **bnd)
        table.append(row)
        fit_txt = f"{fit:.4f}" if fit is not None else "not measured (no capture)"
        share = (f"{100 * bnd['bound_ms'] / ev:.2f} % (events), "
                 + (f"{100 * bnd['bound_ms'] / fit:.2f} % (fit)" if fit else "fit not measured"))
        print(f"K3 table: {name}: {ev:.4f} ms (CUDA events), {fit_txt} ms (graph fit); bound "
              f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}), {share}; host {host:.1f} us a call; "
              f"launches a call {launched} ({smi})", flush=True)
    if strict:
        for counter, i in (("pfa_paged_decode_fused", 0), ("pfa_paged_decode_attend", 1),
                           ("pfa_paged_token_write", 2), ("pfa_paged_decode_fused_tbias", 3),
                           ("pfa_paged_hf", 5), ("pfa_paged_hf_int8", 6)):
            results[counter]["fit_ms"] = table[i]["fit_ms"]
    del q, k, v, ks, vs, long_case, rows
    torch.cuda.empty_cache()
    return table


def time_gpt2_decode(smi: str) -> dict:
    """GPT-2 medium (random weights, seed 0) served as in the serving phase
    (8 requests, NEW_TOKENS new tokens, int8 pool, page 128, decode window
    32): decode ms a step (host clock, synchronised at each window's end)
    and tokens/s, and the launches of the run. Public calls only, so it
    also times a parent tree (``--k3-table``)."""
    from photonic_flash_attention_tpu_torch.core.serving import ServingEngine
    from photonic_flash_attention_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead

    cfg = GPT2Config.medium()
    model = GPT2LMHead(cfg, generator=torch.Generator().manual_seed(0))
    engine = ServingEngine(cfg, model.state_dict(), device="cuda", num_pages=256, page_size=128,
                           max_batch=8, kv_dtype=torch.int8, decode_window=32)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in PROMPT_LENS]
    engine.generate([p[:8] for p in prompts[:2]], max_new_tokens=2)
    best = None
    for _ in range(2):
        engine.reset_performance_stats()
        _build.reset_launches()
        engine.generate(prompts, max_new_tokens=NEW_TOKENS)
        torch.cuda.synchronize()
        stats = engine.get_performance_stats()
        step = 1e3 * stats["decode_time"] / max(stats["decode_steps"], 1)
        if best is None or step < best["step_ms"]:
            best = dict(step_ms=step, tokens_per_s=stats["decode_tokens_per_s"],
                        launches=dict(_build.LAUNCHES))
    # One more run under torch.profiler: the card's kernel time (the
    # decode's K2 + K3 apart), over the run's decode steps.
    from torch.profiler import ProfilerActivity, profile

    engine.reset_performance_stats()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        engine.generate(prompts, max_new_tokens=NEW_TOKENS)
        torch.cuda.synchronize()
    steps = max(engine.get_performance_stats()["decode_steps"], 1)
    device = paged = 0.0
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue
        t = getattr(e, "self_device_time_total", None)
        t = e.self_cuda_time_total if t is None else t
        device += t
        if any(k in e.key for k in ("k3_kernel", "paged_decode_attend", "paged_token_write")):
            paged += t
    best.update(device_ms_per_step=device / 1e3 / steps, paged_ms_per_step=paged / 1e3 / steps)
    print(f"K3 table: GPT-2 medium decode, 8 requests x {NEW_TOKENS} tokens, int8 pool: "
          f"{best['step_ms']:.3f} ms a step, {best['tokens_per_s']:.1f} tokens/s (the better of "
          f"two runs); under the profiler, the card's kernel time "
          f"{best['device_ms_per_step']:.3f} ms a decode step (prefill's included), K2 + K3 "
          f"{best['paged_ms_per_step']:.3f} ms of it; paged launches "
          f"{ {k: n for k, n in best['launches'].items() if 'paged' in k} } ({smi})", flush=True)
    del engine, model
    torch.cuda.empty_cache()
    return best


# -- head dims: every d up to 128 --------------------------------------------

#: Head dims checked beside 64 and 128: JAX pads each to 64 or 128
#: (ops/flash.py::_pad_head_dim); the card runs d <= 64 on the D 64
#: instantiations and the rest on D 128 (ops/_build.py::head_dim_plan), d
#: 100, whose bf16 and int8 rows are not whole 16-byte units, on padded
#: copies.
CHECK_HEAD_DIMS = (16, 32, 80, 96, 100, 112)
#: Cerebras-GPT-2.7B's head dim (n_embd 2560 / n_head 32): the d-80 path's.
CEREBRAS_D = 80
#: K3's decode lengths at the head-dim checks (page 16): empty, one token,
#: page edges, a long row.
HEAD_DIM_DECODE_LENS = (0, 1, 17, 100, 129, 300)


def _k1_head_dim_cases(d: int) -> list:
    """Every bf16 K1 mode at head dim d (the relative-bias modes with and
    without lse): (check_k1_edges' case, whether the call writes lse)."""
    drop = dict(dropout_rate=0.1, dropout_seed=77)
    return [
        (("GQA 32/8", 1, 300, 300, 32, 8, d, True, {}, "pfa_flash_fwd"), True),
        (("ragged, inference (no lse)", 2, 129, 300, 4, 4, d, False, {}, "pfa_flash_fwd"), False),
        (("lens (300, 0) and k_bias", 2, 129, 300, 4, 2, d, True,
          dict(kv_lens=(300, 0), k_bias=True), "pfa_flash_fwd_streams"), True),
        (("window (-40, 0) causal", 2, 129, 300, 4, 2, d, True, dict(window=(-40, 0)),
          "pfa_flash_fwd_window"), True),
        (("dropout 0.1", 2, 300, 300, 4, 2, d, True, drop, "pfa_flash_fwd_dropout"), True),
        (("dense bias Hb1 (TMA side)", 2, 129, 300, 4, 2, d, True, dict(dense_heads=1),
          "pfa_flash_fwd_densebias"), False),
        (("relative bias (T5)", 2, 129, 300, 4, 2, d, True, dict(rel=True),
          "pfa_flash_fwd_relbias_lse"), True),
        (("relative bias (T5), inference", 2, 129, 300, 4, 2, d, False, dict(rel=True),
          "pfa_flash_fwd_relbias"), False),
        (("ALiBi", 2, 129, 300, 4, 2, d, True, dict(alibi=True), "pfa_flash_fwd_alibi_lse"), True),
        (("ALiBi, inference", 2, 129, 300, 4, 2, d, True, dict(alibi=True), "pfa_flash_fwd_alibi"),
         False),
    ]


def _bwd_head_dim_cases(d: int) -> list:
    """Every bf16 K4/K5 mode at head dim d (check_bwd_edges' cases): GQA
    32/8 through the autograd Function, ragged, window, dropout."""
    return [
        ("GQA 32/8 (autograd)", 1, 300, 300, 32, 8, d, True, {}),
        ("ragged Sq129 Skv300", 2, 129, 300, 4, 4, d, True, {}),
        ("window (-40, 0) causal", 2, 129, 300, 4, 4, d, True, dict(window=(-40, 0))),
        ("dropout 0.1", 2, 300, 300, 4, 4, d, True, dict(dropout_rate=0.1, dropout_seed=77)),
    ]


#: K3's modes at the head-dim checks: (mode, pool dtype, Hq, Hkv).
K3_HEAD_DIM_MODES = (
    ("fused", torch.int8, 32, 8), ("fused", torch.bfloat16, 4, 4), ("fused", torch.float32, 4, 4),
    ("fused_tbias", torch.bfloat16, 4, 4), ("attend", torch.int8, 4, 4),
    ("attend_tbias", torch.int8, 4, 4), ("hf", torch.bfloat16, 4, 4),
    ("hf_int8", torch.int8, 4, 4), ("paged_attention", torch.bfloat16, 4, 4),
)


def _k3_head_dim_case(gen, d: int, mode: str, pool_dtype, hq: int, hkv: int) -> tuple:
    """One K3 call at head dim d against its plain version on a small pool
    (2 layers, 64 pages of 16 tokens, scattered tables, lengths
    HEAD_DIM_DECODE_LENS), with the existing bounds: the fused decode 1e-4
    and its pools and scales bit-exact with K2's plain write, the read-only
    attend and paged_attention 1e-3, the token bias BIAS_MODE_BOUND,
    paged_attention_hf float 1e-4 and int8 compute 1e-3. Returns (the
    mode's counter, max abs error)."""
    lengths_l = HEAD_DIM_DECODE_LENS
    b, page, pps, layer = len(lengths_l), 16, 20, 1
    k, v, ks, vs = _serving_pools(pool_dtype, gen, L=2, hkv=hkv, num_pages=64, page=page, d=d)
    need = [-(-n // page) for n in lengths_l]
    perm = (torch.randperm(63, device="cuda", generator=gen)[: sum(need)] + 1).to(torch.int32)
    tables = torch.zeros(b, pps, dtype=torch.int32, device="cuda")
    at = 0
    for i, n in enumerate(need):
        tables[i, :n] = perm[at:at + n]
        at += n
    lengths = torch.tensor(lengths_l, dtype=torch.int32, device="cuda")
    slots = torch.zeros(b, dtype=torch.int32, device="cuda")
    for i, n in enumerate(lengths_l):
        if n:
            slots[i] = tables[i, (n - 1) // page] * page + (n - 1) % page
    q = torch.randn(b, hq, d, device="cuda", generator=gen)
    k_new, v_new = (torch.randn(b, hkv, d, device="cuda", generator=gen).to(torch.bfloat16)
                    for _ in range(2))
    if pool_dtype == torch.float32:
        k_new, v_new = k_new.float(), v_new.float()
    scale = d ** -0.5
    bias = None
    if mode.endswith("tbias"):
        bias = torch.randn(b, hkv, pps * page, device="cuda", generator=gen) * 2.0
        scale = 1.0
    counter = {"fused": "pfa_paged_decode_fused", "fused_tbias": "pfa_paged_decode_fused_tbias",
               "attend": "pfa_paged_decode_attend",
               "attend_tbias": "pfa_paged_decode_attend_tbias", "hf": "pfa_paged_hf",
               "hf_int8": "pfa_paged_hf_int8", "paged_attention": "pfa_paged_attention"}[mode]
    before = _build.LAUNCHES[counter]
    exact = True
    if mode.startswith("fused"):
        pools = [t for t in (k, v, ks, vs)]
        ref_pools = [t.clone() if t is not None else None for t in pools]
        out = paged_ops.paged_decode_attention(q, k_new, v_new, k, v, lengths, tables, slots,
                                               layer, ks, vs, sm_scale=scale, token_bias=bias)
        paged_ops.paged_token_write_plain(k_new, v_new, *ref_pools, slots, layer)
        ref = paged_ops.paged_decode_attend_plain(q, *ref_pools[:2], lengths, tables, layer,
                                                  *ref_pools[2:], scale, bias)
        exact = all(a is None or torch.equal(a, w) for a, w in zip(pools, ref_pools))
        bound = 1e-4 if bias is None else BIAS_MODE_BOUND
    elif mode.startswith("attend"):
        out = paged_ops.paged_decode_attend(q, k, v, lengths, tables, layer, ks, vs,
                                            sm_scale=scale, token_bias=bias)
        ref = paged_ops.paged_decode_attend_plain(q, k, v, lengths, tables, layer, ks, vs, scale,
                                                  bias)
        bound = 1e-3 if bias is None else BIAS_MODE_BOUND
    elif mode == "paged_attention":
        out = paged_ops.paged_attention(q, k, v, lengths, tables, ks, vs, layer=layer)
        ref = paged_ops.paged_decode_attend_plain(q, k, v, lengths, tables, layer, ks, vs, scale)
        bound = 1e-3
    else:
        int8 = mode == "hf_int8"
        qb = q.to(torch.bfloat16)
        out = paged_ops.paged_attention_hf(qb, k, v, lengths, tables, ks, vs, layer=layer)
        ref = paged_ops.paged_attention_hf_plain(qb, k, v, lengths, tables, layer, ks, vs, scale,
                                                 8, int8).to(qb.dtype)
        bound = 1e-3 if int8 else 1e-4
    torch.cuda.synchronize()
    err = rel_err_norm(out, ref)
    line = (f"head dims: K3 {mode} D{d} H{hq}/{hkv} page{page} pool {str(pool_dtype)[6:]} "
            f"lengths {list(lengths_l)}: rel_err_norm {err:.3e} (bound {bound})"
            + ("; pools and scales bit-exact with K2's plain write" if mode.startswith("fused")
               else ""))
    if (err > bound or not exact or not torch.isfinite(out).all() or out.shape != (b, hq, d)
            or (mode != "paged_attention" and out[0].float().abs().max() != 0)
            or _build.LAUNCHES[counter] != before + 1):
        raise AssertionError(f"{line}; pools exact {exact}")
    print(line, flush=True)
    del k, v, ks, vs
    return counter, max_abs_err(out, ref)


def check_head_dims(results: dict) -> None:
    """Every ported kernel and mode at each head dim of CHECK_HEAD_DIMS
    against its plain version, with the bounds of the existing checks: K1
    (every bf16 mode, GQA 32/8, with and without lse), K4/K5 (every bf16
    mode, GQA 32/8 through autograd, two launches bit-identical), K3 (every
    mode, int8, bf16 and fp32 pools, GQA 32/8 over an int8 pool), K2 (pools
    bit-exact), K1's quantized modes and K6 (QUANT_PLAIN_BOUND on the same
    payloads), K1's fp32 body; d 100 runs on padded copies. Each kernel's
    worst max abs error at d 80 goes into its ``d80`` entry (what the card
    takes and refuses past 128: check_wide_head_dims)."""
    gen = torch.Generator(device="cuda").manual_seed(80)
    worst = collections.defaultdict(dict)  # name -> {d: max abs err}

    def note(name, d, err):
        worst[name][d] = max(worst[name].get(d, 0.0), err)

    for d in CHECK_HEAD_DIMS:
        for case, save_lse in _k1_head_dim_cases(d):
            note(case[-1], d, _k1_case(gen, f"head dims: {case[0]}", *case[1:], save_lse=save_lse))
        for case in _bwd_head_dim_cases(d):
            err = _bwd_case(gen, f"head dims: {case[0]}", *case[1:])
            mode = ("_dropout" if "dropout_rate" in case[-1] else
                    "_window" if "window" in case[-1] else "")
            for name in ("pfa_flash_bwd_dkv", "pfa_flash_bwd_dq"):
                note(name + mode, d, err)
        for mode, pool_dtype, hq, hkv in K3_HEAD_DIM_MODES:
            name, err = _k3_head_dim_case(gen, d, mode, pool_dtype, hq, hkv)
            note(name, d, err)
        # K2 alone: pools bit-exact with its plain write.
        for pool_dtype in (torch.int8, torch.bfloat16):
            pools = _serving_pools(pool_dtype, gen, L=2, hkv=4, num_pages=8, page=16, d=d)
            ref = [t.clone() if t is not None else None for t in pools]
            k_new, v_new = (torch.randn(3, 4, d, device="cuda", generator=gen).to(torch.bfloat16)
                            for _ in range(2))
            slots = torch.tensor([0, 17, 100], dtype=torch.int32, device="cuda")
            paged_ops.paged_token_write(k_new, v_new, *pools, slots, 1)
            paged_ops.paged_token_write_plain(k_new, v_new, *ref, slots, 1)
            torch.cuda.synchronize()
            if not all(a is None or torch.equal(a, w) for a, w in zip(pools, ref)):
                raise AssertionError(f"head dims: K2 D{d} pool {pool_dtype}: not bit-exact")
            note("pfa_paged_token_write", d, 0.0)
        # K1's quantized modes and K6 on the same payloads as their plain versions.
        q, k, v = (torch.randn(2, 256, 4, d, device="cuda", generator=gen).to(torch.bfloat16)
                   for _ in range(3))
        for name, (_, prepare, _, _, _) in _quant_modes().items():
            kernel, plain, _ = prepare(q, k, v, True)
            before = _build.LAUNCHES[name]
            out, ref = kernel(), plain()
            torch.cuda.synchronize()
            err = rel_err_norm(out, ref)
            line = (f"head dims: {name} B2 S256 H4 D{d} causal: vs plain rel_err_norm {err:.3e} "
                    f"(bound {QUANT_PLAIN_BOUND})")
            if (err > QUANT_PLAIN_BOUND or not torch.isfinite(out).all() or out.shape != q.shape
                    or _build.LAUNCHES[name] != before + 1):
                raise AssertionError(line)
            print(line, flush=True)
            note(name, d, max_abs_err(out, ref))
        # K1's and K4/K5's fp32 bodies (fp32 inputs stay fp32).
        q, k, v, do = (torch.randn(2, 129, 4, d, device="cuda", generator=gen) for _ in range(4))
        o, lse = flash_ops._fwd_with_lse(q, k, v, True, d ** -0.5)
        ref_o, ref_lse = flash_ops.flash_attention_with_lse_plain(q, k, v, causal=True)
        grads = bwd_ops.flash_attention_bwd(q, k, v, o, lse, do, sm_scale=d ** -0.5, causal=True)
        want = bwd_ops.flash_attention_bwd_plain(q, k, v, ref_o, ref_lse, do, sm_scale=d ** -0.5,
                                                 causal=True)
        torch.cuda.synchronize()
        errs = [rel_err_norm(o, ref_o), rel_err_norm(lse, ref_lse)]
        errs += [rel_err_norm(g, w) for g, w in zip(grads, want)]
        line = (f"head dims: fp32 K1 and K4/K5 B2 S129 H4 D{d} causal: o, lse, dq, dk, dv "
                f"rel_err_norm {', '.join(f'{e:.2e}' for e in errs)} (bound 1e-4)")
        if max(errs) > 1e-4 or not torch.isfinite(o).all():
            raise AssertionError(line)
        print(line, flush=True)
    for name, by_d in worst.items():
        print(f"head dims: {name} worst max abs error by head dim "
              f"{ {d: float(f'{e:.3e}') for d, e in sorted(by_d.items())} }", flush=True)
        results[name].setdefault("d80", {})["max_abs_err"] = by_d[CEREBRAS_D]
        results[name]["d80"]["checked_head_dims"] = sorted(by_d)
    torch.cuda.empty_cache()


#: The d-80 timings: Cerebras-GPT-2.7B's prefill and training geometry
#: (B4 S2048 H32 d80 causal) and its decode (B8 H32 d80, int8 pool).
CEREBRAS_PREFILL = (4, 2048, 32)


def time_head_dims(results: dict, smi: str) -> list:
    """K1, K5 + K4, K1's 8-bit modes and K6 (on payloads quantized once) and
    K3's fused decode at Cerebras-GPT-2.7B's widths, each against its plain
    version (bounds 1e-2, QUANT_PLAIN_BOUND and 1e-4 as the checks'), by
    CUDA events and the graph fit, beside its bound from the real d (the
    D 128 instantiation does 128 / 80 of the needed products), the plain
    version's time and the library call's (SDPA at d 80, whose flash
    backend takes 80; K3 none). K1 is also timed at D 128 on the same B, S
    and H, the width it runs. Public calls only (``--head-dim-table``)."""
    gen = torch.Generator(device="cuda").manual_seed(81)
    b, s, h = CEREBRAS_PREFILL
    d = CEREBRAS_D
    rows = []
    q, k, v, do = (torch.randn(b, s, h, d, device="cuda", generator=gen).to(torch.bfloat16)
                   for _ in range(4))
    shape = f"B{b} S{s} H{h} D{d} causal bf16"
    call = lambda: flash_ops.flash_attention(q, k, v, causal=True)  # noqa: E731
    plain = lambda: flash_ops.flash_attention_plain(q, k, v, causal=True)  # noqa: E731
    out, ref = call(), plain()
    torch.cuda.synchronize()
    err = rel_err_norm(out, ref)
    if err > 1e-2 or not torch.isfinite(out).all():
        raise AssertionError(f"d-80 timing: K1 {shape}: rel_err_norm {err:.3e} (bound 1e-2)")
    ms, fit = _both_ms(call)
    sdpa = _sdpa_call(q, k, v, is_causal=True)
    lib, lib_fit = _both_ms(sdpa)
    wide = [torch.randn(b, s, h, 128, device="cuda", generator=gen).to(torch.bfloat16)
            for _ in range(3)]
    d128_ms, d128_fit = _both_ms(lambda: flash_ops.flash_attention(*wide, causal=True))
    del wide
    row = dict(name="pfa_flash_fwd", shape=shape, ms=ms, fit_ms=fit,
               plain_ms=median_ms(plain, runs=3, warmup=1), library_ms=lib, library_fit_ms=lib_fit,
               d128_ms=d128_ms, d128_fit_ms=d128_fit, rel_err_norm=err,
               max_abs_err=max_abs_err(out, ref), **flash_fwd_bound(q, k, True))
    rows.append(row)
    print(f"head-dim table: K1 {shape}: {ms:.4f} / {fit:.4f} ms (events / fit), the same B S H at "
          f"D 128 {d128_ms:.4f} / {d128_fit:.4f}, SDPA {lib:.4f} / {lib_fit:.4f} (K1 / SDPA "
          f"{fit / lib_fit:.3f} by the fit), plain {row['plain_ms']:.4f}, bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']}; K1 at {100 * row['bound_ms'] / fit:.1f} % "
          f"of it by the fit), rel_err_norm {err:.3e} ({smi})", flush=True)

    o, lse = flash_ops._fwd_with_lse(q, k, v, True, d ** -0.5)
    kw = dict(sm_scale=d ** -0.5, causal=True)
    bwd = lambda: bwd_ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)  # noqa: E731
    bwd_plain = lambda: bwd_ops.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)  # noqa: E731
    got, want = bwd(), bwd_plain()
    torch.cuda.synchronize()
    errs = [rel_err_norm(g, w) for g, w in zip(got, want)]
    if max(errs) > 1e-2 or not all(torch.isfinite(g).all() for g in got):
        raise AssertionError(f"d-80 timing: K5 + K4 {shape}: rel_err_norm {errs} (bound 1e-2)")
    di = bwd_ops.flash_bwd_dq(q, k, v, o, lse, do, **kw)[1]
    k5_ms, k5_fit = _both_ms(lambda: bwd_ops.flash_bwd_dq(q, k, v, o, lse, do, **kw))
    k4_ms, k4_fit = _both_ms(lambda: bwd_ops.flash_bwd_dkv(q, k, v, do, lse, di, **kw))
    ms, fit = _both_ms(bwd)
    alone, node, node_name = _sdpa_bwd_calls(q, k, v, do, is_causal=True)
    lib, lib_fit = median_ms(alone), _fit_ms(node)
    bnd_dkv, bnd_dq = bwd_bounds(q, k, True)
    bound = bnd_dkv["bound_ms"] + bnd_dq["bound_ms"]
    by = "operations" if "operations" in (bnd_dkv["bound_by"], bnd_dq["bound_by"]) else "bytes"
    row = dict(name="pfa_flash_bwd_dkv + pfa_flash_bwd_dq", shape=shape, ms=ms, fit_ms=fit,
               k5_ms=k5_ms, k5_fit_ms=k5_fit, k4_ms=k4_ms, k4_fit_ms=k4_fit,
               plain_ms=median_ms(bwd_plain, runs=3, warmup=1), library_ms=lib,
               library_fit_ms=lib_fit, bound_ms=bound, bound_by=by, k4_bound_ms=bnd_dkv["bound_ms"],
               k5_bound_ms=bnd_dq["bound_ms"], rel_err_norm=max(errs),
               max_abs_err=max(max_abs_err(g, w) for g, w in zip(got, want)))
    rows.append(row)
    print(f"head-dim table: K5 + K4 {shape}: {ms:.4f} / {fit:.4f} ms (events / fit; K5 with di "
          f"{k5_ms:.4f} / {k5_fit:.4f}, K4 {k4_ms:.4f} / {k4_fit:.4f}), SDPA backward "
          f"({node_name}) {lib:.4f} / {lib_fit:.4f} ((K5 + K4) / SDPA {fit / lib_fit:.3f} by the "
          f"fit), plain "
          f"{row['plain_ms']:.4f}, bound {bound:.4f} ms ({by}; at {100 * bound / fit:.1f} % by the "
          f"fit), rel_err_norm dq dk dv {', '.join(f'{e:.2e}' for e in errs)} ({smi})", flush=True)
    del q, k, v, do, o, lse, di, got, want
    torch.cuda.empty_cache()

    # K1's 8-bit modes and K6 at the same shape, on payloads quantized once.
    q, k, v = (torch.randn(b, s, h, d, device="cuda", generator=gen).to(torch.bfloat16)
               for _ in range(3))
    for name, (_, prepare, qk_dtype, pv_dtype, _) in _quant_modes().items():
        kernel, plain_q, scale_bytes = prepare(q, k, v, True)
        out, ref = kernel(), plain_q()
        torch.cuda.synchronize()
        err = rel_err_norm(out, ref)
        if err > QUANT_PLAIN_BOUND or not torch.isfinite(out).all():
            raise AssertionError(f"d-80 timing: {name} {shape}: rel_err_norm {err:.3e} (bound "
                                 f"{QUANT_PLAIN_BOUND})")
        ms, fit = _both_ms(kernel)
        row = dict(name=name, shape=shape, ms=ms, fit_ms=fit,
                   plain_ms=median_ms(plain_q, runs=2, warmup=1), library_ms=None,
                   rel_err_norm=err, max_abs_err=max_abs_err(out, ref),
                   **quant_bound(q, k, True, qk_dtype, pv_dtype, scale_bytes))
        rows.append(row)
        print(f"head-dim table: {name} {shape}: {ms:.4f} / {fit:.4f} ms (events / fit), plain "
              f"{row['plain_ms']:.4f}, bound {row['bound_ms']:.4f} ms ({row['bound_by']}; at "
              f"{100 * row['bound_ms'] / fit:.1f} % by the fit), library none, rel_err_norm "
              f"{err:.3e} ({smi})", flush=True)
    del q, k, v
    torch.cuda.empty_cache()

    q, kp, vp, ks, vs, lengths, tables, slots, k_new, v_new = _decode_case(gen, hq=h, L=2, d=d)
    layer, pps = 1, tables.shape[1]
    ref_pools = [t.clone() for t in (kp, vp, ks, vs)]
    fused = lambda: paged_ops.paged_decode_attention(  # noqa: E731
        q, k_new, v_new, kp, vp, lengths, tables, slots, layer, ks, vs)

    def fused_plain():
        paged_ops.paged_token_write_plain(k_new, v_new, *ref_pools, slots, layer)
        return paged_ops.paged_decode_attend_plain(q, *ref_pools[:2], lengths, tables, layer,
                                                   *ref_pools[2:], d ** -0.5)

    out, ref = fused(), fused_plain()
    torch.cuda.synchronize()
    err = rel_err_norm(out, ref)
    dshape = f"B{q.shape[0]} H{h} D{d} page128 int8 pool, lengths {list(GPT2_DECODE_LENS)}"
    if err > 1e-4 or not torch.isfinite(out).all():
        raise AssertionError(f"d-80 timing: K3 fused {dshape}: rel_err_norm {err:.3e} (bound 1e-4)")
    ms, fit = _both_ms(fused)
    tokens = int(lengths.sum())
    row = dict(name="pfa_paged_decode_fused", shape=dshape, ms=ms, fit_ms=fit,
               plain_ms=median_ms(fused_plain, runs=5, warmup=1), library_ms=None,
               rel_err_norm=err, max_abs_err=max_abs_err(out, ref),
               **k3_bound(q.shape[0], h, h, d, 1, tokens, pps, 4, True, fused_in=2))
    rows.append(row)
    print(f"head-dim table: K3 fused decode {dshape}: {ms:.4f} / {fit:.4f} ms (events / fit), "
          f"plain {row['plain_ms']:.4f}, bound {row['bound_ms']:.4f} ms ({row['bound_by']}; at "
          f"{100 * row['bound_ms'] / fit:.1f} % by the fit), library none, rel_err_norm "
          f"{err:.3e} ({smi})", flush=True)
    del kp, vp, ks, vs, ref_pools
    torch.cuda.empty_cache()
    for row in rows:
        for name in row["name"].split(" + "):
            entry = results[name].setdefault("d80", {})
            entry.update({key: val for key, val in row.items()
                          if key not in ("name", "max_abs_err", "rel_err_norm")})
            entry["max_abs_err"] = max(entry.get("max_abs_err", 0.0), row["max_abs_err"])
    return rows


#: Head dims past 128 the card takes on its D 256 instantiations (K1's bf16
#: plain and key-stream modes, K3 over int8 and bf16 pools): 180 (a bf16 row
#: of 360 bytes) and 200 (an int8 row of 200) run on padded copies.
WIDE_CHECK_HEAD_DIMS = (136, 160, 180, 192, 200, 256)
#: Gemma-2B's attention (google/gemma-2b config.json): 8 query heads over 1
#: KV head, head_dim 256.
GEMMA_HQ, GEMMA_HKV, GEMMA_D = 8, 1, 256
#: A head dim past every compiled width (JAX pads it to 384).
TOO_WIDE_D = 320


def _k1_wide_cases(d: int) -> list:
    """K1's D 256 modes at head dim d as check_k1_edges' cases: plain and
    the key streams, causal (aligned to the end where Sq != Skv) and not,
    MHA and Gemma-2B's 8 query heads over 1 KV head."""
    hq, hkv = GEMMA_HQ, GEMMA_HKV
    streams = dict(kv_lens=(300, 0), k_bias=True)
    return [
        ("MHA causal", 2, 300, 300, 4, 4, d, True, {}, "pfa_flash_fwd"),
        ("MHA ragged", 2, 129, 300, 4, 4, d, False, {}, "pfa_flash_fwd"),
        (f"Hq{hq}/Hkv{hkv} causal", 2, 129, 300, hq, hkv, d, True, {}, "pfa_flash_fwd"),
        (f"Hq{hq}/Hkv{hkv} ragged", 2, 300, 127, hq, hkv, d, False, {}, "pfa_flash_fwd"),
        ("lens (300, 0) and k_bias, MHA", 2, 129, 300, 4, 4, d, False, streams,
         "pfa_flash_fwd_streams"),
        (f"lens (300, 0) and k_bias, Hq{hq}/Hkv{hkv} causal", 2, 129, 300, hq, hkv, d, True,
         streams, "pfa_flash_fwd_streams"),
    ]


#: K3's modes at D 256 (_k3_head_dim_case): the fused decode, its token
#: bias and the attend-only decode over int8 and bf16 pools, and
#: paged_attention_hf (float compute over bf16 pools, int8 compute over
#: int8 ones: its default), groups 1 and 8.
K3_WIDE_MODES = tuple(
    (mode, pool, hq, hkv)
    for mode, pools in (("fused", (torch.int8, torch.bfloat16)),
                        ("fused_tbias", (torch.int8, torch.bfloat16)),
                        ("attend", (torch.int8, torch.bfloat16)), ("hf", (torch.bfloat16,)),
                        ("hf_int8", (torch.int8,)))
    for pool in pools for hq, hkv in ((4, 4), (GEMMA_HQ, GEMMA_HKV)))


def _check_wide_refusals(gen) -> None:
    """One call each of what the card does not take at 129-256 (d 192:
    K1's window, dropout, relative- and dense-bias modes and its fp32 body,
    K5/K4 in bf16 and fp32, K1's 8-bit modes, K6, K3 over an fp32 pool) and
    past 256 (TOO_WIDE_D: K1, K3 over an int8 pool): each must raise
    ValueError naming d and A17 with no launch. Then a training call at d
    256: its forward launches K1 with lse once, its backward raises the
    same ValueError before K5 or K4 launch."""
    from photonic_flash_attention_tpu_torch.ops.rel_bias import T5RelBias

    d, w = 192, TOO_WIDE_D
    q, k, v = (torch.randn(1, 256, 4, d, device="cuda", generator=gen).to(torch.bfloat16)
               for _ in range(3))
    f32 = [t.float() for t in (q, k, v)]
    lse = torch.zeros(1, 4, 256, device="cuda")
    rel = T5RelBias(torch.randn(32, 4, device="cuda", generator=gen), True)
    dense = torch.zeros(1, 1, 256, 256, device="cuda")
    lens = torch.ones(1, dtype=torch.int32, device="cuda")
    table = torch.ones(1, 1, dtype=torch.int32, device="cuda")
    pools32 = _serving_pools(torch.float32, gen, L=1, hkv=4, num_pages=4, page=16, d=d)
    qw = torch.zeros(1, 64, 2, w, device="cuda", dtype=torch.bfloat16)
    pools8 = _serving_pools(torch.int8, gen, L=1, hkv=2, num_pages=4, page=16, d=w)
    calls = {
        (d, "K1 window"): lambda: flash_ops.flash_attention(q, k, v, causal=True, window=(-40, 0)),
        (d, "K1 dropout"): lambda: flash_ops.flash_attention(q, k, v, dropout_rate=0.1,
                                                             dropout_seed=7),
        (d, "K1 relative bias"): lambda: flash_ops.flash_attention(q, k, v, rel_bias=rel),
        (d, "K1 dense bias"): lambda: flash_ops.flash_attention(q, k, v, attn_bias=dense),
        (d, "K1 fp32"): lambda: flash_ops.flash_attention(*f32),
        (d, "K5/K4 bf16"): lambda: bwd_ops.flash_attention_bwd(q, k, v, q, lse, q, sm_scale=1.0,
                                                               causal=False),
        (d, "K5/K4 fp32"): lambda: bwd_ops.flash_attention_bwd(*f32, f32[0], lse, f32[0],
                                                               sm_scale=1.0, causal=False),
        (d, "K3 fp32 pool"): lambda: paged_ops.paged_decode_attend(f32[0][:, 0], *pools32[:2],
                                                                   lens, table, 0),
        (w, "K1"): lambda: flash_ops.flash_attention(qw, qw, qw),
        (w, "K3 int8 pool"): lambda: paged_ops.paged_decode_attend(
            qw[:, 0].float(), *pools8[:2], lens, table, 0, *pools8[2:]),
    }
    for name, (_, prepare, _, _, _) in _quant_modes().items():
        calls[(d, name)] = prepare(q, k, v, True)[0]
    torch.cuda.synchronize()
    launched = sum(_build.LAUNCHES.values())
    for (dim, label), call in calls.items():
        try:
            call()
        except ValueError as e:
            if str(dim) not in str(e) or "A17" not in str(e):
                raise AssertionError(f"head dims past 128: {label} at d {dim} raised without "
                                     f"naming d and A17: {e}")
        else:
            raise AssertionError(f"head dims past 128: {label} took d {dim}")
    if sum(_build.LAUNCHES.values()) != launched:
        raise AssertionError("head dims past 128: a refused call launched a kernel")
    print(f"head dims past 128: {', '.join(label for dim, label in calls if dim == d)} raise "
          f"ValueError at d {d}, and {', '.join(label for dim, label in calls if dim == w)} at d "
          f"{w}, naming d and A17, before any launch", flush=True)

    leaves = [torch.randn(1, 256, h, GEMMA_D, device="cuda", generator=gen).to(torch.bfloat16)
              .requires_grad_() for h in (GEMMA_HQ, GEMMA_HKV, GEMMA_HKV)]
    before = collections.Counter(_build.LAUNCHES)
    out = flash_ops.flash_attention(*leaves, causal=True)
    try:
        torch.autograd.grad(out.float().sum(), leaves)
    except ValueError as e:
        if str(GEMMA_D) not in str(e) or "A17" not in str(e):
            raise AssertionError(f"head dims past 128: the d-256 backward raised without naming "
                                 f"d and A17: {e}")
    else:
        raise AssertionError("head dims past 128: a d-256 backward ran")
    torch.cuda.synchronize()
    ran = collections.Counter(_build.LAUNCHES)
    ran.subtract(before)
    if +ran != collections.Counter({"pfa_flash_fwd": 1}):
        raise AssertionError(f"head dims past 128: the d-256 training call launched {dict(+ran)}, "
                             f"expected K1 with lse once")
    print(f"head dims past 128: a training call at d {GEMMA_D} launched K1 with lse once forward "
          f"and raised ValueError backward before K5/K4", flush=True)


def check_wide_head_dims(results: dict) -> None:
    """Past 128: K1's D 256 modes (_k1_wide_cases, with and without lse:
    check_k1_edges' bounds) and K3's (K3_WIDE_MODES: _k3_head_dim_case's
    bounds, pools bit-exact with K2's plain write) at each head dim of
    WIDE_CHECK_HEAD_DIMS against their plain versions; then the refusals
    (_check_wide_refusals). Each kernel's worst max abs error and the head
    dims it was checked at go into its ``d256`` entry."""
    gen = torch.Generator(device="cuda").manual_seed(256)
    worst = collections.defaultdict(dict)  # name -> {d: max abs err}
    for d in WIDE_CHECK_HEAD_DIMS:
        for case in _k1_wide_cases(d):
            for save_lse in (True, False):
                err = _k1_case(gen, f"head dims: {case[0]}", *case[1:], save_lse=save_lse)
                worst[case[-1]][d] = max(worst[case[-1]].get(d, 0.0), err)
        for mode, pool_dtype, hq, hkv in K3_WIDE_MODES:
            name, err = _k3_head_dim_case(gen, d, mode, pool_dtype, hq, hkv)
            worst[name][d] = max(worst[name].get(d, 0.0), err)
    _check_wide_refusals(gen)
    for name, by_d in worst.items():
        print(f"head dims past 128: {name} worst max abs error by head dim "
              f"{ {d: float(f'{e:.3e}') for d, e in sorted(by_d.items())} }", flush=True)
        entry = results[name].setdefault("d256", {})
        entry["max_abs_err"] = max(by_d.values())
        entry["checked_head_dims"] = sorted(by_d)
    torch.cuda.empty_cache()


def _k1_causal_row(gen, b: int, s: int, hq: int, hkv: int, d: int, smi: str, label: str,
                   plain_runs: int = TIMED_RUNS, *, lse: bool = False,
                   streams: bool = False) -> dict:
    """K1 bf16 at B, S, Hq over Hkv heads, head dim d, causal (``lse``: the
    call that writes the lse; ``streams``: the key streams, lengths
    STREAM_LENS[:B] and a key bias with holes): checked against its plain
    version (bound 1e-2), then by CUDA events and the graph fit beside SDPA
    with ``enable_gqa`` on the same inputs (the streams as its additive
    mask), the plain version and the bound from the real d. Prints
    ``label``'s line and returns the row."""
    import torch.nn.functional as F

    q = torch.randn(b, s, hq, d, device="cuda", generator=gen).to(torch.bfloat16)
    k, v = (torch.randn(b, s, hkv, d, device="cuda", generator=gen).to(torch.bfloat16)
            for _ in range(2))
    kw, sdpa_kw, lens = dict(causal=True), dict(is_causal=True), None
    if streams:
        lens = torch.tensor(STREAM_LENS[:b], dtype=torch.int32, device="cuda")
        bias = _key_bias(b, s, gen)
        kw.update(kv_lens=lens, k_bias=bias)
        sdpa_kw = dict(attn_mask=_sdpa_stream_mask(b, s, s, True, lens, bias))
    fn = flash_ops.flash_attention_with_lse if lse else flash_ops.flash_attention
    call = lambda: fn(q, k, v, **kw)  # noqa: E731
    plain = lambda: flash_ops.flash_attention_plain(q, k, v, **kw)  # noqa: E731
    out, ref = call(), plain()
    out = out[0] if lse else out
    torch.cuda.synchronize()
    err = rel_err_norm(out, ref)
    mode = " with lse" if lse else " with streams" if streams else ""
    line = (f"{label}{mode} B{b} S{s} H{hq}/{hkv} D{d} bf16 causal: rel_err_norm {err:.3e} "
            f"(bound 1e-2)")
    if err > 1e-2 or not torch.isfinite(out).all():
        raise AssertionError(line)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    ms, fit = _both_ms(call)
    plain_ms = median_ms(plain, runs=plain_runs, warmup=1)
    lib, lib_fit = _both_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True,
                                                                    **sdpa_kw))
    bnd = flash_fwd_bound(q, k, True, lens=lens, with_lse=lse, with_bias=streams)
    print(f"{line} | kernel {ms:.4f} ms, fit {fit:.4f} ms, plain {plain_ms:.4f} ms, SDPA "
          f"(enable_gqa{', the streams as a mask' if streams else ''}) {lib:.4f} ms, fit "
          f"{lib_fit:.4f} ms (K1 / SDPA {fit / lib_fit:.3f} by the fit), bound "
          f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}; K1 at {100 * bnd['bound_ms'] / fit:.1f} % "
          f"of it by the fit) ({smi})", flush=True)
    return dict(shape=f"B{b} S{s} Hq{hq}/Hkv{hkv} D{d} causal bf16{mode}", ms=ms, fit_ms=fit,
                plain_ms=plain_ms, library_ms=lib, library_fit_ms=lib_fit,
                max_abs_err=max_abs_err(out, ref), **bnd)


def _k3_fused_row(gen, lengths: tuple, hq: int, hkv: int, d: int, smi: str, label: str,
                  plain_runs: int = TIMED_RUNS) -> dict:
    """K3's fused decode over an int8 pool of pages of 128 tokens (2 layers,
    scattered tables, one length a sequence; a length 0 writes to the trash
    page 0): the pools bit-exact with K2's plain write and the output within
    1e-4 of the plain version, then by CUDA events and the graph fit beside
    the plain version and the bound. Prints ``label``'s line and returns the
    row."""
    page, layer = 128, 1
    b = len(lengths)
    pages_of = [-(-n // page) for n in lengths]
    pps = max(pages_of)
    k_pool, v_pool, ks, vs = _serving_pools(torch.int8, gen, L=2, hkv=hkv,
                                            num_pages=sum(pages_of) + 1, page=page, d=d)
    perm = torch.randperm(sum(pages_of), device="cuda", generator=gen).to(torch.int32) + 1
    tables = torch.zeros(b, pps, dtype=torch.int32, device="cuda")
    slots = torch.zeros(b, dtype=torch.int32, device="cuda")
    at = 0
    for i, (n, np_) in enumerate(zip(lengths, pages_of)):
        tables[i, :np_] = perm[at:at + np_]
        at += np_
        if n:
            slots[i] = tables[i, (n - 1) // page] * page + (n - 1) % page
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    qd = torch.randn(b, hq, d, device="cuda", generator=gen)
    k_new, v_new = (torch.randn(b, hkv, d, device="cuda", generator=gen).to(torch.bfloat16)
                    for _ in range(2))
    pools = [k_pool, v_pool, ks, vs]
    ref_pools = [t.clone() for t in pools]

    def call():
        return paged_ops.paged_decode_attention(qd, k_new, v_new, k_pool, v_pool, lens, tables,
                                                slots, layer, ks, vs)

    def plain_call():
        paged_ops.paged_token_write_plain(k_new, v_new, *ref_pools, slots, layer)
        return paged_ops.paged_decode_attend_plain(qd, *ref_pools[:2], lens, tables, layer,
                                                   *ref_pools[2:], d ** -0.5)

    out, ref = call(), plain_call()
    torch.cuda.synchronize()
    err = rel_err_norm(out, ref)
    exact = all(torch.equal(a, w) for a, w in zip(pools, ref_pools))
    line = (f"{label} B{b} H{hq}/{hkv} D{d} page{page} int8 lengths {list(lengths)}: pools "
            f"bit-exact with K2's plain write: {exact}; rel_err_norm {err:.3e} (bound 1e-4)")
    if not exact or err > 1e-4 or not torch.isfinite(out).all():
        raise AssertionError(line)
    ms, fit = _both_ms(call)
    plain = median_ms(plain_call, runs=plain_runs)
    bnd = k3_bound(b, hq, hkv, d, 1, sum(lengths), pps, 4, True, fused_in=2)
    print(f"{line} | kernel {ms:.4f} ms, fit {fit:.4f} ms, plain {plain:.4f} ms, bound "
          f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}; at {100 * bnd['bound_ms'] / fit:.1f} % "
          f"by the fit), library none ({smi})", flush=True)
    row = dict(shape=f"B{b} Hq{hq}/Hkv{hkv} D{d} int8 pool, lengths {min(lengths)}-{max(lengths)}",
               ms=ms, fit_ms=fit, plain_ms=plain, library_ms=None,
               max_abs_err=max_abs_err(out, ref), **bnd)
    del pools, ref_pools, k_pool, v_pool, ks, vs
    torch.cuda.empty_cache()
    return row


#: The D 256 timings at Gemma-2B's attention (8 query heads over 1 KV head,
#: causal): K1 at these (B, S, mode), and K3's fused decode at B8 over an
#: int8 pool, lengths 0-2000 (GPT2_DECODE_LENS).
WIDE_K1_ROWS = ((4, 2048, {}), (4, 2048, dict(lse=True)), (4, 2048, dict(streams=True)),
                (1, 8192, {}))


def time_wide_head_dims(results: dict, smi: str) -> list:
    """K1 at WIDE_K1_ROWS (plain, with lse, with the key streams) and K3's
    fused decode at B8, each at Gemma-2B's attention (_k1_causal_row,
    _k3_fused_row: against the plain version, by CUDA events and the graph
    fit, beside the bound from the real d, the plain version and SDPA with
    ``enable_gqa`` for K1, none for K3); each row goes into its kernel's
    ``d256`` entry as a case. Public calls only (``--head-dim-table``)."""
    gen = torch.Generator(device="cuda").manual_seed(257)
    rows = []
    for b, s, mode in WIDE_K1_ROWS:
        name = "pfa_flash_fwd_streams" if mode.get("streams") else "pfa_flash_fwd"
        rows.append(dict(name=name, **_k1_causal_row(
            gen, b, s, GEMMA_HQ, GEMMA_HKV, GEMMA_D, smi, "D 256 table: K1", plain_runs=3,
            **mode)))
        torch.cuda.empty_cache()
    rows.append(dict(name="pfa_paged_decode_fused", **_k3_fused_row(
        gen, GPT2_DECODE_LENS, GEMMA_HQ, GEMMA_HKV, GEMMA_D, smi, "D 256 table: K3 fused decode",
        plain_runs=5)))
    for row in rows:
        results[row["name"]].setdefault("d256", {}).setdefault("cases", []).append(
            {key: val for key, val in row.items() if key != "name"})
    return rows


#: The A/B rows at D 64 and 128 (the parent's widths) of ``--head-dim-table``.
HEAD_DIM_AB_ROWS = ("K1 plain B4 S2048 H12 D64 causal",
                    "K1 plain B1 S2048 Hq64/Hkv8 D128 causal (Llama-2-70B's GQA)",
                    "K5 + K4 B4 S2048 H12 D64 causal", "K3 fused GPT-2 medium B8 H16 D64 int8")


def time_head_dim_ab(smi: str) -> None:
    """``--head-dim-table``: the rows at D 64 and 128 that must lose no
    time to the D 256 slice (K1 at B4 S2048 H12 D64 causal and at
    Llama-2-70B's B1 S2048 Hq64/Hkv8 D128 causal, K5 + K4 at the first,
    K3's fused decode at GPT-2 medium's B8 H16 D64 int8), each by the graph
    fit and CUDA events, then the D 256 rows (time_wide_head_dims) where the
    tree takes d 256 (a tree that refuses it prints the refusal). Public
    calls only, so a copy of this script times another tree of the
    repository."""
    gen = torch.Generator(device="cuda").manual_seed(64)
    q, k, v, do = (torch.randn(4, 2048, 12, 64, device="cuda", generator=gen).to(torch.bfloat16)
                   for _ in range(4))
    o, lse = flash_ops._fwd_with_lse(q, k, v, True, 0.125)
    hq, hkv, d = LLAMA_GQA
    gq = torch.randn(1, 2048, hq, d, device="cuda", generator=gen).to(torch.bfloat16)
    gk, gv = (torch.randn(1, 2048, hkv, d, device="cuda", generator=gen).to(torch.bfloat16)
              for _ in range(2))
    dec = _decode_case(gen)
    calls = (
        lambda: flash_ops.flash_attention(q, k, v, causal=True),
        lambda: flash_ops.flash_attention(gq, gk, gv, causal=True),
        lambda: bwd_ops.flash_attention_bwd(q, k, v, o, lse, do, sm_scale=0.125, causal=True),
        lambda: paged_ops.paged_decode_attention(dec[0], dec[8], dec[9], *dec[1:3], dec[5],
                                                 dec[6], dec[7], 7, *dec[3:5]),
    )
    for label, call in zip(HEAD_DIM_AB_ROWS, calls):
        fit = _fit_ms(call)
        ev = median_ms(call)
        print(f"head-dim A/B: {label}: fit {fit:.5f} ms, events {ev:.5f} ms ({smi})", flush=True)
    del q, k, v, do, o, lse, gq, gk, gv, dec
    torch.cuda.empty_cache()
    try:
        time_wide_head_dims(collections.defaultdict(dict), smi)
    except ValueError as e:
        print(f"head-dim A/B: the D 256 rows are refused by this tree: {e}", flush=True)


def phase_kernels(smi: str) -> dict:
    results = {name: {} for name in SOURCES}
    check_flash(results)
    check_flash_lse()
    check_flash_streams(results)
    check_token_write(results)
    check_decode_attend(results)
    check_paged_hf(results)
    check_flash_bwd(results, smi)
    check_flash_quant(results)
    check_flash_relbias(results)
    check_flash_densebias(results)
    check_token_bias(results)
    check_flash_dropout(results)
    check_flash_window(results)
    check_flash_bwd_streams(results, smi)
    check_flash_rel_lse(results)
    check_k1_edges()
    time_k1_modes(results, smi)
    check_bwd_edges()
    time_bwd_modes(results, smi)
    results["k3_table"] = time_k3_modes(results, smi)
    results["quant_table"] = time_quant_modes(results, smi)
    check_llama_kernels(results, smi)
    check_llama_bwd(results, smi)
    results["k4_slices_table"] = time_k4_slices(smi)
    check_head_dims(results)
    results["head_dim_table"] = time_head_dims(results, smi)
    check_wide_head_dims(results)
    results["d256_table"] = time_wide_head_dims(results, smi)
    return results


#: Llama-2-70B's attention geometry: 64 query heads over 8 KV heads, D 128.
LLAMA_GQA = (64, 8, 128)
#: Llama training at Llama-2-70B's width (the parallel path): B1 S2048,
#: LLAMA_TRAIN_STEPS AdamW steps, unsharded and on the (1, 1) mesh; the
#: gradient check's cut: 1 layer at B1 S LLAMA_CHECK_SEQ.
LLAMA_TRAIN_SEQ, LLAMA_TRAIN_STEPS, LLAMA_CHECK_SEQ = 2048, 4, 256
#: K3 at Llama-2-70B's decode geometry: one length a sequence, to 4096.
LLAMA_DECODE_LENS = (1, 17, 128, 129, 700, 1500, 2048, 4096)


def check_llama_kernels(results: dict, smi: str) -> None:
    """K1 and K3 at Llama-2-70B's GQA geometry against their plain
    versions: K1 bf16 at B1 S2048 Hq64/Hkv8 D128 causal (bound 1e-2, beside
    SDPA with ``enable_gqa``), K3's fused decode at B8 Hq64/Hkv8 D128 over
    an int8 pool, lengths 1-4096 (pools bit-exact with K2's plain write,
    output within 1e-4); each by CUDA events and the graph fit, beside its
    bound (_k1_causal_row, _k3_fused_row). Recorded as ``cases`` of the
    kernels' entries."""
    hq, hkv, d = LLAMA_GQA
    gen = torch.Generator(device="cuda").manual_seed(22)
    results["pfa_flash_fwd"].setdefault("cases", []).append(
        _k1_causal_row(gen, 1, 2048, hq, hkv, d, smi, "K1 flash_fwd"))
    results["pfa_paged_decode_fused"].setdefault("cases", []).append(
        _k3_fused_row(gen, LLAMA_DECODE_LENS, hq, hkv, d, smi, "K3 fused decode"))


def check_llama_bwd(results: dict, smi: str) -> None:
    """K5 and K4 at Llama-2-70B's GQA geometry, as Llama training's
    attention backward gives them (B1 S LLAMA_TRAIN_SEQ Hq64/Hkv8 D128
    causal bf16, K/V with their 8 heads): the gradients through
    ``flash_attention``'s autograd Function (K1 with lse, then K5 and K4,
    one launch each) against the plain backward (bound 1e-2); two
    ``flash_attention_bwd`` calls bit-equal in dq, dk and dv; then, each
    by CUDA events and the graph fit, K5 alone (with di), K4 alone (the
    planner's slices; the other counts in ``time_k4_slices``) and the
    Function's whole backward; the plain backward (events); SDPA's backward
    with ``enable_gqa`` (events around ``torch.autograd.grad``; the fit of
    its autograd node); K4's and K5's bounds. Recorded as ``cases`` of the
    K4 and K5 entries."""
    import torch.nn.functional as F

    hq, hkv, d = LLAMA_GQA
    b, s = 1, LLAMA_TRAIN_SEQ
    gen = torch.Generator(device="cuda").manual_seed(23)
    q, do = (torch.randn(b, s, hq, d, device="cuda", generator=gen).to(torch.bfloat16)
             for _ in range(2))
    k, v = (torch.randn(b, s, hkv, d, device="cuda", generator=gen).to(torch.bfloat16)
            for _ in range(2))
    want, _ = _plain_grads(q, k, v, do, True)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_ops.flash_attention(*leaves, causal=True)
    names = ("pfa_flash_bwd_dq", "pfa_flash_bwd_dkv")
    before = [_build.LAUNCHES[n] for n in names]
    got = torch.autograd.grad(out, leaves, do, retain_graph=True)
    torch.cuda.synchronize()
    launched = [_build.LAUNCHES[n] - c for n, c in zip(names, before)]
    errs = [rel_err_norm(g, w) for g, w in zip(got, want)]
    o, lse = flash_ops._fwd_with_lse(q, k, v, True, d ** -0.5)
    kw = dict(sm_scale=d ** -0.5, causal=True)
    first = bwd_ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    second = bwd_ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(first, second))
    shape = f"B{b} S{s} Hq{hq}/Hkv{hkv} D{d} causal bf16"
    line = (f"K4/K5 flash_bwd {shape} (Llama-2-70B's GQA, through the autograd Function): "
            f"rel_err_norm dq {errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e} (bound 1e-2); K5, K4 "
            f"launches {launched}; two calls bit-equal: {same}")
    if (max(errs) > 1e-2 or not same or launched != [1, 1]
            or not all(torch.isfinite(g).all() for g in got)):
        raise AssertionError(line)
    dq_err = max_abs_err(got[0], want[0])
    dkv_err = max(max_abs_err(got[1], want[1]), max_abs_err(got[2], want[2]))
    del want, got, first, second

    di = bwd_ops.flash_bwd_dq(q, k, v, o, lse, do, **kw)[1]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    slices = bwd_ops.k4_slices(b, s, s, hq, hkv, True, None, sms)
    k4, k4_fit = _both_ms(lambda: bwd_ops.flash_bwd_dkv(q, k, v, do, lse, di, **kw))
    k5, k5_fit = _both_ms(lambda: bwd_ops.flash_bwd_dq(q, k, v, o, lse, do, **kw))
    whole = median_ms(lambda: torch.autograd.grad(out, leaves, do, retain_graph=True))
    whole_fit = _fit_ms(lambda: out.grad_fn.apply(do))
    plain = median_ms(lambda: bwd_ops.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw))
    sq, sk, sv = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(sq, sk, sv, is_causal=True, enable_gqa=True)
    g = do.transpose(1, 2).contiguous()
    lib = median_ms(lambda: torch.autograd.grad(sdpa_out, (sq, sk, sv), g, retain_graph=True))
    lib_fit = _fit_ms(lambda: sdpa_out.grad_fn(g))
    node = sdpa_out.grad_fn.name()
    bnd_dkv, bnd_dq = bwd_bounds(q, k, True)
    bound = bnd_dkv["bound_ms"] + bnd_dq["bound_ms"]
    print(f"{line} | K5 with di {k5:.4f} / {k5_fit:.4f} ms (bound {bnd_dq['bound_ms']:.4f}, "
          f"{bnd_dq['bound_by']}), K4 at {slices} slices {k4:.4f} / {k4_fit:.4f} ms (bound "
          f"{bnd_dkv['bound_ms']:.4f}, {bnd_dkv['bound_by']}), the Function's backward "
          f"{whole:.4f} / {whole_fit:.4f} ms (CUDA events / graph "
          f"fit), at {100 * bound / whole_fit:.2f} % of the pair's bound {bound:.4f} ms (fit); "
          f"plain backward {plain:.4f} ms; SDPA backward (enable_gqa; {node}) {lib:.4f} / "
          f"{lib_fit:.4f} ms; the Function's backward / SDPA's {whole / lib:.3f} (events), "
          f"{whole_fit / lib_fit:.3f} (fit) ({smi})", flush=True)
    common = dict(shape=f"{shape}, native GQA", plain_ms=plain, library_ms=lib,
                  library_fit_ms=lib_fit, autograd_backward_ms=whole,
                  autograd_backward_fit_ms=whole_fit, k4_slices=slices)
    results["pfa_flash_bwd_dkv"].setdefault("cases", []).append(dict(
        ms=k4, fit_ms=k4_fit, max_abs_err=dkv_err, **common, **bnd_dkv))
    results["pfa_flash_bwd_dq"].setdefault("cases", []).append(dict(
        ms=k5, fit_ms=k5_fit, max_abs_err=dq_err, **common, **bnd_dq))
    del q, k, v, do, leaves, out, o, lse, di, sq, sk, sv, sdpa_out, g
    torch.cuda.empty_cache()


#: (B, S) of the K4 slice sweep at Llama-2-70B's group (``time_k4_slices``).
K4_SLICE_SWEEP = ((1, 512), (1, 1024), (1, 2048), (1, 4096), (4, 2048))


def time_k4_slices(smi: str) -> list:
    """K4 at 1, 2, 4 and 8 slices of the GQA group by the graph fit, at
    Llama-2-70B's Hq64/Hkv8 D128 causal bf16 over K4_SLICE_SWEEP, beside
    the planner's choice (``k4_slices``) and its ratio to the fastest: the
    data the planner's rule answers to. Each count's dk, dv within 1e-2 of
    one slice's (the sums' order differs)."""
    hq, hkv, d = LLAMA_GQA
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(31)
    kw = dict(sm_scale=d ** -0.5, causal=True)
    rows = []
    for b, s in K4_SLICE_SWEEP:
        q, do = (torch.randn(b, s, hq, d, device="cuda", generator=gen).to(torch.bfloat16)
                 for _ in range(2))
        k, v = (torch.randn(b, s, hkv, d, device="cuda", generator=gen).to(torch.bfloat16)
                for _ in range(2))
        o, lse = flash_ops._fwd_with_lse(q, k, v, True, d ** -0.5)
        di = bwd_ops.flash_bwd_dq(q, k, v, o, lse, do, **kw)[1]
        one = bwd_ops.flash_bwd_dkv(q, k, v, do, lse, di, slices=1, **kw)
        fits = {}
        for n in (1, 2, 4, 8):
            got = bwd_ops.flash_bwd_dkv(q, k, v, do, lse, di, slices=n, **kw)
            err = max(rel_err_norm(g, w) for g, w in zip(got, one))
            if err > 1e-2:
                raise AssertionError(f"K4 at {n} slices B{b} S{s}: rel_err_norm {err:.3e} from "
                                     f"one slice's")
            fits[n] = _fit_ms(lambda: bwd_ops.flash_bwd_dkv(q, k, v, do, lse, di, slices=n, **kw))
        planned = bwd_ops.k4_slices(b, s, s, hq, hkv, True, None, sms)
        best = min(fits, key=fits.get)
        rows.append(dict(shape=[b, s, hq, hkv, d], fit_ms_by_slices=fits, planned=planned,
                         fastest=best))
        print(f"K4 slices B{b} S{s} Hq{hq}/Hkv{hkv} D{d} causal bf16: fit "
              + ", ".join(f"{n}: {t:.4f}" for n, t in fits.items())
              + f" ms; the planner's {planned} slices at {fits[planned] / fits[best]:.3f} x the "
              f"fastest ({best}) ({smi})", flush=True)
        del q, k, v, do, o, lse, di, one
        torch.cuda.empty_cache()
    return rows


PROMPT_LENS = (17, 64, 100, 128, 256, 300, 512, 700)
NEW_TOKENS = 33


@functools.lru_cache(maxsize=None)
def gpt2_medium_state() -> dict:
    """GPT-2 medium's weights (Flax's initialisers, a CPU generator seeded 0),
    drawn once: the serving, durable and training paths all use them."""
    from photonic_flash_attention_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead

    t0 = time.perf_counter()
    model = GPT2LMHead(GPT2Config.medium(), generator=torch.Generator().manual_seed(0))
    state = {k: v.detach() for k, v in model.state_dict().items()}
    print(f"main path: GPT-2 medium init {time.perf_counter() - t0:.1f} s "
          f"({sum(v.numel() for v in state.values()) / 1e6:.1f} M params)", flush=True)
    return state


def gpt2_medium_on_card(cfg):
    """A GPT-2 of ``cfg`` (GPT-2 medium, or its depth cut) made on the card
    with :func:`gpt2_medium_state`'s weights (the first ``cfg.n_layer``
    layers)."""
    from photonic_flash_attention_tpu_torch.models.gpt2 import GPT2LMHead

    with torch.device("cuda"):
        model = GPT2LMHead(cfg, generator=torch.Generator(device="cuda").manual_seed(0))
    model.load_state_dict({k: v for k, v in gpt2_medium_state().items()
                           if not k.startswith("h.") or int(k.split(".")[1]) < cfg.n_layer})
    return model


def _eager_windows(engine):
    """``engine`` with every decode window run as eager steps
    (``_window_eager``, the window's plain version) where it would replay
    its step graphs: the reference a graphed window is held against, at
    the same widths."""
    engine._window_graphed = engine._window_eager
    return engine


def _decode_ms(engine) -> float:
    """The engine's decode ms a step since its last stats reset (host
    clock, each window ended by its token read)."""
    stats = engine.get_performance_stats()
    return 1e3 * stats["decode_time"] / max(stats["decode_steps"], 1)


def _graphs_of(engine) -> str:
    st = engine.window_graph_stats()
    return (f"{st['graphs']} step graphs, capture {[round(c, 2) for c in st['capture_ms']]} ms, "
            f"pool {st['pool_bytes']} bytes")


def _profile_window(engine, prompts, new_tokens: int, tag: str) -> None:
    """``prompts`` served once more by ``engine``, its first decode window
    under torch.profiler (``_profile_runs``: the window's wall, the card's
    busy time and its idle share)."""
    import tempfile

    run, profiled = engine._window_graphed, []

    def once(*args):
        if profiled:
            return run(*args)
        profiled.append(tag)
        with tempfile.TemporaryDirectory() as tmp:
            _profile_runs(lambda: run(*args), 1, Path(tmp), tag)

    engine._window_graphed = once
    engine.generate(prompts, max_new_tokens=new_tokens)
    torch.cuda.synchronize()


def check_window_graphs(label: str, engine, make_engine, prompts, new_tokens: int, smi: str,
                        profile_tag: Optional[str] = None) -> dict:
    """``engine`` has served ``prompts`` once, so each width's step graph
    is captured: it serves them again (timed), and a fresh engine of
    ``make_engine()`` with eager windows serves them after the same
    warm-up. The greedy tokens must be bit-equal. Prints decode ms a step of
    both, the graphs' count, capture ms and pool bytes; with
    ``profile_tag``, one window of each under torch.profiler (the card's
    busy share). Returns the graphed run's launches (replays counted)."""
    engine.reset_performance_stats()
    _build.reset_launches()
    got = engine.generate(prompts, max_new_tokens=new_tokens)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    graphed_ms = _decode_ms(engine)
    eager = _eager_windows(make_engine())
    eager.generate([p[:8] for p in prompts[:2]], max_new_tokens=2)  # warm-up
    torch.cuda.synchronize()
    eager.reset_performance_stats()
    want = eager.generate(prompts, max_new_tokens=new_tokens)
    torch.cuda.synchronize()
    eager_ms = _decode_ms(eager)
    if not engine.window_graph_stats()["graphs"]:
        raise AssertionError(f"decode window: {label}: no window ran from a step graph")
    line = (f"decode window: {label}, {len(prompts)} requests x {new_tokens} tokens: graphed "
            f"{graphed_ms:.3f} ms a step, eager {eager_ms:.3f} ms a step "
            f"({eager_ms / graphed_ms:.2f}x); {_graphs_of(engine)}; greedy tokens equal to the "
            f"eager window's: {got == want} ({smi})")
    if got != want:
        bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
        raise AssertionError(f"{line}: requests {bad} differ")
    print(line, flush=True)
    if profile_tag:
        _profile_window(engine, prompts, new_tokens, f"{profile_tag}_graphed")
        _profile_window(eager, prompts, new_tokens, f"{profile_tag}_eager")
    del eager
    torch.cuda.empty_cache()
    return launches


def phase_serving(smi: str) -> dict:
    from photonic_flash_attention_tpu_torch.core.serving import ServingEngine
    from photonic_flash_attention_tpu_torch.models.gpt2 import GPT2Config
    from photonic_flash_attention_tpu_torch.models.gpt2_serving import (
        KVPages, prefill_step, prepare_params,
    )

    cfg = GPT2Config.medium()
    model = gpt2_medium_on_card(cfg)
    engine = ServingEngine(
        cfg, model.state_dict(), device="cuda", num_pages=256, page_size=128,
        max_batch=8, kv_dtype=torch.int8, decode_window=32,
    )
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in PROMPT_LENS]
    engine.generate([p[:8] for p in prompts[:2]], max_new_tokens=2)  # warm-up
    torch.cuda.synchronize()
    engine.reset_performance_stats()

    _build.reset_launches()
    t0 = time.perf_counter()
    outs = engine.generate(prompts, max_new_tokens=NEW_TOKENS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)

    for p, o in zip(prompts, outs):
        if len(o) != NEW_TOKENS or not all(0 <= t < cfg.vocab_size for t in o):
            raise AssertionError(f"prompt of {len(p)} tokens: bad output {o}")
    need = {
        "pfa_flash_fwd": cfg.n_layer * len(prompts),
        "pfa_paged_decode_fused": cfg.n_layer * (NEW_TOKENS - 1),
    }
    for name, n in need.items():
        got = launches.get(name, 0)
        if got < n or (name == "pfa_flash_fwd" and got != n):
            raise AssertionError(f"{name}: {got} launches in the main path, expected {n}")
    stats = engine.get_performance_stats()
    print(f"main path: {len(prompts)} requests x {NEW_TOKENS} tokens in {wall:.2f} s; "
          f"launches {launches}", flush=True)
    print(f"main path: decode {stats['decode_tokens']} tokens at "
          f"{stats['decode_tokens_per_s']:.1f} tokens/s, "
          f"{1e3 * stats['decode_time'] / max(stats['decode_steps'], 1):.3f} ms a step, prefill "
          f"{stats['prefill_tokens']} tokens at {stats['prefill_tokens_per_s']:.1f} tokens/s "
          f"({smi})", flush=True)

    window_launches = check_window_graphs(
        "GPT-2 medium int8 pool", engine,
        lambda: ServingEngine(cfg, model.state_dict(), device="cuda", num_pages=256,
                              page_size=128, max_batch=8, kv_dtype=torch.int8, decode_window=32),
        prompts, NEW_TOKENS, smi, profile_tag="gpt2_medium_window")
    del engine
    chunked_launches = check_chunked_serving(cfg, model, prompts, outs, smi)

    # First step: the serving prefill's logits for prompt 0 against the
    # dense forward of the same weights, both on the card.
    params = prepare_params(model.state_dict(), cfg, "cuda")
    n0 = len(prompts[0])
    s_pad = max(16, 1 << (n0 - 1).bit_length())
    ids = torch.zeros(1, s_pad, dtype=torch.long, device="cuda")
    ids[0, :n0] = torch.tensor(prompts[0], device="cuda")
    pages = KVPages.create(cfg, 4, 128, torch.int8, "cuda")
    slots = torch.arange(s_pad, dtype=torch.int32, device="cuda")[None] + 128
    slots[0, n0:] = 0
    logits = prefill_step(params, cfg, ids, torch.tensor([n0], device="cuda"),
                          pages, slots, True)
    with torch.no_grad():
        dense = model.to("cuda")(ids[:, :n0])[0, -1].float()
    err = rel_err_norm(logits[0], dense)
    line = f"main path: prefill logits vs dense forward rel_err_norm {err:.3e} (bound 5e-2)"
    if err > 5e-2:
        raise AssertionError(line)
    print(line, flush=True)
    return (collections.Counter(launches) + collections.Counter(window_launches)
            + collections.Counter(chunked_launches))


# -- durable path: the KV cache, serving checkpoints, training resume -------

#: The KV cache at Llama-2-7B's decode width (K3 (b)'s heads and D).
DURABLE_CACHE = dict(hkv=32, hq=32, d=128, page=128)
DURABLE_CACHE_LENS = (17, 100, 128, 300, 512, 700, 1500, 2000)
#: GPT-2 medium served, saved after DURABLE_SAVE_AFTER steps, restored
#: (the longest prompt and its new tokens fill the 1024 positions).
DURABLE_PROMPT_LENS = (17, 64, 100, 128, 300, 512, 700, 992)
DURABLE_NEW_TOKENS = 32
#: Windows of 2 decode steps: 16 windows a request, so the save after 12
#: steps falls mid-generation.
DURABLE_WINDOW = 2
DURABLE_SAVE_AFTER = 12
DURABLE_SAMPLING = dict(temperature=0.8, top_k=50, seed=1234)
#: K3 against its plain version (check_paged_attention's bound).
DURABLE_K3_BOUND = 1e-3
#: Training resume at GPT-2 medium's width cut to this many layers.
RESUME_LAYERS = 4


def _dir_bytes(path: str) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


def _check_kv_cache(smi: str, tmp: str) -> None:
    """PagedKVCache on the card at Llama-2-7B's decode width, int8 and bf16
    pools: each prompt appended as one run, then four single tokens; K3
    (``paged_attention``) on the cache's own tensors against its plain
    version; ``gather_kv`` against the appended inputs within the pool's
    rounding (int8: half a per-token step, absmax/254; bf16: 2^-8
    relative); save/restore bit-exact on the card."""
    from photonic_flash_attention_tpu_torch.core.checkpoint import (
        restore_kv_cache, save_kv_cache,
    )
    from photonic_flash_attention_tpu_torch.core.kv_cache import PagedKVCache

    hkv, hq, d, page = (DURABLE_CACHE[k] for k in ("hkv", "hq", "d", "page"))
    lens = DURABLE_CACHE_LENS
    gen = torch.Generator(device="cuda").manual_seed(23)
    num_pages = sum(-(-(n + 4) // page) for n in lens) + 1
    for dtype in (torch.int8, torch.bfloat16):
        cache = PagedKVCache(num_pages, page, hkv, d, dtype=dtype, max_pages_per_seq=32,
                             device="cuda")
        sids = [cache.allocate_sequence() for _ in lens]
        appended = []
        for sid, n in zip(sids, lens):
            runs = [torch.randn(m, hkv, d, device="cuda", generator=gen) for m in (n, 1, 1, 1, 1)]
            runs = [(k, 0.5 * torch.randn(k.shape, device="cuda", generator=gen)) for k in runs]
            for k, v in runs:
                cache.append(sid, k, v)
            appended.append((torch.cat([k for k, _ in runs]), torch.cat([v for _, v in runs])))
        worst = 0.0
        for sid, (k, v) in zip(sids, appended):
            for got, x in zip(cache.gather_kv(sid), (k, v)):
                if dtype == torch.int8:
                    bound = x.abs().amax(-1, keepdim=True) * (1 / 254 + 2.0 ** -22)
                else:
                    bound = x.abs() * 2.0 ** -8
                excess = float(((got - x).abs() - bound).max())
                if excess > 0:
                    raise AssertionError(f"durable path: gather_kv off the {dtype} rounding "
                                         f"bound by {excess:.3e}")
                worst = max(worst, float((got - x).abs().max()))
        lengths, tables = cache.page_table(sids)
        qdt = torch.float32 if dtype == torch.int8 else torch.bfloat16
        q = torch.randn(len(lens), hq, d, device="cuda", generator=gen).to(qdt)
        out = paged_ops.paged_attention(q, cache.k_pages, cache.v_pages, lengths, tables,
                                        cache.k_scales, cache.v_scales)
        k5, v5, ks5, vs5, lyr = paged_ops._hf_layout(cache.k_pages, cache.v_pages,
                                                     cache.k_scales, cache.v_scales, None)
        ref = paged_ops.paged_decode_attend_plain(q.float(), k5, v5, lengths, tables, lyr, ks5,
                                                  vs5, d ** -0.5).to(qdt)
        err = rel_err_norm(out, ref)
        line = (f"durable path: PagedKVCache {str(dtype)[6:]} H{hkv} D{d} page {page}, "
                f"{len(lens)} sequences of {lens[0] + 4}-{lens[-1] + 4} tokens: gather_kv max "
                f"abs err {worst:.3e} (within the pool's rounding); K3 paged_attention on the "
                f"cache's tensors rel_err_norm {err:.3e} (bound {DURABLE_K3_BOUND:g})")
        if not err <= DURABLE_K3_BOUND or not torch.isfinite(out).all():
            raise AssertionError(line)
        path = str(Path(tmp) / f"kv_{str(dtype)[6:]}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_kv_cache(cache, path)
        save_ms = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        back = restore_kv_cache(path, device="cuda")
        torch.cuda.synchronize()
        restore_ms = 1e3 * (time.perf_counter() - t0)
        for name in ("k_pages", "v_pages", "k_scales", "v_scales"):
            a, b = getattr(cache, name), getattr(back, name)
            if not ((a is None and b is None) or torch.equal(a, b)):
                raise AssertionError(f"durable path: restore_kv_cache changed {name}")
        if back.page_table(sids)[1].tolist() != tables.tolist():
            raise AssertionError("durable path: restore_kv_cache changed the page tables")
        print(f"{line}; save_kv_cache {save_ms:.1f} ms, restore_kv_cache {restore_ms:.1f} ms, "
              f"{_dir_bytes(path)} bytes, bit-exact ({smi})", flush=True)
        del cache, back
    torch.cuda.empty_cache()


def _resume_case(label: str, cfg, state, prompts, engine_kw: dict, tmp: str, smi: str,
                 **sample) -> None:
    """The uninterrupted run (native allocator and scheduler asserted), then
    the interrupted one: DURABLE_SAVE_AFTER steps, ``save``, ``restore``
    into a fresh engine, finish; the tokens must be equal."""
    from photonic_flash_attention_tpu_torch.core.serving import ServingEngine

    kw = dict(engine_kw, **sample)
    engine = ServingEngine(cfg, state, device="cuda", **kw)
    st = engine.status()
    if (st["allocator"], st["scheduler"]) != ("NativePageAllocator", "NativeRequestScheduler"):
        raise AssertionError(f"durable path ({label}): engine on {st['allocator']} and "
                             f"{st['scheduler']}, not the native pair")
    want = engine.generate(prompts, max_new_tokens=DURABLE_NEW_TOKENS)
    graphs = _graphs_of(engine)
    if not engine.window_graph_stats()["graphs"]:
        raise AssertionError(f"durable path ({label}): no decode window ran from a step graph")
    del engine
    eager = _eager_windows(ServingEngine(cfg, state, device="cuda", **kw))
    if eager.generate(prompts, max_new_tokens=DURABLE_NEW_TOKENS) != want:
        raise AssertionError(f"durable path ({label}): the graphed windows' tokens differ from "
                             f"the eager windows'")
    del eager

    engine = ServingEngine(cfg, state, device="cuda", **kw)
    sids = [engine.submit(p, DURABLE_NEW_TOKENS) for p in prompts]
    for _ in range(DURABLE_SAVE_AFTER):
        engine.step()
    if all(engine._sequences[s].done for s in sids):
        raise AssertionError(f"durable path ({label}): every request done before the save")
    path = str(Path(tmp) / f"{label.replace(' ', '_')}_{'sampled' if sample else 'greedy'}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.save(path)
    save_ms = 1e3 * (time.perf_counter() - t0)
    del engine
    t0 = time.perf_counter()
    engine = ServingEngine.restore(path, cfg, state, device="cuda")
    torch.cuda.synchronize()
    restore_ms = 1e3 * (time.perf_counter() - t0)
    steps = 0
    while not all(engine._sequences[s].done for s in sids):
        if engine.step() == 0:
            raise AssertionError(f"durable path ({label}): the restored engine stalled")
        steps += 1
    got = [engine._sequences[s].tokens[len(p):] for s, p in zip(sids, prompts)]
    if got != want:
        bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
        raise AssertionError(f"durable path ({label}): resumed tokens differ from the "
                             f"uninterrupted run's in requests {bad}")
    mode = (f"sampled (temperature {sample['temperature']}, top_k {sample['top_k']}, seed "
            f"{sample['seed']})" if sample else "greedy")
    print(f"durable path: {label} {mode}, {len(prompts)} requests x {DURABLE_NEW_TOKENS} "
          f"tokens: the uninterrupted run's graphed windows ({graphs}) give the eager windows' "
          f"tokens; saved after {DURABLE_SAVE_AFTER} steps, resumed {steps} steps, tokens equal "
          f"to the uninterrupted run's; save {save_ms:.1f} ms, restore {restore_ms:.1f} ms, "
          f"checkpoint {_dir_bytes(path)} bytes ({smi})", flush=True)
    del engine
    torch.cuda.empty_cache()


def _check_serving_resume(smi: str, tmp: str) -> None:
    """GPT-2 medium at full width (24 layers, int8 pool, page 128), then
    T5-large's width cut to 2+2 layers (its pinned cross buffers in the
    checkpoint), each greedy and sampled (``_resume_case``)."""
    from photonic_flash_attention_tpu_torch.models.gpt2 import GPT2Config
    from photonic_flash_attention_tpu_torch.models.t5 import T5Config

    cfg = GPT2Config.medium()
    state = gpt2_medium_on_card(cfg).state_dict()
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in DURABLE_PROMPT_LENS]
    kw = dict(num_pages=64, page_size=128, max_batch=8, kv_dtype=torch.int8,
              decode_window=DURABLE_WINDOW)
    for sample in ({}, DURABLE_SAMPLING):
        _resume_case("GPT-2 medium int8 pool", cfg, state, prompts, kw, tmp, smi, **sample)
    del state

    t5cfg = dataclasses.replace(T5Config.large(), num_layers=2, num_decoder_layers=2)
    state = _t5_model(t5cfg, "cuda", seed=3).state_dict()
    rng = np.random.default_rng(4)
    prompts = [rng.integers(2, t5cfg.vocab_size, n).tolist() for n in T5_PROMPT_LENS]
    kw = dict(num_pages=64, page_size=128, max_batch=8, max_pages_per_seq=4,
              kv_dtype=torch.int8, decode_window=DURABLE_WINDOW, enc_max_len=T5_ENC_MAX_LEN)
    for sample in ({}, DURABLE_SAMPLING):
        _resume_case("T5-large width 2+2 layers int8 pool", t5cfg, state, prompts, kw, tmp, smi,
                     **sample)


def _check_training_resume(smi: str, tmp: str) -> None:
    """GPT-2 medium's width cut to RESUME_LAYERS layers (vocabulary 50257
    kept), B TRAIN_BATCH S TRAIN_SEQ: two AdamW steps, the model, AdamW and
    step saved through ``CheckpointManager``, a third step on the same
    model; then a fresh model and optimizer restored from the checkpoint
    take step 3: loss and parameters bit-equal (K1, K4 and K5 are
    deterministic)."""
    from photonic_flash_attention_tpu_torch.core.checkpoint import CheckpointManager
    from photonic_flash_attention_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    from photonic_flash_attention_tpu_torch.training import Trainer, synthetic_lm_batches

    cfg = dataclasses.replace(GPT2Config.medium(), n_layer=RESUME_LAYERS)

    def fresh(seed: int):
        with torch.device("cuda"):
            model = GPT2LMHead(cfg, generator=torch.Generator(device="cuda").manual_seed(seed))
        return model, torch.optim.AdamW(model.parameters(), lr=1e-4, betas=(0.9, 0.999),
                                        eps=1e-8, weight_decay=1e-4)

    batch = next(synthetic_lm_batches(batch=TRAIN_BATCH, seq=TRAIN_SEQ, vocab=cfg.vocab_size,
                                      seed=0))
    model, opt = fresh(0)
    trainer = Trainer(model, opt)
    state = trainer.init_state()
    for _ in range(2):
        state, _ = trainer.train_step(state, batch)
    mgr = CheckpointManager(str(Path(tmp) / "train"), max_to_keep=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d = mgr.save(state.step, {"model": model.state_dict(), "optimizer": opt.state_dict(),
                              "step": state.step})
    save_ms = 1e3 * (time.perf_counter() - t0)
    state, metrics = trainer.train_step(state, batch)
    want_loss = float(metrics["loss"])
    want = {k: v.clone() for k, v in model.state_dict().items()}
    del model, opt, trainer, state
    torch.cuda.empty_cache()

    model, opt = fresh(1)
    t0 = time.perf_counter()
    saved = mgr.restore()["params"]  # tensors on the devices they were saved from
    model.load_state_dict(saved["model"])
    opt.load_state_dict(saved["optimizer"])
    torch.cuda.synchronize()
    restore_ms = 1e3 * (time.perf_counter() - t0)
    trainer = Trainer(model, opt)
    state = trainer.init_state()
    state.step = saved["step"]
    state, metrics = trainer.train_step(state, batch)
    got_loss = float(metrics["loss"])
    differ = [k for k, v in model.state_dict().items() if not torch.equal(v, want[k])]
    line = (f"durable path: training resume, GPT-2 medium width {RESUME_LAYERS} layers "
            f"B{TRAIN_BATCH} S{TRAIN_SEQ}: step {state.step} loss {got_loss:.6f} after restore, "
            f"{want_loss:.6f} uninterrupted; {len(want) - len(differ)}/{len(want)} parameter "
            f"tensors bit-equal; save {save_ms:.1f} ms, restore {restore_ms:.1f} ms, checkpoint "
            f"{_dir_bytes(d)} bytes ({smi})")
    if state.step != 3 or got_loss != want_loss or differ:
        raise AssertionError(f"{line}; differing: {differ[:5]}")
    print(line, flush=True)
    del model, opt, trainer, state, saved, want
    torch.cuda.empty_cache()


def phase_durable(smi: str) -> dict:
    """The durable path: the paged KV cache through K3 (``_check_kv_cache``),
    serving resumed from a checkpoint (``_check_serving_resume``: K1
    prefills, K3's fused decode) and training resumed at step 3
    (``_check_training_resume``: K1, K4, K5). No failure is caught: a failed
    native build, save or restore fails the run. Returns the path's
    launches, counted from 0."""
    import tempfile

    _build.reset_launches()
    with tempfile.TemporaryDirectory(prefix="pfa_durable_") as tmp:
        _check_kv_cache(smi, tmp)
        _check_serving_resume(smi, tmp)
        _check_training_resume(smi, tmp)
    launches = collections.Counter(_build.LAUNCHES)
    need = ("pfa_paged_attention", "pfa_flash_fwd", "pfa_paged_decode_fused",
            "pfa_paged_decode_fused_tbias", "pfa_flash_bwd_dkv", "pfa_flash_bwd_dq")
    missing = [name for name in need if not launches.get(name, 0)]
    if missing or launches["pfa_paged_attention"] != 2:
        raise AssertionError(f"durable path: kernels not launched {missing}; launches "
                             f"{dict(launches)}")
    print(f"durable path: launches {dict(launches)}", flush=True)
    return launches


# -- parallel path: distribution over torch.distributed at world 1 ----------

#: Ring forward at Llama-2-70B's attention width (causal bf16, kv_lens and a
#: k_bias); its 4-rank schedule plays each rank's steps at S_local 8192.
PAR_RING = dict(b=1, s=32768, hq=64, hkv=8, d=128)
PAR_RING_LENS = (20000,)  # shard 3 of the 4-rank schedule lies past it: the skip
PAR_SCHEDULE_RANKS = 4
#: The ring's backward at GPT-2 medium's width; Ulysses at Llama-2-7B's.
PAR_RING_BWD = dict(b=1, s=8192, h=16, d=64)
PAR_ULYSSES = dict(b=1, s=32768, h=32, d=128)
#: The engine's forced RING and ULYSSES calls (GPT-2 medium's heads).
PAR_ENGINE = dict(b=1, s=4096, h=16, d=64)
#: GPT-2 medium trained on a (data 1, model 1) mesh, and served on one.
PAR_TRAIN_BATCH, PAR_TRAIN_STEPS = 4, 3
PAR_SERVE_NEW, PAR_SERVE_SAVE_AFTER = 8, 2
#: Bounds: the schedule's merged bf16 partials against one K1 call (o by
#: rel_err_norm, lse by max abs); gradients as the repo's 5e-2.
PAR_O_BOUND, PAR_LSE_BOUND, PAR_GRAD_BOUND = 1e-2, 1e-3, 5e-2


def _par_inputs(shape: dict, seed: int, hkv: Optional[int] = None):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    b, s, h, d = shape["b"], shape["s"], shape.get("hq", shape.get("h")), shape["d"]
    hkv = hkv or h

    def rnd(heads):
        return torch.randn(b, s, heads, d, device="cuda", generator=gen).to(torch.bfloat16)

    return rnd(h), rnd(hkv), rnd(hkv), gen


def _ring_schedule(q, k, v, lens, bias, n: int, scale: float):
    """Every rank's steps of an n-rank ring, played in one process: rank
    ``me`` holds query shard ``me`` and at step t the K/V and bias shards of
    ``(me - t) mod n``, as the rotation brings them; each step runs the
    ring's own body (``ring_step``), the partials merge by ``softmax_merge``.
    Returns the concatenated (o float32, lse) and the steps skipped."""
    from photonic_flash_attention_tpu_torch.parallel.ring import ring_step, softmax_merge

    sl = q.shape[1] // n
    shard = lambda t, i: t[:, i * sl:(i + 1) * sl].contiguous()  # noqa: E731
    lens_host = lens.tolist()
    outs, lses, skipped = [], [], 0
    for me in range(n):
        acc = None
        for step in range(n):
            src = (me - step) % n
            part = ring_step(shard(q, me), shard(k, src), shard(v, src), me=me, n=n, step=step,
                             causal=True, sm_scale=scale, kv_lens=lens, lens_host=lens_host,
                             k_bias=shard(bias, src))
            if part is None:
                skipped += 1
            else:
                acc = part if acc is None else softmax_merge(*acc, *part)
        outs.append(acc[0])
        lses.append(acc[1])
    return torch.cat(outs, 1), torch.cat(lses, 2), skipped


def _counted(runs: dict, label: str, need: tuple, fn, path: str = "parallel path"):
    """Run one counted run of a path, ``fn()`` (a sharded run, a part of the
    shell path), with every launch count set to 0 just before it and read
    just after; each kernel of ``need`` must have launched in it. The
    counts go into ``runs[label]``; the references the run is held against
    run outside this window."""
    _build.reset_launches()
    out = fn()
    got = collections.Counter(_build.LAUNCHES)
    _build.reset_launches()
    missing = [name for name in need if not got.get(name, 0)]
    if missing:
        raise AssertionError(f"{path}: {label}: kernels not launched {missing}; "
                             f"launches {dict(got)}")
    runs[label] = got
    return out


def _par_line(label: str, errs: dict, bounds: dict, extra: str, smi: str) -> None:
    line = (f"parallel path: {label}: " + ", ".join(
        f"{name} {err:.3e} (bound {bounds[name]:g})" for name, err in errs.items())
        + f"; {extra} ({smi})")
    if any(not err <= bounds[name] for name, err in errs.items()):
        raise AssertionError(line)
    print(line, flush=True)


def _check_par_ring(mesh_seq, group, runs: dict, smi: str) -> None:
    """Ring forward at world 1 and its 4-rank schedule, both against one
    unsharded K1-with-lse call with the same streams."""
    from photonic_flash_attention_tpu_torch.parallel import ring as ring_mod

    c = PAR_RING
    q, k, v, gen = _par_inputs(c, 40, hkv=c["hkv"])
    lens = torch.tensor(PAR_RING_LENS, dtype=torch.int32, device="cuda")
    bias = _key_bias(c["b"], c["s"], gen)
    scale = c["d"] ** -0.5
    want_o, want_lse = flash_ops.flash_attention_with_lse(q, k, v, causal=True, kv_lens=lens,
                                                          k_bias=bias)
    fn = ring_mod.make_ring_attention(mesh_seq, data_axis=None, model_axis=None, causal=True)
    o, (o_l, lse_l) = _counted(runs, "ring forward", ("pfa_flash_fwd_streams",), lambda: (
        fn(q, k, v, kv_lens=lens, k_bias=bias),
        ring_mod._ring_fwd_with_lse(q, k, v, group, True, scale, lens, bias)))
    ring_ms = device_ms(lambda: fn(q, k, v, kv_lens=lens, k_bias=bias), runs=3, warmup=1)
    k1_ms = device_ms(lambda: flash_ops.flash_attention_with_lse(
        q, k, v, causal=True, kv_lens=lens, k_bias=bias), runs=3, warmup=1)
    bound = flash_fwd_bound(q, k, True, lens=PAR_RING_LENS, with_lse=True, with_bias=True)
    _par_line(
        f"ring forward at world 1, B{c['b']} S{c['s']} Hq{c['hq']}/Hkv{c['hkv']} D{c['d']} causal "
        f"bf16 with kv_lens {list(PAR_RING_LENS)} and a k_bias, vs unsharded K1 with lse",
        {"o max_abs_err": max_abs_err(o, want_o), "o (lse path) max_abs_err":
         max_abs_err(o_l, want_o), "lse max_abs_err": max_abs_err(lse_l, want_lse)},
        {"o max_abs_err": 0.0, "o (lse path) max_abs_err": 2 ** -8,
         "lse max_abs_err": 0.0},
        f"ring {ring_ms:.3f} ms (output all-gather included), K1 {k1_ms:.3f} ms, bound "
        f"{bound['bound_ms']:.3f} ms ({bound['bound_by']})", smi)
    n = PAR_SCHEDULE_RANKS
    o_s, lse_s, skipped = _counted(runs, "ring schedule", ("pfa_flash_fwd_streams",),
                                   lambda: _ring_schedule(q, k, v, lens, bias, n, scale))
    ran = runs["ring schedule"]["pfa_flash_fwd_streams"]
    # The causal future blocks, and at least one block past every length.
    if ran != n * n - skipped or skipped <= n * (n - 1) // 2:
        raise AssertionError(f"ring schedule: {ran} K1 launches with {skipped} skipped steps")
    fin = torch.isfinite(want_lse)
    _par_line(
        f"ring {n}-rank schedule in one process (S_local {c['s'] // n}: clipped lengths, bias "
        f"shards, {skipped} skipped steps of {n * n}), merged, vs unsharded K1 with lse",
        {"o rel_err_norm": rel_err_norm(o_s, want_o),
         "lse max_abs_err": max_abs_err(lse_s[fin], want_lse[fin])},
        {"o rel_err_norm": PAR_O_BOUND, "lse max_abs_err": PAR_LSE_BOUND},
        f"{ran} K1 stream launches", smi)
    del q, k, v, bias, o, o_l, lse_l, o_s, lse_s, want_o, want_lse
    torch.cuda.empty_cache()


def _grads_of(fn, leaves, g):
    leaves = [t.detach().clone().requires_grad_() for t in leaves]
    out = fn(*leaves)
    return out, torch.autograd.grad(out, leaves, g)


def _check_par_ring_bwd(mesh_seq, runs: dict, smi: str) -> None:
    """The ring's gradient at world 1 (plain PyTorch backward, blocked over
    rows) against unsharded autograd through K1 and K4/K5."""
    from photonic_flash_attention_tpu_torch.parallel.ring import make_ring_attention

    c = PAR_RING_BWD
    q, k, v, gen = _par_inputs(c, 41)
    g = torch.randn(q.shape, device="cuda", generator=gen).to(torch.bfloat16)
    ring = make_ring_attention(mesh_seq, data_axis=None, model_axis=None, causal=True,
                               differentiable=True)
    flash = lambda a, b, c_: flash_ops.flash_attention(a, b, c_, causal=True)  # noqa: E731
    _, want = _grads_of(flash, (q, k, v), g)
    _, got = _counted(runs, "ring backward", ("pfa_flash_fwd",),
                      lambda: _grads_of(ring, (q, k, v), g))
    ring_ms = median_ms(lambda: _grads_of(ring, (q, k, v), g), runs=3, warmup=1)
    k_ms = median_ms(lambda: _grads_of(flash, (q, k, v), g), runs=3, warmup=1)
    _par_line(
        f"ring backward at world 1, B{c['b']} S{c['s']} H{c['h']} D{c['d']} causal bf16, vs "
        f"unsharded autograd (K1, K4/K5)",
        {f"{n} rel_err_norm": rel_err_norm(a, b) for n, a, b in zip(("dq", "dk", "dv"), got, want)},
        {f"{n} rel_err_norm": PAR_GRAD_BOUND for n in ("dq", "dk", "dv")},
        f"forward + backward: ring {ring_ms:.3f} ms (plain backward), K1 + K4/K5 {k_ms:.3f} ms",
        smi)


def _check_par_ulysses(mesh_seq, runs: dict, smi: str) -> None:
    """Ulysses at world 1 (two NCCL all-to-alls around K1, K4/K5 through
    their inverse) against the same attention unsharded."""
    from photonic_flash_attention_tpu_torch.parallel.ulysses import make_ulysses_attention

    c = PAR_ULYSSES
    q, k, v, gen = _par_inputs(c, 42)
    g = torch.randn(q.shape, device="cuda", generator=gen).to(torch.bfloat16)
    uly = make_ulysses_attention(mesh_seq, data_axis=None, causal=True)
    flash = lambda a, b, c_: flash_ops.flash_attention(a, b, c_, causal=True)  # noqa: E731
    want_o, want = _grads_of(flash, (q, k, v), g)
    o, got = _counted(runs, "Ulysses", TRAIN_KERNELS, lambda: _grads_of(uly, (q, k, v), g))
    u_ms = median_ms(lambda: _grads_of(uly, (q, k, v), g), runs=3, warmup=1)
    f_ms = median_ms(lambda: _grads_of(flash, (q, k, v), g), runs=3, warmup=1)
    errs = {"o max_abs_err": max_abs_err(o.detach(), want_o.detach())}
    errs |= {f"{n} rel_err_norm": rel_err_norm(a, b) for n, a, b in zip(("dq", "dk", "dv"), got,
                                                                           want)}
    _par_line(
        f"Ulysses at world 1, B{c['b']} S{c['s']} H{c['h']} D{c['d']} causal bf16, forward and "
        f"gradient vs unsharded K1, K4/K5", errs,
        {"o max_abs_err": 0.0, **{f"{n} rel_err_norm": PAR_GRAD_BOUND for n in ("dq", "dk", "dv")}},
        f"forward + backward: Ulysses {u_ms:.3f} ms, unsharded {f_ms:.3f} ms", smi)
    del q, k, v, g, o, got, want_o, want
    torch.cuda.empty_cache()


def _check_par_engine(mesh_seq, runs: dict, smi: str) -> None:
    """``set_mesh``, then one forced call each of RING and ULYSSES."""
    from photonic_flash_attention_tpu_torch.core.engine import AttentionEngine
    from photonic_flash_attention_tpu_torch.core.router import KernelKind

    c = PAR_ENGINE
    q, k, v, _ = _par_inputs(c, 43)
    eng = AttentionEngine()
    eng.set_mesh(mesh_seq, seq_axis="seq")
    want = flash_ops.flash_attention(q, k, v, causal=True)
    errs = {}
    for kind in (KernelKind.RING, KernelKind.ULYSSES):
        out, _ = _counted(runs, f"engine {kind.value}", ("pfa_flash_fwd",),
                          lambda: eng._run(kind, q, k, v, None, None, None, True, False))
        errs[f"{kind.value} max_abs_err"] = max_abs_err(out, want)
    eng.clear_mesh()
    _par_line(f"engine after set_mesh, forced RING and ULYSSES, B{c['b']} S{c['s']} H{c['h']} "
              f"D{c['d']} causal bf16, vs K1", errs, {n: 2 ** -8 for n in errs},
              "mesh cleared after", smi)


def _timed_steps(trainer, batch: dict, steps: int) -> tuple:
    """``steps`` train steps of ``trainer`` on ``batch`` from its initial
    state: (the last state, losses, gradient norms, wall ms a step, each
    step synchronized by reading its loss)."""
    state = trainer.init_state()
    losses, norms, step_ms = [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, m = trainer.train_step(state, batch)
        losses.append(float(m["loss"]))  # synchronizes
        step_ms.append(round(1e3 * (time.perf_counter() - t0), 1))
        norms.append(float(m["grad_norm"]))
    return state, losses, norms, step_ms


def _check_par_training(mesh_dm, runs: dict, smi: str, profile_dir: Optional[str]) -> None:
    """GPT-2 medium on a (data 1, model 1) mesh with param_sharding_rules
    (the tensor-parallel forward, the data axis's all-reduce) against the
    unsharded trainer from the same init and batch, which runs first,
    outside the sharded run's launch count. With ``profile_dir``, one more
    step of each under the profiler."""
    from photonic_flash_attention_tpu_torch.models.gpt2 import GPT2Config, param_sharding_rules
    from photonic_flash_attention_tpu_torch.training import Trainer, synthetic_lm_batches

    cfg = GPT2Config.medium()
    batch = next(synthetic_lm_batches(batch=PAR_TRAIN_BATCH, seq=TRAIN_SEQ, vocab=cfg.vocab_size,
                                      seed=2))

    def train(name: str):
        model = gpt2_medium_on_card(cfg)
        opt = torch.optim.AdamW(model.parameters(), lr=1e-4, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=1e-4)
        kw = dict(mesh=mesh_dm, param_specs=param_sharding_rules(model.state_dict())) \
            if name == "mesh" else {}
        trainer = Trainer(model, opt, **kw)
        state, losses, norms, step_ms = _timed_steps(trainer, batch, PAR_TRAIN_STEPS)
        if profile_dir:
            _profile_runs(lambda: trainer.train_step(state, batch), 1, Path(profile_dir),
                          f"parallel_train_{name}")
        del model, opt, trainer, state
        torch.cuda.empty_cache()
        return losses, norms, step_ms

    l0, n0, ms0 = train("unsharded")
    l1, n1, ms1 = _counted(runs, "sharded training", TRAIN_KERNELS, lambda: train("mesh"))
    bit_equal = l0 == l1
    _par_line(
        f"training, GPT-2 medium on a (data 1, model 1) mesh with param_sharding_rules, "
        f"B{PAR_TRAIN_BATCH} S{TRAIN_SEQ}, {PAR_TRAIN_STEPS} AdamW steps, vs the unsharded trainer",
        {"loss max rel diff": max(abs(a - b) / abs(b) for a, b in zip(l1, l0)),
         "grad_norm max rel diff": max(abs(a - b) / abs(b) for a, b in zip(n1, n0))},
        {"loss max rel diff": 1e-3, "grad_norm max rel diff": 1e-3},
        f"losses {l1} vs {l0}: bit-equal {bit_equal}; step ms {ms1} vs {ms0}", smi)


def _llama_train_model(cfg):
    """Llama of ``cfg`` made on the card from seed 0: fp32 parameters, bf16
    compute."""
    from photonic_flash_attention_tpu_torch.models.llama import LlamaForCausalLM

    return LlamaForCausalLM(cfg, generator=torch.Generator(device="cuda").manual_seed(0),
                            device="cuda")


def _check_llama_train_grads(cfg) -> None:
    """One batch's gradient of a Llama of ``cfg``'s widths cut to 1 layer
    at B1 S LLAMA_CHECK_SEQ: bf16 compute on the card (K1 with lse, the GQA
    repeat, K4, K5, the group sum, each launched once) against fp32 on the
    CPU (the plain versions) from the same weights, the bf16-scale gate
    5e-2 (``check_train_grads``')."""
    from photonic_flash_attention_tpu_torch.config import get_config, reset_config
    from photonic_flash_attention_tpu_torch.models.llama import LlamaForCausalLM
    from photonic_flash_attention_tpu_torch.training import synthetic_lm_batches

    cut = dataclasses.replace(cfg, num_hidden_layers=1)
    batch = {k: torch.as_tensor(v) for k, v in next(synthetic_lm_batches(
        batch=1, seq=LLAMA_CHECK_SEQ, vocab=cfg.vocab_size, seed=5)).items()}
    card = _llama_train_model(cut)
    state = {k: v.to("cpu", copy=True) for k, v in card.state_dict().items()}
    # The CPU model takes the card's weights as they are (no init on the CPU).
    host = LlamaForCausalLM(dataclasses.replace(cut, dtype=torch.float32), device="meta")
    host.load_state_dict(state, assign=True)
    # S 256 is below flash_threshold: lower both thresholds so both runs
    # take the flash route (kernels on the card, plain versions on the CPU).
    get_config().update(flash_threshold=LLAMA_CHECK_SEQ, flash_min_tokens=LLAMA_CHECK_SEQ)
    try:
        t0 = time.perf_counter()
        grads = {"host": _lm_grads(host, batch)}
        cpu_s = time.perf_counter() - t0
        before = dict(_build.LAUNCHES)
        grads["card"] = _lm_grads(card, {k: v.cuda() for k, v in batch.items()})
        for name in TRAIN_KERNELS:
            if _build.LAUNCHES[name] - before.get(name, 0) != 1:
                raise AssertionError(f"Llama gradient check: {name} not launched once")
    finally:
        reset_config()
    del card, host, state
    torch.cuda.empty_cache()
    flat = {d: torch.cat([g.flatten() for g in gs.values()]) for d, gs in grads.items()}
    errs = {"all": rel_err_norm(flat["card"], flat["host"])}
    for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
        errs[name] = rel_err_norm(grads["card"][f"layers.0.attn.{name}.weight"],
                                  grads["host"][f"layers.0.attn.{name}.weight"])
    errs["embed_tokens"] = rel_err_norm(grads["card"]["embed_tokens"], grads["host"]["embed_tokens"])
    line = (f"parallel path: Llama training: gradient of Llama-2-70B's widths cut to 1 layer, "
            f"B1 S{LLAMA_CHECK_SEQ}, card bf16 vs CPU fp32 plain ({cpu_s:.1f} s on the CPU): "
            + ", ".join(f"{n} {e:.3e}" for n, e in errs.items()) + " (bound 5e-2)")
    if max(errs.values()) > 5e-2 or not torch.isfinite(flat["card"]).all():
        raise AssertionError(line)
    print(line, flush=True)


def _check_par_llama_training(mesh_dm, runs: dict, smi: str) -> None:
    """Llama at Llama-2-70B's width cut to 2 layers (2.24 B parameters, fp32
    with bf16 compute: its attention K1 with lse, K4 and K5 on the GQA
    route) trained LLAMA_TRAIN_STEPS AdamW steps at B1 S LLAMA_TRAIN_SEQ
    on one fixed batch: unsharded, then on the (data 1, model 1) mesh with
    ``llama_param_sharding_rules``, each run counted alone: K1, K4 and K5
    launch once per layer and step, the loss falls, the mesh run's losses
    and gradient norms within 1e-3 of the unsharded run's. Then the first
    layer's gradient against the CPU (``_check_llama_train_grads``)."""
    from photonic_flash_attention_tpu_torch.models.llama import llama_param_sharding_rules
    from photonic_flash_attention_tpu_torch.training import Trainer, synthetic_lm_batches

    cfg = _llama_70b_width()
    batch = next(synthetic_lm_batches(batch=1, seq=LLAMA_TRAIN_SEQ, vocab=cfg.vocab_size, seed=4))

    def train(name: str):
        model = _llama_train_model(cfg)
        params = sum(p.numel() for p in model.parameters())
        # optax.adamw(1e-4)'s defaults; the fused step keeps no temporaries
        # of the parameters' size.
        opt = torch.optim.AdamW(model.parameters(), lr=1e-4, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=1e-4, fused=True)
        kw = dict(mesh=mesh_dm, param_specs=llama_param_sharding_rules(model.state_dict())) \
            if name == "mesh" else {}
        trainer = Trainer(model, opt, **kw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state, losses, norms, step_ms = _timed_steps(trainer, batch, LLAMA_TRAIN_STEPS)
        peak = torch.cuda.max_memory_allocated() / 2**30
        del model, opt, trainer, state
        torch.cuda.empty_cache()
        return losses, norms, step_ms, peak, params

    need = cfg.num_hidden_layers * LLAMA_TRAIN_STEPS
    metrics = {}
    for name, label in (("unsharded", "Llama training, unsharded"),
                        ("mesh", "Llama training on the (1, 1) mesh")):
        metrics[name] = _counted(runs, label, TRAIN_KERNELS, functools.partial(train, name))
        counts = runs[label]
        if any(counts[k] != need for k in TRAIN_KERNELS):
            raise AssertionError(f"parallel path: {label}: launches {dict(counts)}, expected "
                                 f"{need} of each of {TRAIN_KERNELS}")
        losses, norms, step_ms, peak, params = metrics[name]
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"parallel path: {label}: loss did not fall: {losses}")
        tokens_s = (LLAMA_TRAIN_STEPS - 1) * LLAMA_TRAIN_SEQ / (sum(step_ms[1:]) / 1e3)
        print(f"parallel path: {label}: Llama-2-70B's widths (hidden {cfg.hidden_size}, "
              f"{cfg.num_attention_heads}/{cfg.num_key_value_heads} heads, intermediate "
              f"{cfg.intermediate_size}) cut to {cfg.num_hidden_layers} layers, {params} "
              f"parameters, fp32 params / bf16 compute, B1 S{LLAMA_TRAIN_SEQ}, "
              f"{LLAMA_TRAIN_STEPS} AdamW steps: step ms {step_ms} (steps 2-{LLAMA_TRAIN_STEPS}: "
              f"{tokens_s:.1f} tokens/s), peak memory {peak:.2f} GiB; losses {losses}, grad "
              f"norms {norms}; launches {dict(counts)} ({smi})", flush=True)
    (l0, n0, ms0, *_), (l1, n1, ms1, *_) = metrics["unsharded"], metrics["mesh"]
    _par_line(
        f"Llama training on the (data 1, model 1) mesh with llama_param_sharding_rules, "
        f"B1 S{LLAMA_TRAIN_SEQ}, {LLAMA_TRAIN_STEPS} AdamW steps, vs the unsharded trainer",
        {"loss max rel diff": max(abs(a - b) / abs(b) for a, b in zip(l1, l0)),
         "grad_norm max rel diff": max(abs(a - b) / abs(b) for a, b in zip(n1, n0))},
        {"loss max rel diff": 1e-3, "grad_norm max rel diff": 1e-3},
        f"bit-equal {l0 == l1 and n0 == n1}; step ms {ms1} vs {ms0}", smi)
    _check_llama_train_grads(cfg)


def _check_par_serving(mesh_dm, tmp: str, runs: dict, smi: str) -> None:
    """A sharded ServingEngine on the (1, 1) mesh serves GPT-2 medium on an
    int8 pool: its greedy tokens equal the unsharded engine's (which runs
    first, outside the sharded runs' launch counts); save/restore
    round-trips it; restore without the mesh raises."""
    from photonic_flash_attention_tpu_torch.core.serving import ServingEngine
    from photonic_flash_attention_tpu_torch.models.gpt2 import GPT2Config

    cfg = GPT2Config.medium()
    state = gpt2_medium_state()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in PROMPT_LENS]
    kw = dict(num_pages=256, page_size=128, max_batch=8, kv_dtype=torch.int8, decode_window=2)
    want = ServingEngine(cfg, state, device="cuda", **kw).generate(prompts,
                                                                   max_new_tokens=PAR_SERVE_NEW)
    eng = ServingEngine(cfg, state, device="cuda", mesh=mesh_dm, **kw)
    t0 = time.perf_counter()
    got = _counted(runs, "sharded serving", SERVE_KERNELS_PAR,
                   lambda: eng.generate(prompts, max_new_tokens=PAR_SERVE_NEW))
    wall = time.perf_counter() - t0
    if got != want:
        raise AssertionError(f"sharded serving: tokens differ from the unsharded engine's: "
                             f"{got} vs {want}")
    graphed_ms, graphs = _decode_ms(eng), _graphs_of(eng)
    eager = _eager_windows(ServingEngine(cfg, state, device="cuda", mesh=mesh_dm, **kw))
    if eager.generate(prompts, max_new_tokens=PAR_SERVE_NEW) != got:
        raise AssertionError("sharded serving: the graphed windows' tokens differ from the "
                             "eager windows'")
    print(f"parallel path: sharded serving's windows from step graphs ({graphs}), "
          f"{graphed_ms:.3f} ms a step with the graphs' captures, eager windows "
          f"{_decode_ms(eager):.3f} ms a step; tokens equal ({smi})", flush=True)
    del eager
    path = str(Path(tmp) / "serve")

    def resume():
        eng = ServingEngine(cfg, state, device="cuda", mesh=mesh_dm, **kw)
        sids = [eng.submit(p, PAR_SERVE_NEW) for p in prompts]
        for _ in range(PAR_SERVE_SAVE_AFTER):
            eng.step()
        eng.save(path)
        try:
            ServingEngine.restore(path, cfg, state, device="cuda")
        except ValueError as e:
            refused = str(e)
        else:
            raise AssertionError("restoring a sharded checkpoint without a mesh did not raise")
        eng2 = ServingEngine.restore(path, cfg, state, device="cuda", mesh=mesh_dm)
        for e in (eng, eng2):
            while any(not e._sequences[s].done for s in sids):
                e.step()
        return eng2, sids, refused

    eng2, sids, refused = _counted(runs, "sharded save/restore", SERVE_KERNELS_PAR, resume)
    resumed = [eng2._sequences[s].tokens[len(p):] for s, p in zip(sids, prompts)]
    if resumed != want:
        raise AssertionError(f"sharded restore: tokens {resumed} vs {want}")
    print(f"parallel path: sharded serving, GPT-2 medium on a (data 1, model 1) mesh, int8 pool, "
          f"{len(prompts)} requests x {PAR_SERVE_NEW} tokens: greedy tokens equal the unsharded "
          f"engine's ({wall:.2f} s); saved after {PAR_SERVE_SAVE_AFTER} steps as "
          f"{sorted(p.name for p in Path(path).iterdir())}, restored with the mesh: tokens equal; "
          f"without it: ValueError ({refused[:60]}...) ({smi})", flush=True)


def _time_collectives(mesh_dm, smi: str) -> None:
    """NCCL's world-1 collectives by CUDA events, at the sizes the sharded
    paths hand them (GPT-2 medium's B8 S1024 activations in bf16)."""
    import torch.distributed as dist

    from photonic_flash_attention_tpu_torch.parallel import collectives as C
    from photonic_flash_attention_tpu_torch.parallel.mesh import axis_group

    group = axis_group(mesh_dm, "model")
    x = torch.randn(8, 1024, 1024, device="cuda").to(torch.bfloat16)
    times = {
        # The sharded paths skip a one-rank sum; NCCL's is timed here itself.
        "all_reduce": device_ms(lambda: dist.all_reduce(x, group=group)),
        "all_gather": device_ms(lambda: C.all_gather_cat(x, 2, group)),
        "all_to_all": device_ms(lambda: C.all_to_all(x.view(8, 1024, 16, 64), 2, 1, group)),
        "copy": device_ms(lambda: x.clone()),
    }
    NCCL_WORLD1_MS.update(times)
    print(f"parallel path: NCCL at world 1 on {x.numel() * 2 / 2**20:.0f} MiB bf16 (GPT-2 medium "
          f"B8 S1024 activations): " + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items())
          + f" ({smi})", flush=True)


#: What a sharded serving run must launch: K1 prefills, K3's fused decode.
SERVE_KERNELS_PAR = ("pfa_flash_fwd", "pfa_paged_decode_fused")


def phase_parallel(smi: str, profile_dir: Optional[str] = None) -> dict:
    """The parallel path over a real NCCL group of world size 1 (a file
    store): the mesh, ring (world 1 and the 4-rank schedule), the ring's
    gradient, Ulysses, the engine's RING and ULYSSES, sharded training and
    sharded serving, then the telemetry's bytes and NCCL's times. No
    failure is caught. Returns the path's launches: those of its sharded
    runs and of the unsharded Llama training run, each counted from 0 just
    before it (``_counted``); the references the sharded runs are held
    against run outside these counts."""
    import tempfile

    import torch.distributed as dist

    from photonic_flash_attention_tpu_torch.parallel import create_mesh
    from photonic_flash_attention_tpu_torch.parallel.mesh import axis_group
    from photonic_flash_attention_tpu_torch.parallel.multihost import (
        initialize_multihost,
        process_summary,
    )
    from photonic_flash_attention_tpu_torch.parallel.telemetry import collective_bytes, get_telemetry

    with tempfile.TemporaryDirectory(prefix="pfa_parallel_") as tmp:
        info = initialize_multihost(f"file://{tmp}/store", 1, 0)
        try:
            if info["backend"] != "nccl" or info["global_devices"] != 1:
                raise AssertionError(f"process group: {info}")
            mesh_seq = create_mesh((1,), ("seq",))
            mesh_dm = create_mesh((1, 1), ("data", "model"))
            print(f"parallel path: initialize_multihost {info}; create_mesh {mesh_dm}; "
                  f"process_summary {process_summary()}", flush=True)
            get_telemetry().reset()
            runs = {}
            _check_par_ring(mesh_seq, axis_group(mesh_seq, "seq"), runs, smi)
            _check_par_ring_bwd(mesh_seq, runs, smi)
            _check_par_ulysses(mesh_seq, runs, smi)
            _check_par_engine(mesh_seq, runs, smi)
            _check_par_training(mesh_dm, runs, smi, profile_dir)
            _check_par_llama_training(mesh_dm, runs, smi)
            _check_par_serving(mesh_dm, tmp, runs, smi)
            stats = get_telemetry().get_stats()
            c = PAR_RING
            shard = c["b"] * c["s"] // PAR_SCHEDULE_RANKS * c["hkv"] * c["d"] * 2
            print(f"parallel path: telemetry at world 1 {stats['axes']} (link "
                  f"{stats['link_gbps']} GB/s each way, data sheet); at {PAR_SCHEDULE_RANKS} ranks the "
                  f"ring above would move {(PAR_SCHEDULE_RANKS - 1) * collective_bytes('ppermute', 2 * shard, PAR_SCHEDULE_RANKS)} "
                  f"bytes a rank (ppermute of K and V shards)", flush=True)
            _time_collectives(mesh_dm, smi)
        finally:
            dist.destroy_process_group()
    launches = collections.Counter()
    for counts in runs.values():
        launches.update(counts)
    print(f"parallel path: launches by counted run "
          f"{ {label: dict(c) for label, c in runs.items()} }", flush=True)
    print(f"parallel path: launches {dict(launches)}", flush=True)
    return launches


PREFILL_CHUNK = 256
#: Bound on rel_err_norm between the chunked and the whole prefill's
#: last-prompt-token logits: the chunks attend over the int8-dequantized
#: history where the whole prefill attends over the bf16 K/V it just made.
CHUNK_LOGITS_BOUND = 5e-2


def _serving_engine(cfg, state, **kw):
    from photonic_flash_attention_tpu_torch.core.serving import ServingEngine

    return ServingEngine(cfg, state, device="cuda", num_pages=256, page_size=128, max_batch=8,
                         kv_dtype=torch.int8, decode_window=32, **kw)


def _capture_first_logits(engine) -> dict:
    """Wrap the engine's prefill-boundary sampling to keep each request's
    last-prompt-token logits."""
    logits_by_seq = {}
    pick = engine._pick_token

    def keep(logits_row, seq):
        logits_by_seq[tuple(seq.tokens[:seq.prompt_len])] = logits_row.float().clone()
        return pick(logits_row, seq)

    engine._pick_token = keep
    return logits_by_seq


def check_chunked_serving(cfg, model, prompts, unchunked_outs, smi) -> dict:
    """The same requests with prefill_chunk=PREFILL_CHUNK: prompts longer
    than it prefill one chunk per step() through K1 with the key-bias
    stream over the paged history. Every request's first token must equal
    the unchunked run's and its last-prompt-token logits must agree within
    CHUNK_LOGITS_BOUND; prints the share of equal greedy tokens."""
    state = model.state_dict()
    whole = _serving_engine(cfg, state)
    whole_logits = _capture_first_logits(whole)
    whole.generate(prompts, max_new_tokens=1)
    engine = _serving_engine(cfg, state, prefill_chunk=PREFILL_CHUNK)
    chunk_logits = _capture_first_logits(engine)
    engine.generate([p[:8] for p in prompts[:2]], max_new_tokens=2)  # warm-up
    torch.cuda.synchronize()
    engine.reset_performance_stats()
    chunk_logits.clear()
    _build.reset_launches()
    t0 = time.perf_counter()
    outs = engine.generate(prompts, max_new_tokens=NEW_TOKENS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    stats = engine.get_performance_stats()
    want_chunks = sum(-(-len(p) // PREFILL_CHUNK) for p in prompts if len(p) > PREFILL_CHUNK)
    if stats["prefill_chunks"] != want_chunks:
        raise AssertionError(f"chunked serving: {stats['prefill_chunks']} chunks, expected {want_chunks}")
    if launches.get("pfa_flash_fwd_streams", 0) != cfg.n_layer * want_chunks:
        raise AssertionError(f"chunked serving: K1 with streams launched "
                             f"{launches.get('pfa_flash_fwd_streams', 0)} times, expected "
                             f"{cfg.n_layer * want_chunks}")
    firsts = [o[0] for o in outs] == [o[0] for o in unchunked_outs]
    same = sum(a == b for o, u in zip(outs, unchunked_outs) for a, b in zip(o, u))
    errs = [rel_err_norm(chunk_logits[tuple(p)], whole_logits[tuple(p)])
            for p in prompts if len(p) > PREFILL_CHUNK]
    line = (f"chunked serving: prefill_chunk={PREFILL_CHUNK}, {stats['prefill_chunks']} chunks, "
            f"{len(prompts)} requests x {NEW_TOKENS} tokens in {wall:.2f} s; K1 launches "
            f"{launches.get('pfa_flash_fwd', 0)} plain + {launches.get('pfa_flash_fwd_streams', 0)} "
            f"with streams; first tokens equal to unchunked: {firsts}; greedy tokens equal "
            f"{same}/{len(prompts) * NEW_TOKENS} ({100 * same / (len(prompts) * NEW_TOKENS):.1f}%); "
            f"chunked-prompt last-token logits rel_err_norm "
            f"{[f'{e:.3e}' for e in errs]} (bound {CHUNK_LOGITS_BOUND}) ({smi})")
    if not firsts or max(errs) > CHUNK_LOGITS_BOUND:
        raise AssertionError(line)
    print(line, flush=True)
    return launches


LLAMA_PROMPT_LENS = (17, 100, 128, 300, 512, 700, 1500, 2000)
#: Bound on rel_err_norm of the served logits (last prompt token, and the
#: first decode steps over a bf16 pool) against the dense forward of the
#: same weights on the card, in bf16 and in fp32 (the GPT-2 phase's).
LLAMA_LOGITS_BOUND = 5e-2
LLAMA_DECODE_CHECK_STEPS = 4
#: The chunked run's first tokens must equal the whole prefill's exactly, so
#: a prompt whose dense fp32 top-2 last-position logits lie closer than this
#: share of the logits' rms is redrawn (T5_TIE_MARGIN's rule): with random
#: weights the logits over a large vocabulary tie within bf16's rounding
#: (Gemma-2B's widths: top-2 gaps 0 to 0.031 on four of five prompts), while
#: two served runs' logits differ by about 2e-2 of their rms, so by ~0.028
#: of it between two words: the margin is over four times that.
LLAMA_TIE_MARGIN = 0.12
LLAMA_PROMPT_DRAWS = 64


def _llama_70b_width():
    """Llama-2-70B's widths (hidden 8192, 64 heads over 8 KV heads,
    intermediate 28672) cut to 2 layers (2.24 B parameters)."""
    from photonic_flash_attention_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig(hidden_size=8192, intermediate_size=28672, num_hidden_layers=2,
                       num_attention_heads=64, num_key_value_heads=8)


def _llama_engine(cfg, state, kv_dtype=torch.int8, **kw):
    from photonic_flash_attention_tpu_torch.core.serving import ServingEngine

    return ServingEngine(cfg, state, device="cuda", num_pages=64, page_size=128, max_batch=8,
                         max_pages_per_seq=16, kv_dtype=kv_dtype, decode_window=32, **kw)


def _dense_last_logits(model, tokens, positions) -> torch.Tensor:
    """The dense forward's logits (fp32) of ``tokens`` at ``positions``."""
    with torch.no_grad():
        out = model(torch.tensor([tokens], device="cuda"))[0]
    return out[list(positions)].float()


def _llama_prompts(dense32, vocab: int):
    """One prompt per length of LLAMA_PROMPT_LENS from seed 0, redrawn while
    the dense fp32 model's top-2 last-position logits lie within
    LLAMA_TIE_MARGIN of the logits' rms: (prompts, their dense fp32
    last-position logits, the number redrawn)."""
    rng = np.random.default_rng(0)
    prompts, dense, redrawn = [], [], 0
    for n in LLAMA_PROMPT_LENS:
        for _ in range(LLAMA_PROMPT_DRAWS):
            prompt = rng.integers(1, vocab, n).tolist()
            logits = _dense_last_logits(dense32, prompt, [n - 1])[0]
            top = logits.topk(2).values
            if float(top[0] - top[1]) >= LLAMA_TIE_MARGIN * float(logits.square().mean().sqrt()):
                break
            redrawn += 1
        else:
            raise AssertionError(f"llama path: no prompt of {n} tokens in {LLAMA_PROMPT_DRAWS} "
                                 f"draws without a top-2 tie within {LLAMA_TIE_MARGIN} of "
                                 f"the logits' rms")
        prompts.append(prompt)
        dense.append(logits)
    return prompts, dense, redrawn


def _llama_path(label: str, cfg, smi: str, profile_tag: Optional[str] = None
                ) -> collections.Counter:
    """One Llama configuration served on the card (random bf16 weights from
    seed 0, made on the card; their bytes, the time to read them once and
    the pool's bytes printed; prompts drawn by _llama_prompts): 8 requests
    through an int8 pool with the launch counts asserted and the decode
    rates printed; every last-prompt logit row against the dense fp32
    forward, and those of the shortest and the longest prompt against the
    dense bf16 forward; the same requests with prefill_chunk=PREFILL_CHUNK,
    whose first tokens must equal the whole prefill's; decode steps 1-4 over
    a bf16 pool against the dense forward over the same tokens. Returns the
    launches of the served runs."""
    from photonic_flash_attention_tpu_torch.models.llama import LlamaForCausalLM

    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, generator=torch.Generator(device="cuda").manual_seed(0),
                             device="cuda", param_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"llama path: {label} ({cfg.num_hidden_layers} layers, hidden {cfg.hidden_size}, "
          f"{cfg.num_attention_heads}/{cfg.num_key_value_heads} heads, D {cfg.head_dim}) made on "
          f"the card in bf16 in {time.perf_counter() - t0:.1f} s ({n_params / 1e9:.3f} B "
          f"params)", flush=True)
    state = model.state_dict()
    # The same weights in an fp32 model (made on the meta device, given the
    # card's tensors): the dense fp32 forward.
    dense32 = LlamaForCausalLM(dataclasses.replace(cfg, dtype=torch.float32), device="meta")
    dense32.load_state_dict(state, assign=True)
    t0 = time.perf_counter()
    prompts, dense_logits, redrawn = _llama_prompts(dense32, cfg.vocab_size)
    del dense32
    print(f"llama path: {label}: prompts of {list(LLAMA_PROMPT_LENS)} tokens drawn in "
          f"{time.perf_counter() - t0:.1f} s, {redrawn} redrawn for a dense fp32 top-2 gap below "
          f"{LLAMA_TIE_MARGIN} of the logits' rms", flush=True)
    n_layer = cfg.num_hidden_layers
    counts = collections.Counter()

    engine = _llama_engine(cfg, state)
    weight_bytes = sum(t.numel() * t.element_size() for t in state.values())
    pool_bytes = sum(t.numel() * t.element_size() for t in (engine.pages.k, engine.pages.v,
                                                            engine.pages.k_scales,
                                                            engine.pages.v_scales)
                     if t is not None)
    read_ms = weight_bytes / HBM_BYTES_PER_S * 1e3
    print(f"llama path: {label}: weights {weight_bytes} bytes (one read {read_ms:.3f} ms at "
          f"{HBM_BYTES_PER_S / 1e12} TB/s: a decode step's bound), int8 pool {pool_bytes} bytes",
          flush=True)
    first_logits = _capture_first_logits(engine)
    engine.generate([p[:8] for p in prompts[:2]], max_new_tokens=2)  # warm-up
    torch.cuda.synchronize()
    engine.reset_performance_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    outs = engine.generate(prompts, max_new_tokens=NEW_TOKENS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    counts.update(launches)
    for p, o in zip(prompts, outs):
        if len(o) != NEW_TOKENS or not all(0 <= t < cfg.vocab_size for t in o):
            raise AssertionError(f"{label}: prompt of {len(p)} tokens: bad output {o}")
    if launches.get("pfa_flash_fwd", 0) != n_layer * len(prompts):
        raise AssertionError(f"{label}: pfa_flash_fwd launched {launches.get('pfa_flash_fwd', 0)} "
                             f"times, expected {n_layer * len(prompts)}")
    if launches.get("pfa_paged_decode_fused", 0) < n_layer * (NEW_TOKENS - 1):
        raise AssertionError(f"{label}: pfa_paged_decode_fused launched "
                             f"{launches.get('pfa_paged_decode_fused', 0)} times, expected >= "
                             f"{n_layer * (NEW_TOKENS - 1)}")
    stats = engine.get_performance_stats()
    print(f"llama path: {label}, int8 pool, {len(prompts)} requests of "
          f"{min(LLAMA_PROMPT_LENS)}-{max(LLAMA_PROMPT_LENS)} tokens x {NEW_TOKENS} new in "
          f"{wall:.3f} s wall; decode {stats['decode_tokens']} tokens at "
          f"{stats['decode_tokens_per_s']:.1f} tokens/s, "
          f"{1e3 * stats['decode_time'] / max(stats['decode_steps'], 1):.3f} ms a step; prefill "
          f"{stats['prefill_tokens']} tokens at {stats['prefill_tokens_per_s']:.1f} tokens/s; "
          f"launches {launches} ({smi})", flush=True)
    errs = {}
    for p in (prompts[0], prompts[-1]):
        dense = _dense_last_logits(model, p, [len(p) - 1])[0]
        errs[len(p)] = rel_err_norm(first_logits[tuple(p)], dense)
    line = (f"llama path: {label}, served last-prompt logits vs the dense forward, rel_err_norm "
            f"{ {n: f'{e:.3e}' for n, e in errs.items()} } (bound {LLAMA_LOGITS_BOUND})")
    if max(errs.values()) > LLAMA_LOGITS_BOUND:
        raise AssertionError(line)
    print(line, flush=True)
    errs = {len(p): rel_err_norm(first_logits[tuple(p)], want)
            for p, want in zip(prompts, dense_logits)}
    line = (f"llama path: {label}, served last-prompt logits vs the dense fp32 forward, "
            f"rel_err_norm { {n: f'{e:.3e}' for n, e in errs.items()} } (bound "
            f"{LLAMA_LOGITS_BOUND})")
    if max(errs.values()) > LLAMA_LOGITS_BOUND or \
            not all(torch.isfinite(first_logits[tuple(p)]).all() for p in prompts):
        raise AssertionError(line)
    print(line, flush=True)
    whole_logits = {k: v for k, v in first_logits.items() if len(k) > PREFILL_CHUNK}
    counts.update(check_window_graphs(f"{label} int8 pool", engine,
                                      lambda: _llama_engine(cfg, state), prompts, NEW_TOKENS, smi,
                                      profile_tag))
    del engine
    torch.cuda.empty_cache()

    engine = _llama_engine(cfg, state, prefill_chunk=PREFILL_CHUNK)
    chunk_logits = _capture_first_logits(engine)
    _build.reset_launches()
    chunk_outs = engine.generate(prompts, max_new_tokens=2)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    counts.update(launches)
    want_chunks = sum(-(-len(p) // PREFILL_CHUNK) for p in prompts if len(p) > PREFILL_CHUNK)
    if engine.get_performance_stats()["prefill_chunks"] != want_chunks or \
            launches.get("pfa_flash_fwd_streams", 0) != n_layer * want_chunks:
        raise AssertionError(f"{label}: chunked prefill ran "
                             f"{engine.get_performance_stats()['prefill_chunks']} chunks and "
                             f"{launches.get('pfa_flash_fwd_streams', 0)} K1 stream launches; "
                             f"expected {want_chunks} and {n_layer * want_chunks}")
    errs = [rel_err_norm(chunk_logits[k], v) for k, v in whole_logits.items()]
    firsts = sum(c[0] == o[0] for c, o in zip(chunk_outs, outs))
    line = (f"llama path: {label}, prefill_chunk={PREFILL_CHUNK}: {want_chunks} chunks, K1 with "
            f"streams {launches.get('pfa_flash_fwd_streams', 0)} launches; chunked-prompt "
            f"last-token logits vs the whole prefill rel_err_norm {[f'{e:.3e}' for e in errs]} "
            f"(bound {CHUNK_LOGITS_BOUND}); first tokens equal to the whole prefill's "
            f"{firsts}/{len(prompts)}")
    if max(errs) > CHUNK_LOGITS_BOUND or firsts != len(prompts):
        raise AssertionError(line)
    print(line, flush=True)
    del engine
    torch.cuda.empty_cache()

    # Decode steps 1-4 over a bf16 pool: slot i serves request i.
    engine = _llama_engine(cfg, state, kv_dtype=torch.bfloat16)
    step_logits = torch.zeros(LLAMA_DECODE_CHECK_STEPS, engine.max_batch, cfg.vocab_size,
                              device="cuda")
    decode = engine._decode_step

    def keep(*args):
        # Runs at the window's eager first step and into its step graph:
        # each replay stores its logits at row ``step`` of the window.
        logits = decode(*args)
        step_logits.index_copy_(0, engine._win.step, logits.float()[None])
        return logits

    engine._decode_step = keep
    checked = (prompts[0], prompts[-1])
    _build.reset_launches()
    served = engine.generate(list(checked), max_new_tokens=LLAMA_DECODE_CHECK_STEPS + 1)
    torch.cuda.synchronize()
    counts.update(_build.LAUNCHES)
    steps = engine.get_performance_stats()["decode_steps"]
    if steps != LLAMA_DECODE_CHECK_STEPS or engine.window_graph_stats()["graphs"] != 1:
        raise AssertionError(f"{label}: {steps} decode steps in "
                             f"{engine.window_graph_stats()['graphs']} step graphs, expected "
                             f"{LLAMA_DECODE_CHECK_STEPS} in one")
    errs = []
    for slot, (p, o) in enumerate(zip(checked, served)):
        n = len(p)
        dense = _dense_last_logits(model, p + o[:LLAMA_DECODE_CHECK_STEPS],
                                   range(n, n + LLAMA_DECODE_CHECK_STEPS))
        errs += [rel_err_norm(step_logits[j][slot], dense[j])
                 for j in range(LLAMA_DECODE_CHECK_STEPS)]
    line = (f"llama path: {label}, bf16 pool, decode steps 1-{LLAMA_DECODE_CHECK_STEPS} of the "
            f"{len(checked[0])}- and {len(checked[1])}-token prompts vs the dense forward over the "
            f"same tokens, rel_err_norm {[f'{e:.3e}' for e in errs]} (bound {LLAMA_LOGITS_BOUND})")
    if max(errs) > LLAMA_LOGITS_BOUND:
        raise AssertionError(line)
    print(line, flush=True)
    del engine, model, state
    torch.cuda.empty_cache()
    return counts


def phase_llama(smi: str) -> dict:
    """Llama serving on the card: Llama-2-7B at full width and depth, then
    GQA at Llama-2-70B's width cut to 2 layers (``_llama_path``)."""
    from photonic_flash_attention_tpu_torch.models.llama import LlamaConfig

    counts = collections.Counter()
    for label, cfg, tag in (("Llama-2-7B", LlamaConfig.llama2_7b(), "llama2_7b_window"),
                            ("Llama-2-70B width, 2 layers", _llama_70b_width(), None)):
        counts += _llama_path(label, cfg, smi, tag)
    return counts


BERT_LENS = (512, 480, 384, 300, 256, 128, 64, 17)
#: Bound on rel_err_norm of the bf16 encoder against the same weights in
#: fp32 on the card (kept rows of the sequence output, and the pooler).
BERT_BOUND = 2e-2


def phase_bert(smi: str) -> dict:
    """BERT-base (random weights from seed 0, bf16 compute) on a padded batch
    of B8 S512 with two token types: the padding reaches K1 as key streams
    (one ``pfa_flash_fwd_streams`` launch a layer); the kept rows and the
    pooled output against the same weights in fp32 on the card."""
    from photonic_flash_attention_tpu_torch.models.bert import BertConfig, BertModel

    cfg = BertConfig()
    model = BertModel(cfg, generator=torch.Generator(device="cuda").manual_seed(0))
    ref = BertModel(dataclasses.replace(cfg, dtype=torch.float32))
    ref.load_state_dict(model.state_dict())
    rng = np.random.default_rng(0)
    b, s = len(BERT_LENS), max(BERT_LENS)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))).cuda()
    lens = torch.tensor(BERT_LENS, device="cuda")
    pos = torch.arange(s, device="cuda")[None]
    mask = (pos < lens[:, None]).long()
    types = (pos >= lens[:, None] // 2).long() * mask  # segment B: each row's second half

    def forward():
        with torch.no_grad():
            return model(ids, mask, types)

    forward()  # warm-up
    torch.cuda.synchronize()
    _build.reset_launches()
    seq, pooled = forward()
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    if launches != {"pfa_flash_fwd_streams": cfg.num_hidden_layers}:
        raise AssertionError(f"bert path: launches {launches}, expected "
                             f"{{'pfa_flash_fwd_streams': {cfg.num_hidden_layers}}}")
    ms = median_ms(forward)
    with torch.no_grad():
        want, want_pooled = ref(ids, mask, types)
    keep = mask.bool()
    err, err_pool = rel_err_norm(seq[keep], want[keep]), rel_err_norm(pooled, want_pooled)
    line = (f"bert path: BERT-base B{b} S{s} lengths {list(BERT_LENS)}, bf16: launches "
            f"{launches}; {ms:.3f} ms a forward (CUDA events), "
            f"{int(lens.sum()) / ms * 1e3:.0f} kept tokens/s; vs fp32 on the card: kept rows "
            f"rel_err_norm {err:.3e}, pooled {err_pool:.3e} (bound {BERT_BOUND}) ({smi})")
    if max(err, err_pool) > BERT_BOUND or not torch.isfinite(seq).all():
        raise AssertionError(line)
    print(line, flush=True)
    del model, ref
    torch.cuda.empty_cache()
    return launches


ENGINE_WIDTH, ENGINE_HEADS = 1024, 16  # GPT-2 medium's attention widths
#: Bound on rel_err_norm of a layer call against the same layer with fp32
#: fused attention on the card (bf16 projections and attention output).
ENGINE_BOUND = 2e-2


def _seeded_layer(causal: bool, gen: torch.Generator):
    from photonic_flash_attention_tpu_torch.models.attention import PhotonicFlashAttention

    layer = PhotonicFlashAttention(ENGINE_WIDTH, ENGINE_HEADS, causal=causal)
    with torch.no_grad():
        for lin in (layer.q_proj, layer.k_proj, layer.v_proj, layer.out_proj):
            lin.weight.normal_(0.0, 0.02, generator=gen)
            lin.bias.normal_(0.0, 0.02, generator=gen)
    return layer.to("cuda")


def _layer_oracle(layer, query, key, value, mask, kv_lens):
    """The layer's computation with fp32 fused attention."""
    from photonic_flash_attention_tpu_torch.models.attention import dense
    from photonic_flash_attention_tpu_torch.ops.fused import fused_attention

    b, sq, _ = query.shape
    skv = key.shape[1]
    h, d = layer.num_heads, layer.head_dim
    q = dense(query.to(layer.dtype), layer.q_proj).reshape(b, sq, h, d)
    k = dense(key.to(layer.dtype), layer.k_proj).reshape(b, skv, h, d)
    v = dense(value.to(layer.dtype), layer.v_proj).reshape(b, skv, h, d)
    if kv_lens is not None:
        mask = (torch.arange(skv, device="cuda")[None] < kv_lens[:, None])[:, None, None, :]
    out, _ = fused_attention(q.float(), k.float(), v.float(), mask, causal=layer.causal)
    return dense(out.to(layer.dtype).reshape(b, sq, h * d), layer.out_proj)


def _engine_cases(gen):
    """(name, causal layer?, query, key, value, mask, kv_lens, heuristic kind,
    kernel counter) at GPT-2-medium width."""
    x = torch.randn(4, 2048, ENGINE_WIDTH, device="cuda", generator=gen)
    lens4 = torch.tensor([2048, 1536, 1000, 700], device="cuda")
    pad_mask = (torch.arange(2048, device="cuda")[None] < lens4[:, None])[:, None, None, :]
    q1 = torch.randn(8, 1, ENGINE_WIDTH, device="cuda", generator=gen)
    ctx = torch.randn(8, 2048, ENGINE_WIDTH, device="cuda", generator=gen)
    lens8 = torch.tensor([2048, 2000, 1500, 1024, 1000, 700, 129, 128], dtype=torch.int32,
                         device="cuda")
    short = torch.randn(4, 128, ENGINE_WIDTH, device="cuda", generator=gen)
    dense_mask = torch.rand(4, 1, 2048, 2048, device="cuda", generator=gen) > 0.1
    dense_mask[..., 0] = True
    return [
        ("B4 S2048 causal", True, x, None, None, None, None, "flash_unrolled", "pfa_flash_fwd"),
        ("B4 S2048 (B,1,1,S) key padding", False, x, None, None, pad_mask, None,
         "flash_unrolled", "pfa_flash_fwd_streams"),
        ("B4 S2048 (B,1,S,S) dense mask", False, x, None, None, dense_mask, None, "flash",
         "pfa_flash_fwd_densebias"),
        ("decode B8 Sq1 Skv2048 kv_lens", False, q1, ctx, ctx, None, lens8, "paged_decode",
         "pfa_paged_hf"),
        ("B4 S128 causal", True, short, None, None, None, None, "fused", None),
    ]


#: Bound on rel_err_norm of a layer call under a quant mode against the fp32
#: fused oracle: the reference's gate for quantized paths.
QUANT_ENGINE_BOUND = 0.1
#: quant_mode -> (the heuristic's kind for the cross-attention call, its
#: counter, the counters the measured warm-up must raise).
QUANT_ENGINE_MODES = {
    "int8": ("flash_int8full", "pfa_flash_fwd_int8full",
             ("pfa_flash_fwd_int8qk", "pfa_flash_fwd_int8full")),
    "fp8": ("flash_fp8qk", "pfa_flash_fwd_fp8qk", ("pfa_flash_fwd_fp8qk", "pfa_flash_quant_fp8")),
}


def _engine_pass(layers, cases, *, measured: bool, calls: int, bound: float, label: str):
    """Drive ``cases`` through the drop-in layer with a fresh engine under
    the current config: each case ``calls`` times; outputs against the fp32
    fused oracle within ``bound``; with the heuristic the kind is asserted
    and its counter must grow; measured, the router's table is printed.
    Raises on any engine failure."""
    from photonic_flash_attention_tpu_torch.core.engine import get_engine, reset_engine
    from photonic_flash_attention_tpu_torch.core.router import KernelKind, WorkloadCharacteristics

    reset_engine()
    engine = get_engine()
    for name, causal, query, key, value, mask, lens, kind, counter in cases:
        layer = layers[causal]
        before = dict(_build.LAUNCHES)
        t0 = time.perf_counter()
        for _ in range(calls):
            out, _ = layer(query, key, value, mask, kv_lens=lens)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        used = engine.last_kernel_used
        err = rel_err_norm(out, _layer_oracle(layer, query, key if key is not None else query,
                                              value if value is not None else query, mask, lens))
        line = (f"engine ({label}{'measured' if measured else 'heuristic'}): {name}: kind {used}, "
                f"rel_err_norm {err:.3e} (bound {bound}), {wall:.3f} ms for {calls} calls")
        if err > bound or not torch.isfinite(out).all():
            raise AssertionError(line)
        if not measured:
            if used != kind:
                raise AssertionError(f"{line}: the heuristic must pick {kind}")
            if counter and _build.LAUNCHES[counter] <= before.get(counter, 0):
                raise AssertionError(f"{line}: {counter} did not launch")
        else:
            skv = (key if key is not None else query).shape[1]
            dense = mask is not None and mask.shape[-2] > 1
            w = WorkloadCharacteristics(
                batch_size=query.shape[0], q_len=query.shape[1], kv_len=skv,
                num_heads=ENGINE_HEADS, head_dim=64, causal=causal,
                mask_kind="dense" if dense else "none" if mask is None and lens is None else "key",
                is_decode=query.shape[1] == 1, dtype="bfloat16", num_kv_heads=ENGINE_HEADS)
            table = {k.value: engine.router.predicted_latency(k, w) for k in KernelKind
                     if engine.router.predicted_latency(k, w) is not None}
            line += (f"; roofline energy of the last call {engine.last_energy_mj:.4f} mJ; "
                     f"router table (ms by kind) {table}")
            if dense and "flash" not in table:
                raise AssertionError(f"{line}: the measured table must offer flash for a dense mask")
        print(line, flush=True)
    stats = engine.get_performance_stats()
    if stats["failures"]:
        raise AssertionError(f"engine ({label}): failures {stats['failures']}")
    return stats


def phase_engine(smi: str) -> dict:
    """The drop-in layer's adaptive route, eager calls under no_grad at
    GPT-2-medium width: once with the heuristic (the kinds must be exactly
    as listed; a dense mask takes FLASH, K1's dense-bias mode) and once
    measured (warm-up over every eligible kind, then exploit; a dense
    mask's table must hold FLASH); every output against the fp32 fused
    oracle; K1 and K3 must launch and the engine must count no failure. Then under quant_mode
    "int8" and "fp8": a square causal call (the heuristic keeps
    flash_unrolled, the JAX order) and a cross-attention call (Sq 512, Skv
    2048: the quantized kind), heuristic then measured; the warm-up must
    launch each quantized kernel mode the mode offers."""
    from photonic_flash_attention_tpu_torch.config import get_config, reset_config
    from photonic_flash_attention_tpu_torch.core.engine import reset_engine

    gen = torch.Generator(device="cuda").manual_seed(0)
    layers = {c: _seeded_layer(c, torch.Generator().manual_seed(int(c))) for c in (False, True)}
    cases = _engine_cases(gen)
    _build.reset_launches()
    with torch.no_grad():
        for measured in (False, True):
            reset_config()
            get_config().update(auto_kernel_selection=measured)
            stats = _engine_pass(layers, cases, measured=measured, calls=4 if measured else 1,
                                 bound=ENGINE_BOUND, label="")
        launches = dict(_build.LAUNCHES)
        for name in ("pfa_flash_fwd", "pfa_flash_fwd_streams", "pfa_flash_fwd_densebias",
                     "pfa_paged_hf"):
            if not launches.get(name):
                raise AssertionError(f"engine: {name} never launched through the engine")
        print(f"engine: launches {launches}; failures {stats['failures']}; card power limit "
              f"{stats['board_power_w']} W; last energy {stats['last_energy_mj']} mJ ({smi})",
              flush=True)

        prefill, cross = cases[0], _quant_cross_case(gen)
        for quant_mode, (kind, counter, warmup_counters) in QUANT_ENGINE_MODES.items():
            quant_cases = [prefill, cross[:7] + (kind, counter)]
            for measured in (False, True):
                reset_config()
                get_config().update(auto_kernel_selection=measured, quant_mode=quant_mode)
                before = dict(_build.LAUNCHES)
                # Measured: more calls than kinds, so the warm-up reaches each.
                stats = _engine_pass(layers, quant_cases, measured=measured,
                                     calls=8 if measured else 1, bound=QUANT_ENGINE_BOUND,
                                     label=f"quant_mode={quant_mode}, ")
                if measured:
                    for name in warmup_counters:
                        if _build.LAUNCHES[name] <= before.get(name, 0):
                            raise AssertionError(f"engine (quant_mode={quant_mode}): {name} did "
                                                 "not launch in the measured warm-up")
    launches = dict(_build.LAUNCHES)
    print(f"engine: launches with the quant modes {launches}; failures {stats['failures']} ({smi})",
          flush=True)
    reset_config()
    reset_engine()
    return launches


def _quant_cross_case(gen):
    """A cross-attention call at GPT-2-medium width: B4, Sq 512 over a
    2048-token context (non-causal layer); the kind is set per quant mode."""
    query = torch.randn(4, 512, ENGINE_WIDTH, device="cuda", generator=gen)
    ctx = torch.randn(4, 2048, ENGINE_WIDTH, device="cuda", generator=gen)
    return ("B4 Sq512 Skv2048 cross", False, query, ctx, ctx, None, None, None, None)


TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, CHECK_LAYERS = 8, 1024, 5, 4
TRAIN_KERNELS = ("pfa_flash_fwd", "pfa_flash_bwd_dkv", "pfa_flash_bwd_dq")
#: GPT-2 with attn_pdrop: the kernels' dropout modes.
DROPOUT_KERNELS = ("pfa_flash_fwd_dropout", "pfa_flash_bwd_dkv_dropout", "pfa_flash_bwd_dq_dropout")
#: The dropout run's seeds: Trainer(dropout_rng=Generator(DROPOUT_RNG_SEED));
#: the gradient check's fixed forward seed.
DROPOUT_RNG_SEED, GRAD_DROPOUT_SEED = 0, 99


def _lm_grads(model, batch, dropout_seed=None) -> dict:
    from photonic_flash_attention_tpu_torch.training.trainer import lm_loss

    model.zero_grad(set_to_none=True)
    lm_loss(model, batch, dropout_seed=dropout_seed).backward()
    return {n: p.grad.float().cpu() for n, p in model.named_parameters()}


def check_train_grads(cfg, state: dict, batch: dict, kernels=TRAIN_KERNELS) -> None:
    """One step's gradient of the first CHECK_LAYERS layers of the weights
    at B1: bf16 on the card (K1, K4, K5, in their dropout modes when the
    config drops; one fixed dropout seed on both sides, so the same masks)
    against fp32 on the CPU (the plain versions), the bf16-scale gate
    5e-2."""
    from photonic_flash_attention_tpu_torch.config import get_config, reset_config
    from photonic_flash_attention_tpu_torch.models.gpt2 import GPT2LMHead

    cut = dataclasses.replace(cfg, n_layer=CHECK_LAYERS)
    seed = GRAD_DROPOUT_SEED if cfg.attn_pdrop > 0.0 else None
    one = {k: torch.as_tensor(v[:1]) for k, v in batch.items()}
    # B1 S1024 is below flash_min_tokens: lower it so both runs take the
    # flash route (kernels on the card, plain versions on the CPU).
    get_config().update(flash_min_tokens=TRAIN_SEQ)
    grads = {}
    for device, dtype in (("cpu", torch.float32), ("cuda", cfg.dtype)):
        model = GPT2LMHead(dataclasses.replace(cut, dtype=dtype))
        model.load_state_dict(state)
        before = dict(_build.LAUNCHES)
        grads[device] = _lm_grads(model.to(device), {k: v.to(device) for k, v in one.items()}, seed)
        if device == "cuda":
            for name in kernels:
                if _build.LAUNCHES[name] - before.get(name, 0) != CHECK_LAYERS:
                    raise AssertionError(f"gradient check: {name} not launched per layer")
    reset_config()
    flat = {d: torch.cat([g.flatten() for g in gs.values()]) for d, gs in grads.items()}
    errs = {"all": rel_err_norm(flat["cuda"], flat["cpu"])}
    for i in range(CHECK_LAYERS):
        name = f"h.{i}.attn.q_proj.weight"
        errs[name] = rel_err_norm(grads["cuda"][name], grads["cpu"][name])
    line = (f"training path: gradient of GPT-2 widths {cfg.n_embd}/{cfg.n_head} heads, "
            f"attn_pdrop {cfg.attn_pdrop}, first "
            f"{CHECK_LAYERS} layers, B1 S{TRAIN_SEQ}, card bf16 vs CPU fp32 plain: "
            + ", ".join(f"{n} {e:.3e}" for n, e in errs.items()) + " (bound 5e-2)")
    if max(errs.values()) > 5e-2 or not torch.isfinite(flat["cuda"]).all():
        raise AssertionError(line)
    print(line, flush=True)


KERNEL_GROUPS = (  # (group, substrings of the CUDA kernel names)
    ("K1 flash forward", ("flash_fwd",)),
    ("K2 paged token write", ("paged_token_write",)),
    ("K3 paged decode", ("paged_decode_attend", "k3_kernel")),
    ("K4 flash dK/dV", ("bwd_dkv",)),
    ("K5 flash dQ", ("bwd_dq",)),
    ("matmul (cuBLAS)", ("gemm", "cutlass", "nvjet", "xmma")),
    ("AdamW (multi-tensor)", ("multi_tensor",)),
    ("softmax / cross entropy", ("SoftMax", "softmax")),
    ("layer norm", ("layer_norm", "LayerNorm", "GammaBeta")),
    ("reductions", ("reduce_kernel",)),
    ("elementwise and copies", ("elementwise", "copy", "fill", "Memcpy", "Memset")),
)
PROFILED_STEPS = 3
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, reach = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end > reach:
            busy += end - max(start, reach)
            reach = end
    return busy


def _profile_runs(fn, runs: int, out_dir: Path, tag: str) -> None:
    """torch.profiler (device activity only) over ``runs`` single calls of
    ``fn``. For each: its own wall time (host clock, card synchronized
    before and after), the device's busy time (union of its kernel and copy
    intervals in the trace) and the span from the first device event to
    the last. Idle share = 1 - busy / wall, per call. Then the mean device
    time by kernel group; traces and a per-kernel table
    (``{tag}_profile.txt``) go into ``out_dir``."""
    from torch.profiler import ProfilerActivity, profile

    out_dir.mkdir(parents=True, exist_ok=True)
    groups = collections.Counter()
    by_kernel = collections.Counter()
    idle = []
    for i in range(runs):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0)
        trace = out_dir / f"{tag}_trace_{i}.json"
        prof.export_chrome_trace(str(trace))
        events = [e for e in json.loads(trace.read_text())["traceEvents"]
                  if e.get("cat") in DEVICE_CATEGORIES and "dur" in e]
        if not events:
            raise AssertionError(f"profile {tag}: the trace holds no device events")
        spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events]
        busy = _busy_us(spans)
        span = max(e for _, e in spans) - min(s for s, _ in spans)
        idle.append(1 - busy / wall_us)
        print(f"profile {tag}: call {i}: wall {wall_us / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms, "
              f"first-to-last device event {span / 1e3:.3f} ms, idle {100 * idle[-1]:.1f}% of "
              f"the wall ({len(events)} device events)", flush=True)
        for e in events:
            name = e["name"]
            by_kernel[name] += float(e["dur"]) / 1e3 / runs
            group = next((g for g, keys in KERNEL_GROUPS if any(k in name for k in keys)), "other")
            groups[group] += float(e["dur"]) / 1e3 / runs
    total = sum(groups.values())
    lines = [f"profile {tag}: idle share over {runs} profiled calls "
             f"{100 * min(idle):.1f}% .. {100 * max(idle):.1f}%; mean device time by group "
             f"(sum {total:.3f} ms):"]
    lines += [f"profile {tag}:   {g}: {t:.3f} ms ({100 * t / total:.1f}%)"
              for g, t in groups.most_common()]
    print("\n".join(lines), flush=True)
    table = [f"{t:10.3f} ms  {name}" for name, t in by_kernel.most_common(80)]
    (out_dir / f"{tag}_profile.txt").write_text("\n".join(lines + [""] + table) + "\n")


def profile_train_step(trainer, state, batch, out_dir: Path) -> None:
    """PROFILED_STEPS single training steps under the profiler."""
    _profile_runs(lambda: trainer.train_step(state, batch), PROFILED_STEPS, out_dir, "train_step")


def _train_run(cfg, label: str, kernels, smi: str, dropout_rng=None, model=None,
               first_layers=None, batch_size: int = TRAIN_BATCH,
               model_name: str = "GPT-2 medium"):
    """TRAIN_STEPS AdamW steps of GPT-2 ``cfg`` at B ``batch_size`` S
    TRAIN_SEQ on one fixed batch through ``Trainer.train_step``, after a
    warm-up step: the loss must fall and each of ``kernels`` launch once per
    layer and step. ``model`` and its first CHECK_LAYERS layers' initial
    weights (``first_layers``, on the CPU) default to GPT-2 medium's.
    Returns (trainer, state, batch, the first CHECK_LAYERS layers' initial
    weights, launches, median step ms)."""
    from photonic_flash_attention_tpu_torch.training import Trainer, synthetic_lm_batches

    if model is None:
        model = gpt2_medium_on_card(cfg)
        first_layers = {k: v for k, v in gpt2_medium_state().items()
                        if not k.startswith("h.") or int(k.split(".")[1]) < CHECK_LAYERS}
    # optax.adamw(1e-4)'s defaults (torch's default weight decay is 1e-2).
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)
    trainer = Trainer(model, opt, dropout_rng=dropout_rng)
    state = trainer.init_state()
    batch = next(synthetic_lm_batches(batch=batch_size, seq=TRAIN_SEQ,
                                      vocab=cfg.vocab_size, seed=0))
    state, _ = trainer.train_step(state, batch)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    _build.reset_launches()
    losses, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, metrics = trainer.train_step(state, batch)
        losses.append(float(metrics["loss"]))  # synchronizes
        step_ms.append(1e3 * (time.perf_counter() - t0))
    launches = dict(_build.LAUNCHES)

    need = cfg.n_layer * TRAIN_STEPS
    for name in kernels:
        if launches.get(name, 0) != need:
            raise AssertionError(f"{name}: {launches.get(name, 0)} launches in the "
                                 f"training path ({label}), expected {need}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"training path ({label}): loss did not fall over {TRAIN_STEPS} "
                             f"steps: {losses}")
    wall = sum(step_ms) / 1e3
    tokens = TRAIN_STEPS * batch_size * TRAIN_SEQ
    print(f"training path ({label}): {model_name} B{batch_size} S{TRAIN_SEQ}, {TRAIN_STEPS} AdamW "
          f"steps in {wall:.3f} s, {tokens / wall:.1f} tokens/s, step ms "
          f"{[round(t, 3) for t in step_ms]} (median {statistics.median(step_ms):.3f}), "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({smi}); "
          f"losses {[round(x, 4) for x in losses]}; launches {launches}", flush=True)
    return trainer, state, batch, first_layers, launches, statistics.median(step_ms)


def phase_training(smi: str, profile_dir: Optional[str] = None) -> dict:
    """GPT-2 medium (the JAX training bench's B8 S512 model), at S1024:
    once as published without dropout (K1, K4, K5), once with attn_pdrop
    0.1 through ``Trainer(dropout_rng=...)`` (their dropout modes, which
    must launch n_layer x steps times); each run's loss must fall and its
    first 4 layers' gradient match the CPU plain run."""
    from photonic_flash_attention_tpu_torch.models.gpt2 import GPT2Config

    cfg = GPT2Config.medium()
    trainer, state, batch, first_layers, launches, plain_ms = _train_run(
        cfg, "attn_pdrop 0", TRAIN_KERNELS, smi)
    if profile_dir:
        profile_train_step(trainer, state, batch, Path(profile_dir))
    del trainer, state
    torch.cuda.empty_cache()
    check_train_grads(cfg, first_layers, batch)

    drop_cfg = dataclasses.replace(cfg, attn_pdrop=0.1)
    trainer, state, batch, first_layers, drop_launches, drop_ms = _train_run(
        drop_cfg, "attn_pdrop 0.1", DROPOUT_KERNELS, smi,
        dropout_rng=torch.Generator().manual_seed(DROPOUT_RNG_SEED))
    print(f"training path: median step with attn_pdrop 0.1 {drop_ms:.3f} ms against "
          f"{plain_ms:.3f} ms without ({smi})", flush=True)
    del trainer, state
    torch.cuda.empty_cache()
    check_train_grads(drop_cfg, first_layers, batch, DROPOUT_KERNELS)
    return collections.Counter(launches) + collections.Counter(drop_launches)


# -- the d-80 path: Cerebras-GPT-2.7B's widths served and trained -------------

#: Cerebras-GPT-2.7B's published widths (the cerebras/Cerebras-GPT-2.7B
#: config: n_embd 2560, n_head 32, n_layer 32, n_positions 2048, GPT-2's
#: vocabulary; the Cerebras-GPT paper's Table 1: d_head 80) on the repo's
#: GPT-2 block, built inline: the d-80 path.
D80_WIDTHS = dict(vocab_size=50257, n_positions=2048, n_embd=2560, n_layer=32, n_head=32)
#: Pages of 128 tokens of the d-80 path's int8 pool (5,120 bytes a token a
#: layer beside 256 bytes of scales).
D80_PAGES = 128
#: The d-80 path's training cut: every width, 4 layers, B2 S TRAIN_SEQ.
D80_TRAIN_LAYERS, D80_TRAIN_BATCH = 4, 2
#: Bound on rel_err_norm of the served prefill's last-position logits (bf16
#: compute) against the dense fp32 forward of the same weights: GPT-2's.
D80_LOGITS_BOUND = 5e-2
#: The d-256 path (Gemma-2B's widths) holds its served logits to the same
#: bound against the dense fp32 forward: LLAMA_LOGITS_BOUND, as every Llama
#: path does.
#: Gemma-2B's published widths (google/gemma-2b config.json: hidden_size
#: 2048, 8 attention heads over 1 KV head, head_dim 256, intermediate_size
#: 16384, 18 layers, vocabulary 256000, tied embeddings, rope_theta 10000,
#: rms_norm_eps 1e-6) on the repo's Llama block, built inline: the d-256
#: path. Llama's SwiGLU MLP and RMSNorm stand where Gemma has its GeGLU,
#: RMSNorm's (1 + w) and the embedding's x sqrt(2048); none touches attention.
GEMMA_2B_WIDTHS = dict(vocab_size=256000, hidden_size=2048, intermediate_size=16384,
                       num_hidden_layers=18, num_attention_heads=8, num_key_value_heads=1,
                       max_position_embeddings=8192, rope_theta=10000.0, rms_norm_eps=1e-6,
                       tie_word_embeddings=True)


def phase_gpt2_d80(smi: str) -> dict:
    """The d-80 path: GPT-2 at Cerebras-GPT-2.7B's widths (D80_WIDTHS, head
    dim 80), weights drawn on the card from a seed. Served through
    ServingEngine over an int8 pool (max_batch 8, decode window 32, the
    serving phase's prompts, NEW_TOKENS new tokens): K1 must launch
    n_layer x 8 times and the fused decode at least n_layer x (NEW_TOKENS -
    1); the greedy tokens graphed and eager bit-equal; then one chunked
    prefill run (K1's key-bias stream); the served prefill's last-position
    logits against the dense fp32 forward (D80_LOGITS_BOUND). Then the same
    widths cut to D80_TRAIN_LAYERS layers trained TRAIN_STEPS AdamW steps
    at B D80_TRAIN_BATCH S TRAIN_SEQ (K1 with lse, K5, K4 once a layer a
    step), and the first CHECK_LAYERS layers' gradient against the CPU's
    fp32 plain run (5e-2). Returns the path's launches."""
    from photonic_flash_attention_tpu_torch.core.serving import ServingEngine
    from photonic_flash_attention_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    from photonic_flash_attention_tpu_torch.models.gpt2_serving import (
        KVPages, prefill_step, prepare_params,
    )

    cfg = GPT2Config(**D80_WIDTHS)
    if cfg.n_embd // cfg.n_head != CEREBRAS_D:
        raise AssertionError(f"d-80 path: head dim {cfg.n_embd // cfg.n_head}")
    t0 = time.perf_counter()
    with torch.device("cuda"):
        model = GPT2LMHead(cfg, generator=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    state = model.state_dict()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"d-80 path: GPT-2 at Cerebras-GPT-2.7B's widths (n_embd {cfg.n_embd}, n_head "
          f"{cfg.n_head}, head dim {CEREBRAS_D}, {cfg.n_layer} layers, n_positions "
          f"{cfg.n_positions}), {n_params / 1e9:.3f} B parameters drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    def make_engine(**kw):
        return ServingEngine(cfg, state, device="cuda", num_pages=D80_PAGES, page_size=128,
                             max_batch=8, kv_dtype=torch.int8, decode_window=32, **kw)

    engine = make_engine()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in PROMPT_LENS]
    engine.generate([p[:8] for p in prompts[:2]], max_new_tokens=2)  # warm-up
    torch.cuda.synchronize()
    engine.reset_performance_stats()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    outs = engine.generate(prompts, max_new_tokens=NEW_TOKENS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    for p, o in zip(prompts, outs):
        if len(o) != NEW_TOKENS or not all(0 <= t < cfg.vocab_size for t in o):
            raise AssertionError(f"d-80 path: prompt of {len(p)} tokens: bad output {o}")
    need = {"pfa_flash_fwd": cfg.n_layer * len(prompts),
            "pfa_paged_decode_fused": cfg.n_layer * (NEW_TOKENS - 1)}
    for name, n in need.items():
        got = launches.get(name, 0)
        if got < n or (name == "pfa_flash_fwd" and got != n):
            raise AssertionError(f"d-80 path: {name}: {got} launches, expected {n}")
    stats = engine.get_performance_stats()
    print(f"d-80 path: {len(prompts)} requests x {NEW_TOKENS} tokens in {wall:.2f} s; decode "
          f"{stats['decode_tokens']} tokens at {stats['decode_tokens_per_s']:.1f} tokens/s, "
          f"{_decode_ms(engine):.3f} ms a step, prefill {stats['prefill_tokens']} tokens at "
          f"{stats['prefill_tokens_per_s']:.1f} tokens/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {launches} ({smi})",
          flush=True)
    window_launches = check_window_graphs(
        f"Cerebras-GPT-2.7B widths (head dim {CEREBRAS_D}) int8 pool", engine, make_engine,
        prompts, NEW_TOKENS, smi)
    del engine
    torch.cuda.empty_cache()
    chunked_launches = check_chunked_serving(cfg, model, prompts, outs, smi)
    torch.cuda.empty_cache()

    # The served prefill's last-position logits for prompt 0 against the
    # dense forward of the same weights in fp32 (a model on the meta device
    # given the card's tensors), and the dense bf16 forward beside it.
    params = prepare_params(state, cfg, "cuda")
    n0 = len(prompts[0])
    s_pad = max(16, 1 << (n0 - 1).bit_length())
    ids = torch.zeros(1, s_pad, dtype=torch.long, device="cuda")
    ids[0, :n0] = torch.tensor(prompts[0], device="cuda")
    pages = KVPages.create(cfg, 4, 128, torch.int8, "cuda")
    slots = torch.arange(s_pad, dtype=torch.int32, device="cuda")[None] + 128
    slots[0, n0:] = 0
    logits = prefill_step(params, cfg, ids, torch.tensor([n0], device="cuda"), pages, slots,
                          True)[0].float()
    with torch.device("meta"):
        dense32 = GPT2LMHead(dataclasses.replace(cfg, dtype=torch.float32))
    dense32.load_state_dict(state, assign=True)
    with torch.no_grad():
        want = dense32(ids[:, :n0])[0, -1].float()
        bf16 = model(ids[:, :n0])[0, -1].float()
    err, err_bf16 = rel_err_norm(logits, want), rel_err_norm(logits, bf16)
    line = (f"d-80 path: served prefill's last-position logits (prompt of {n0} tokens) vs the "
            f"dense fp32 forward rel_err_norm {err:.3e} (bound {D80_LOGITS_BOUND}); vs the dense "
            f"bf16 forward {err_bf16:.3e}; argmax {int(logits.argmax())} / {int(want.argmax())}")
    if err > D80_LOGITS_BOUND or not torch.isfinite(logits).all():
        raise AssertionError(line)
    print(line, flush=True)
    first_layers = {k: v.cpu() for k, v in state.items()
                    if not k.startswith("h.") or int(k.split(".")[1]) < D80_TRAIN_LAYERS}
    del params, pages, dense32, model, state
    torch.cuda.empty_cache()

    cut = dataclasses.replace(cfg, n_layer=D80_TRAIN_LAYERS)
    with torch.device("cuda"):
        tmodel = GPT2LMHead(cut, generator=torch.Generator(device="cuda").manual_seed(0))
    tmodel.load_state_dict(first_layers)
    trainer, tstate, batch, _, train_launches, step_ms = _train_run(
        cut, "d-80 path", TRAIN_KERNELS, smi, model=tmodel, first_layers=first_layers,
        batch_size=D80_TRAIN_BATCH,
        model_name=f"Cerebras-GPT-2.7B widths cut to {D80_TRAIN_LAYERS} layers (head dim "
                   f"{CEREBRAS_D})")
    del trainer, tstate, tmodel
    torch.cuda.empty_cache()
    check_train_grads(cut, first_layers, batch)
    return (collections.Counter(launches) + collections.Counter(window_launches)
            + collections.Counter(chunked_launches) + collections.Counter(train_launches))


def phase_gemma_d256(smi: str) -> dict:
    """The d-256 path: Llama at Gemma-2B's widths (GEMMA_2B_WIDTHS, head dim
    256 over one KV head; 2.51 B parameters, 5.0 GB in bf16), weights drawn
    on the card from a seed, served at all 18 layers through _llama_path
    (max_batch 8, decode window 32, int8 pool, phase_llama's prompts of
    17-2000 tokens x NEW_TOKENS, redrawn off top-2 ties): K1 at D 256
    launched 18 x 8 times, K3's fused decode at D 256 at least 18 x
    (NEW_TOKENS - 1), greedy tokens graphed and eager bit-equal, the chunked
    run (K1's key streams at D 256) with the whole prefill's first tokens,
    the served logits against the dense fp32 forward (LLAMA_LOGITS_BOUND).
    Returns the path's launches."""
    from photonic_flash_attention_tpu_torch.models.llama import LlamaConfig

    cfg = LlamaConfig(**GEMMA_2B_WIDTHS)
    if cfg.head_dim != GEMMA_D:
        raise AssertionError(f"d-256 path: head dim {cfg.head_dim}")
    return _llama_path(f"Gemma-2B widths (head dim {GEMMA_D})", cfg, smi)


T5_PROMPT_LENS = (64, 100, 128, 200, 256, 300, 400, 512)
T5_NEW_TOKENS = 32
T5_ENC_MAX_LEN = 512
#: Bound on rel_err_norm of the cut T5-large forward (fp32 on the card)
#: against the same weights in fp32 on the CPU.
T5_FORWARD_BOUND = 2e-2
#: The greedy-parity rule's tolerance: the JAX test's (see phase_t5).
T5_PARITY_TOL = 0.05
#: The first-token check is exact, so a prompt whose dense fp32 top-2
#: first-step logits lie closer than this (a tie at the int8 pool's
#: first-step logit error, 1e-2 relative, ~4e-2 absolute) is redrawn.
T5_TIE_MARGIN = 0.1


def _t5_model(cfg, device: str, seed: int = 0):
    """T5ForConditionalGeneration with Flax's initialisers drawn from a
    seeded generator on ``device`` (eval mode, no gradients)."""
    from photonic_flash_attention_tpu_torch.models.t5 import T5ForConditionalGeneration

    with torch.device(device):
        model = T5ForConditionalGeneration(cfg, generator=torch.Generator(device=device).manual_seed(seed))
    return model.eval().requires_grad_(False)


def _t5_dense_logits(model, enc_ids, dec_ids) -> torch.Tensor:
    """The dense model's last-position logits (V,) fp32 on the card."""
    with torch.no_grad():
        return model(torch.tensor([enc_ids], device="cuda"),
                     torch.tensor([dec_ids], device="cuda"))[0, -1].float()


def check_t5_forward(cfg) -> dict:
    """(a) The forward at full width cut to 2+2 layers, B1, encoder 1024,
    decoder 512, unmasked: both stacks on K1's relative-bias mode (the B1
    cross-attention is below flash_min_tokens: fused). The card's fp32
    forward (K1's fp32 path) against the same weights in fp32 on the CPU
    (plain versions), bound T5_FORWARD_BOUND; the card's bf16 forward
    against the same CPU run is reported beside it, and is no check: with
    random weights and unscaled d_kv-64 scores (std ~8, a near-argmax
    softmax) bf16 rounding alone moves T5's logits by several percent, in
    the JAX model as well."""
    cut = dataclasses.replace(cfg, num_layers=2, num_decoder_layers=2)
    card = {torch.float32: _t5_model(dataclasses.replace(cut, dtype=torch.float32), "cuda", seed=1)}
    card[torch.bfloat16] = _t5_model(cut, "cuda")
    card[torch.bfloat16].load_state_dict(card[torch.float32].state_dict())
    cpu = _t5_model(dataclasses.replace(cut, dtype=torch.float32), "cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card[torch.float32].state_dict().items()})
    rng = np.random.default_rng(1)
    enc = torch.from_numpy(rng.integers(2, cfg.vocab_size, (1, 1024)))
    dec = torch.from_numpy(rng.integers(2, cfg.vocab_size, (1, 512)))
    t0 = time.perf_counter()
    with torch.no_grad():
        want = cpu(enc, dec)
    cpu_s = time.perf_counter() - t0
    _build.reset_launches()
    errs = {}
    for dtype, model in card.items():
        with torch.no_grad():
            got = model(enc.cuda(), dec.cuda()).float()
        if not torch.isfinite(got).all():
            raise AssertionError(f"T5 forward (a) {dtype}: non-finite logits")
        errs[dtype] = rel_err_norm(got.cpu(), want)
    launches = dict(_build.LAUNCHES)
    with torch.no_grad():
        ms = {dtype: median_ms(lambda: model(enc.cuda(), dec.cuda()), runs=3, warmup=0)
              for dtype, model in card.items()}
    line = (f"T5 forward (a): T5-large width cut to 2+2 layers, B1 encoder 1024 decoder 512 vs "
            f"fp32 CPU plain: card fp32 rel_err_norm {errs[torch.float32]:.3e} (bound "
            f"{T5_FORWARD_BOUND}), card bf16 {errs[torch.bfloat16]:.3e} (reported); card "
            f"{ms[torch.float32]:.2f} ms fp32, {ms[torch.bfloat16]:.2f} ms bf16, CPU {cpu_s:.1f} s; "
            f"launches {launches}")
    if errs[torch.float32] > T5_FORWARD_BOUND or launches.get("pfa_flash_fwd_relbias", 0) != 2 * 4:
        raise AssertionError(line)
    print(line, flush=True)
    return launches


def _serve_t5(cfg, state, prompts, kv_dtype, smi: str, profile_dir: Optional[str] = None,
              window_check: bool = False):
    """Serve ``prompts`` on a fresh engine (warm-up first): (outputs, first
    logits by prompt, launches of the timed run, stats, wall, launches of
    the window check). With ``profile_dir``, the same requests are served
    once more under the profiler (``_profile_runs``); with
    ``window_check``, the graphed windows are held against eager ones and
    one window of each is profiled (``check_window_graphs``)."""
    from photonic_flash_attention_tpu_torch.core.serving import ServingEngine

    def make():
        return ServingEngine(cfg, state, device="cuda", num_pages=64, page_size=128,
                             max_batch=8, max_pages_per_seq=4, kv_dtype=kv_dtype,
                             decode_window=32, enc_max_len=T5_ENC_MAX_LEN)

    engine = make()
    engine.generate([p[:8] for p in prompts[:2]], max_new_tokens=2)  # warm-up
    torch.cuda.synchronize()
    engine.reset_performance_stats()
    first_logits = _capture_first_logits(engine)
    _build.reset_launches()
    t0 = time.perf_counter()
    outs = engine.generate(prompts, max_new_tokens=T5_NEW_TOKENS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    stats = engine.get_performance_stats()
    if profile_dir:
        tag = f"t5_serving_{str(cfg.dtype)[6:]}_{str(kv_dtype)[6:]}"
        _profile_runs(lambda: engine.generate(prompts, max_new_tokens=T5_NEW_TOKENS), 1,
                      Path(profile_dir), tag)
    window_launches = {}
    if window_check:
        label = f"T5-large {str(cfg.dtype)[6:]} compute, {str(kv_dtype)[6:]} pool"
        window_launches = check_window_graphs(label, engine, make, prompts, T5_NEW_TOKENS, smi,
                                              profile_tag="t5_large_window")
    del engine
    torch.cuda.empty_cache()
    return outs, first_logits, launches, stats, wall, window_launches


def _check_greedy_parity(model, prompt, served) -> float:
    """The JAX test's rule (tests/integration/test_t5_serving.py:51): along
    the SERVED trajectory each token's dense logit is within T5_PARITY_TOL
    of the dense best. Returns the largest gap."""
    from photonic_flash_attention_tpu_torch.models.t5_serving import DECODER_START_TOKEN_ID

    dec, worst = [DECODER_START_TOKEN_ID], 0.0
    for i, tok in enumerate(served):
        lg = _t5_dense_logits(model, prompt, dec)
        gap = float(lg.max() - lg[tok])
        worst = max(worst, gap)
        if gap > T5_PARITY_TOL:
            raise AssertionError(f"T5 greedy parity: encoder prompt of {len(prompt)} tokens, step "
                                 f"{i}: served {tok} is {gap:.4f} below the dense best "
                                 f"(tolerance {T5_PARITY_TOL})")
        dec.append(tok)
    return worst


def _t5_prompts(model32, vocab: int):
    """One encoder prompt per length of T5_PROMPT_LENS from a seeded
    generator, redrawn while the dense fp32 model's top-2 first-step logits
    lie within T5_TIE_MARGIN: (prompts, their dense fp32 first-step logits,
    the number redrawn)."""
    from photonic_flash_attention_tpu_torch.models.t5_serving import DECODER_START_TOKEN_ID

    rng = np.random.default_rng(2)
    prompts, dense, redrawn = [], [], 0
    for n in T5_PROMPT_LENS:
        for _ in range(32):
            prompt = rng.integers(2, vocab, n).tolist()
            logits = _t5_dense_logits(model32, prompt, [DECODER_START_TOKEN_ID])
            top = logits.topk(2).values
            if float(top[0] - top[1]) >= T5_TIE_MARGIN:
                break
            redrawn += 1
        else:
            raise AssertionError(f"T5 path: no prompt of {n} tokens without a first-step tie")
        prompts.append(prompt)
        dense.append(logits)
    return prompts, dense, redrawn


def phase_t5(smi: str, profile_dir: Optional[str] = None) -> dict:
    """T5-large (``T5Config.large()``: d_model 1024, 24+24 layers, 16 heads,
    d_kv 64, d_ff 4096, vocabulary 32128), random weights from a seeded
    generator on the card. (a) The cut forward against the CPU. (b)
    ``ServingEngine`` at full depth, 8 requests, encoder prompts
    T5_PROMPT_LENS, T5_NEW_TOKENS new tokens, page 128, once with a bf16
    and once with an int8 KV pool, the model computing in fp32: every
    request's first token must equal the dense fp32 model's argmax on the
    card (prompts whose dense top-2 logits tie within T5_TIE_MARGIN are
    redrawn), and two trajectories of the bf16-pool run must pass the JAX
    test's greedy-parity rule at its own tolerance, 0.05. Why fp32: with
    random weights the full-depth model is chaotic in bf16 (unscaled d_kv-64
    scores make every softmax near-argmax, and 48 layers amplify rounding),
    so two bf16 computations of the same logits disagree at first order;
    the phase prints the dense bf16 model's first-step logits against the
    fp32 ones to show it, and a third run, bf16 compute over a bf16 pool
    (the throughput configuration), is timed and reported without the
    token checks. (c) The full-depth bf16 forward at B2, encoder 2048,
    decoder 512, timed. With ``profile_dir`` the bf16 serving run is
    profiled once more. Returns the launches of the main paths."""
    from photonic_flash_attention_tpu_torch.models.t5 import T5Config
    from photonic_flash_attention_tpu_torch.models.t5_serving import DECODER_START_TOKEN_ID

    cfg = T5Config.large()
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    launches = collections.Counter(check_t5_forward(cfg))
    t0 = time.perf_counter()
    model32 = _t5_model(cfg32, "cuda")
    torch.cuda.synchronize()
    print(f"T5 path: T5-large init on the card {time.perf_counter() - t0:.1f} s "
          f"({sum(p.numel() for p in model32.parameters()) / 1e6:.1f} M params)", flush=True)
    state = model32.state_dict()
    model16 = _t5_model(cfg, "cuda")
    model16.load_state_dict(state)
    prompts, dense32, redrawn = _t5_prompts(model32, cfg.vocab_size)
    start = [DECODER_START_TOKEN_ID]
    dense16 = [_t5_dense_logits(model16, p, start) for p in prompts]
    firsts = [int(d.argmax()) for d in dense32]
    gaps = [float(d.topk(2).values[0] - d.topk(2).values[1]) for d in dense32]
    print(f"T5 path: dense first-step logits, bf16 model vs fp32 model: rel_err_norm "
          f"{[f'{rel_err_norm(a, b):.3e}' for a, b in zip(dense16, dense32)]}, argmax equal "
          f"{sum(int(a.argmax()) == f for a, f in zip(dense16, firsts))}/{len(prompts)}; fp32 "
          f"argmax {firsts}, top-2 gaps {[round(g, 4) for g in gaps]} ({redrawn} prompts "
          f"redrawn for a top-2 gap below {T5_TIE_MARGIN})", flush=True)
    decode_steps = T5_NEW_TOKENS - 1
    need = cfg.num_decoder_layers * (len(prompts) + decode_steps)
    for run_cfg, kv_dtype in ((cfg32, torch.bfloat16), (cfg32, torch.int8), (cfg, torch.bfloat16)):
        checked = run_cfg.dtype == torch.float32
        outs, first_logits, runs, stats, wall, window_runs = _serve_t5(
            run_cfg, state, prompts, kv_dtype, smi, None if checked else profile_dir,
            window_check=not checked)
        label = f"{str(run_cfg.dtype)[6:]} compute, {str(kv_dtype)[6:]} pool"
        for p, o in zip(prompts, outs):
            if len(o) != T5_NEW_TOKENS or not all(0 <= t < cfg.vocab_size for t in o):
                raise AssertionError(f"T5 serving {label}: prompt of {len(p)} tokens: bad output {o}")
        dense = dense32 if checked else dense16
        errs = [rel_err_norm(first_logits[tuple(p)], d) for p, d in zip(prompts, dense)]
        served = [o[0] for o in outs]
        line = (f"T5 serving (b) {label}: {len(prompts)} requests (encoder "
                f"{list(T5_PROMPT_LENS)}) x {T5_NEW_TOKENS} tokens in {wall:.2f} s; decode "
                f"{stats['decode_tokens']} tokens at {stats['decode_tokens_per_s']:.1f} tokens/s, "
                f"prefill {stats['prefill_tokens']} encoder tokens at "
                f"{stats['prefill_tokens_per_s']:.1f} tokens/s ({smi}); launches {runs}; first "
                f"tokens {served}, equal to the dense {str(run_cfg.dtype)[6:]} argmax: "
                f"{served == [int(d.argmax()) for d in dense]}; first-step logits vs the dense "
                f"model's rel_err_norm max {max(errs):.3e}")
        if checked and served != firsts:
            raise AssertionError(f"{line}: the dense fp32 model picks {firsts}")
        for counter in ("pfa_paged_decode_fused_tbias",):
            if runs.get(counter, 0) != need:
                raise AssertionError(f"{line}: {counter} launched {runs.get(counter, 0)} times, "
                                     f"expected {need}")
        print(line, flush=True)
        launches.update(runs)
        launches.update(window_runs)
        if checked and kv_dtype == torch.bfloat16:
            for p, o in list(zip(prompts, outs))[:2]:
                worst = _check_greedy_parity(model32, p, o)
                print(f"T5 greedy parity ({label}, encoder {len(p)} tokens): {len(o)} steps, "
                      f"largest gap to the dense fp32 best {worst:.4f} (tolerance "
                      f"{T5_PARITY_TOL}); tokens {o}", flush=True)
    del model32, state
    torch.cuda.empty_cache()
    launches.update(time_t5_forward(cfg, model16, smi))
    del model16
    torch.cuda.empty_cache()
    return launches


def time_t5_forward(cfg, model, smi: str) -> dict:
    """(c) The full-depth forward at B2, encoder 2048, decoder 512: every
    self-attention on K1's relative-bias mode (24 bidirectional at 2048, 24
    causal at 512), the cross-attention on plain K1; CUDA-event median."""
    rng = np.random.default_rng(3)
    enc = torch.from_numpy(rng.integers(2, cfg.vocab_size, (2, 2048))).cuda()
    dec = torch.from_numpy(rng.integers(2, cfg.vocab_size, (2, 512))).cuda()
    with torch.no_grad():
        model(enc, dec)  # warm-up
        torch.cuda.synchronize()
        _build.reset_launches()
        logits = model(enc, dec)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        ms = median_ms(lambda: model(enc, dec), runs=5, warmup=0)
    layers = cfg.num_layers + cfg.num_decoder_layers
    line = (f"T5 forward (c): T5-large full depth, B2 encoder 2048 decoder 512, bf16: {ms:.2f} ms "
            f"(median of 5, {2 * (2048 + 512) / ms * 1e3:.0f} tokens/s, {smi}); launches {launches}")
    if (logits.shape != (2, 512, cfg.vocab_size) or not torch.isfinite(logits.float()).all()
            or launches.get("pfa_flash_fwd_relbias", 0) != layers
            or launches.get("pfa_flash_fwd", 0) != cfg.num_decoder_layers):
        raise AssertionError(line)
    print(line, flush=True)
    return launches


T5_TRAIN_BATCH, T5_TRAIN_ENC, T5_TRAIN_DEC, T5_TRAIN_STEPS = 2, 1024, 512, 3


def seq2seq_loss(model, batch) -> torch.Tensor:
    """The T5 training loss: token cross entropy of the decoder's logits
    against ``labels``, in fp32 (``Trainer``'s ``loss_fn``, as JAX's
    ``make_train_step`` takes one)."""
    logits = model(batch["input_ids"].long(), batch["decoder_input_ids"].long())
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, batch["labels"].long()[..., None]).mean()


def _t5_batch(vocab: int, b: int, s_enc: int, s_dec: int, seed: int) -> dict:
    """Random encoder tokens and decoder labels; the decoder input is the
    labels shifted right behind the start token."""
    from photonic_flash_attention_tpu_torch.models.t5_serving import DECODER_START_TOKEN_ID

    rng = np.random.default_rng(seed)
    labels = rng.integers(2, vocab, (b, s_dec))
    dec = np.concatenate([np.full((b, 1), DECODER_START_TOKEN_ID), labels[:, :-1]], axis=1)
    return {"input_ids": rng.integers(2, vocab, (b, s_enc)), "decoder_input_ids": dec,
            "labels": labels}


def check_t5_train_grads(cfg) -> None:
    """The gradient of seq2seq_loss for T5-large's width cut to 2+2 layers,
    B1, encoder 1024, decoder 512 (both stacks' self-attention on K1's
    relative-bias mode with lse and the blockwise backward): fp32 on the
    card against fp32 on the CPU (plain versions), every parameter within
    T5_FORWARD_BOUND, both rel_embedding tables included."""
    from photonic_flash_attention_tpu_torch.models.t5 import T5ForConditionalGeneration

    cut = dataclasses.replace(cfg, num_layers=2, num_decoder_layers=2, dtype=torch.float32)
    with torch.device("cuda"):
        card = T5ForConditionalGeneration(cut, generator=torch.Generator(device="cuda").manual_seed(4))
    cpu = T5ForConditionalGeneration(cut)
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    batch = {k: torch.from_numpy(v) for k, v in _t5_batch(cfg.vocab_size, 1, 1024, 512, 5).items()}
    grads = {}
    for device, model in (("cuda", card), ("cpu", cpu)):
        before = _build.LAUNCHES["pfa_flash_fwd_relbias_lse"]
        t0 = time.perf_counter()
        seq2seq_loss(model, {k: v.to(device) for k, v in batch.items()}).backward()
        grads[device] = {n: p.grad.cpu() for n, p in model.named_parameters()}
        if device == "cuda" and _build.LAUNCHES["pfa_flash_fwd_relbias_lse"] - before != 4:
            raise AssertionError("T5 gradient check: K1's relative-bias mode with lse not launched "
                                 "per self-attention")
        if device == "cpu":
            cpu_s = time.perf_counter() - t0
    errs = {n: rel_err_norm(grads["cuda"][n], g) for n, g in grads["cpu"].items()}
    worst = max(errs, key=errs.get)
    tables = {n: f"{e:.3e}" for n, e in errs.items() if n.endswith("rel_embedding")}
    line = (f"T5 training path: gradient of T5-large width cut to 2+2 layers, B1 encoder 1024 decoder "
            f"512, card fp32 vs CPU fp32 plain ({cpu_s:.1f} s): {len(errs)} parameters, largest "
            f"rel_err_norm {errs[worst]:.3e} ({worst}), rel_embedding {tables} (bound "
            f"{T5_FORWARD_BOUND})")
    if errs[worst] > T5_FORWARD_BOUND or not all(torch.isfinite(g).all() for g in grads["cuda"].values()):
        raise AssertionError(line)
    print(line, flush=True)


def phase_t5_training(smi: str) -> dict:
    """T5-large at full width and depth (24+24 layers), bf16 compute over
    fp32 parameters, B2, encoder 1024, decoder 512: T5_TRAIN_STEPS AdamW
    steps on one fixed batch through ``Trainer(loss_fn=seq2seq_loss)``
    after a warm-up. Every self-attention runs K1's relative-bias mode with
    lse forward and the plain blockwise backward (JAX's is XLA too), the
    cross-attention K1, K4 and K5: each must launch once per layer and
    step, and the loss must fall. Prints the step time, peak memory and the
    plain relative-bias backward's share of a step; then the cut model's
    gradient against the CPU."""
    from photonic_flash_attention_tpu_torch.models.t5 import T5Config, T5ForConditionalGeneration
    from photonic_flash_attention_tpu_torch.training import Trainer

    cfg = T5Config.large()
    t0 = time.perf_counter()
    with torch.device("cuda"):
        model = T5ForConditionalGeneration(cfg, generator=torch.Generator(device="cuda").manual_seed(0))
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)
    trainer = Trainer(model, opt, loss_fn=seq2seq_loss)
    state = trainer.init_state()
    batch = _t5_batch(cfg.vocab_size, T5_TRAIN_BATCH, T5_TRAIN_ENC, T5_TRAIN_DEC, 6)
    state, _ = trainer.train_step(state, batch)  # warm-up
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    losses, step_ms = [], []
    for _ in range(T5_TRAIN_STEPS):
        t0 = time.perf_counter()
        state, metrics = trainer.train_step(state, batch)
        losses.append(float(metrics["loss"]))  # synchronizes
        step_ms.append(1e3 * (time.perf_counter() - t0))
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    layers = cfg.num_layers + cfg.num_decoder_layers
    need = {"pfa_flash_fwd_relbias_lse": layers * T5_TRAIN_STEPS,
            "pfa_flash_fwd": cfg.num_decoder_layers * T5_TRAIN_STEPS,
            "pfa_flash_bwd_dkv": cfg.num_decoder_layers * T5_TRAIN_STEPS,
            "pfa_flash_bwd_dq": cfg.num_decoder_layers * T5_TRAIN_STEPS}
    # The plain relative-bias backward at the step's shapes, 24 layers each.
    gen = torch.Generator(device="cuda").manual_seed(16)
    share_ms = 0.0
    for s_len, causal in ((T5_TRAIN_ENC, False), (T5_TRAIN_DEC, True)):
        q, k, v, do = (torch.randn(T5_TRAIN_BATCH, s_len, cfg.num_heads, cfg.d_kv, device="cuda",
                                   generator=gen).to(cfg.dtype) for _ in range(4))
        vec = torch.randn(cfg.num_heads, 2 * s_len - 1, device="cuda", generator=gen)
        o, lse = flash_ops._flash_fwd_bias_cuda(q, k, v, causal, 1.0, "pfa_flash_fwd_relbias",
                                                vec=vec, save_lse=True)
        share_ms += 24 * median_ms(lambda: flash_ops.flash_attention_bwd_masked_plain(
            q, k, v, o, lse, do, sm_scale=1.0, causal=causal, rel_vec=vec), runs=5)
    median = statistics.median(step_ms)
    tokens = T5_TRAIN_BATCH * (T5_TRAIN_ENC + T5_TRAIN_DEC)
    line = (f"T5 training path: T5-large full depth, bf16 compute, B{T5_TRAIN_BATCH} encoder "
            f"{T5_TRAIN_ENC} decoder {T5_TRAIN_DEC}, {T5_TRAIN_STEPS} AdamW steps (init and warm-up "
            f"{init_s:.1f} s): step ms {[round(t, 3) for t in step_ms]} (median {median:.3f}, "
            f"{tokens / median * 1e3:.1f} tokens/s), peak memory {peak:.2f} GiB ({smi}); plain "
            f"relative-bias backward ~{share_ms:.3f} ms a step ({100 * share_ms / median:.1f}% of "
            f"it); losses {[round(x, 4) for x in losses]}; launches {launches}")
    bad = {n: launches.get(n, 0) for n, want in need.items() if launches.get(n, 0) != want}
    if bad or launches.get("pfa_flash_fwd_relbias", 0) or not all(np.isfinite(losses)) \
            or not losses[-1] < losses[0]:
        raise AssertionError(f"{line}: expected launches {need}, got {bad}")
    print(line, flush=True)
    del trainer, state, model, opt
    torch.cuda.empty_cache()
    check_t5_train_grads(cfg)
    return launches


#: K7's shapes: (what, shape, dtype). The softmax over attention scores at
#: the headline shape, and over GPT-2's vocabulary row (a ragged D).
SOFTMAX_CASES = (("attention scores B4 H12 S2048", (4, 12, 2048, 2048), torch.bfloat16),
                 ("GPT-2 vocabulary row B8 S1024", (8, 1024, 50257), torch.float32))
#: K8's shapes: (what, shape, dtype, rms). GPT-2 medium's LayerNorm and
#: Llama-2-7B's RMSNorm (hidden 4096).
NORM_CASES = (("GPT-2 medium LayerNorm", (8, 1024, 1024), torch.bfloat16, False),
              ("Llama-2-7B RMSNorm", (8, 2048, 4096), torch.bfloat16, True))
#: Small and ragged rows (16-byte and one-element paths of both kernels).
RAGGED_ROWS = ((1, 1), (1000, 200), (1000, 1001), (3, 50257))
#: Per-element operations counted for the bounds (fp32): softmax max,
#: subtract, exp, add, divide; LayerNorm add, subtract, multiply-add,
#: subtract, multiply x3, add; RMSNorm multiply-add, multiply x3.
ROW_OPS = {"pfa_softmax": 5.0, "pfa_layer_norm": 8.0, "pfa_rms_norm": 4.0}
#: B14 on K3: (what, B, Hq, Hkv, D, pool dtype, lengths, rank-5 layer or None).
PAGED_ATTENTION_CASES = (
    ("(a) GPT-2 medium", 8, 16, 16, 64, torch.int8, (0, 1, 17, 128, 129, 700, 1000, 2000), 7),
    ("(b) Llama-2-7B decode", 8, 32, 32, 128, torch.bfloat16,
     (1, 100, 512, 1000, 2048, 3000, 4000, 4096), None),
)


def _row_case_entry(x, name: str, ms: float, whole: float, plain: float, lib,
                    err: float) -> dict:
    """One timed row-kernel shape: times, the bound (x read once, written
    once; gamma and beta are under 0.01 %), the library call."""
    bnd = card_bound(ROW_OPS[name] * x.numel(), 2 * x.numel() * x.element_size(), torch.float32)
    return {"shape": list(x.shape), "dtype": str(x.dtype)[6:], "ms": ms, "whole_call_ms": whole,
            "plain_ms": plain, "library_ms": lib, "max_abs_err": err, **bnd}


def _row_times(kernel, public, plain, library) -> tuple:
    """(kernel, whole call, plain, library) ms of a row kernel: the kernel
    launched alone (``_build.launch`` on preallocated tensors) and the
    library call each by ``graph_ms`` (device time, replayed from a CUDA
    graph); the plain version by ``device_ms``; the public call as one
    call, its wrapper's host time included (``median_ms``)."""
    return (graph_ms(kernel), median_ms(public), device_ms(plain, runs=5),
            None if library is None else graph_ms(library))


def _record_rows(results: dict, name: str, case: dict) -> None:
    """The first timed shape is the kernel's row; every shape is listed."""
    r = results[name]
    if "ms" not in r:
        r.update({k: case[k] for k in ("ms", "whole_call_ms", "plain_ms", "library_ms",
                                        "bound_ms", "bound_by") if k in case})
    r["max_abs_err"] = max(r.get("max_abs_err", 0.0), case["max_abs_err"])
    r.setdefault("cases", []).append(case)


def check_softmax(results: dict) -> None:
    """K7 against its plain version (rel_err_norm 1e-5 fp32, 1e-2 bf16;
    rows must sum to 1), timed at SOFTMAX_CASES against torch.softmax."""
    from photonic_flash_attention_tpu_torch.ops import nonlinearity as nl_ops

    gen = torch.Generator(device="cuda").manual_seed(20)
    cases = [(f"ragged rows {r}x{d}", (r, d), dt, False) for r, d in RAGGED_ROWS
             for dt in (torch.float32, torch.bfloat16)]
    cases += [(what, shape, dt, True) for what, shape, dt in SOFTMAX_CASES]
    for what, shape, dtype, timed in cases:
        x = (torch.randn(shape, device="cuda", generator=gen) * 3).to(dtype)
        out = nl_ops.fused_softmax(x)
        ref = nl_ops.softmax_rows_plain(x.view(-1, shape[-1])).view(shape)
        torch.cuda.synchronize()
        bound = 1e-5 if dtype == torch.float32 else 1e-2
        err = rel_err_norm(out, ref)
        sums = out.float().sum(-1)
        line = (f"K7 softmax {what} {list(shape)} {str(dtype)[6:]}: rel_err_norm {err:.3e} "
                f"(bound {bound}), max |row sum - 1| {float((sums - 1).abs().max()):.3e}")
        if err > bound or not torch.isfinite(out).all() or float((sums - 1).abs().max()) > 2e-2:
            raise AssertionError(line)
        if timed:
            x2, y = x.view(-1, shape[-1]), torch.empty_like(out)
            kernel = lambda: _build.launch(  # noqa: E731
                "pfa_softmax", x.device, x2.data_ptr(), y.data_ptr(), x2.shape[0], shape[-1],
                _build.DTYPE_CODES[dtype], count_as="pfa_softmax")
            ms, whole, plain, lib = _row_times(
                kernel, lambda: nl_ops.fused_softmax(x),
                lambda: nl_ops.softmax_rows_plain(x2), lambda: torch.softmax(x, dim=-1))
            case = _row_case_entry(x, "pfa_softmax", ms, whole, plain, lib, max_abs_err(out, ref))
            _record_rows(results, "pfa_softmax", case)
            line += (f" | kernel {ms:.4f} ms (whole call {whole:.4f}), plain {plain:.4f} ms, "
                     f"torch.softmax {lib:.4f} ms, bound {case['bound_ms']:.4f} ms "
                     f"({case['bound_by']})")
        print(line, flush=True)
        del x, out, ref


def check_norms(results: dict) -> None:
    """K8 in both modes against its plain version (rel_err_norm 1e-5 fp32,
    1e-2 bf16) on inputs of mean 1, timed at NORM_CASES against
    F.layer_norm / F.rms_norm; then the LayerNorm backward at the GPT-2
    medium shape on the card against the CPU (5e-2, bf16)."""
    import torch.nn.functional as F

    from photonic_flash_attention_tpu_torch.ops import nonlinearity as nl_ops

    gen = torch.Generator(device="cuda").manual_seed(21)
    cases = [(f"ragged rows {r}x{d}", (r, d), dt, rms, False) for r, d in RAGGED_ROWS[:3]
             for dt in (torch.float32, torch.bfloat16) for rms in (False, True)]
    cases += [(what, shape, dt, rms, True) for what, shape, dt, rms in NORM_CASES]
    for what, shape, dtype, rms, timed in cases:
        d = shape[-1]
        x = (torch.randn(shape, device="cuda", generator=gen) * 2 + 1).to(dtype)
        g = (torch.randn(d, device="cuda", generator=gen) * 0.1 + 1).to(dtype)
        b = None if rms else (torch.randn(d, device="cuda", generator=gen) * 0.1).to(dtype)
        name = "pfa_rms_norm" if rms else "pfa_layer_norm"
        call = ((lambda: nl_ops.fused_rms_norm(x, g)) if rms
                else (lambda: nl_ops.fused_layer_norm(x, g, b)))
        out = call()
        eps = 1e-6 if rms else 1e-5
        ref = nl_ops.rownorm_plain(x.view(-1, d), g, b, eps, rms).view(shape)
        torch.cuda.synchronize()
        bound = 1e-5 if dtype == torch.float32 else 1e-2
        err = rel_err_norm(out, ref)
        line = (f"K8 {'RMSNorm' if rms else 'LayerNorm'} {what} {list(shape)} {str(dtype)[6:]}: "
                f"rel_err_norm {err:.3e} (bound {bound})")
        if err > bound or not torch.isfinite(out).all():
            raise AssertionError(line)
        if timed:
            x2, y = x.view(-1, d), torch.empty_like(out)
            g32, b32 = g.float(), None if rms else b.float()
            kernel = lambda: _build.launch(  # noqa: E731
                "pfa_rownorm", x.device, x2.data_ptr(), g32.data_ptr(),
                None if rms else b32.data_ptr(), y.data_ptr(), x2.shape[0], d, 1.0 / d, eps,
                int(rms), _build.DTYPE_CODES[dtype], count_as=name)
            if rms:
                lib = ((lambda: F.rms_norm(x, (d,), g, eps)) if hasattr(F, "rms_norm") else None)
            else:
                lib = lambda: F.layer_norm(x, (d,), g, b, eps)  # noqa: E731
            ms, whole, plain, lib_ms = _row_times(
                kernel, call, lambda: nl_ops.rownorm_plain(x2, g, b, eps, rms), lib)
            case = _row_case_entry(x, name, ms, whole, plain, lib_ms, max_abs_err(out, ref))
            _record_rows(results, name, case)
            lib_s = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
            line += (f" | kernel {ms:.4f} ms (whole call {whole:.4f}), plain {plain:.4f} ms, "
                     f"library {lib_s}, bound {case['bound_ms']:.4f} ms ({case['bound_by']})")
        print(line, flush=True)
        del x, out, ref

    # The backward (plain recompute, as JAX's XLA VJP) on the card against the CPU.
    shape = NORM_CASES[0][1]
    d = shape[-1]
    x, dy = ((torch.randn(shape, device="cuda", generator=gen) * 2 + 1).to(torch.bfloat16)
             for _ in range(2))
    g = (torch.randn(d, device="cuda", generator=gen) * 0.1 + 1).to(torch.bfloat16)
    b = (torch.randn(d, device="cuda", generator=gen) * 0.1).to(torch.bfloat16)
    grads = {}
    for dev in ("cuda", "cpu"):
        leaves = [t.detach().to(dev).requires_grad_() for t in (x, g, b)]
        nl_ops.fused_layer_norm(*leaves).backward(dy.to(dev))
        grads[dev] = [t.grad for t in leaves]
    errs = [rel_err_norm(a.cpu(), c) for a, c in zip(grads["cuda"], grads["cpu"])]
    line = (f"K8 LayerNorm backward {list(shape)} bf16, card against CPU: rel_err_norm dx "
            f"{errs[0]:.3e}, dgamma {errs[1]:.3e}, dbeta {errs[2]:.3e} (bound 5e-2)")
    if max(errs) > 5e-2:
        raise AssertionError(line)
    print(line, flush=True)


def _paged_attention_case(gen, b, hq, hkv, d, pool_dtype, lengths, layer):
    """Pools and inputs for one PAGED_ATTENTION_CASES row: rank 5 (24
    layers) when ``layer`` is given, else one layer's rank-4 pool; scattered
    pages; q in the pool's float type (fp32 over an int8 pool)."""
    page = 128
    pps = -(-max(lengths) // page)
    num_pages = b * pps + 1
    k, v, ks, vs = _serving_pools(pool_dtype, gen, L=24 if layer is not None else 1, hkv=hkv,
                                  num_pages=num_pages, page=page, d=d)
    if layer is None:
        k, v = k[0], v[0]
        ks, vs = (ks[0], vs[0]) if ks is not None else (None, None)
    perm = torch.randperm(num_pages - 1, device="cuda", generator=gen)[: b * pps] + 1
    tables = perm.view(b, pps).to(torch.int32)
    qdt = torch.float32 if pool_dtype == torch.int8 else pool_dtype
    q = torch.randn(b, hq, d, device="cuda", generator=gen).to(qdt)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, k, v, lens, tables, ks, vs


def check_paged_attention(results: dict) -> None:
    """The B14 entry (``paged_attention`` on K3's decode attend) against
    its plain version at PAGED_ATTENTION_CASES (rel_err_norm 1e-3, a row of
    length 0 gives 0); bytes from the valid tokens."""
    gen = torch.Generator(device="cuda").manual_seed(22)
    worst = 0.0
    for what, b, hq, hkv, d, pool_dtype, lengths, layer in PAGED_ATTENTION_CASES:
        q, k, v, lens, tables, ks, vs = _paged_attention_case(gen, b, hq, hkv, d, pool_dtype,
                                                              lengths, layer)
        call = lambda: paged_ops.paged_attention(q, k, v, lens, tables, ks, vs,  # noqa: E731
                                                 layer=layer)
        out = call()
        k5, v5, ks5, vs5, lyr = paged_ops._hf_layout(k, v, ks, vs, layer)
        plain = lambda: paged_ops.paged_decode_attend_plain(  # noqa: E731
            q.float(), k5, v5, lens, tables, lyr, ks5, vs5, d ** -0.5).to(q.dtype)
        ref = plain()
        torch.cuda.synchronize()
        err = rel_err_norm(out, ref)
        quant = pool_dtype == torch.int8
        line = (f"B14 paged_attention on K3 {what}: B{b} H{hq}/{hkv} D{d} page 128 pool "
                f"{str(pool_dtype)[6:]} {'rank 5' if layer is not None else 'rank 4'}, q "
                f"{str(q.dtype)[6:]}, lengths {list(lengths)}: rel_err_norm {err:.3e} (bound 1e-3)")
        empty = lens == 0
        if err > 1e-3 or not torch.isfinite(out).all() or (out[empty] != 0).any():
            raise AssertionError(line)
        worst = max(worst, max_abs_err(out, ref))
        ms = median_ms(call)
        plain_ms = median_ms(plain, runs=5)
        tokens = sum(lengths)
        nbytes = (2 * tokens * hkv * d * k.element_size() + 2 * 4 * tokens * hkv * quant
                  + 2 * b * hq * d * q.element_size() + 4 * b + 4 * tables.numel())
        bnd = card_bound(4.0 * d * hq * tokens, nbytes, torch.float32)
        line += (f" | kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms "
                 f"({bnd['bound_by']})")
        print(line, flush=True)
        case = {"case": what, "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                "max_abs_err": max_abs_err(out, ref), **bnd}
        _record_rows(results, "pfa_paged_attention", case)
    results["pfa_paged_attention"]["max_abs_err"] = worst


def _run_cli(argv: list) -> str:
    """``cli.main(argv)`` in process: its standard output, echoed; rc 0."""
    import contextlib
    import io

    from photonic_flash_attention_tpu_torch import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    text = buf.getvalue()
    for row in text.splitlines():
        print(f"cli {argv[0]}: {row}", flush=True)
    if rc != 0:
        raise AssertionError(f"cli {' '.join(argv)}: rc {rc}")
    print(f"cli {' '.join(argv)}: rc 0 in {time.perf_counter() - t0:.1f} s", flush=True)
    return text


def _cli_engines(argv: list, eager: bool) -> list:
    """``_run_cli(argv)`` keeping every ServingEngine the command builds,
    each with eager windows (``_eager_windows``) when ``eager``."""
    from photonic_flash_attention_tpu_torch.core.serving import ServingEngine

    made, init = [], ServingEngine.__init__

    def keep(self, *args, **kwargs):
        init(self, *args, **kwargs)
        made.append(_eager_windows(self) if eager else self)

    ServingEngine.__init__ = keep
    try:
        _run_cli(argv)
    finally:
        ServingEngine.__init__ = init
    return made


def phase_ops(smi: str) -> dict:
    """The ops surface and the CLI. After the comparisons (kernels against
    their plain versions, the library times), the main path: the public
    ops at the full-width shapes (fused_softmax, the norms, every kind of
    apply_nonlinearity, paged_attention on both cases, paged_attention_auto
    at the GPT-2 shape, the quantization round trip of GPT-2 medium's KV),
    then the four CLI commands in process (calibrate's gates must all pass).
    K7, K8 (both modes) and the B14 entry must launch in the ops path,
    exactly as often as it calls them; the CLI is a path of its own, its
    launch counts reset before it. Returns the kernels' results and the
    two paths' launches."""
    import tempfile

    from photonic_flash_attention_tpu_torch.config import reset_config
    from photonic_flash_attention_tpu_torch.core.engine import reset_engine
    from photonic_flash_attention_tpu_torch.ops import nonlinearity as nl_ops
    from photonic_flash_attention_tpu_torch.ops import quantization as q_ops

    results = {name: {} for name in OPS_KERNELS}
    check_softmax(results)
    check_norms(results)
    check_paged_attention(results)
    torch.cuda.empty_cache()

    gen = torch.Generator(device="cuda").manual_seed(23)
    _build.reset_launches()
    t0 = time.perf_counter()
    for _, shape, dtype in SOFTMAX_CASES:
        out = nl_ops.fused_softmax(torch.randn(shape, device="cuda", generator=gen).to(dtype))
        assert out.shape == shape and out.dtype == dtype
        del out
    for _, shape, dtype, rms in NORM_CASES:
        x = torch.randn(shape, device="cuda", generator=gen).to(dtype)
        gamma = torch.ones(shape[-1], device="cuda", dtype=dtype)
        out = nl_ops.fused_rms_norm(x, gamma) if rms else nl_ops.fused_layer_norm(x, gamma)
        assert out.shape == shape and bool(torch.isfinite(out).all())
    act = torch.randn(NORM_CASES[0][1], device="cuda", generator=gen).to(torch.bfloat16)
    for kind in nl_ops.NonlinearityType:
        out = nl_ops.apply_nonlinearity(kind, act)
        assert out.shape == act.shape and bool(torch.isfinite(out).all()), kind
    before_auto = 0
    for i, (_, b, hq, hkv, d, pool_dtype, lengths, layer) in enumerate(PAGED_ATTENTION_CASES):
        args = _paged_attention_case(gen, b, hq, hkv, d, pool_dtype, lengths, layer)
        out = paged_ops.paged_attention(*args, layer=layer)
        assert bool(torch.isfinite(out).all())
        if i == 0:  # paged_attention_auto at the GPT-2 shape must take the kernel
            before_auto = _build.LAUNCHES["pfa_paged_attention"]
            paged_ops.paged_attention_auto(*args, layer=layer)
            if _build.LAUNCHES["pfa_paged_attention"] <= before_auto:
                raise AssertionError("paged_attention_auto did not launch K3 at the GPT-2 shape")
    kv = torch.randn(2, 8, 1024, 16, 64, device="cuda", generator=gen)  # GPT-2 medium K/V
    for qdtype, gate in ((torch.int8, 0.05), (torch.float8_e4m3fn, 0.1)):
        kq, vq = q_ops.quantize_kv(kv[0], kv[1], qdtype)
        errs = [q_ops.quantization_error(t, qt) for t, qt in ((kv[0], kq), (kv[1], vq))]
        line = (f"ops: quantize_kv {list(kv.shape[1:])} {str(qdtype)[6:]}: mean_rel_err "
                f"{[round(e['mean_rel_err'], 5) for e in errs]} (gate {gate}), accuracy "
                f"{[round(e['accuracy'], 5) for e in errs]}")
        if max(e["mean_rel_err"] for e in errs) > gate or kq.dequantize().shape != kv[0].shape:
            raise AssertionError(line)
        print(line, flush=True)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"ops: main path in {time.perf_counter() - t0:.2f} s; launches {launches}", flush=True)
    need = {"pfa_softmax": len(SOFTMAX_CASES) + 1, "pfa_layer_norm": 2, "pfa_rms_norm": 2,
            "pfa_paged_attention": len(PAGED_ATTENTION_CASES) + 1}
    if launches != need:
        raise AssertionError(f"ops: launches {launches}, expected {need}")
    del act, kv, args, out
    torch.cuda.empty_cache()

    reset_config()
    reset_engine()
    _build.reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        report_path = str(Path(tmp) / "calibrate.json")
        _run_cli(["calibrate", "--patterns", "8", "--device", "cuda", "-o", report_path])
        report = json.loads(Path(report_path).read_text())
    gates = {mode: {k: v for k, v in m.items() if k.startswith("passes_")}
             for mode, m in report["modes"].items()}
    if not all(all(g.values()) for g in gates.values()):
        raise AssertionError(f"cli calibrate: a gate failed: {gates}")
    _run_cli(["benchmark", "--seq-lengths", "1024", "4096", "--batch-sizes", "1", "8", "--causal",
              "--device", "cuda"])
    serve_bench = ["serve-bench", "--model", "small", "--kv-dtype", "both", "--device", "cuda"]
    graphed = _cli_engines(serve_bench, eager=False)
    info = json.loads(_run_cli(["device-info", "--json", "--device", "cuda"]))
    print(f"cli device-info: backend {info['backend']}, {info['device_count']} device(s): "
          f"{[(d['device_kind'], d.get('bytes_limit')) for d in info['devices']]}", flush=True)
    reset_config()
    reset_engine()
    cli_launches = dict(_build.LAUNCHES)
    print(f"cli: launches {cli_launches} ({smi})", flush=True)
    # The decode rows again with eager windows: the same tokens.
    eager = _cli_engines(serve_bench, eager=True)

    def tokens(engines):
        return [[seq.tokens for seq in e._sequences.values()] for e in engines]

    graphs = [e.window_graph_stats()["graphs"] for e in graphed]
    if tokens(graphed) != tokens(eager) or not all(graphs):
        raise AssertionError(f"cli serve-bench: graphed windows ({graphs} step graphs an "
                             f"engine) and eager windows give different tokens")
    print(f"cli serve-bench: the second rows ran eager windows; the first rows' {graphs} step "
          f"graphs an engine gave their tokens ({smi})", flush=True)
    del graphed, eager
    torch.cuda.empty_cache()
    return results, {"ops": launches, "cli": cli_launches}


# -- shell path: the ops shell beside GPT-2 serving ----------------------------

#: ``examples/serve_gpt2.py``'s three prompts, plus one.
SHELL_PROMPTS = ([464, 3290, 318], [15496, 995], [1, 2, 3, 4], [50256, 11, 262, 1049, 286])
SHELL_NEW_TOKENS = 16
#: The workload balancer's tasks: causal bf16 attention at GPT-2 medium's
#: width.
SHELL_TASK = dict(b=8, s=1024, h=16, d=64)
SHELL_TASKS = 16
#: The headline workload (K1's row of the kernels phase).
SHELL_HEADLINE = dict(b=4, s=2048, h=12, d=64)
#: The QUANT_ACCURACY rung's call: cross attention, where JAX's heuristic
#: order gives an int8 kind under quant_mode "int8".
SHELL_CROSS = dict(b=4, sq=512, skv=2048, h=16, d=64)
SHELL_INT8_MODES = ("pfa_flash_fwd_int8qk", "pfa_flash_fwd_int8full")
#: ResearchBenchmark at GPT-2 medium's width (fp32, JAX's default).
SHELL_RESEARCH = dict(batch=2, seq=1024, embed=1024, heads=16)
#: Collective size of the topology simulator's rows, and the card counts.
SHELL_COLLECTIVE_BYTES = 16 * 2**20
SHELL_CARDS = (1, 2, 4, 8)
#: NCCL's world-1 times (ms) measured by the parallel phase of this run.
NCCL_WORLD1_MS: dict = {}


def _shell_qkv(gen, b, sq, h, d, skv=None):
    skv = sq if skv is None else skv
    return tuple(torch.randn(b, n, h, d, device="cuda", generator=gen).to(torch.bfloat16)
                 for n in (sq, skv, skv))


def _shell_balancer(runs: dict, smi: str) -> None:
    """(b) 16 attention tasks through one local node's engine executor,
    each output bit-equal to a direct engine call on the same inputs."""
    from photonic_flash_attention_tpu_torch.core.engine import get_engine
    from photonic_flash_attention_tpu_torch.scaling import (
        ComputeNode, DistributedTask, DistributedWorkloadBalancer, TaskState,
    )

    c = SHELL_TASK
    gen = torch.Generator(device="cuda").manual_seed(25)
    inputs = [_shell_qkv(gen, c["b"], c["s"], c["h"], c["d"]) for _ in range(SHELL_TASKS)]
    balancer = DistributedWorkloadBalancer()
    balancer.register_node(ComputeNode("gpu0"))  # the default local engine executor
    tasks = [DistributedTask(f"attn{i}", payload={"q": q, "k": k, "v": v, "causal": True},
                             seq_length=c["s"]) for i, (q, k, v) in enumerate(inputs)]
    for t in tasks:
        balancer.submit_task(t)
    t0 = time.perf_counter()
    _counted(runs, "balancer", ("pfa_flash_fwd",), lambda: balancer.run_until_drained(),
             path="shell path")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    engine = get_engine()
    kind = engine.last_kernel_used
    for t, (q, k, v) in zip(tasks, inputs):
        direct, _ = engine(q, k, v, causal=True)
        if t.state != TaskState.DONE or not torch.equal(t.result, direct):
            raise AssertionError(f"shell path: balancer task {t.task_id}: state {t.state}, "
                                 f"not bit-equal to the direct engine call")
    if runs["balancer"]["pfa_flash_fwd"] != SHELL_TASKS:
        raise AssertionError(f"shell path: balancer launches {dict(runs['balancer'])}, "
                             f"expected pfa_flash_fwd {SHELL_TASKS}")
    status = balancer.get_cluster_status()["nodes"]["gpu0"]
    print(f"shell path: workload balancer: {SHELL_TASKS} tasks B{c['b']} S{c['s']} H{c['h']} "
          f"D{c['d']} causal bf16 on the engine's {kind}, bit-equal to direct calls; "
          f"{wall * 1e3:.1f} ms drained, node EMA {status['ema_latency_ms']} ms a task; "
          f"launches {dict(runs['balancer'])} ({smi})", flush=True)


def _shell_serving(runs: dict, smi: str) -> None:
    """(a) GPT-2 medium served beside a live MetricsServer: tokens equal to
    the serving path's engine on the same prompts; /metrics and /health
    read once through urllib after generate."""
    import urllib.request

    from photonic_flash_attention_tpu_torch.core.serving import ServingEngine
    from photonic_flash_attention_tpu_torch.models.gpt2 import GPT2Config
    from photonic_flash_attention_tpu_torch.monitoring import (
        HealthStatus, MetricsServer, get_health_monitor,
    )
    from photonic_flash_attention_tpu_torch.utils.security import sanitize_state_dict

    cfg = GPT2Config.medium()
    model = gpt2_medium_on_card(cfg)
    t0 = time.perf_counter()
    sanitize_state_dict(model)  # (f): the model on the card passes
    print(f"shell path: sanitize_state_dict passed GPT-2 medium on the card "
          f"({len(model.state_dict())} tensors) in {(time.perf_counter() - t0) * 1e3:.1f} ms",
          flush=True)
    prompts = [[t % cfg.vocab_size for t in p] for p in SHELL_PROMPTS]
    # The serving path's engine on the same prompts (max_batch 8), and the
    # same at this path's max_batch 4: the reference tokens.
    refs = {}
    for max_batch in (8, 4):
        ref_engine = ServingEngine(cfg, model.state_dict(), device="cuda", num_pages=256,
                                   page_size=128, max_batch=max_batch, kv_dtype=torch.int8,
                                   decode_window=32)
        refs[max_batch] = ref_engine.generate(prompts, max_new_tokens=SHELL_NEW_TOKENS)
        del ref_engine
    engine = ServingEngine(cfg, model.state_dict(), device="cuda", kv_dtype=torch.int8,
                           max_batch=4)
    server = MetricsServer(port=0, host="127.0.0.1")
    port = server.start()
    try:
        t0 = time.perf_counter()
        outs = _counted(runs, "serving", ("pfa_flash_fwd", "pfa_paged_decode_fused"),
                        lambda: engine.generate(prompts, max_new_tokens=SHELL_NEW_TOKENS),
                        path="shell path")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        base = f"http://127.0.0.1:{port}"
        t0 = time.perf_counter()
        metrics = urllib.request.urlopen(f"{base}/metrics", timeout=30).read().decode()
        t_metrics = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        health = json.loads(urllib.request.urlopen(f"{base}/health", timeout=30).read())
        t_health = (time.perf_counter() - t0) * 1e3
    finally:
        server.stop()
    if outs != refs[4]:
        raise AssertionError(f"shell path: served tokens {outs} differ from the serving "
                             f"path's engine at max_batch 4 {refs[4]}")
    eager = _eager_windows(ServingEngine(cfg, model.state_dict(), device="cuda",
                                         kv_dtype=torch.int8, max_batch=4))
    if eager.generate(prompts, max_new_tokens=SHELL_NEW_TOKENS) != outs or \
            not engine.window_graph_stats()["graphs"]:
        raise AssertionError(f"shell path: the graphed windows ({_graphs_of(engine)}) do not "
                             f"give the eager windows' tokens")
    del eager
    parity = _shell_token_parity(model, prompts, outs, refs[8])
    got = runs["serving"]
    need = {"pfa_flash_fwd": cfg.n_layer * len(prompts),
            "pfa_paged_decode_fused": cfg.n_layer * (SHELL_NEW_TOKENS - 1)}
    if got["pfa_flash_fwd"] != need["pfa_flash_fwd"] or \
            got["pfa_paged_decode_fused"] < need["pfa_paged_decode_fused"]:
        raise AssertionError(f"shell path: serving launches {dict(got)}, expected {need}")
    series = ("pfa_engine_total_calls", "pfa_hbm_bytes_in_use", "pfa_hbm_utilization")
    missing = [s for s in series if f"\n{s} " not in f"\n{metrics}"]
    if missing:
        raise AssertionError(f"shell path: /metrics lacks {missing}")
    results = get_health_monitor().run_checks()
    dev, hbm = results["device_reachable"], results["hbm"]
    if dev.status != HealthStatus.HEALTHY or dev.value != 1.0 or hbm.value is None \
            or hbm.status == HealthStatus.UNKNOWN:
        raise AssertionError(f"shell path: health {results}")
    if health["checks"]["device_reachable"]["value"] != 1.0:
        raise AssertionError(f"shell path: /health {health}")
    print(f"shell path: GPT-2 medium int8 pool, max_batch 4, {len(prompts)} prompts x "
          f"{SHELL_NEW_TOKENS} tokens in {wall:.3f} s, tokens equal to the serving path's "
          f"engine at max_batch 4 and to its own eager windows'; at its max_batch 8 {parity}; "
          f"launches {dict(got)}; /metrics {len(metrics.splitlines())} lines in "
          f"{t_metrics:.2f} ms, /health {health['overall']} in {t_health:.2f} ms; health: "
          f"{dev.message} ({dev.status.value}), HBM {hbm.message} ({hbm.status.value}) ({smi})",
          flush=True)


def _shell_token_parity(model, prompts, served, ref) -> str:
    """Served tokens against an engine of other batch geometry: the first
    tokens must be equal; at each prompt's first divergence the dense
    forward's logit gap between the two tokens is reported."""
    if [o[0] for o in served] != [r[0] for r in ref]:
        raise AssertionError(f"shell path: first tokens {[o[0] for o in served]} differ from "
                             f"the serving path's engine {[r[0] for r in ref]}")
    same = sum(a == b for o, r in zip(served, ref) for a, b in zip(o, r))
    gaps = []
    for i, (p, o, r) in enumerate(zip(prompts, served, ref)):
        step = next((j for j, (a, b) in enumerate(zip(o, r)) if a != b), None)
        if step is None:
            continue
        ids = torch.tensor([p + o[:step]], device="cuda")
        with torch.no_grad():
            lg = model(ids)[0, -1].float()
        gaps.append(f"prompt {i} step {step}: {o[step]} vs {r[step]}, dense logit gap "
                    f"{float(lg[o[step]] - lg[r[step]]):+.4f} (top-2 gap "
                    f"{float(lg.topk(2).values[0] - lg.topk(2).values[1]):.4f})")
    total = sum(len(o) for o in served)
    return f"{same}/{total} tokens equal" + (f" ({'; '.join(gaps)})" if gaps else "")


def _shell_resilience(runs: dict, smi: str) -> None:
    """(c) the resilient wrapper around the engine on the card: bit-equal to
    the engine; an injected KernelLaunchError raises three times with no
    last resort and no KERNEL_FAILURE rung, and the next good call launches
    K1; QUANT_ACCURACY moves the engine's next call off K1's int8 modes."""
    from photonic_flash_attention_tpu_torch.config import get_config, set_global_config
    from photonic_flash_attention_tpu_torch.core.engine import get_engine
    from photonic_flash_attention_tpu_torch.resilience import (
        DegradationTrigger, GracefulDegradationManager, ResilientAttentionWrapper,
    )
    from photonic_flash_attention_tpu_torch.utils.exceptions import KernelLaunchError

    c = SHELL_TASK
    gen = torch.Generator(device="cuda").manual_seed(26)
    q, k, v = _shell_qkv(gen, c["b"], c["s"], c["h"], c["d"])
    engine = get_engine()
    wrapped = ResilientAttentionWrapper(lambda q, k, v, mask=None, **kw: engine(q, k, v, mask, **kw))
    out, _ = wrapped(q, k, v, causal=True)
    if not torch.equal(out, engine(q, k, v, causal=True)[0]):
        raise AssertionError("shell path: the wrapper's output is not the engine's")
    left = {"failures": 3}

    def injected(q, k, v, mask=None, **kw):
        if left["failures"]:
            left["failures"] -= 1
            raise KernelLaunchError("pfa_flash_fwd failed: injected launch failure")
        return engine(q, k, v, mask, **kw)

    flaky = ResilientAttentionWrapper(injected)
    threshold = get_config().flash_threshold
    for i in range(3):
        try:
            flaky(q, k, v, causal=True)
        except KernelLaunchError:
            continue
        raise AssertionError(f"shell path: injected failure {i + 1} did not raise")
    status = flaky.get_status()
    if status["last_resort_uses"] or get_config().flash_threshold != threshold or \
            status["degradation"]["level"] != "NORMAL":
        raise AssertionError(f"shell path: wrapper after 3 failures {status}")
    _counted(runs, "resilient", ("pfa_flash_fwd",), lambda: flaky(q, k, v, causal=True),
             path="shell path")
    print(f"shell path: resilient wrapper bit-equal to the engine; 3 injected "
          f"KernelLaunchErrors raised, last_resort_uses {status['last_resort_uses']}, breaker "
          f"{status['breaker_state']}, flash_threshold {get_config().flash_threshold}; the next "
          f"call launched {dict(runs['resilient'])}", flush=True)

    x = SHELL_CROSS
    qc, kc, vc = _shell_qkv(gen, x["b"], x["sq"], x["h"], x["d"], skv=x["skv"])
    set_global_config(quant_mode="int8")
    ladder = GracefulDegradationManager()
    steps = (("int8", None), ("raised", DegradationTrigger.QUANT_ACCURACY), ("recovered", None))
    for label, trigger in steps:
        if trigger is not None:
            ladder.degrade(trigger, "shell path check")
        elif label == "recovered":
            ladder.recover(DegradationTrigger.QUANT_ACCURACY)
        key = f"quant_{label}"
        _counted(runs, key, (), lambda: engine(qc, kc, vc), path="shell path")
        int8 = sum(runs[key][m] for m in SHELL_INT8_MODES)
        if (label == "raised") == bool(int8) or (label == "raised" and
                                                  runs[key]["pfa_flash_fwd"] != 1):
            raise AssertionError(f"shell path: QUANT_ACCURACY {label}: launches "
                                 f"{dict(runs[key])}, quant_mode {get_config().quant_mode}")
        print(f"shell path: QUANT_ACCURACY {label}: quant_mode {get_config().quant_mode}, "
              f"kind {engine.last_kernel_used}, launches {dict(runs[key])}", flush=True)
    set_global_config(quant_mode="bf16")


def _shell_optimizer(runs: dict, k1_ms: float, smi: str) -> None:
    """(d) AdaptiveOptimizer around K1 at the headline shape (profiled ms
    beside the CUDA-event median; a cached hit launches nothing), and the
    AdaptiveDecisionEngine fed each eligible kind's measured time."""
    from photonic_flash_attention_tpu_torch.core.engine import get_engine
    from photonic_flash_attention_tpu_torch.core.router import (
        AdaptiveRouter, WorkloadCharacteristics,
    )
    from photonic_flash_attention_tpu_torch.intelligence import AdaptiveDecisionEngine, Outcome
    from photonic_flash_attention_tpu_torch.optimization import AdaptiveOptimizer

    c = SHELL_HEADLINE
    gen = torch.Generator(device="cuda").manual_seed(27)
    q, k, v = _shell_qkv(gen, c["b"], c["s"], c["h"], c["d"])

    def k1(q, k, v):
        return flash_ops.flash_attention(q, k, v, causal=True)

    opt = AdaptiveOptimizer()
    calls = 20
    for _ in range(3):
        opt.optimize_operation(k1, q, k, v, operation="warmup")
    _counted(runs, "optimizer", ("pfa_flash_fwd",),
             lambda: [opt.optimize_operation(k1, q, k, v, operation="k1") for _ in range(calls)],
             path="shell path")
    profiled = opt.get_stats()["profiler"]["operations"]["k1"]
    events = median_ms(lambda: k1(q, k, v))
    first = opt.optimize_operation(k1, q, k, v, operation="k1_cached", cacheable=True)
    _build.reset_launches()
    hit = opt.optimize_operation(k1, q, k, v, operation="k1_cached", cacheable=True)
    launched = sum(_build.LAUNCHES.values())
    if hit is not first or launched or opt.get_stats()["cache"]["hits"] != 1:
        raise AssertionError(f"shell path: the cached hit launched {dict(_build.LAUNCHES)}")
    print(f"shell path: AdaptiveOptimizer K1 B{c['b']} S{c['s']} H{c['h']} D{c['d']} causal "
          f"bf16: profiled {profiled['mean_ms']:.4f} ms mean over {profiled['count']} calls "
          f"(max {profiled['max_ms']:.4f}), CUDA-event median {events:.4f} ms, the kernels "
          f"phase's {k1_ms:.4f} ms; a cacheable hit launched nothing ({smi})", flush=True)

    engine = get_engine()
    w = WorkloadCharacteristics(batch_size=c["b"], q_len=c["s"], kv_len=c["s"],
                                num_heads=c["h"], head_dim=c["d"], causal=True,
                                dtype="bfloat16", num_kv_heads=c["h"])
    available = engine._available_kernels(w)
    eligible = engine.router.eligible_kernels(w, available)
    measured = {kind: device_ms(lambda kind=kind: engine._run(kind, q, k, v, None, None, None,
                                                              True, False))
                for kind in eligible}
    decider = AdaptiveDecisionEngine(actions=[kind.value for kind in eligible],
                                     exploration_rate=0.0)
    router = AdaptiveRouter(exploration_rate=0.0)
    for kind, ms in measured.items():
        router.record_measurement(kind, w, ms)
        for _ in range(3):
            decider.record_outcome(w, Outcome(kind.value, ms, c["b"] * c["s"]))
    choice = decider.make_decision(w)
    if choice["action"] not in [kind.value for kind in eligible]:
        raise AssertionError(f"shell path: AdaptiveDecisionEngine chose {choice}")
    print(f"shell path: AdaptiveDecisionEngine on the measured kinds "
          f"{ {kind.value: round(ms, 4) for kind, ms in measured.items()} } ms: "
          f"{choice['action']} ({choice['source']}); the router: measured "
          f"{router.select_kernel(w, available).value}, heuristic "
          f"{router.heuristic_selection(w, eligible).value} ({smi})", flush=True)


def _shell_simulators(k1_ms: float, smi: str) -> None:
    """(e) the pipeline simulator's best tile on the card's record beside
    K1's measured time; the topology simulator's collective costs beside
    NCCL's world-1 times from the parallel phase."""
    from photonic_flash_attention_tpu_torch.hardware import (
        KernelPipelineSimulator, TopologySimulator, detect_tpu_hardware,
    )

    caps = detect_tpu_hardware()[0].capabilities
    c = SHELL_HEADLINE
    best = KernelPipelineSimulator(caps).best(c["b"], c["s"], c["s"], c["h"], c["d"], causal=True)
    print(f"shell path: KernelPipelineSimulator on the {caps.generation} record, B{c['b']} "
          f"S{c['s']} H{c['h']} D{c['d']} causal: best tile {best.block_q}x{best.block_kv} "
          f"(feasible {best.feasible}, {best.vmem_bytes} B against a budget of "
          f"{caps.vmem_mb * 1e6 * 0.5:.0f}), {best.t_total_us:.2f} us, bound by {best.bound}; "
          f"K1 measured {k1_ms:.4f} ms: measured / predicted "
          f"{k1_ms * 1e3 / best.t_total_us:.3f} ({smi})", flush=True)
    rows = []
    for n in SHELL_CARDS:
        topo = TopologySimulator((n,), caps)
        costs = {op: topo.collective_cost(op, SHELL_COLLECTIVE_BYTES)
                 for op in ("psum", "all_gather", "all_to_all", "ppermute")}
        rows.append(f"{n} card(s) ({topo.topology}, diameter {topo.max_hops()}): " + ", ".join(
            f"{op} {cost.t_us:.2f} us ({cost.bytes_moved:.0f} B)" for op, cost in costs.items()))
    measured = ", ".join(f"{k} {v:.4f} ms" for k, v in NCCL_WORLD1_MS.items())
    print(f"shell path: TopologySimulator at {SHELL_COLLECTIVE_BYTES / 2**20:.0f} MiB a rank: "
          + "; ".join(rows) + f"; NCCL measured at world 1 this run: {measured} ({smi})",
          flush=True)


def _shell_research_security(smi: str) -> None:
    """(f) ResearchBenchmark at GPT-2 medium's width on the card; the
    sanitizer refuses a CUDA tensor holding a NaN."""
    from photonic_flash_attention_tpu_torch.research import ResearchBenchmark
    from photonic_flash_attention_tpu_torch.utils.exceptions import SecurityError
    from photonic_flash_attention_tpu_torch.utils.security import InputSanitizer

    bench = ResearchBenchmark(**SHELL_RESEARCH)
    results = bench.run(iters=3)
    bad = [r.name for r in results if not r.finite]
    if bad or len(results) != 3:
        raise AssertionError(f"shell path: research outputs not finite: {bad}")
    print(f"shell path: ResearchBenchmark B{SHELL_RESEARCH['batch']} S{SHELL_RESEARCH['seq']} "
          f"E{SHELL_RESEARCH['embed']} H{SHELL_RESEARCH['heads']} fp32: "
          + ", ".join(f"{r.name} {r.latency_ms:.3f} ms (stability {r.stability:.6f})"
                      for r in results) + f" ({smi})", flush=True)
    x = torch.randn(4, 1024, 16, 64, device="cuda").to(torch.bfloat16)
    sanitizer = InputSanitizer()
    sanitizer.sanitize_tensor(x, "q")
    x[1, 7, 3, 5] = float("nan")
    try:
        sanitizer.sanitize_tensor(x, "q")
    except SecurityError as e:
        print(f"shell path: InputSanitizer refused the CUDA tensor with a NaN: {e}", flush=True)
    else:
        raise AssertionError("shell path: InputSanitizer passed a CUDA tensor holding a NaN")


def phase_shell(smi: str, k1_ms: float) -> dict:
    """The ops shell at full width (no kernel of its own): (b) the workload
    balancer's tasks on the engine, (a) GPT-2 medium served beside a live
    MetricsServer, (c) the resilient wrapper on the card, (d) the adaptive
    optimizer and decision engine, (e) the simulators, (f) research and
    security. The engine runs under the heuristic (JAX's order), so each
    call's kind is fixed. No failure is caught. Returns the path's
    launches: each counted run from 0 just before it (``_counted``), the
    references outside."""
    from photonic_flash_attention_tpu_torch.config import reset_config, set_global_config
    from photonic_flash_attention_tpu_torch.core.engine import reset_engine

    reset_config()
    reset_engine()
    set_global_config(auto_kernel_selection=False)
    runs = {}
    t0 = time.perf_counter()
    try:
        _shell_balancer(runs, smi)
        _shell_serving(runs, smi)
        _shell_resilience(runs, smi)
        _shell_optimizer(runs, k1_ms, smi)
        _shell_simulators(k1_ms, smi)
        _shell_research_security(smi)
    finally:
        reset_config()
        reset_engine()
        torch.cuda.empty_cache()
    launches = collections.Counter()
    for counts in runs.values():
        launches.update(counts)
    print(f"shell path: launches by part { {label: dict(c) for label, c in runs.items()} }; "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


# -- roofline: the card's probes (K9-K12), its rates, the composite ceiling ---

#: exp2 results (MUFU) a clock per SM at compute capability 9.0 (CUDA C++
#: Programming Guide, arithmetic instruction throughput), and the FP32
#: pipe's lanes a clock per SM.
MUFU_PER_CLK_SM = 16
FP32_PER_CLK_SM = 128
#: The instructions one element of K12's function needs (masked mode,
#: unmasked), each issued for 32 lanes: FFMA (s * log2 e - m * log2 e),
#: FMNMX, FADD, half an F2FP (the bf16 pair pack), the bf16 unpack and the
#: MUFU.EX2 itself; masked adds the compare and the select. Counted from
#: the function, not from the compiled kernel (whose update loop holds 7.9
#: and 5.7 besides MUFU.EX2 at 512 columns; ``k12_sass_counts``, PERF.md
#: §6): at 128 lanes a clock both stay under
#: MUFU's 8 clocks per 128 exps, so the MUFU term is K12's bound.
K12_ISSUE_PER_ELEMENT = {True: 7.5, False: 5.5}
EXP_CHECK_BOUND = 1e-6
SOFTMAX_CHECK_BOUND = 2.0 ** -8  # one bf16 ulp in [0.5, 1)
#: K12's running sums l (fp32, rows 0-7) against the plain version's,
#: relative: the sums are taken in another order (a group's shuffles against
#: torch's reduction) over p that may differ by an fp32 ulp.
SOFTMAX_L_RTOL = 1e-4
#: K12 against its plain version: (rows, cols, iters): JAX's probe tile,
#: JAX's wider linear-fit tile, a ragged row count.
SOFTMAX_CHECKS = ((128, 512, 64), (224, 896, 8), (1000, 256, 16))
#: Iteration counts at which K11's and K12's outputs still depend on the
#: input and the count, none a multiple of K11's unroll of 4: K11's chain
#: contracts onto 0.567 by ~0.57 a step (at 256 iterations every element is
#: that value, whatever the count), and K12's rows collapse within a few
#: updates (to exp(-max) where the row max is above 1). So these checks
#: take wide inputs, K11's in [0, 4), K12's in [-8, 1).
FEW_ITERS = (1, 2, 3, 5, 7)
#: A measured rate may exceed its data-sheet bound by at most this factor.
RATE_OVER_BOUND = 1.05
#: Replays of each CUDA graph that graph_ms captures: one warm-up, 5 timed.
GRAPH_REPLAYS = 6
#: Iterations of the K11 and K12 calls timed for the kernels JSON: the
#: measure functions' defaults (JAX's).
EXP_ITERS, SOFTMAX_ITERS = 256, 512
#: The profiler's kernel time against the graph fit, at most this apart.
PROFILE_AGREEMENT = 0.10
#: K1's headline shape (B, S, H, D; causal bf16), timed in check_flash.
K1_HEADLINE = (4, 2048, 12, 64)


def card_rates() -> dict:
    """The card's SM count, maximum SM clock and the data-sheet rates the
    probes are held against."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_hz = float(nvidia_smi("clocks.max.sm", units=False)) * 1e6
    return {"sms": sms, "clock_hz": clock_hz, "hbm_Bps": HBM_BYTES_PER_S,
            "exp_per_s": MUFU_PER_CLK_SM * sms * clock_hz,
            "fp32_per_s": FP32_PER_CLK_SM * sms * clock_hz}


def exp_bound(n: int, iters: int, peak: dict) -> dict:
    """K11's bound: n x iters exps over the MUFU rate."""
    return {"bound_ms": n * iters / peak["exp_per_s"] * 1e3, "bound_by": "operations"}


def softmax_bound(rows: int, cols: int, iters: int, masked: bool, peak: dict) -> dict:
    """K12's bound: (elements + rows) x iters exps over the MUFU rate, or
    the instructions the function needs over 128 lanes a clock per SM,
    whichever is longer."""
    t_exp = (rows * cols + rows) * iters / peak["exp_per_s"] * 1e3
    t_issue = rows * cols * iters * K12_ISSUE_PER_ELEMENT[masked] / peak["fp32_per_s"] * 1e3
    return {"bound_ms": max(t_exp, t_issue), "bound_by": "operations"}


def check_hbm_probes(results: dict) -> None:
    """K9 and K10 against their plain versions, bit for bit: K9 over 1, 2
    and 3 chunks and bench.py's 256 MiB stream (bf16; fp32 and int8 at one
    chunk), K10 at (131072, 512) bf16, short fp32 and int8 arrays and its
    ring's tails (16 bytes, a chunk and 16 bytes, a size that ends mid
    chunk); both timed at the rate shapes, K10 against ``y.copy_(x)``."""
    from photonic_flash_attention_tpu_torch.ops import hbm_bw

    gen = torch.Generator(device="cuda").manual_seed(30)
    read = [((rows, 512), torch.bfloat16) for rows in (4096, 8192, 12288)]
    read += [((4096, 512), torch.float32), ((4096, 512), torch.int8),
             (hbm_bw.READ_SHAPE, torch.bfloat16)]
    for shape, dtype in read:
        x = (torch.randn(shape, device="cuda", generator=gen) * 50).to(dtype)
        out = hbm_bw.hbm_read_probe(x)
        if not torch.equal(out, hbm_bw.hbm_read_probe_plain(x)):
            raise AssertionError(f"K9 hbm_read {list(shape)} {str(dtype)[6:]}: not the plain slice")
    nbytes = x.numel() * x.element_size()
    ms = graph_ms(lambda: hbm_bw.hbm_read_probe(x))
    plain = device_ms(lambda: hbm_bw.hbm_read_probe_plain(x))
    bound = card_bound(0, nbytes, torch.bfloat16)
    results["pfa_hbm_read"] = {"ms": ms, "plain_ms": plain, "library_ms": None,
                               "max_abs_err": 0.0, "shape": list(x.shape), **bound}
    print(f"K9 hbm_read: equal to the plain slice at {[list(s) for s, _ in read]} | "
          f"{list(x.shape)} bf16 ({nbytes / 2**20:.0f} MiB): kernel {ms:.4f} ms "
          f"({nbytes / ms / 1e6:.1f} GB/s), plain (the slice) {plain:.4f} ms, "
          f"bound {bound['bound_ms']:.4f} ms (bytes)", flush=True)
    del x, out

    copy = [((4096, 256), torch.float32), ((100, 512), torch.int8), ((1, 8), torch.bfloat16),
            ((1, 16392), torch.bfloat16), ((3, 40008), torch.bfloat16),
            (hbm_bw.COPY_SHAPE, torch.bfloat16)]
    for shape, dtype in copy:
        x = (torch.randn(shape, device="cuda", generator=gen) * 50).to(dtype)
        y = hbm_bw.hbm_copy(x)
        if not torch.equal(y, x):
            raise AssertionError(f"K10 hbm_copy {list(shape)} {str(dtype)[6:]}: y != x")
    nbytes = 2 * x.numel() * x.element_size()
    ms = graph_ms(lambda: hbm_bw.hbm_copy(x))
    plain = device_ms(lambda: hbm_bw.hbm_copy_plain(x))
    lib = graph_ms(lambda: y.copy_(x))
    bound = card_bound(0, nbytes, torch.bfloat16)
    results["pfa_hbm_copy"] = {"ms": ms, "plain_ms": plain, "library_ms": lib,
                               "max_abs_err": 0.0, "shape": list(x.shape), **bound}
    print(f"K10 hbm_copy: equal to x at {[list(s) for s, _ in copy]} | {list(x.shape)} bf16: "
          f"kernel {ms:.4f} ms ({nbytes / ms / 1e6:.1f} GB/s read + written), plain (clone) "
          f"{plain:.4f} ms, y.copy_(x) {lib:.4f} ms ({nbytes / lib / 1e6:.1f} GB/s), bound "
          f"{bound['bound_ms']:.4f} ms (bytes)", flush=True)
    del x, y


def _check_count_sensitive(name: str, plain, x, iters: int, bound: float, margin: float) -> None:
    """Fail unless the plain version at ``iters`` + 1 differs from that at
    ``iters`` by ``margin`` x ``bound``: a check at this count and input
    then catches a kernel that runs one iteration too many or too few."""
    gap = max_abs_err(plain(x, iters + 1), plain(x, iters))
    if not gap > margin * bound:
        raise AssertionError(f"{name} iters {iters}: one more iteration moves the plain version "
                             f"by {gap:.3e}, not above {margin} x the bound {bound:.3e}")


def check_compute_probes(results: dict, peak: dict) -> None:
    """K11 (<= 1e-6 abs) and K12 in both modes (<= one bf16 ulp, l within
    1e-4 relative, masked equal to unmasked) against their plain versions:
    at 1, 2, 3, 5 and 7 iterations on wide inputs, where the outputs still
    depend on the count (checked on the plain versions), and at the timed
    counts, at JAX's shapes, ragged ones and the measure functions' card
    shapes; both timed at the card shapes by graph_ms."""
    from photonic_flash_attention_tpu_torch.ops import device_probes as dp

    gen = torch.Generator(device="cuda").manual_seed(31)
    exp_card = (dp.EXP_WAVES * dp.wave_rows("exp"), 512)
    worst = 0.0
    cases = [(shape, it, 0.0, 4.0) for shape in ((40, 132), exp_card) for it in FEW_ITERS]
    cases += [(shape, EXP_ITERS, 0.1, 1.0) for shape in (dp.JAX_EXP_SHAPE, (40, 132), exp_card)]
    for shape, iters, lo, hi in cases:
        x = torch.rand(shape, device="cuda", generator=gen) * (hi - lo) + lo
        if iters in FEW_ITERS:
            _check_count_sensitive("K11", dp.exp_probe_plain, x, iters, EXP_CHECK_BOUND, 100)
        err = max_abs_err(dp.exp_probe(x, iters), dp.exp_probe_plain(x, iters))
        worst = max(worst, err)
        line = (f"K11 exp_probe {list(shape)} x in [{lo}, {hi}) iters {iters}: max_abs_err "
                f"{err:.3e} (bound {EXP_CHECK_BOUND})")
        if not err <= EXP_CHECK_BOUND:
            raise AssertionError(line)
        print(line, flush=True)
    n = x.numel()
    jax_x = torch.rand(dp.JAX_EXP_SHAPE, device="cuda", generator=gen)
    jax_ms = graph_ms(lambda: dp.exp_probe(jax_x, EXP_ITERS))
    ms = graph_ms(lambda: dp.exp_probe(x, EXP_ITERS))
    plain = device_ms(lambda: dp.exp_probe_plain(x, EXP_ITERS), runs=3)
    bound = exp_bound(n, EXP_ITERS, peak)
    results["pfa_exp_probe"] = {"ms": ms, "plain_ms": plain, "library_ms": None,
                                "max_abs_err": worst, "shape": list(x.shape),
                                "iters": EXP_ITERS, **bound}
    print(f"K11 exp_probe {list(x.shape)} iters {EXP_ITERS}: kernel {ms:.4f} ms "
          f"({n * EXP_ITERS / ms / 1e6:.1f} Gexp/s), plain {plain:.4f} ms, bound "
          f"{bound['bound_ms']:.4f} ms (MUFU at {peak['exp_per_s'] / 1e12:.3f} Texp/s); "
          f"JAX's (512, 512): {jax_ms:.4f} ms ({jax_x.numel() * EXP_ITERS / jax_ms / 1e6:.1f} "
          f"Gexp/s)", flush=True)
    del x, jax_x

    card_rows = {m: dp.wave_rows("softmax", 512, m) for m in (True, False)}
    checks = [(rows, cols, it, -8.0, 1.0) for rows, cols in ((1000, 256), (224, 896),
                                                             (card_rows[True], 512))
              for it in FEW_ITERS]
    checks += [(rows, cols, it, -2.0, 2.0) for rows, cols, it in SOFTMAX_CHECKS]
    checks.append((card_rows[True], 512, 8, -2.0, 2.0))
    worst = 0.0
    for rows, cols, iters, lo, hi in checks:
        x = torch.rand((rows, cols), device="cuda", generator=gen) * (hi - lo) + lo
        if iters in FEW_ITERS:
            _check_count_sensitive("K12", dp.softmax_block_probe_plain, x, iters,
                                   SOFTMAX_CHECK_BOUND, 4)
        outs = {m: dp.softmax_block_probe(x, iters, masked=m, return_l=True)
                for m in (True, False)}
        if not (torch.equal(outs[True][0], outs[False][0])
                and torch.equal(outs[True][1], outs[False][1])):
            raise AssertionError(f"K12 {rows}x{cols} iters {iters}: masked and unmasked differ")
        for m in (True, False):
            out, l = outs[m]
            want, want_l = dp.softmax_block_probe_plain(x, iters, m, return_l=True)
            err = max_abs_err(out, want)
            l_err = float(((l - want_l).abs() / want_l.abs()).max()) if iters else 0.0
            worst = max(worst, err)
            line = (f"K12 softmax_probe {'masked' if m else 'unmasked'} [{rows}, {cols}] x in "
                    f"[{lo}, {hi}) iters {iters}: max_abs_err {err:.3e} (bound "
                    f"{SOFTMAX_CHECK_BOUND:.3e}), l max_rel_err {l_err:.3e} (bound "
                    f"{SOFTMAX_L_RTOL})")
            if not (err <= SOFTMAX_CHECK_BOUND and l_err <= SOFTMAX_L_RTOL):
                raise AssertionError(line)
            print(line, flush=True)
    for m in (True, False):
        name = "pfa_softmax_probe" if m else "pfa_softmax_probe_unmasked"
        x = dp.probe_input(card_rows[m], 512, "cuda")
        jax_x = dp.probe_input(*dp.JAX_SOFTMAX_SHAPE, "cuda")
        ms = graph_ms(lambda: dp.softmax_block_probe(x, SOFTMAX_ITERS, m))
        jax_ms = graph_ms(lambda: dp.softmax_block_probe(jax_x, SOFTMAX_ITERS, m), runs=5)
        plain = device_ms(lambda: dp.softmax_block_probe_plain(x, SOFTMAX_ITERS, m), runs=2,
                          warmup=1)
        bound = softmax_bound(card_rows[m], 512, SOFTMAX_ITERS, m, peak)
        results[name] = {"ms": ms, "plain_ms": plain, "library_ms": None, "max_abs_err": worst,
                         "shape": [card_rows[m], 512], "iters": SOFTMAX_ITERS, **bound}
        elems = x.numel() * SOFTMAX_ITERS
        print(f"K12 softmax_probe {'masked' if m else 'unmasked'} [{card_rows[m]}, 512] (one "
              f"wave) iters {SOFTMAX_ITERS}: kernel {ms:.4f} ms ({elems / ms / 1e6:.1f} Gelem/s), "
              f"plain {plain:.4f} ms, bound {bound['bound_ms']:.4f} ms; JAX's (128, 512): "
              f"{jax_ms:.4f} ms ({jax_x.numel() * SOFTMAX_ITERS / jax_ms / 1e6:.1f} Gelem/s)",
              flush=True)
    del x, jax_x


def profiled_kernel_ms(fn, name: str, runs: int = 5) -> float:
    """Mean device time of the kernels whose name holds ``name`` in a
    torch.profiler trace of one replay of a CUDA graph of ``runs`` calls."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    fn()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(runs):
            fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        trace = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(trace))
        events = [e for e in json.loads(trace.read_text())["traceEvents"]
                  if e.get("cat") == "kernel" and name in e.get("name", "") and "dur" in e]
    del graph
    if len(events) != runs:
        raise AssertionError(f"profile: {len(events)} {name} kernels in the trace of one "
                             f"replay, expected {runs}")
    return sum(float(e["dur"]) for e in events) / runs / 1e3


def phase_roofline(k1: dict, smi: str) -> tuple:
    """The card's record (hardware/detection.py); K9-K12 against their
    plain versions; then the main path, counted from 0: the read, copy,
    exp and softmax-stream rates (masked and unmasked, and the stream's
    linear fit) through the measure functions at the card's shapes and at
    JAX's; K1's share of the composite ceiling built from them; last, the
    profiler's time of K11 and K12 against the graph fit (within 10 %).
    ``k1`` is K1's kernels-phase entry at its headline shape (ms, bound)."""
    from photonic_flash_attention_tpu_torch.hardware import detection
    from photonic_flash_attention_tpu_torch.hardware import roofline as rl
    from photonic_flash_attention_tpu_torch.ops import device_probes as dp
    from photonic_flash_attention_tpu_torch.ops import hbm_bw

    t_phase = time.perf_counter()
    dev = detection.get_best_tpu_device()
    if dev is None or dev.platform != "gpu":
        raise AssertionError(f"roofline: detection found no card: {detection.get_device_info()}")
    print(f"roofline: device record {dev}", flush=True)
    peak = card_rates()
    print(f"roofline: {peak['sms']} SMs at {peak['clock_hz'] / 1e6:.0f} MHz (clocks.max.sm): "
          f"MUFU {peak['exp_per_s'] / 1e12:.3f} Texp/s, FP32 pipe {peak['fp32_per_s'] / 1e12:.3f} "
          f"Tlane-op/s; HBM {HBM_BYTES_PER_S / 1e12:.2f} TB/s (data sheet)", flush=True)
    results = {}
    check_hbm_probes(results)
    check_compute_probes(results, peak)
    torch.cuda.empty_cache()

    _build.reset_launches()
    t0 = time.perf_counter()
    read = hbm_bw.hbm_read_bytes_per_s()
    copy = hbm_bw.hbm_copy_bytes_per_s()
    exp_rate = dp.measure_exp_rate()
    stream = {m: dp.measure_softmax_rate(masked=m) for m in (True, False)}
    linear = dp.measure_softmax_linear(fit=(20, 120))
    jax_exp = dp.measure_exp_rate(shape=dp.JAX_EXP_SHAPE)
    jax_stream = dp.measure_softmax_rate(shape=dp.JAX_SOFTMAX_SHAPE, fit=(4, 24))
    jax_linear = dp.measure_softmax_linear(shapes=dp.JAX_LINEAR_SHAPES, fit=(2, 6))
    torch.cuda.synchronize()
    launches, captured = dict(_build.LAUNCHES), dict(_build.CAPTURED)
    print(f"roofline: main path in {time.perf_counter() - t0:.2f} s; launches {launches}; "
          f"calls captured into CUDA graphs {captured} (each graph replayed "
          f"{GRAPH_REPLAYS} times)", flush=True)
    for name in ("pfa_hbm_read", "pfa_hbm_copy", "pfa_exp_probe", "pfa_softmax_probe",
                 "pfa_softmax_probe_unmasked"):
        if not launches.get(name):
            raise AssertionError(f"roofline: {name} never launched by the measure functions")

    def stream_peak(masked: bool) -> float:
        rows = dp.wave_rows("softmax", 512, masked)
        return rows * 512 * SOFTMAX_ITERS / softmax_bound(rows, 512, SOFTMAX_ITERS, masked,
                                                          peak)["bound_ms"] * 1e3

    lines = [
        f"read {read / 1e9:.1f} GB/s (data sheet {HBM_BYTES_PER_S / 1e9:.0f})",
        f"copy {copy / 1e9:.1f} GB/s read + written (data sheet {HBM_BYTES_PER_S / 1e9:.0f})",
        f"exp {exp_rate / 1e9:.1f} Gexp/s (MUFU {peak['exp_per_s'] / 1e9:.1f}); JAX's (512, 512) "
        f"{jax_exp / 1e9:.1f}",
        f"softmax stream masked {stream[True] / 1e9:.1f}, unmasked {stream[False] / 1e9:.1f} "
        f"Gelem/s (bound {stream_peak(True) / 1e9:.1f} masked, {stream_peak(False) / 1e9:.1f} "
        f"unmasked); JAX's (128, 512) masked "
        f"{jax_stream / 1e9:.1f}",
        f"linear fit a {linear['fixed_s_per_tile'] * 1e9:.1f} ns per update of "
        f"{dp.card_linear_shapes()[0][0]} rows, 1/b {linear['asymptotic_elems_per_s'] / 1e9:.1f} "
        f"Gelem/s, points {linear['points']}; JAX's shapes: a "
        f"{jax_linear['fixed_s_per_tile'] * 1e9:.1f} ns, 1/b "
        f"{jax_linear['asymptotic_elems_per_s'] / 1e9:.1f} Gelem/s",
    ]
    for line in lines:
        print(f"roofline: measured {line} ({smi})", flush=True)
    rates = {"hbm_read_Bps": read, "vpu_softmax_elems_per_s": linear["asymptotic_elems_per_s"],
             "vpu_softmax_fixed_s_per_tile": linear["fixed_s_per_tile"],
             "vpu_exp_elems_per_s": exp_rate}
    if not all(v > 0 and v == v and v != float("inf") for v in (read, copy, exp_rate,
                                                                *stream.values())):
        raise AssertionError(f"roofline: a rate is not finite and positive: {lines}")
    # No measured rate may exceed its data-sheet bound: a probe that skips
    # work would. JAX's linear fit counts only where it found a slope (at
    # 32 and 224 rows each update is latency-bound and b may sit at its
    # floor, where 1/b is no rate).
    held = [("read", read, HBM_BYTES_PER_S), ("copy", copy, HBM_BYTES_PER_S),
            ("exp", exp_rate, peak["exp_per_s"]), ("exp, JAX's shape", jax_exp, peak["exp_per_s"]),
            ("stream masked", stream[True], stream_peak(True)),
            ("stream unmasked", stream[False], stream_peak(False)),
            ("stream masked, JAX's shape", jax_stream, stream_peak(True)),
            ("linear fit 1/b", linear["asymptotic_elems_per_s"], stream_peak(False))]
    if jax_linear["s_per_elem"] > 1e-15:
        held.append(("linear fit 1/b, JAX's shapes", jax_linear["asymptotic_elems_per_s"],
                     stream_peak(False)))
    else:
        print("roofline: JAX's linear-fit shapes give no per-element slope on the card (b at "
              "its floor): not a rate, not held to a bound", flush=True)
    for what, rate, bound in held:
        line = (f"roofline: {what} {rate:.6e} a second is {rate / bound:.4f} x its data-sheet "
                f"bound {bound:.6e} (at most {RATE_OVER_BOUND})")
        if not rate <= RATE_OVER_BOUND * bound:
            raise AssertionError(line)
        print(line, flush=True)
    b, s, h, d = K1_HEADLINE
    ceiling = rl.attention_composite_ceiling(b, s, s, h, d, causal=True, rates=rates)
    print(f"roofline: composite ceiling of K1's B{b} S{s} H{h} D{d} causal bf16 from the "
          f"measured rates: {ceiling}; K1 {k1['ms']:.4f} ms (CUDA events) = "
          f"{100 * rl.composite_fraction(k1['ms'] * 1e3, ceiling):.2f} % of it, "
          f"{k1['fit_ms']:.4f} ms (graph fit) = "
          f"{100 * rl.composite_fraction(k1['fit_ms'] * 1e3, ceiling):.2f} %, against "
          f"{100 * k1['bound_ms'] / k1['ms']:.2f} % of its data-sheet bound "
          f"{k1['bound_ms']:.4f} ms ({k1['bound_by']}); rates {rates}", flush=True)

    probes = (("pfa_exp_probe", "exp_chain", exp_rate, lambda x, it: dp.exp_probe(x, it)),
              ("pfa_softmax_probe", "softmax_stream", stream[True],
               lambda x, it: dp.softmax_block_probe(x, it, True)))
    for name, kernel, rate, call in probes:
        shape, iters = results[name]["shape"], results[name]["iters"]
        x = dp.probe_input(*shape, "cuda")
        fit_ms = x.numel() * iters / rate * 1e3
        prof_ms = profiled_kernel_ms(lambda: call(x, iters), kernel)
        gap = abs(prof_ms - fit_ms) / fit_ms
        line = (f"roofline: {name} {shape} iters {iters}: profiler {prof_ms:.4f} ms a launch "
                f"(one replay of a graph), graph fit {fit_ms:.4f} ms: {100 * gap:.2f} % apart "
                f"(at most {100 * PROFILE_AGREEMENT:.0f} %)")
        if not gap <= PROFILE_AGREEMENT:
            raise AssertionError(line)
        print(line, flush=True)
        del x
    torch.cuda.empty_cache()
    print(f"roofline: phase in {time.perf_counter() - t_phase:.2f} s ({smi})", flush=True)
    return results, {"roofline": launches}, {"roofline": captured}, rates


# -- experiments: the design-space kernels (K13-K21) ---------------------------

#: K13 (both exp modes), K14, K15, K16, K17, K18 (both modes), K19 and the
#: backward's K20 and K21: the experiments path's kernels (K16-K19's fp32
#: modes, which the bf16 mains do not run, are checked and timed in
#: check_experiments and nest under them: NESTED_MODES).
EXPERIMENT_KERNELS = ("pfa_flash_fixedmax", "pfa_flash_fixedmax_fast", "pfa_flash_aug",
                      "pfa_flash_pair", "pfa_flash_pipelined", "pfa_flash_chunked",
                      "pfa_flash_tri", "pfa_flash_tri_i8", "pfa_flash_fulltri",
                      "pfa_flash_bwd_dq_rowblock", "pfa_flash_bwd_dkv_colblock")
#: Each against its plain version: K1's bf16 bound (check_flash).
EXPERIMENT_BOUND = 1e-2
#: The mains' errors against the fp32 oracle: K1's bf16 bound, and for
#: ``fast_exp`` the bit trick's own largest relative error a value (2.98e-2
#: against torch.exp over [-30, 0]).
ORACLE_BOUND, FAST_EXP_ORACLE_BOUND = 1e-2, 3e-2
#: int8 Q.K rows: the JAX tests' gate of ``flash_attention_int8qk``
#: (_quant_modes).
INT8_ORACLE_BOUND = 0.05
#: The two-point fit of the experiments' mains on this path (theirs default
#: to JAX's longer windows).
EXPERIMENT_FIT = (2, 10)
#: The experiments' long geometry (B, S, H, D), bf16.
EXPERIMENT_LONG = (1, 8192, 12, 64)
#: Each main's row keys that hold a variant's time, and its label.
EXPERIMENT_VARIANTS = (("fixedmax_ms", "K13 fixed-max (with its prolog)"),
                       ("fast_exp_ms", "K13 fast_exp (with its prolog)"),
                       ("kernel_ms", "K13 fixed-max, kernel alone"),
                       ("fast_kernel_ms", "K13 fast_exp, kernel alone"),
                       ("aug_ms", "K14 aug"), ("pair_ms", "K15 pair"),
                       ("unrolled_ms", "K16 pipelined"), ("chunked_ms", "K17 chunked"),
                       ("tri_ms", "K18 triangular"),
                       ("tri_i8_ms", "K18 int8-QK triangular (with its quantization)"),
                       ("tri_i8_kernel_ms", "K18 int8-QK triangular, kernel alone"),
                       ("segmented_ms", "segmented on K1 with lse"),
                       ("fulltri_ms", "K19 full triangle"))
#: Row keys of the int8 Q.K variants (no library call; the quantized bound).
INT8_VARIANTS = ("tri_i8_ms", "tri_i8_kernel_ms")
#: The row key of K1's time that a variant's key is set beside, where it is
#: not ``k1_ms`` (the kernel alone beside K1's int8-QK kernel alone).
K1_KEYS = {"tri_i8_kernel_ms": "k1_kernel_ms"}
#: Query rows of the long causal checks compared with the plain version:
#: the last ones, which see every key (the end-aligned causal mask of a
#: slice of rows is ``col <= row`` there).
LONG_CHECK_ROWS = 1024
#: Per kernel, the mains' row at K1's headline shape (B4 S2048 H12 D64
#: causal) that gives its time in the kernels line: (main, row, the
#: kernel's key, the public call's key where it does more).
HEADLINE_ROWS = {
    "pfa_flash_fixedmax": ("fixedmax", "b4_s2048_h12_d64_causal", "kernel_ms", "fixedmax_ms"),
    "pfa_flash_fixedmax_fast": ("fixedmax", "b4_s2048_h12_d64_causal", "fast_kernel_ms",
                                "fast_exp_ms"),
    "pfa_flash_aug": ("aug", "B4 S2048", "aug_ms", None),
    "pfa_flash_pair": ("pair", "B4 S2048 pair 512x512 x2", "pair_ms", None),
    "pfa_flash_pipelined": ("pipeline", "bf16 d64 b4 s2048 causal", "unrolled_ms", None),
    "pfa_flash_chunked": ("chunked", "d64 b4 s2048 causal chunked bq=512 bkv=512 u=4",
                          "chunked_ms", None),
    "pfa_flash_tri": ("tri", "d64 b4 s2048 tri bq=512 bkv=512", "tri_ms", None),
    "pfa_flash_tri_i8": ("i8", "d64 b4 s2048 causal", "tri_i8_kernel_ms", "tri_i8_ms"),
    "pfa_flash_fulltri": ("fulltri", "d64 b4 s2048", "fulltri_ms", None),
    "pfa_flash_bwd_dq_rowblock": ("bwd_unrolled", "d64 b4 s2048 causal unrolled bq=512 bkv=512",
                                  "k20_ms", "unrolled_ms"),
    "pfa_flash_bwd_dkv_colblock": ("bwd_unrolled", "d64 b4 s2048 causal unrolled bq=512 bkv=512",
                                   "k21_ms", "unrolled_ms"),
}
#: The backward main's rows, by the key of their time: its label, the
#: yardstick's key and label in the same row, and its operations per (query,
#: key) pair over D and H (``bwd_bounds``' counts).
BWD_VARIANTS = (("unrolled_ms", "K20 + K21 unrolled backward (dq, dk, dv)", "k45_ms",
                 "K4 + K5", 14.0),
                ("k20_ms", "K20 alone (dq)", "k5_ms", "K5 alone", 6.0),
                ("k21_ms", "K21 alone (dk, dv)", "k4_ms", "K4 alone", 8.0))


def _experiment_case(name: str, label: str, call, plain, checked: dict,
                     timed: bool = False, launches: Optional[Tuple[str, int]] = None) -> None:
    """The kernel's ``call`` against its ``plain`` version on the same
    inputs, the plain version run once; with ``timed`` that run's CUDA-event
    time is the kernel's ``plain_ms``. ``launches`` (counter, n): ``call``
    must launch n times under that counter."""
    before = _build.LAUNCHES[launches[0]] if launches else 0
    out = call()
    torch.cuda.synchronize()
    if launches and _build.LAUNCHES[launches[0]] - before != launches[1]:
        raise AssertionError(f"{label}: {_build.LAUNCHES[launches[0]] - before} launches of "
                             f"{launches[0]}, not {launches[1]}")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    ref = plain()
    end.record()
    end.synchronize()
    err = rel_err_norm(out, ref)
    r = checked.setdefault(name, {"max_abs_err": 0.0})
    r["max_abs_err"] = max(r["max_abs_err"], max_abs_err(out, ref))
    line = f"{label}: rel_err_norm {err:.3e} against the plain version (bound {EXPERIMENT_BOUND})"
    if timed:
        r["plain_ms"] = start.elapsed_time(end)
        line += f"; the plain version {r['plain_ms']:.4f} ms"
    if not err <= EXPERIMENT_BOUND or not torch.isfinite(out).all():
        raise AssertionError(line)
    print(line, flush=True)


def check_experiments(results: dict) -> dict:
    """K13-K21 against their plain versions at small and ragged shapes and
    at every geometry the experiments path gives them (K13 both exp modes
    causal and not, K14 also with Sq < Skv, K15 at each nchain the card
    takes, K16 with GQA, D 128 and fp32 inputs, K17 at unroll 2 and 4 and
    K18's int8-QK mode causal and not (its bf16 V on K1's Hopper int8-QK
    body, an fp32 V on the mma.sync body under its own counter), K18 at
    each of ``main_tri``'s blocks and K19 causal, K17-K19 at the pipeline
    module's CARD_CHECK_SHAPES, which hold the int8 main's I8_CASES, K18 in
    both modes launched once a row-block, a call of each replayed from a
    CUDA graph, K16-K19's fp32 inputs and K18 int8's fp32 V timed); then
    the segmented path (K1 once a segment)
    and K1 at the segmented main's long geometries, and K1's int8-QK mode at
    the int8 main's, where the plain version computes only the last rows or
    batch 0; then K20 and K21 at the backward module's CARD_CHECKS and its
    main's geometries and blocks, launched once a row-block and once a key
    block, K20's bf16 dq at K1's headline shape equal to K5's bit for bit,
    a K20 and a K21 call replayed from a CUDA graph, and both kernels' fp32
    inputs (the mma.sync bodies) timed. Each plain version runs once a case and is timed at K1's
    headline shape (B4 S2048 H12 D64 causal bf16). Returns, per kernel, its
    worst max abs error and that plain time; K1's and its int8-QK mode's
    errors go into ``results``."""
    from photonic_flash_attention_tpu_torch.experiments import flash_aug_experiment as ax
    from photonic_flash_attention_tpu_torch.experiments import flash_bwd_unrolled_experiment as bx
    from photonic_flash_attention_tpu_torch.experiments import flash_fixedmax_experiment as fx
    from photonic_flash_attention_tpu_torch.experiments import flash_pair_experiment as px
    from photonic_flash_attention_tpu_torch.experiments import flash_pipeline_experiment as ux
    from photonic_flash_attention_tpu_torch.ops import flash_fp8 as fp8_ops

    t_checks = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(40)

    def qkv(b, sq, h, d, skv=None, hkv=None, dtype=torch.bfloat16):
        skv, hkv = skv or sq, hkv or h
        return (torch.randn(b, sq, h, d, device="cuda", generator=gen).to(dtype),
                *(torch.randn(b, skv, hkv, d, device="cuda", generator=gen).to(dtype)
                  for _ in range(2)))

    checked = {}
    for (b, s, h, d), blk in (((2, 256, 4, 64), 128), ((1, 96, 3, 128), 32),
                              ((2, 320, 3, 64), 64), ((1, 320, 2, 128), 64), (K1_HEADLINE, 512),
                              (EXPERIMENT_LONG, 512)):
        q, k, v = qkv(b, s, h, d)
        for causal in (False, True):
            for fast in (False, True):
                kw = dict(causal=causal, block_q=blk, block_kv=blk, fast_exp=fast)
                _experiment_case("pfa_flash_fixedmax_fast" if fast else "pfa_flash_fixedmax",
                                 f"K13 fixedmax{' fast_exp' if fast else ''} B{b} S{s} H{h} D{d} "
                                 f"causal={causal}",
                                 lambda: fx.flash_fixedmax(q, k, v, **kw),
                                 lambda: fx.flash_fixedmax_plain(q, k, v, **kw), checked,
                                 timed=(b, s, h, d) == K1_HEADLINE and causal)
    for fast in (False, True):
        check_k13_graph_replay(fast, checked, lambda sh: qkv(*sh))
    for (b, sq, skv, h), blk in (((2, 256, 256, 4), 128), ((1, 96, 160, 2), 32),
                                 ((1, 160, 96, 2), 32), ((4, 2048, 2048, 12), 512),
                                 ((1, 8192, 8192, 12), 512)):
        q, k, v = qkv(b, sq, h, 64, skv=skv)
        _experiment_case("pfa_flash_aug", f"K14 aug B{b} Sq{sq} Skv{skv} H{h} D64 causal",
                         lambda: ax.flash_aug(q, k, v, bq=blk, bkv=blk),
                         lambda: ax.flash_aug_plain(q, k, v, bq=blk, bkv=blk), checked,
                         timed=(b, sq, h, 64) == K1_HEADLINE, launches=("pfa_flash_aug", 1))
    # K15 at each nchain the card takes: the mains' geometries (S cut to a
    # multiple of nchain x 128 where nchain does not divide it), small
    # shapes, a length whose last work tile is ragged, Sq != Skv each way.
    for nc in px.CARD_NCHAINS:
        ragged = px.RAGGED_LENGTHS[nc]
        for b, sq, skv, h in ((2, 384, 384, 4), (1, 1536, 1536, 3), (4, 2048, 2048, 12),
                              (1, 8192, 8192, 12), (2, ragged, ragged, 3), (2, 192, 320, 3),
                              (2, 384, 192, 3)):
            (sq, blk), skv = px.pair_case(sq, nc), skv if skv != sq else px.pair_case(sq, nc)[0]
            q, k, v = qkv(b, sq, h, 64, skv=skv)
            bkv = blk if skv % blk == 0 else 32
            _experiment_case("pfa_flash_pair", f"K15 pair nchain {nc} B{b} Sq{sq} Skv{skv} H{h} "
                             f"D64 causal",
                             lambda: px.flash_pair(q, k, v, bq=blk, bkv=bkv, nchain=nc),
                             lambda: px.flash_pair_plain(q, k, v, bq=blk, bkv=bkv, nchain=nc),
                             checked, timed=(b, sq, h, 64) == K1_HEADLINE and nc == 2,
                             launches=("pfa_flash_pair", 1))
        check_k15_graph_replay(nc, checked, lambda sh: qkv(*sh))
    both = (True, False)
    # K16-K19's counter: the Hopper body's in bf16, the mma.sync body's (a
    # mode of its own) in fp32.
    route = lambda name, dtype: name if dtype == torch.bfloat16 else f"{name}_fp32"  # noqa: E731
    for (b, s, h, hkv, d, dtype), causals in (((2, 256, 4, 4, 64, torch.bfloat16), both),
                                              ((1, 96, 4, 2, 64, torch.bfloat16), both),
                                              ((2, 320, 8, 2, 128, torch.bfloat16), both),
                                              ((1, 192, 4, 1, 128, torch.float32), both),
                                              ((4, 2048, 12, 12, 64, torch.bfloat16), both),
                                              ((1, 8192, 12, 12, 64, torch.bfloat16), (False,)),
                                              ((4, 4096, 32, 8, 128, torch.bfloat16), both)):
        q, k, v = qkv(b, s, h, d, hkv=hkv, dtype=dtype)
        blk = 32 if s % 64 else 512 if s >= 2048 else 64
        for causal in causals:
            kw = dict(causal=causal, block_q=blk, block_kv=blk)
            name = route("pfa_flash_pipelined", dtype)
            _experiment_case(name, f"K16 pipelined B{b} S{s} H{h}/{hkv} D{d} {str(dtype)[6:]} "
                             f"causal={causal}",
                             lambda: ux.flash_unrolled(q, k, v, **kw),
                             lambda: ux.flash_unrolled_plain(q, k, v, **kw), checked,
                             timed=(b, s, h, d) == K1_HEADLINE and causal, launches=(name, 1))
    blk = ux.check_block
    for b, s, h, hkv, d, dtype in ux.CARD_CHECK_SHAPES:
        q, k, v = qkv(b, s, h, d, hkv=hkv, dtype=dtype)
        geom = f"B{b} S{s} H{h}/{hkv} D{d} {str(dtype)[6:]}"
        headline = (b, s, h, d) == K1_HEADLINE
        for causal in both:
            for u in ux.CARD_UNROLLS:
                kw = dict(causal=causal, block_q=blk(s), block_kv=blk(s, u), unroll=u)
                name = route("pfa_flash_chunked", dtype)
                _experiment_case(name, f"K17 chunked unroll {u} {geom} causal={causal}",
                                 lambda: ux.flash_chunked(q, k, v, **kw),
                                 lambda: ux.flash_chunked_plain(q, k, v, **kw), checked,
                                 timed=headline and causal and u == 4, launches=(name, 1))
            kw = dict(causal=causal, block_q=blk(s), block_kv=blk(s))
            name = route("pfa_flash_tri_i8", dtype)
            _experiment_case(name, f"K18 int8-QK {geom} causal={causal}",
                             lambda: ux.flash_tri_i8(q, k, v, **kw),
                             lambda: ux.flash_tri_i8_plain(q, k, v, **kw), checked,
                             timed=headline and causal, launches=(name, s // blk(s)))
        for bq, bkv in ux.check_tri_blocks(s):
            kw = dict(block_q=bq, block_kv=bkv)
            name = route("pfa_flash_tri", dtype)
            _experiment_case(name, f"K18 triangular bq={bq} bkv={bkv} {geom} causal",
                             lambda: ux.flash_triangular(q, k, v, **kw),
                             lambda: ux.flash_triangular_plain(q, k, v, **kw), checked,
                             timed=headline and (bq, bkv) == (512, 512), launches=(name, s // bq))
        kw = dict(block_q=blk(s, 2), block_kv=blk(s))
        name = route("pfa_flash_fulltri", dtype)
        _experiment_case(name, f"K19 full triangle {geom} causal",
                         lambda: ux.flash_fulltri(q, k, v, **kw),
                         lambda: ux.flash_fulltri_plain(q, k, v, **kw), checked, timed=headline,
                         launches=(name, 1))
    # K18 in bf16 captured into a CUDA graph (its launches after the first
    # programmatic dependent launches), replayed on new inputs and read by
    # the stream's next kernel before any synchronisation; its int8 mode
    # likewise, causal and not.
    for shape, bq, int8, causal in (((4, 2048, 12, 12, 64), 512, False, True),
                                    ((1, 8192, 12, 12, 64), 512, False, True),
                                    ((2, 320, 8, 2, 128), 64, False, True),
                                    ((4, 2048, 12, 12, 64), 512, True, True),
                                    ((2, 320, 8, 2, 128), 64, True, False)):
        check_k18_graph_replay(shape, bq, checked, lambda sh: qkv(*sh[:3], sh[4], hkv=sh[3]),
                               int8, causal)
    # Their fp32 bodies at K1's headline shape in fp32 (causal, K17 at
    # unroll 4, K18 at block_q 512): checked, the plain version timed once,
    # the kernel by the fit beside SDPA on the same fp32 inputs; the bound
    # counts fp32 bytes and bf16 products (the bodies convert on load).
    b, s, h, d = K1_HEADLINE
    q, k, v = qkv(b, s, h, d, dtype=torch.float32)
    bound = card_bound(4.0 * d * h * attention_pairs(b, s, s, True), 4 * 4 * b * s * h * d,
                       torch.bfloat16)
    sdpa32 = _sdpa_fit_ms(b, s, h, h, d, True, EXPERIMENT_FIT, torch.float32)
    kw = dict(block_q=512, block_kv=512)
    for name, label, call, plain, n in (
            ("pfa_flash_pipelined_fp32", "K16 pipelined",
             lambda: ux.flash_unrolled(q, k, v, causal=True, **kw),
             lambda: ux.flash_unrolled_plain(q, k, v, causal=True, **kw), 1),
            ("pfa_flash_chunked_fp32", "K17 chunked unroll 4",
             lambda: ux.flash_chunked(q, k, v, causal=True, unroll=4, **kw),
             lambda: ux.flash_chunked_plain(q, k, v, causal=True, unroll=4, **kw), 1),
            ("pfa_flash_tri_fp32", "K18 triangular bq=512",
             lambda: ux.flash_triangular(q, k, v, **kw),
             lambda: ux.flash_triangular_plain(q, k, v, **kw), s // 512),
            ("pfa_flash_fulltri_fp32", "K19 full triangle",
             lambda: ux.flash_fulltri(q, k, v, **kw),
             lambda: ux.flash_fulltri_plain(q, k, v, **kw), 1)):
        _experiment_case(name, f"{label} B{b} S{s} H{h} D{d} float32 causal", call, plain,
                         checked, timed=True, launches=(name, n))
        ms = fit_seconds(call, EXPERIMENT_FIT, torch.device("cuda")) * 1e3
        checked[name].update(ms=ms, library_ms=sdpa32, shape=list(K1_HEADLINE), **bound)
        print(f"experiments: {label} fp32 (mma.sync body) B{b} S{s} H{h} D{d} causal: {ms:.4f} "
              f"ms (graph fit); SDPA fp32 {sdpa32:.4f} ms; bound {bound['bound_ms']:.4f} ms "
              f"({bound['bound_by']}), {100 * bound['bound_ms'] / ms:.2f} % of it", flush=True)
    # K18's int8 mode with an fp32 V (the mma.sync body) there: checked, the
    # plain version timed once, the kernel alone on payloads quantized once
    # by the fit; no library call; the bound of int8 Q.K and bf16 P.V
    # products over int8 Q/K, fp32 V and the fp32 output.
    name = "pfa_flash_tri_i8_fp32"
    _experiment_case(name, f"K18 int8-QK bq=512 B{b} S{s} H{h} D{d} float32 V causal",
                     lambda: ux.flash_tri_i8(q, k, v, causal=True, **kw),
                     lambda: ux.flash_tri_i8_plain(q, k, v, causal=True, **kw), checked,
                     timed=True, launches=(name, s // 512))
    q8, k8, sc = ux.quant_qk(q, k)
    ms = fit_seconds(lambda: ux._tri_i8_payloads(q8, k8, sc, v, 512, 512, True), EXPERIMENT_FIT,
                     torch.device("cuda")) * 1e3
    bound = quant_bound(q, k, True, torch.int8, torch.bfloat16, 4, v_elt=4, out_elt=4)
    checked[name].update(ms=ms, library_ms=None, shape=list(K1_HEADLINE), **bound)
    print(f"experiments: K18 int8-QK fp32 V (mma.sync body) B{b} S{s} H{h} D{d} causal, the "
          f"kernel alone: {ms:.4f} ms (graph fit); no library call; bound "
          f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}), {100 * bound['bound_ms'] / ms:.2f} "
          f"% of it", flush=True)
    del q8, k8
    # The segmented main's long geometries, and K1 there (its reference): the
    # last LONG_CHECK_ROWS rows, which span several interior segments and
    # merges, against K1's plain version on those rows and every key.
    tail = slice(-LONG_CHECK_ROWS, None)
    for b, s, h, d in (shape for _, shape in ux.SEG_CASES):
        q, k, v = qkv(b, s, h, d)
        n_kv = s // ux.SEG_BLOCK
        n_seg = sum(len(ux.segments(i, n_kv, ux.SEG_TILES, True)) for i in range(n_kv))
        _experiment_case("segmented", f"segmented on K1 seg_tiles {ux.SEG_TILES} B{b} S{s} H{h} "
                         f"D{d} causal, its last {LONG_CHECK_ROWS} rows",
                         lambda: ux.flash_segmented(q, k, v, causal=True, seg_tiles=ux.SEG_TILES,
                                                    block_q=ux.SEG_BLOCK,
                                                    block_kv=ux.SEG_BLOCK)[:, tail],
                         lambda: flash_ops.flash_attention_with_lse_plain(
                             q[:, tail], k, v, causal=True)[0], checked,
                         launches=("pfa_flash_fwd", n_seg))
        _experiment_case("pfa_flash_fwd", f"K1 B{b} S{s} H{h} D{d} causal, its last "
                         f"{LONG_CHECK_ROWS} rows",
                         lambda: flash_ops.flash_attention(q, k, v, causal=True)[:, tail],
                         lambda: flash_ops.flash_attention_plain(q[:, tail], k, v, causal=True),
                         checked, launches=("pfa_flash_fwd", 1))
    # The int8 main's reference, K1's int8-QK mode, at its geometries: the
    # whole call against the plain version on the same payloads, batch 0.
    for _, (b, s, h, hkv, d), causal in ux.I8_CASES:
        q, k, v = qkv(b, s, h, d, hkv=hkv)
        q8, k8, sc = ux.quant_qk(q, k)
        _experiment_case("pfa_flash_fwd_int8qk", f"K1 int8-QK B{b} S{s} H{h}/{hkv} D{d} "
                         f"causal={causal}, batch 0",
                         lambda: fp8_ops.flash_attention_int8qk(q, k, v, causal=causal)[:1],
                         lambda: flash_ops.flash_attention_qk_quant_plain(
                             q8[:1], k8[:1], v[:1], sc, causal=causal, out_dtype=v.dtype),
                         checked, launches=("pfa_flash_fwd_int8qk", 1))
    # K20 (dq, once a row-block) and K21 (dk, dv, once a key block: bf16 on
    # K5's and K4's Hopper bodies, fp32 on the mma.sync bodies under their
    # own counters) through their wrappers on one di: at bx.CARD_CHECKS
    # causal and not, and at every geometry and block of their main. K21's
    # two outputs are compared stacked. At K1's headline shape K20's dq
    # must be K5's bit for bit (each row sees K5's key tiles in its order).
    bwd_cases = ([(shape, dtype, blocks, causal) for shape, dtype, blocks in bx.CARD_CHECKS
                  for causal in both]
                 + [(shape, torch.bfloat16, bx.BLOCKS, causal) for _, shape, causal in bx.CASES])
    for (b, s, h, d), dtype, blocks, causal in bwd_cases:
        q, k, v, do = (torch.randn(b, s, h, d, device="cuda", generator=gen).to(dtype)
                       for _ in range(4))
        o, lse = flash_ops.flash_attention_with_lse(q, k, v, causal=causal)
        q, k, v, o, do = (t.transpose(1, 2).contiguous() for t in (q, k, v, o, do))
        di = bx.flash_bwd_di(o, do)
        for bq, bkv in blocks:
            kw = dict(sm_scale=d ** -0.5, causal=causal, block_q=bq, block_kv=bkv)
            geom = f"B{b} S{s} H{h} D{d} {str(dtype)[6:]} bq={bq} bkv={bkv} causal={causal}"
            headline = (b, s, h, d) == K1_HEADLINE and causal and (bq, bkv) == bx.HEADLINE[1]
            name = route("pfa_flash_bwd_dq_rowblock", dtype)
            _experiment_case(name, f"K20 dq {geom}",
                             lambda: bx.dq_rowblocks(q, k, v, do, lse, di, **kw),
                             lambda: bx.dq_rowblocks_plain(q, k, v, do, lse, di, **kw), checked,
                             timed=headline, launches=(name, s // bq))
            if headline:  # K20 on K5's di (K5 computes it in its prologue)
                t = lambda x: x.transpose(1, 2).contiguous()  # noqa: E731
                k5, di5 = bwd_ops.flash_bwd_dq(t(q), t(k), t(v), t(o), lse, t(do),
                                               sm_scale=d ** -0.5, causal=True)
                k20 = bx.dq_rowblocks(q, k, v, do, lse, di5, **kw)
                gap = max_abs_err(k20, t(k5))
                line = f"K20 dq {geom}: max abs {gap:.3e} from K5's dq on the same inputs"
                if gap != 0.0:
                    raise AssertionError(line + ", not 0")
                print(line, flush=True)
            name = route("pfa_flash_bwd_dkv_colblock", dtype)
            _experiment_case(name, f"K21 dk, dv {geom}",
                             lambda: torch.stack(bx.dkv_colblocks(q, k, v, do, lse, di, **kw)),
                             lambda: torch.stack(bx.dkv_colblocks_plain(q, k, v, do, lse, di,
                                                                        **kw)),
                             checked, timed=headline, launches=(name, s // bkv))
    check_unrolled_graph_replays(checked, gen)
    # K20's and K21's fp32 inputs (the mma.sync bodies) at K1's headline
    # shape in fp32, blocks 512: checked, the plain version timed once, the
    # kernel by the fit beside SDPA's backward on the same fp32 inputs (CUDA
    # events); the bound counts fp32 bytes and bf16 products (the bodies
    # convert on load): K20 reads q, k, v, dO, lse and di and writes dq
    # (6 D a pair), K21 reads the same and writes dk and dv (8 D a pair).
    b, s, h, d = K1_HEADLINE
    q, k, v, do = (torch.randn(b, s, h, d, device="cuda", generator=gen) for _ in range(4))
    o, lse = flash_ops.flash_attention_with_lse(q, k, v, causal=True)
    lib32 = sdpa_bwd_ms(q, k, v, do)
    q, k, v, o, do = (t.transpose(1, 2).contiguous() for t in (q, k, v, o, do))
    di = bx.flash_bwd_di(o, do)
    kw = dict(sm_scale=d ** -0.5, causal=True, block_q=512, block_kv=512)
    pairs = attention_pairs(b, s, s, True)
    for name, label, call, plain, ops, tensors in (
            ("pfa_flash_bwd_dq_rowblock_fp32", "K20 dq",
             lambda: bx.dq_rowblocks(q, k, v, do, lse, di, **kw),
             lambda: bx.dq_rowblocks_plain(q, k, v, do, lse, di, **kw), 6.0, 5),
            ("pfa_flash_bwd_dkv_colblock_fp32", "K21 dk, dv",
             lambda: torch.stack(bx.dkv_colblocks(q, k, v, do, lse, di, **kw)),
             lambda: torch.stack(bx.dkv_colblocks_plain(q, k, v, do, lse, di, **kw)), 8.0, 6)):
        _experiment_case(name, f"{label} B{b} S{s} H{h} D{d} float32 bq=512 bkv=512 causal",
                         call, plain, checked, timed=True, launches=(name, s // 512))
        ms = fit_seconds(call, EXPERIMENT_FIT, torch.device("cuda")) * 1e3
        bound = card_bound(ops * d * h * pairs, 4 * (tensors * b * s * h * d + 2 * b * h * s),
                           torch.bfloat16)
        checked[name].update(ms=ms, library_ms=lib32, shape=list(K1_HEADLINE), **bound)
        print(f"experiments: {label} fp32 (mma.sync body) B{b} S{s} H{h} D{d} blocks 512 causal: "
              f"{ms:.4f} ms (graph fit); SDPA backward fp32 (dq, dk, dv; CUDA events) "
              f"{lib32:.4f} ms; bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}), "
              f"{100 * bound['bound_ms'] / ms:.2f} % of it", flush=True)
    for name in ("pfa_flash_fwd", "pfa_flash_fwd_int8qk"):
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"],
                                           checked[name]["max_abs_err"])
    del q, k, v, o, lse, do, di
    torch.cuda.empty_cache()
    print(f"experiments: checks against the plain versions in "
          f"{time.perf_counter() - t_checks:.2f} s", flush=True)
    return checked


def check_graph_replay(name: str, label: str, call, plain, n_calls: int, checked: dict,
                       inputs, fresh) -> None:
    """``call`` (n_calls calls of kernel counter ``name``) captured into a
    CUDA graph after a warm-up outside the capture, replayed twice on new
    inputs (``fresh()`` copied into ``inputs``), its output read by the
    stream's next kernel before any synchronisation; each replay against
    ``plain`` within EXPERIMENT_BOUND."""
    call()  # warm up outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = _build.CAPTURED[name]
    with torch.cuda.graph(graph):
        out = call()
    if _build.CAPTURED[name] - before != n_calls:
        raise AssertionError(f"{label} graph: {_build.CAPTURED[name] - before} calls "
                             f"captured, not {n_calls}")
    for i in range(2):
        for t, new in zip(inputs, fresh()):
            t.copy_(new)
        _experiment_case(name, f"{label}, captured in a CUDA graph, replay {i + 1}",
                         lambda: (graph.replay(), out.float() * 1.0)[1],
                         lambda: plain().float(), checked)
    del graph


def check_k15_graph_replay(nchain: int, checked: dict, make_qkv) -> None:
    """One K15 call at B4 S2048 H12 D64 (S cut by ``px.pair_case``) through
    check_graph_replay."""
    from photonic_flash_attention_tpu_torch.experiments import flash_pair_experiment as px

    s, blk = px.pair_case(2048, nchain)
    shape = (4, s, 12, 64)
    q, k, v = make_qkv(shape)
    kw = dict(bq=blk, bkv=blk, nchain=nchain)
    check_graph_replay("pfa_flash_pair", f"K15 pair nchain {nchain} B4 S{s} H12 D64 causal",
                       lambda: px.flash_pair(q, k, v, **kw),
                       lambda: px.flash_pair_plain(q, k, v, **kw), 1, checked, (q, k, v),
                       lambda: make_qkv(shape))


def check_k13_graph_replay(fast: bool, checked: dict, make_qkv) -> None:
    """One K13 call at K1's headline shape, causal, in either exp mode,
    through check_graph_replay."""
    from photonic_flash_attention_tpu_torch.experiments import flash_fixedmax_experiment as fx

    q, k, v = make_qkv(K1_HEADLINE)
    kw = dict(causal=True, block_q=512, block_kv=512, fast_exp=fast)
    b, s, h, d = K1_HEADLINE
    check_graph_replay("pfa_flash_fixedmax_fast" if fast else "pfa_flash_fixedmax",
                       f"K13 fixedmax{' fast_exp' if fast else ''} B{b} S{s} H{h} D{d} causal",
                       lambda: fx.flash_fixedmax(q, k, v, **kw),
                       lambda: fx.flash_fixedmax_plain(q, k, v, **kw), 1, checked, (q, k, v),
                       lambda: make_qkv(K1_HEADLINE))


def check_unrolled_graph_replays(checked: dict, gen) -> None:
    """One K20 and one K21 call in bf16 at K1's headline shape, causal,
    blocks 512 (4 launches each, each after the first a programmatic
    dependent launch), on inputs from K1's forward, through
    check_graph_replay."""
    from photonic_flash_attention_tpu_torch.experiments import flash_bwd_unrolled_experiment as bx

    b, s, h, d = K1_HEADLINE
    kw = dict(sm_scale=d ** -0.5, causal=True, block_q=512, block_kv=512)

    def fresh():
        q, k, v, do = (torch.randn(b, s, h, d, device="cuda", generator=gen).to(torch.bfloat16)
                       for _ in range(4))
        o, lse = flash_ops.flash_attention_with_lse(q, k, v, causal=True)
        q, k, v, o, do = (t.transpose(1, 2).contiguous() for t in (q, k, v, o, do))
        return q, k, v, do, lse, bx.flash_bwd_di(o, do)

    inputs = fresh()
    check_graph_replay("pfa_flash_bwd_dq_rowblock",
                       f"K20 dq B{b} S{s} H{h} D{d} bfloat16 bq=512 causal",
                       lambda: bx.dq_rowblocks(*inputs, **kw),
                       lambda: bx.dq_rowblocks_plain(*inputs, **kw), s // 512,
                       checked, inputs, fresh)
    check_graph_replay("pfa_flash_bwd_dkv_colblock",
                       f"K21 dk, dv B{b} S{s} H{h} D{d} bfloat16 bkv=512 causal",
                       lambda: torch.stack(bx.dkv_colblocks(*inputs, **kw)),
                       lambda: torch.stack(bx.dkv_colblocks_plain(*inputs, **kw)), s // 512,
                       checked, inputs, fresh)


def check_k18_graph_replay(shape, block_q: int, checked: dict, make_qkv, int8: bool = False,
                           causal: bool = True) -> None:
    """One K18 call in bf16 (B, S, Hq, Hkv, D) at ``block_q`` (one launch a
    row-block, each after the first a programmatic dependent launch; with
    ``int8`` its int8-QK mode, its quantization passes first, causal or
    not) through check_graph_replay."""
    from photonic_flash_attention_tpu_torch.experiments import flash_pipeline_experiment as ux

    b, s, hq, hkv, d = shape
    q, k, v = make_qkv(shape)
    kw = dict(block_q=block_q, block_kv=block_q)
    if int8:
        kw["causal"] = causal
        name, label = "pfa_flash_tri_i8", "K18 int8-QK"
        call, plain = ux.flash_tri_i8, ux.flash_tri_i8_plain
    else:
        name, label = "pfa_flash_tri", "K18 triangular"
        call, plain = ux.flash_triangular, ux.flash_triangular_plain
    check_graph_replay(name, f"{label} bq={block_q} B{b} S{s} H{hq}/{hkv} D{d} bfloat16 "
                       f"causal={causal}", lambda: call(q, k, v, **kw),
                       lambda: plain(q, k, v, **kw), s // block_q, checked, (q, k, v),
                       lambda: make_qkv(shape))


def _sdpa_fit_ms(b, s, hq, hkv, d, causal, fit, dtype=torch.bfloat16) -> float:
    """One F.scaled_dot_product_attention call at the geometry (GQA through
    ``enable_gqa``) in ``dtype``, timed by the experiments' fit."""
    import torch.nn.functional as F

    from photonic_flash_attention_tpu_torch.core.timing import fit_seconds

    q = torch.randn(b, hq, s, d, device="cuda", dtype=dtype)
    k, v = (torch.randn(b, hkv, s, d, device="cuda", dtype=dtype) for _ in range(2))
    return fit_seconds(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                              enable_gqa=hq != hkv),
                       fit, torch.device("cuda")) * 1e3


def time_exp_table(smi: str) -> list:
    """The exp table: K16 over the pipeline module's CASES, K17 at unroll 2
    and 4 over its CHUNKED_CASES, K18 over its TRI_CASES at each block_q of
    TRI_BLOCKS that divides S, with that block_q's first block_kv (a call:
    S / block_q launches; the bf16 body reads no block_kv) and K19 over
    its FULLTRI_CASES (the mains' geometries and blocks, bf16), each by the
    graph fit (2, 10) beside K1 bf16 (``flash_attention``) and SDPA at the
    same geometry, also by the fit, the bound (``flash_fwd_bound``) and the
    kernel's share of it, and its output against K1's on the same inputs,
    within EXPERIMENT_BOUND. The rows use public calls only, so
    ``--exp-table`` in a copy of this script times another tree of the
    repository (the parent commit, or a copy with a lever of the kernels
    changed). K14 and K15 (each nchain its tree's ``CARD_NCHAINS`` holds, S cut
    by the pair module's ``pair_case`` where nchain does not divide it) come
    first, over the aug and pair modules' CASES, causal. K13 in both exp
    modes (the kernel alone, ``fixedmax_kernel``, its bound precomputed)
    joins them over the fixed-max module's CASES, its fast_exp rows held to
    K1 within FAST_EXP_ORACLE_BOUND. Then K18's int8-QK mode, the kernel
    alone, beside K1's int8-QK kernel (``time_i8_rows``), and K20, K21 and
    the unrolled backward's whole call (``time_unrolled_rows``)."""
    from photonic_flash_attention_tpu_torch.experiments import flash_aug_experiment as ax
    from photonic_flash_attention_tpu_torch.experiments import flash_fixedmax_experiment as fx
    from photonic_flash_attention_tpu_torch.experiments import flash_pair_experiment as px
    from photonic_flash_attention_tpu_torch.experiments import flash_pipeline_experiment as ux

    gen = torch.Generator(device="cuda").manual_seed(29)
    fit = lambda fn: fit_seconds(fn, EXPERIMENT_FIT, torch.device("cuda")) * 1e3  # noqa: E731
    # trees before K15's Hopper body take nchain 1 and 2, which divide CASES' S
    pair_case = getattr(px, "pair_case", lambda s, n: (s, min(512, s)))
    tri_blocks = {}
    for bq, bkv in ux.TRI_BLOCKS:
        tri_blocks.setdefault(bq, bkv)
    cases = ([(f"K13{' fast_exp' if fast else ''}", name, (b, s, h, h, d), causal, fast)
              for name, (b, s, h, d), causal in fx.CASES for fast in (False, True)]
             + [("K14", f"B{b} S{s}", (b, s, h, h, d), True, None) for b, s, h, d in ax.CASES]
             + [(f"K15 nchain {n}", f"B{b} S{pair_case(s, n)[0]}",
                 (b, pair_case(s, n)[0], h, h, d), True, (n, pair_case(s, n)[1]))
                for b, s, h, d in px.CASES for n in px.CARD_NCHAINS]
             + [("K16", name, shape, causal, None) for name, shape, causal in ux.CASES]
             + [(f"K17 unroll {u}", name, shape, causal, u)
                for name, shape, causal in ux.CHUNKED_CASES for u in ux.CARD_UNROLLS]
             + [(f"K18 bq={bq} bkv={bkv}", name, shape, True, (bq, bkv))
                for name, shape in ux.TRI_CASES for bq, bkv in tri_blocks.items()
                if shape[1] % bq == 0 and shape[1] % bkv == 0]
             + [("K19", name, shape, True, None) for name, shape in ux.FULLTRI_CASES])
    # one geometry's rows together: its inputs, K1 and SDPA made once
    order = list(dict.fromkeys((c[2], c[3]) for c in cases))
    cases.sort(key=lambda c: order.index((c[2], c[3])))
    table, k1, inputs = [], {}, {}
    for kernel, name, (b, s, hq, hkv, d), causal, arg in cases:
        key = ((b, s, hq, hkv, d), causal)
        if key not in inputs:
            inputs.clear()
            torch.cuda.empty_cache()
            q = torch.randn(b, s, hq, d, device="cuda", generator=gen).to(torch.bfloat16)
            k, v = (torch.randn(b, s, hkv, d, device="cuda", generator=gen).to(torch.bfloat16)
                    for _ in range(2))
            ref = flash_ops.flash_attention(q, k, v, causal=causal)
            k1[key] = (fit(lambda: flash_ops.flash_attention(q, k, v, causal=causal)),
                       _sdpa_fit_ms(b, s, hq, hkv, d, causal, EXPERIMENT_FIT))
            inputs[key] = (q, k, v, ref)
        q, k, v, ref = inputs[key]
        blk = min(512, s)
        bound_err = EXPERIMENT_BOUND
        if kernel.startswith("K13"):
            fm = fx.fixed_max_bound(q, k, d ** -0.5)
            call = lambda: fx.fixedmax_kernel(q, k, v, fm, causal=causal,  # noqa: E731
                                              sm_scale=d ** -0.5, fast_exp=arg)
            bound_err = FAST_EXP_ORACLE_BOUND if arg else EXPERIMENT_BOUND
        elif kernel == "K14":
            call = lambda: ax.flash_aug(q, k, v, bq=blk, bkv=blk)  # noqa: E731
        elif kernel.startswith("K15"):
            call = lambda: px.flash_pair(q, k, v, bq=arg[1], bkv=arg[1],  # noqa: E731
                                         nchain=arg[0])
        elif kernel == "K16":
            call = lambda: ux.flash_unrolled(q, k, v, causal=causal, block_q=blk,  # noqa: E731
                                             block_kv=blk)
        elif kernel.startswith("K17"):
            call = lambda: ux.flash_chunked(q, k, v, causal=causal, block_q=blk,  # noqa: E731
                                            block_kv=blk, unroll=arg)
        elif kernel.startswith("K18"):
            call = lambda: ux.flash_triangular(q, k, v, block_q=arg[0],  # noqa: E731
                                               block_kv=arg[1])
        else:
            call = lambda: ux.flash_fulltri(q, k, v, block_q=blk, block_kv=blk)  # noqa: E731
        err = rel_err_norm(call(), ref)
        ms = fit(call)
        k1_ms, sdpa = k1[key]
        meta_q = torch.empty(b, s, hq, d, device="meta", dtype=torch.bfloat16)
        meta_k = torch.empty(b, s, hkv, d, device="meta", dtype=torch.bfloat16)
        bnd = flash_fwd_bound(meta_q, meta_k, causal)
        row = dict(kernel=kernel, case=name, shape=[b, s, hq, hkv, d], causal=causal, fit_ms=ms,
                   k1_fit_ms=k1_ms, sdpa_fit_ms=sdpa, rel_err_k1=err, **bnd)
        line = (f"exp table: {kernel} {name} (B{b} S{s} H{hq}/{hkv} D{d} causal={causal}): "
                f"{ms:.4f} ms (graph fit); K1 bf16 {k1_ms:.4f} ms, SDPA {sdpa:.4f} ms; "
                f"kernel / K1 {ms / k1_ms:.3f}, kernel / SDPA {ms / sdpa:.3f}; bound "
                f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}), kernel at "
                f"{100 * bnd['bound_ms'] / ms:.2f} % of it; vs K1 rel_err_norm {err:.3e} ({smi})")
        print(line, flush=True)
        if not err <= bound_err:
            raise AssertionError(line)
        table.append(row)
    inputs.clear()
    torch.cuda.empty_cache()
    return table + time_i8_rows(smi) + time_unrolled_rows(smi)


def time_i8_rows(smi: str) -> list:
    """K18's int8-QK mode over the int8 main's I8_CASES at block_q 512 (S /
    512 launches), the kernel alone on payloads quantized once
    (``_tri_i8_payloads``, bf16 V), by the graph fit (2, 10) beside K1's
    int8-QK kernel alone on the same payloads (``flash_attention_qk_quant``),
    the bound (``quant_bound``) and each one's share of it; its output
    against K1's int8-QK kernel's within EXPERIMENT_BOUND. Calls both trees
    hold, so a copy of this script times another tree."""
    from photonic_flash_attention_tpu_torch.experiments import flash_pipeline_experiment as ux

    gen = torch.Generator(device="cuda").manual_seed(31)
    fit = lambda fn: fit_seconds(fn, EXPERIMENT_FIT, torch.device("cuda")) * 1e3  # noqa: E731
    table = []
    for name, (b, s, hq, hkv, d), causal in ux.I8_CASES:
        torch.cuda.empty_cache()
        q = torch.randn(b, s, hq, d, device="cuda", generator=gen).to(torch.bfloat16)
        k, v = (torch.randn(b, s, hkv, d, device="cuda", generator=gen).to(torch.bfloat16)
                for _ in range(2))
        q8, k8, sc = ux.quant_qk(q, k)
        bq = min(512, s)
        call = lambda: ux._tri_i8_payloads(q8, k8, sc, v, bq, bq, causal)  # noqa: E731
        k1 = lambda: flash_ops.flash_attention_qk_quant(  # noqa: E731
            q8, k8, v, sc, causal=causal, out_dtype=v.dtype)
        err = rel_err_norm(call(), k1())
        ms, k1_ms = fit(call), fit(k1)
        bnd = quant_bound(q, k, causal, torch.int8, torch.bfloat16, 4)
        row = dict(kernel="K18 int8-QK", case=name, shape=[b, s, hq, hkv, d], causal=causal,
                   fit_ms=ms, k1_int8qk_fit_ms=k1_ms, rel_err_k1=err, **bnd)
        line = (f"exp table: K18 int8-QK bq={bq} {name} (B{b} S{s} H{hq}/{hkv} D{d} "
                f"causal={causal}), the kernel alone: {ms:.4f} ms (graph fit); K1 int8-QK kernel "
                f"alone {k1_ms:.4f} ms; kernel / K1 int8-QK {ms / k1_ms:.3f}; bound "
                f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}), kernel at "
                f"{100 * bnd['bound_ms'] / ms:.2f} %, K1 int8-QK at "
                f"{100 * bnd['bound_ms'] / k1_ms:.2f} % of it; vs K1 int8-QK rel_err_norm "
                f"{err:.3e} ({smi})")
        print(line, flush=True)
        if not err <= EXPERIMENT_BOUND:
            raise AssertionError(line)
        table.append(row)
    return table


def time_probe_table(smi: str) -> None:
    """The probe table: K12 in both modes at iters 512 over 512-column rows,
    one wave of this tree's occupancy and a fixed PROBE_TABLE_ROWS (so that
    two trees of different occupancy compare at one size), by graph_ms, in
    ms and elements/s beside its bound (``softmax_bound``); K12's SASS
    instructions a value besides MUFU.EX2 (``k12_sass_counts``); then the
    rates of the measure functions (read, exp, the stream's linear fit) and
    K1's share of the composite ceiling they build at its headline shape,
    K1 by the graph fit (2, 10). Calls both trees hold, so a copy of this
    script times another tree."""
    from photonic_flash_attention_tpu_torch.hardware import roofline as rl
    from photonic_flash_attention_tpu_torch.ops import device_probes as dp
    from photonic_flash_attention_tpu_torch.ops import hbm_bw

    peak = card_rates()
    for m in (True, False):
        mode = "masked" if m else "unmasked"
        wave = dp.wave_rows("softmax", 512, m)
        for rows, what in ((wave, "one wave"), (PROBE_TABLE_ROWS, "fixed rows")):
            x = dp.probe_input(rows, 512, "cuda")
            ms = graph_ms(lambda: dp.softmax_block_probe(x, SOFTMAX_ITERS, m))
            bound = softmax_bound(rows, 512, SOFTMAX_ITERS, m, peak)
            elems = rows * 512 * SOFTMAX_ITERS
            print(f"probe table: K12 {mode} [{rows}, 512] ({what}) iters {SOFTMAX_ITERS}: "
                  f"{ms:.4f} ms, {elems / ms / 1e6:.1f} Gelem/s; bound {bound['bound_ms']:.4f} ms, "
                  f"kernel at {100 * bound['bound_ms'] / ms:.2f} % of it ({smi})", flush=True)
            del x
    for (cols, masked), (per_value, updates) in sorted(k12_sass_counts(_build.library_path()).items()):
        print(f"probe table: K12 SASS {cols} columns {'masked' if masked else 'unmasked'}: "
              f"{per_value:.2f} instructions a value besides MUFU.EX2 ({updates:g} update(s) in "
              f"the loop body)", flush=True)
    rates = {"hbm_read_Bps": hbm_bw.hbm_read_bytes_per_s(),
             "vpu_exp_elems_per_s": dp.measure_exp_rate()}
    linear = dp.measure_softmax_linear(fit=(20, 120))
    rates.update(vpu_softmax_elems_per_s=linear["asymptotic_elems_per_s"],
                 vpu_softmax_fixed_s_per_tile=linear["fixed_s_per_tile"])
    b, s, h, d = K1_HEADLINE
    q, k, v = (torch.randn(b, s, h, d, device="cuda").to(torch.bfloat16) for _ in range(3))
    k1_ms = fit_seconds(lambda: flash_ops.flash_attention(q, k, v, causal=True), K1_TABLE_FIT,
                        torch.device("cuda")) * 1e3
    ceiling = rl.attention_composite_ceiling(b, s, s, h, d, causal=True, rates=rates)
    print(f"probe table: K1 B{b} S{s} H{h} D{d} causal bf16 {k1_ms:.4f} ms (graph fit) = "
          f"{100 * rl.composite_fraction(k1_ms * 1e3, ceiling):.2f} % of the composite ceiling "
          f"{ceiling}; rates {rates} ({smi})", flush=True)


def time_unrolled_rows(smi: str) -> list:
    """The unrolled backward over its CASES by the graph fit (2, 10): K20
    (``dq_rowblocks``, a launch a row-block) at each block_q of its BLOCKS
    beside K5 alone (``flash_bwd_dq``: all rows in one launch, di in its
    prologue, whose di K20, K21 and K4 take here), K21
    (``dkv_colblocks``, a launch a key block) at each block_kv beside K4
    alone, and the whole call (``flash_bwd_unrolled``: di, K20 and K21) at
    each of its BLOCKS beside K4 + K5 (``flash_attention_bwd``); each beside
    SDPA's backward (dq, dk, dv; its autograd node replayed from a graph) on
    the same inputs (o and lse from K1's forward), its bound (``bwd_bounds``'
    dq or dk/dv, ``bwd_call_bound``) and its share of it. K20's dq must
    hold to K5's and K21's dk, dv to K4's within EXPERIMENT_BOUND (K20's max
    abs from K5's printed: 0 where each row sees K5's key tiles). Where the
    tree has them (``_k20_launches``), K20's levers are timed beside it:
    the other launch order and the chaining off. Public calls otherwise, so
    a copy of this script times another tree of the repository."""
    from photonic_flash_attention_tpu_torch.experiments import flash_bwd_unrolled_experiment as bx

    gen = torch.Generator(device="cuda").manual_seed(30)
    fit = lambda fn: fit_seconds(fn, EXPERIMENT_FIT, torch.device("cuda")) * 1e3  # noqa: E731
    levers = hasattr(bx, "_k20_launches")
    table = []
    for name, (b, s, h, d), causal in bx.CASES:
        torch.cuda.empty_cache()
        qs, ks, vs, dos = (torch.randn(b, s, h, d, device="cuda", generator=gen)
                           .to(torch.bfloat16) for _ in range(4))
        os_, lse = flash_ops.flash_attention_with_lse(qs, ks, vs, causal=causal)
        q, k, v, o, do = (t.transpose(1, 2).contiguous() for t in (qs, ks, vs, os_, dos))
        sm = d ** -0.5
        kw45 = dict(sm_scale=sm, causal=causal)
        k5 = lambda: bwd_ops.flash_bwd_dq(qs, ks, vs, os_, lse, dos, **kw45)  # noqa: E731
        ref_dq, di = k5()  # K5's di (its prologue's) for K4, K20 and K21
        ref_dq = ref_dq.transpose(1, 2)
        k4 = lambda: bwd_ops.flash_bwd_dkv(qs, ks, vs, dos, lse, di, **kw45)  # noqa: E731
        k45 = lambda: bwd_ops.flash_attention_bwd(qs, ks, vs, os_, lse, dos, **kw45)  # noqa: E731
        ref_dkv = torch.stack([t.transpose(1, 2) for t in k4()])
        yard = {"K20": ("K5 alone", fit(k5)), "K21": ("K4 alone", fit(k4)),
                "call": ("K4 + K5", fit(k45))}
        sdpa_bwd = fit(_sdpa_bwd_calls(qs, ks, vs, dos, is_causal=causal)[1])
        meta = torch.empty(b, s, h, d, device="meta", dtype=torch.bfloat16)
        bnd_dkv, bnd_dq = bwd_bounds(meta, meta, causal)
        bounds = {"K20": bnd_dq, "K21": bnd_dkv, "call": bwd_call_bound(meta, causal)}
        rows = ([("K20", f"bq={bq}", (bq, bq), s // bq) for bq in dict.fromkeys(
                    bq for bq, _ in bx.BLOCKS)]
                + [("K21", f"bkv={bkv}", (bkv, bkv), s // bkv) for bkv in dict.fromkeys(
                    bkv for _, bkv in bx.BLOCKS)]
                + [("call", f"bq={bq} bkv={bkv}", (bq, bkv), f"{s // bq} + {s // bkv}")
                   for bq, bkv in bx.BLOCKS])
        for kernel, blocks, (bq, bkv), launches in rows:
            if s % bq or s % bkv:
                continue
            kw = dict(sm_scale=sm, causal=causal, block_q=bq, block_kv=bkv)
            extra, levers_ms = "", {}
            if kernel == "K20":
                call = lambda: bx.dq_rowblocks(q, k, v, do, lse, di, **kw)  # noqa: E731
                out = call()
                err, gap = rel_err_norm(out, ref_dq), max_abs_err(out, ref_dq)
                extra = f"; max abs from K5's dq {gap:.3e}"
                if levers:
                    dq = torch.empty_like(q)
                    shipped = bx.K20_DESCENDING
                    for label, desc, chained in (("other order", not shipped, True),
                                                 ("chaining off", shipped, False)):
                        lever = lambda: bx._k20_launches(  # noqa: E731
                            q, k, v, do, lse, di, dq, sm_scale=sm, causal=causal, block_q=bq,
                            descending=desc, chained=chained)
                        lever()
                        if not torch.equal(dq, out):
                            raise AssertionError(f"exp table: K20 {name} {blocks} {label}: dq "
                                                 f"differs from the shipped call's")
                        levers_ms[label] = fit(lever)
            elif kernel == "K21":
                call = lambda: bx.dkv_colblocks(q, k, v, do, lse, di, **kw)  # noqa: E731
                err = rel_err_norm(torch.stack(call()), ref_dkv)
            else:
                call = lambda: bx.flash_bwd_unrolled(q, k, v, o, lse, do, **kw)  # noqa: E731
                out = call()
                err = max(rel_err_norm(out[0], ref_dq), rel_err_norm(torch.stack(out[1:]),
                                                                     ref_dkv))
            ms = fit(call)
            yard_label, yard_ms = yard[kernel]
            bnd = bounds[kernel]
            table.append(dict(kernel=kernel, case=f"{name} {blocks}", shape=[b, s, h, h, d],
                              causal=causal, fit_ms=ms, yardstick=yard_label,
                              yardstick_fit_ms=yard_ms, sdpa_bwd_fit_ms=sdpa_bwd, rel_err=err,
                              launches=launches, levers_fit_ms=levers_ms, **bnd))
            lever_text = "".join(f"; {label} {t:.4f} ms ({t / ms:.3f} x)"
                                 for label, t in levers_ms.items())
            line = (f"exp table: {'K20 + K21 + di' if kernel == 'call' else kernel} {name} "
                    f"{blocks} (B{b} S{s} H{h} D{d} causal={causal}, {launches} launches): "
                    f"{ms:.4f} ms (graph fit){lever_text}; {yard_label} {yard_ms:.4f} ms, SDPA "
                    f"backward (dq, dk, dv) {sdpa_bwd:.4f} ms; kernel / {yard_label} "
                    f"{ms / yard_ms:.3f}, kernel / SDPA backward {ms / sdpa_bwd:.3f}; bound "
                    f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}), kernel at "
                    f"{100 * bnd['bound_ms'] / ms:.2f} % of it; vs K4/K5 rel_err_norm {err:.3e}"
                    f"{extra} ({smi})")
            print(line, flush=True)
            if not err <= EXPERIMENT_BOUND:
                raise AssertionError(line)
    torch.cuda.empty_cache()
    return table


#: K10's rings the copy table times beside the shipped one: (chunk bytes,
#: stages, CTAs a SM; 0: a CTA a chunk).
K10_RINGS = ((32768, 4, 1), (32768, 6, 1), (16384, 8, 1), (65536, 3, 1), (16384, 4, 2),
             (16384, 2, 0))


def time_k10_rows(smi: str, rounds: int = 3) -> list:
    """K10 (``hbm_copy``) at bench.py's copy shape (131072, 512) bf16 beside
    ``y.copy_(x)``, each by ``graph_ms`` (20 calls replayed from one CUDA
    graph) in ``rounds`` alternating rounds, with GB/s read + written and
    the bound; where the tree has ``k10_plan``, every ring and grid of
    K10_RINGS too (launched by ``_copy_into``, each
    copy checked bit for bit). Public calls otherwise, so a copy of this
    script times another tree's K10 (the parent's body)."""
    from photonic_flash_attention_tpu_torch.ops import hbm_bw

    x = torch.randn(hbm_bw.COPY_SHAPE, device="cuda").to(torch.bfloat16)
    y = torch.empty_like(x)
    nbytes = 2 * x.numel() * x.element_size()
    bound = card_bound(0, nbytes, torch.bfloat16)
    runs = {"K10": lambda: hbm_bw.hbm_copy(x), "y.copy_(x)": lambda: y.copy_(x)}
    if hasattr(hbm_bw, "k10_plan"):
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        for chunk, stages, per_sm in K10_RINGS:
            plan = hbm_bw.k10_plan(x.numel() * 2, sms * per_sm, chunk=chunk, stages=stages,
                                   persistent=per_sm > 0)
            y.zero_()
            hbm_bw._copy_into(x, y, plan)
            if not torch.equal(y, x):
                raise AssertionError(f"copy table: K10 ring {plan}: y != x")
            runs[f"K10 ring {chunk // 1024} KB x {stages}, {plan.grid} CTAs"] = (
                lambda plan=plan: hbm_bw._copy_into(x, y, plan))
    times = {label: [] for label in runs}
    for _ in range(rounds):
        for label, fn in runs.items():
            times[label].append(graph_ms(fn))
    table = []
    for label, ts in times.items():
        ms = statistics.median(ts)
        table.append(dict(kernel=label, shape=list(x.shape), ms=ms, rounds=ts, **bound))
        print(f"copy table: {label} {list(x.shape)} bf16: {ms:.4f} ms (median of {rounds} "
              f"graph_ms rounds: {', '.join(f'{t:.4f}' for t in ts)}), "
              f"{nbytes / ms / 1e6:.1f} GB/s read + written; bound {bound['bound_ms']:.4f} ms, "
              f"{100 * bound['bound_ms'] / ms:.2f} % of it ({smi})", flush=True)
    return table


def bwd_call_bound(q, causal: bool) -> dict:
    """The whole backward's bound (dq, dk, dv from q, k, v, o, dO and lse):
    K4's and K5's operations together, 14 D per (query, key) pair and head,
    over q, k, v, o, dO and lse read once and dq, dk, dv written once."""
    b, s, h, d = q.shape
    nbytes = q.element_size() * 8 * b * s * h * d + 4 * b * h * s
    return card_bound(14.0 * d * h * attention_pairs(b, s, s, causal), nbytes, q.dtype)


def _bwd_experiment_lines(table: dict, smi: str) -> None:
    """Each timed row of the backward's main: the unrolled call (and on the
    headline row K20 and K21 alone) beside K4 + K5 (K5, K4 alone) in the
    same run, SDPA's backward at the geometry (CUDA events: autograd's
    backward is not captured into a graph here) and the data-sheet bound
    (``bwd_call_bound``; ``bwd_bounds``' dq and dk/dv for K20 and K21);
    no composite ceiling, which has no backward form. Sets each row's
    ``sdpa_bwd_ms`` and ``bounds``."""
    sdpa_bwd = {}
    gen = torch.Generator(device="cuda").manual_seed(41)
    for row_name, row in table.items():
        if "shape" not in row:
            continue
        b, s, h, d = row["shape"]
        causal, (bq, bkv) = row["causal"], row["blocks"]
        if (row["shape"], causal) not in sdpa_bwd:
            q, k, v, do = (torch.randn(b, s, h, d, device="cuda", generator=gen,
                                       dtype=torch.bfloat16) for _ in range(4))
            sdpa_bwd[(row["shape"], causal)] = sdpa_bwd_ms(q, k, v, do, is_causal=causal)
            del q, k, v, do
        lib = row["sdpa_bwd_ms"] = sdpa_bwd[(row["shape"], causal)]
        meta = torch.empty(b, s, h, d, device="meta", dtype=torch.bfloat16)
        bnd_dkv, bnd_dq = bwd_bounds(meta, meta, causal)
        row["bounds"] = {"unrolled_ms": bwd_call_bound(meta, causal), "k20_ms": bnd_dq,
                         "k21_ms": bnd_dkv}
        pairs = attention_pairs(b, s, s, causal)
        n_q, n_kv = row["launches"]
        launches = {"unrolled_ms": f"{n_q} + {n_kv}", "k20_ms": f"{n_q}", "k21_ms": f"{n_kv}"}
        for key, label, ref_key, ref_label, ops in BWD_VARIANTS:
            if key not in row:
                continue
            ms, bound = row[key], row["bounds"][key]
            print(f"experiments: {label} B{b} S{s} H{h} D{d} causal={causal} bq={bq} bkv={bkv} "
                  f"(bwd_unrolled, {launches[key]} launches a call): {ms:.4f} ms, "
                  f"{ops * d * h * pairs / ms / 1e9:.1f} TFLOP/s; {ref_label} "
                  f"{row[ref_key]:.4f} ms in the same run, {ref_label}/variant "
                  f"{row[ref_key] / ms:.3f}; SDPA backward (dq, dk, dv; CUDA events, median of "
                  f"{TIMED_RUNS}) {lib:.4f} ms; {100 * bound['bound_ms'] / ms:.2f} % of the "
                  f"bound ({bound['bound_ms']:.4f} ms, {bound['bound_by']}) ({smi})", flush=True)


def phase_experiments(smi: str, rates: dict, checked: dict) -> tuple:
    """The experiments path, counted from 0: the four forward files' mains,
    the pipeline file's five others and the backward's main on the card
    (their parity checks, then each variant and K1, or K4 + K5, timed by
    the two-point graph fit at JAX's geometries). Then, per variant and geometry: its time and
    TFLOP/s, K1's time in the same run (K1's int8-QK mode for the int8
    variant) and the ratio, SDPA's (none for int8 Q.K), its share of the
    data-sheet bound (``flash_fwd_bound``, ``quant_bound`` for int8 Q.K) and
    of the composite ceiling from the roofline phase's measured ``rates``,
    and its rel_err_norm against the fp32 oracle on the mains' (1, 1024)
    slice ((1, 2048) segmented), which must stay within its bound; the
    segmented main's timed calls must have run K1 once per segment (the
    calls its graphs captured), and the backward main's graphs one K20 a
    row-block and one K21 a key block a call (its rows printed by
    ``_bwd_experiment_lines``). Returns K13-K21's
    kernels-line entries (the time from each main's row at K1's headline
    shape, beside ``checked``'s error and plain time), launches and
    captured calls."""
    from photonic_flash_attention_tpu_torch.experiments import flash_aug_experiment as ax
    from photonic_flash_attention_tpu_torch.experiments import flash_bwd_unrolled_experiment as bx
    from photonic_flash_attention_tpu_torch.experiments import flash_fixedmax_experiment as fx
    from photonic_flash_attention_tpu_torch.experiments import flash_pair_experiment as px
    from photonic_flash_attention_tpu_torch.experiments import flash_pipeline_experiment as ux
    from photonic_flash_attention_tpu_torch.hardware import roofline as rl

    t_phase = time.perf_counter()
    _build.reset_launches()
    rows = {}
    for name, fn in (("fixedmax", fx.main), ("aug", ax.main), ("pair", px.main),
                     ("pipeline", ux.main), *ux.VARIANTS.items(), ("bwd_unrolled", bx.main)):
        k1_before = _build.CAPTURED["pfa_flash_fwd"]
        rows[name] = fn("cuda", fit=EXPERIMENT_FIT)
        if name == "seg":
            seg_k1_captured = _build.CAPTURED["pfa_flash_fwd"] - k1_before
    torch.cuda.synchronize()
    launches, captured = dict(_build.LAUNCHES), dict(_build.CAPTURED)
    print(f"experiments: main path in {time.perf_counter() - t_phase:.2f} s; launches "
          f"{launches}; calls captured into CUDA graphs {captured}", flush=True)
    for name in EXPERIMENT_KERNELS:
        if not launches.get(name):
            raise AssertionError(f"experiments: {name} never launched by the experiments' mains")
    # Each seg row's fit captures sum(EXPERIMENT_FIT) calls of K1 alone and
    # as many segmented calls, each of them one K1 call a segment.
    n_segs = [sum(len(ux.segments(i, s // ux.SEG_BLOCK, ux.SEG_TILES, True))
                  for i in range(s // ux.SEG_BLOCK)) for _, (_, s, _, _) in ux.SEG_CASES]
    want = sum(EXPERIMENT_FIT) * sum(1 + n for n in n_segs)
    if seg_k1_captured != want:
        raise AssertionError(f"experiments: the segmented main's graphs captured "
                             f"{seg_k1_captured} K1 calls, not {want} (segments {n_segs})")
    print(f"experiments: the segmented main's graphs captured {seg_k1_captured} K1 calls: "
          f"{sum(EXPERIMENT_FIT)} fit calls of K1 alone and of the segmented call ({n_segs} "
          f"segments) per geometry", flush=True)
    # Each fit of the backward's main captures sum(EXPERIMENT_FIT) calls: of
    # the unrolled call on every row, and of K20 and K21 alone on the
    # headline row; a call is one K20 a row-block and one K21 a key block.
    bwd_rows = [r for r in rows["bwd_unrolled"].values() if "shape" in r]
    want = {name: sum(EXPERIMENT_FIT) * sum(r["launches"][i] * (1 + (alone in r))
                                            for r in bwd_rows)
            for i, (name, alone) in enumerate((("pfa_flash_bwd_dq_rowblock", "k20_ms"),
                                               ("pfa_flash_bwd_dkv_colblock", "k21_ms")))}
    got = {name: captured.get(name, 0) for name in want}
    if got != want:
        raise AssertionError(f"experiments: the backward main's graphs captured {got}, not "
                             f"{want}")
    print(f"experiments: the backward main's graphs captured {got}: one K20 a row-block and "
          f"one K21 a key block per call", flush=True)
    _bwd_experiment_lines(rows["bwd_unrolled"], smi)
    sdpa, bounds = {}, {}
    for main_name, table in rows.items():
        if main_name == "bwd_unrolled":  # printed above, beside K4 + K5
            continue
        for row_name, row in table.items():
            if "shape" not in row:
                continue
            b, s, hq, hkv, d = row["shape"]
            causal = row["causal"]
            int8 = any(key in row for key in INT8_VARIANTS)
            if not int8 and (row["shape"], causal) not in sdpa:
                sdpa[(row["shape"], causal)] = _sdpa_fit_ms(b, s, hq, hkv, d, causal,
                                                           EXPERIMENT_FIT)
            lib = None if int8 else sdpa[(row["shape"], causal)]
            meta_q = torch.empty(b, s, hq, d, device="meta", dtype=torch.bfloat16)
            meta_k = torch.empty(b, s, hkv, d, device="meta", dtype=torch.bfloat16)
            bound = (quant_bound(meta_q, meta_k, causal, torch.int8, torch.bfloat16, 4) if int8
                     else flash_fwd_bound(meta_q, meta_k, causal))
            bounds[(row["shape"], causal, int8)] = bound
            ceiling = rl.attention_composite_ceiling(b, s, s, hq, d, causal=causal,
                                                     num_kv_heads=hkv, rates=rates)
            for key, label in EXPERIMENT_VARIANTS:
                if key not in row:
                    continue
                ms, k1_ms = row[key], row[K1_KEYS.get(key, "k1_ms")]
                if key == "pair_ms":
                    label += f" nchain {row['nchain']}"
                fast = key.startswith("fast")
                err = row["fast_rel_err"] if fast else row["rel_err"]
                err_bound = (FAST_EXP_ORACLE_BOUND if fast else INT8_ORACLE_BOUND if int8
                             else ORACLE_BOUND)
                entry = {"tflops": row["flops"] / ms / 1e9, "k1_over": k1_ms / ms,
                         "bound_share": bound["bound_ms"] / ms,
                         "ceiling_share": rl.composite_fraction(ms * 1e3, ceiling)}
                line = (f"experiments: {label} B{b} S{s} H{hq}/{hkv} D{d} causal={causal} "
                        f"({main_name}{', ' + row_name if main_name in ux.VARIANTS else ''}): "
                        f"{ms:.4f} ms, {entry['tflops']:.1f} TFLOP/s; "
                        f"K1{' int8-QK' if int8 else ''}"
                        f"{', kernel alone,' if key in K1_KEYS else ''} "
                        f"{k1_ms:.4f} ms in the same run, K1/variant "
                        f"{entry['k1_over']:.3f}; "
                        f"{'no library call' if int8 else f'SDPA {lib:.4f} ms'}; "
                        f"{100 * entry['bound_share']:.2f} % of "
                        f"{'quant_bound' if int8 else 'flash_fwd_bound'} "
                        f"({bound['bound_ms']:.4f} ms, {bound['bound_by']}); "
                        f"{100 * entry['ceiling_share']:.2f} % of the composite ceiling "
                        f"({ceiling['t_ceiling_us']:.2f} us, {ceiling['bound']}); rel_err_norm "
                        f"{err:.3e} against the fp32 oracle (bound {err_bound}) ({smi})")
                if not err <= err_bound:
                    raise AssertionError(line)
                print(line, flush=True)
    results = {}
    for name, (main_name, row_name, key, whole_key) in HEADLINE_ROWS.items():
        row = rows[main_name][row_name]
        if main_name == "bwd_unrolled":
            if tuple(row["shape"]) != K1_HEADLINE or not row["causal"]:
                raise AssertionError(f"experiments: {row_name!r} is not at K1's headline shape")
            results[name] = {"ms": row[key], "library_ms": row["sdpa_bwd_ms"],
                             "whole_call_ms": row[whole_key], "shape": list(K1_HEADLINE),
                             **checked[name], **row["bounds"][key]}
            continue
        b, s, hq, hkv, d = row["shape"]
        if (b, s, hq, d) != K1_HEADLINE or not row["causal"]:
            raise AssertionError(f"experiments: {main_name}'s row {row_name!r} is not at "
                                 f"K1's headline shape")
        int8 = key in INT8_VARIANTS
        results[name] = {"ms": row[key], "library_ms": None if int8 else sdpa[(row["shape"], True)],
                         "shape": list(K1_HEADLINE), **checked[name],
                         **bounds[(row["shape"], True, int8)]}
        if whole_key:
            results[name]["whole_call_ms"] = row[whole_key]
    for name in ("pfa_flash_pipelined_fp32", "pfa_flash_chunked_fp32", "pfa_flash_tri_fp32",
                 "pfa_flash_tri_i8_fp32", "pfa_flash_fulltri_fp32",
                 "pfa_flash_bwd_dq_rowblock_fp32", "pfa_flash_bwd_dkv_colblock_fp32"):
        results[name] = checked[name]  # timed in check_experiments
    results["pfa_flash_pair"]["cases"] = [
        {"nchain": row["nchain"], "ms": row["pair_ms"], "k1_ms": row["k1_ms"]}
        for row in rows["pair"].values()
        if "nchain" in row and tuple(row["shape"][:3]) == K1_HEADLINE[:3]]
    torch.cuda.empty_cache()
    print(f"experiments: phase in {time.perf_counter() - t_phase:.2f} s ({smi})", flush=True)
    return results, {"experiments": launches}, {"experiments": captured}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", metavar="DIR",
                        help="also profile three training steps, one step each of the "
                             "parallel path's unsharded and (1, 1)-mesh trainers and one T5 "
                             "serving run (bf16); write the traces and tables into DIR")
    parser.add_argument("--quant-table", action="store_true",
                        help="only build and print the quant table (public calls only, so a "
                             "copy of this script times any tree of the repository); no result "
                             "line")
    parser.add_argument("--exp-table", action="store_true",
                        help="only build and print the exp table of K13-K21 (public calls "
                             "only, so a copy of this script times any tree of the repository); "
                             "no result line")
    parser.add_argument("--bwd-table", action="store_true",
                        help="only build and print the exp table's K20, K21 and unrolled "
                             "backward rows (with K20's levers) and the copy table of K10 (with "
                             "its rings); public calls otherwise, as --exp-table; no result line")
    parser.add_argument("--probe-table", action="store_true",
                        help="only build and print the probe table: K12 in both modes with its "
                             "SASS count a value, and K1's share of the composite ceiling from "
                             "the measured rates (calls any tree holds, as --exp-table); no "
                             "result line")
    parser.add_argument("--sass-diff", metavar="LIB",
                        help="only build and compare the SASS of K1's, K4/K5's, K20/K21's, the "
                             "quantized body's (K1's 8-bit modes, K6, K18 int8), "
                             "K13-K19's and K3's Hopper instantiations and of the probes K9-K12, "
                             "normalised, with another build of the library (LIB, e.g. the "
                             "parent commit's); no result line")
    parser.add_argument("--k3-table", action="store_true",
                        help="only build, print the K3 table and time GPT-2 medium's decode "
                             "step (public calls only, so a copy of this script times any tree "
                             "of the repository); no result line")
    parser.add_argument("--head-dim-table", action="store_true",
                        help="only build and time the rows at D 64 and 128 that the D 256 slice "
                             "must not slow (K1, K5 + K4, K3's fused decode) and the D 256 rows "
                             "where the tree takes d 256 (public calls only, so a copy of this "
                             "script times any tree of the repository); no result line")
    parser.add_argument("--head-dims", action="store_true",
                        help="only build and run the head-dim checks, the d-80 and D 256 "
                             "timings, the d-80 path (GPT-2 at Cerebras-GPT-2.7B's widths served "
                             "and trained) and the d-256 path (Llama at Gemma-2B's widths "
                             "served); no result line")
    parser.add_argument("--shell", action="store_true",
                        help="only build and run the shell path (K1's time measured here at "
                             "the headline shape; no NCCL times); no result line")
    args = parser.parse_args()
    t_script = time.perf_counter()
    smi = phase_device()
    if args.shell:
        phase_build(sass=False)
        q, k, v = _shell_qkv(torch.Generator(device="cuda").manual_seed(1), SHELL_HEADLINE["b"],
                             SHELL_HEADLINE["s"], SHELL_HEADLINE["h"], SHELL_HEADLINE["d"])
        t0 = time.perf_counter()
        phase_shell(smi, median_ms(lambda: flash_ops.flash_attention(q, k, v, causal=True)))
        print(f"chip_smoke: shell path in {time.perf_counter() - t0:.1f} s", flush=True)
        return
    if args.head_dim_table:
        phase_build(sass=False)
        time_head_dim_ab(smi)
        return
    if args.head_dims:
        phase_build(sass=False)
        results = {name: {} for name in SOURCES}
        t0 = time.perf_counter()
        check_head_dims(results)
        time_head_dims(results, smi)
        check_wide_head_dims(results)
        time_wide_head_dims(results, smi)
        print(f"chip_smoke: head-dim checks and timings in {time.perf_counter() - t0:.1f} s",
              flush=True)
        for label, phase in (("d-80", phase_gpt2_d80), ("d-256", phase_gemma_d256)):
            t0 = time.perf_counter()
            print(f"chip_smoke: {label} path launches {dict(phase(smi))} in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
        return
    if args.quant_table:
        phase_build(sass=False)
        time_quant_modes(collections.defaultdict(dict), smi,
                         strict="pfa_quant_sm90_info" in _build._SIGNATURES)
        return
    if args.exp_table:
        phase_build(sass=False)
        time_exp_table(smi)
        return
    if args.bwd_table:
        phase_build(sass=False)
        time_unrolled_rows(smi)
        time_k10_rows(smi)
        return
    if args.probe_table:
        phase_build(sass=False)
        time_probe_table(smi)
        return
    if args.sass_diff:
        phase_build(sass=False)
        sass_diff(_build.library_path(), Path(args.sass_diff))
        return
    if args.k3_table:
        phase_build(sass=False)
        time_k3_modes(collections.defaultdict(dict), smi,
                      strict=hasattr(paged_ops, "k3_plan"))
        time_gpt2_decode(smi)
        return
    seconds = {}

    def timed(name: str, fn, *fn_args):
        t0 = time.perf_counter()
        out = fn(*fn_args)
        seconds[name] = round(time.perf_counter() - t0, 1)
        return out

    timed("build", phase_build)
    results = timed("kernels", phase_kernels, smi)
    roofline_results, by_path, captured_by_path, rates = timed(
        "roofline", phase_roofline, results["pfa_flash_fwd"], smi)
    results.update(roofline_results)
    experiment_results, experiment_launches, experiment_captured = timed(
        "experiments", phase_experiments, smi, rates, check_experiments(results))
    results.update(experiment_results)
    by_path.update(experiment_launches)
    captured_by_path.update(experiment_captured)
    # Each main path's launches, counted from 0 just before it.
    by_path |= {"serving": timed("serving", phase_serving, smi),
                "gpt2_d80": timed("gpt2_d80", phase_gpt2_d80, smi),
                "gemma_d256": timed("gemma_d256", phase_gemma_d256, smi),
                "durable": timed("durable", phase_durable, smi),
                "parallel": timed("parallel", phase_parallel, smi, args.profile),
                "llama": timed("llama", phase_llama, smi),
                "bert": timed("bert", phase_bert, smi),
                "engine": timed("engine", phase_engine, smi),
                "training": timed("training", phase_training, smi, args.profile),
                "t5": timed("t5", phase_t5, smi, args.profile),
                "t5_training": timed("t5_training", phase_t5_training, smi)}
    ops_results, ops_launches = timed("ops", phase_ops, smi)
    for name, r in ops_results.items():  # keep the kernels phase's head-dim cases
        for key in ("d80", "d256"):
            if key in results.get(name, {}):
                r.setdefault(key, results[name][key])
    results.update(ops_results)
    by_path.update(ops_launches)
    by_path["shell"] = timed("shell", phase_shell, smi, results["pfa_flash_fwd"]["ms"])
    launches = collections.Counter()
    for counts in by_path.values():
        launches.update(counts)
    ran = {m: launches[m] for m in NESTED_MODES if launches.get(m, 0)}
    if ran:
        raise AssertionError(f"modes listed as off every main path launched there: {ran}")

    def entry(name: str) -> dict:
        r = results[name]
        return {
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches.get(name, 0),
            "launches_by_path": {p: c[name] for p, c in by_path.items() if c.get(name, 0)},
            # Calls recorded into CUDA graphs (not launches: the card ran
            # each once per replay, GRAPH_REPLAYS times).
            **({"captured_calls_by_path": captured}
               if (captured := {p: c[name] for p, c in captured_by_path.items()
                                if c.get(name, 0)}) else {}),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            **({"whole_call_ms": r["whole_call_ms"]} if "whole_call_ms" in r else {}),
            **({"cases": r["cases"]} if "cases" in r else {}),
            **{k: r[k] for k in ("shape", "iters") if k in r},
            # The kernel at Cerebras-GPT-2.7B's head dim (check_head_dims,
            # time_head_dims): its worst error there, and its times at
            # that model's shapes where it is timed.
            **({"d80": r["d80"]} if "d80" in r else {}),
            # The same past 128 (check_wide_head_dims, time_wide_head_dims),
            # at Gemma-2B's attention where timed.
            **({"d256": r["d256"]} if "d256" in r else {}),
        }

    kernels = [entry(name) for name in SOURCES if name not in NESTED_MODES]
    for mode, (parent, label) in NESTED_MODES.items():
        # A mode that no main path runs (checked in the kernels phase only)
        # rides under its kernel's entry.
        next(k for k in kernels if k["name"] == parent).setdefault("modes", {})[label] = entry(mode)
    print(f"chip_smoke: seconds by phase {seconds}", flush=True)
    print(f"chip_smoke: every phase in {time.perf_counter() - t_script:.1f} s ({smi})", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
