// K4/K5's stream modes and the bf16 Hopper backward's launchers, shared by
// flash_bwd.cu (the C entry points and the fp32 path) and flash_bwd_sm90.cu
// (the bf16 kernels).
#pragma once

#include "common.cuh"

// Each stream mode is its own instantiation, so the plain path carries none
// of the others' work: the window predicate and band, or the dropout mask.
enum StreamMode { PLAIN = 0, WINDOW = 1, DROPOUT = 2 };

// One backward call: q, o, o's gradient dout (B, Sq, Hq, D) and k, v (B,
// Skv, Hkv, D) bf16, query head h on KV head h / (Hq / Hkv); lse (natural
// log) and di = rowsum(o * dout), (B, Hq, Sq) fp32: K5 reads o and writes
// di to `di_out`; K4 (and K20, K21) read it from `di`. K4 splits each KV
// head's group of query heads into `slices` slices (a divisor of the
// group) and, with more than one, sums their fp32 partials through `ws`
// (2 x slices x B x Hkv x key blocks of 128 x 128 x D floats) and
// `counters` (B x Hkv x key blocks ints, zero between launches).
struct BwdSm90Args {
  const void *q, *k, *v, *o, *dout;
  const float *lse, *di;
  float* di_out;
  int B, Sq, Skv, Hq, Hkv, D;
  float scale;
  int causal;
  Streams st;
  float* ws;
  int* counters;
  int slices;
};

// K4: dk, dv (like k); K5: dq (like q) and di. `mode` is a StreamMode.
cudaError_t k4_bf16_sm90(const BwdSm90Args& a, void* dk, void* dv, int mode, cudaStream_t stream);
cudaError_t k5_bf16_sm90(const BwdSm90Args& a, void* dq, int mode, cudaStream_t stream);
