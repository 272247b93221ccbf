// K1's score modes and the bf16 Hopper forward's launcher, shared by
// flash_fwd.cu (the C entry points, the fp32 and quantized paths) and
// flash_fwd_sm90.cu (the bf16 kernel).
#pragma once

#include "common.cuh"

// PLAIN, WINDOW (the sliding-window predicate and the banded key loop) and
// DROPOUT (the keep mask on P.V) run in log2 units; the others in natural
// units with a bias: STREAMS the key streams (lens, kbias), REL the
// relative-bias vector, DENSE the dense bias. Each mode is its own
// instantiation, so the plain path carries none of the others' work.
enum K1Mode { PLAIN = 0, STREAMS = 1, REL = 2, DENSE = 3, WINDOW = 4, DROPOUT = 5 };

__host__ __device__ constexpr bool natural_units(int mode) {
  return mode == STREAMS || mode == REL || mode == DENSE;
}

// One K1 call: q (B, Sq, Hq, D), k/v (B, Skv, Hkv, D), o like q; the
// optional lse (B, Hq, Sq) fp32 and the streams of the mode (null when
// absent); qkbias (B, Hb, Sq, Skv) fp32.
struct K1Args {
  const void *q, *k, *v;
  void* o;
  float* lse;
  const int* lens;
  const float *kbias, *relvec, *qkbias;
  int B, Hb, Sq, Skv, Hq, Hkv, D;
  float scale;
  int causal;
  Streams st;
};

// The bf16 forward (flash_fwd_sm90.cu): TMA, wgmma, warp-specialised.
cudaError_t k1_bf16_sm90(const K1Args& a, int mode, cudaStream_t stream);
