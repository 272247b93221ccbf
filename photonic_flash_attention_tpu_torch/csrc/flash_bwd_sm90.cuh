// K4/K5's stream modes and the bf16 Hopper backward's launchers, shared by
// flash_bwd.cu (the C entry points and the fp32 path) and flash_bwd_sm90.cu
// (the bf16 kernels).
#pragma once

#include "common.cuh"

// Each stream mode is its own instantiation, so the plain path carries none
// of the others' work: the window predicate and band, or the dropout mask.
enum StreamMode { PLAIN = 0, WINDOW = 1, DROPOUT = 2 };

// One backward call: q, o's gradient dout (B, Sq, H, D) and k, v (B, Skv,
// H, D) bf16, K/V repeated to the q heads; lse (natural log) and di =
// rowsum(o * dout), (B, H, Sq) fp32.
struct BwdSm90Args {
  const void *q, *k, *v, *dout;
  const float *lse, *di;
  int B, Sq, Skv, H, D;
  float scale;
  int causal;
  Streams st;
};

// K4: dk, dv (like k); K5: dq (like q). `mode` is a StreamMode.
cudaError_t k4_bf16_sm90(const BwdSm90Args& a, void* dk, void* dv, int mode, cudaStream_t stream);
cudaError_t k5_bf16_sm90(const BwdSm90Args& a, void* dq, int mode, cudaStream_t stream);
