// K1 (bf16): the flash-attention forward redesigned for Hopper (sm_90a):
// TMA loads, wgmma products and warp specialisation, one kernel body for
// every bf16 mode (plain and lse, the key streams, the relative and dense
// biases, the window and dropout).
//
// Replaces the TPU kernels photonic_flash_attention_tpu/ops/flash.py::
// _flash_fwd_kernel and ops/flash_unrolled.py::_kernel in bf16 (the
// contract, the modes' units and clamps: flash_fwd.cu's header). It takes
// the place of the earlier mma.sync body (4 warps, 64 rows, synchronous
// 16-byte loads), whose times PERF.md keeps.
//
// What bounds it on the H100: at D 64 and 128 over S ~ 1k-8k tokens the
// two products do far more operations per loaded byte than the bf16 ridge
// (989 TFLOP/s over 3.35 TB/s, the data sheet at 700 W), so the limit is
// the tensor cores and, at D 64, the softmax's FP32/MUFU stream beside
// them. The design, after FlashAttention-3:
// * A CTA is three warpgroups: two consumers of 64 query rows each (128
//   rows a work tile) and one producer, whose first warp issues every load
//   by TMA (a CUtensorMap per tensor over the (D, H, S, B) layout, 128-byte
//   swizzle, one head and 64 columns a box: D 128 takes two boxes). Q is
//   double-buffered; K and V go through a ring (Cfg::STAGES: 3 where they
//   fit in 227 KB, else 2) with mbarriers: the producer waits "empty" and
//   posts the whole boxes' bytes on "full" (also where TMA zero-fills past
//   Sq or Skv); each consumer warp arrives on "empty" once its products
//   are done with the stage. setmaxnreg gives the producer 24 registers
//   and the consumers 240.
// * S = Q K^T runs on wgmma m64nBKVk16 with both operands in shared memory
//   (K-major, 128-byte swizzle); O += P V on wgmma m64nDk16 with P from
//   registers (the S accumulator rounded to bf16 is wgmma's A register
//   layout) and V from shared memory as a transposed (MN-major) B operand:
//   no V gathers (the tile step: flash_sm90_step.cuh, shared with K17 and
//   K19's bf16 body). Within a warpgroup, tile j's Q K^T is issued ahead of
//   tile j-1's P V, and tile j's softmax runs while that P V finishes. The
//   two consumer warpgroups take turns at the tensor cores (named
//   barriers, FA3's ping-pong), so one's softmax runs under the other's
//   products.
// * The causal mask, the ragged last tile, the lens tile and the window's
//   edge tiles take the per-score predicate; every other tile takes none.
// * The grid is persistent: one CTA a SM walks the work tiles (q-block,
//   head, batch row) in snake order, causal q-blocks longest first and
//   heads adjacent, so with a (B, 1, S, S) dense bias the Hq tiles that
//   read one bias tile run together; the producer loads the next work tile
//   while the consumers finish this one and store its output.
// * The log2-unit modes fold the scale into the exponent: the running max
//   is kept on the raw scores and p = ex2(s * scale - m * scale), one FFMA
//   and one ex2.approx.ftz a score (sm_scale must be > 0 there). The
//   natural-unit modes keep (x - m) * log2 e: x clamps at MASK_VALUE, and
//   MASK_VALUE * log2 e overflows to -inf.
// * Dense bias: the producer stages each (BQ, BKV) fp32 bias tile into the
//   ring beside its K/V tile, by TMA (32-column boxes, 128-byte swizzle)
//   where the row pitch Skv * 4 and the base are 16-byte aligned, else by
//   4-byte cp.async into the same swizzled layout, decided per call inside
//   the kernel (bias_tma). A 128 x 128 fp32 stage is 64 KB, so the dense
//   mode walks 64-key tiles. REL and STREAMS stage their per-tile vectors
//   (BQ + BKV - 1 offsets, BKV key biases) by 4-byte cp.async into the
//   ring; cp.async.mbarrier.arrive ties them to the stage's "full".
// * Head dims: the body is compiled at D 64 and 128 in every mode and at
//   D 256 in PLAIN and STREAMS (JAX pads to 64, then to multiples of 128,
//   ops/flash.py::_pad_head_dim); a head dim d <= 64 runs on D 64,
//   64 < d <= 128 on D 128, 128 < d <= 256 on D 256, with d a multiple of
//   8 (the wrapper pads the rest into a copy, ops/_build.py::head_dim_plan,
//   which also refuses what is not compiled). The tensor maps keep d as
//   their innermost dimension, so TMA fills a box's columns d..D-1 with
//   zeros (a box wholly past d too): they add nothing to Q K^T, and P V
//   gives zero columns there, which are not stored. O's store is strided
//   and guarded by d; sm_scale is the real d's (the caller's). At d 80 the
//   products run 128 / 80 of the needed multiply-adds: a native width is
//   later work.
// * D 256: one 128-row Q is 64 KB and a 64-key K/V stage 64 KB, so Q is
//   single-buffered and the ring holds two stages; K and V then take
//   barriers of their own (Cfg::SPLIT): tile j's K is released once its
//   softmax is done and its V once its P V is, so tile j+1's K and V load
//   under tile j's work in two stages, and the next work tile's Q under
//   this one's last P V and store. P V is one m64n256k16 a 16-key step,
//   wgmma's widest N.
// Not yet done (later work): a TMA store of O, a dynamic (atomic) tile
// scheduler.

#include <limits.h>
#include <string.h>

#include "flash_fwd_sm90.cuh"
#include "flash_sm90_step.cuh"
#include "sm90.cuh"

namespace {

constexpr int BQ = 128;         // query rows a CTA: CONSUMERS warpgroups x 64
constexpr int CONSUMERS = 2;    // consumer warpgroups
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;  // 24 + 2 x 240 = 3 x 168
constexpr int VEC = 256;        // floats of a stage's vector (REL: BQ + BKV - 1)

// The modes compiled at D 256 (ops/_build.py::WIDE_KERNELS).
__host__ __device__ constexpr bool wide_mode(int mode) { return mode == PLAIN || mode == STREAMS; }

template <int D, int MODE>
struct Cfg {
  // A dense-bias stage carries BQ x BKV fp32 beside K and V: 64 keys keep
  // three stages in 227 KB. At D 128, 96 keys keep a tile's scores, the
  // previous tile's P and O (48 + 24 + 64 registers a thread) under the
  // consumers' 240 without spilling (128 keys spill and serialise wgmma).
  // At D 256, 64 keys: 32 + 16 + 128 registers, and two 64 KB stages.
  static constexpr int BKV = MODE == DENSE || D == 256 ? 64 : D == 128 ? 96 : 128;
  static constexpr int HALVES = D / 64;  // 128-byte column boxes a row
  static constexpr int QBUF = D == 256 ? 1 : 2;  // Q buffers
  static constexpr bool SPLIT = D == 256;        // K and V on barriers of their own
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BKV * D * 2;  // K or V, one stage
  static constexpr int BIAS_BYTES = MODE == DENSE ? BQ * BKV * 4 : 0;
  static constexpr int VEC_BYTES = (MODE == STREAMS || MODE == REL) ? VEC * 4 : 0;
  static constexpr int STAGE_BYTES = 2 * KV_BYTES + BIAS_BYTES + VEC_BYTES;
  // Ring depth: the consumers hold two stages (a tile's K and the tile
  // before's V), so a third keeps the next tile's load in flight; two where
  // three do not fit.
  static constexpr int STAGES = QBUF * Q_BYTES + 3 * STAGE_BYTES + 8 * 10 + 1024 <= SMEM_MAX ? 3 : 2;
  static constexpr int OFF_K = QBUF * Q_BYTES;  // every offset a multiple of 1024
  static constexpr int OFF_V = OFF_K + STAGES * KV_BYTES;
  static constexpr int OFF_BIAS = OFF_V + STAGES * KV_BYTES;
  static constexpr int OFF_VEC = OFF_BIAS + STAGES * BIAS_BYTES;
  static constexpr int OFF_BAR = OFF_VEC + STAGES * VEC_BYTES;
  static constexpr int SMEM = OFF_BAR + 8 * (2 * STAGES * (SPLIT ? 2 : 1) + 2 * QBUF) + 1024;  // + slack
};

// The Q buffer of work tile n and the phase of its barriers.
template <int QBUF>
__device__ __forceinline__ int q_buf(int n) { return QBUF == 2 ? n & 1 : 0; }
template <int QBUF>
__device__ __forceinline__ uint32_t q_phase(int n) { return QBUF == 2 ? (n >> 1) & 1 : n & 1; }

struct Params {
  __nv_bfloat16* o;
  float* lse;
  const int* lens;
  const float *kbias, *relvec, *qkbias;
  int B, Hb, Sq, Skv, Hq, Hkv;
  int d;       // the real head dim: the row pitch of q, k, v, o (D: the compiled width)
  int n_work;  // work tiles: query blocks x Hq x B
  float sm_scale;
  int causal, bias_tma;
  Streams st;
};

// Byte offset of fp32 element (r, c) of a (BQ, BKV) bias stage: 32-column
// boxes of BQ rows x 128 bytes, each row's 16-byte chunks swizzled by r % 8
// (TMA's 128-byte swizzle).
__device__ __forceinline__ uint32_t bias_offset(int r, int c) {
  return (c >> 5) * (BQ * 128) + r * 128 + ((((c & 31) >> 2) ^ (r & 7)) << 4) + (c & 3) * 4;
}

// --- the kernel ---------------------------------------------------------------

// The scores of one tile in the mode's units, in place: scale, bias and
// clamp (natural units), and with MASKED the per-score predicate (-inf for
// a structurally invalid key); mx gets the row maxima of this thread's
// values. `vec` is the stage's vector, `bias` its dense tile.
template <int D, int MODE, bool MASKED>
__device__ __forceinline__ void tile_scores(float* sc, float (&mx)[2], const Params& p,
                                            const float* vec, const unsigned char* bias, int q0,
                                            int kv0, int row0, int t4, int len, int off,
                                            float scale) {
  constexpr int BKV = Cfg<D, MODE>::BKV;
#pragma unroll
  for (int j = 0; j < BKV / 8; ++j) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int c = 8 * j + 2 * t4, row = row0 + 8 * rr;
      float x[2] = {sc[4 * j + 2 * rr], sc[4 * j + 2 * rr + 1]};
      if constexpr (natural_units(MODE)) {
        float bv[2] = {0.f, 0.f};
        if constexpr (MODE == STREAMS) {
          if (p.kbias != nullptr) bv[0] = vec[c], bv[1] = vec[c + 1];
        } else if constexpr (MODE == REL) {
          const int i = c - (row - q0) + BQ - 1;
          bv[0] = vec[i], bv[1] = vec[i + 1];
        } else {
          const float2 t = *reinterpret_cast<const float2*>(bias + bias_offset(row - q0, c));
          bv[0] = t.x, bv[1] = t.y;
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) x[e] = fmaxf(x[e] * scale + bv[e], MASK_VALUE);
      }
      if constexpr (MASKED) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = kv0 + c + e;
          const bool ok = col < len && (!p.causal || col <= row + off) &&
                          (MODE != WINDOW || p.st.in_window(col - row - off));
          if (!ok) x[e] = -INFINITY;
        }
      }
      sc[4 * j + 2 * rr] = x[0];
      sc[4 * j + 2 * rr + 1] = x[1];
      mx[rr] = fmaxf(mx[rr], fmaxf(x[0], x[1]));
    }
  }
}

// One tile's online softmax, in place: sc goes from the raw scores to the
// probabilities P.V takes (dropout applied); m and l move on; alpha gets
// the factors that bring O to the new max. `stage` is the tile's ring slot
// (its bias vector or dense tile), wrow the warpgroup's first row.
template <int D, int MODE>
__device__ __forceinline__ void softmax_step(float* sc, float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], const Params& p,
                                             const unsigned char* smem, int stage, int q0, int kv0,
                                             int wrow, int row0, int t4, int len, int off,
                                             float scale, uint32_t bh) {
  using C = Cfg<D, MODE>;
  constexpr int BKV = C::BKV, NS = BKV / 2;
  // Only the tiles a mask or an edge reaches take the predicate.
  const bool masked = kv0 + BKV > len || (p.causal && kv0 + BKV - 1 > wrow + off) ||
                      (MODE == WINDOW && (kv0 - (wrow + 63) - off < p.st.lo ||
                                          kv0 + BKV - 1 - wrow - off > p.st.hi));
  const float* vec = reinterpret_cast<const float*>(smem + C::OFF_VEC + stage * C::VEC_BYTES);
  const unsigned char* bias = smem + C::OFF_BIAS + stage * C::BIAS_BYTES;
  float mx[2] = {-INFINITY, -INFINITY};
  if (masked)
    tile_scores<D, MODE, true>(sc, mx, p, vec, bias, q0, kv0, row0, t4, len, off, scale);
  else
    tile_scores<D, MODE, false>(sc, mx, p, vec, bias, q0, kv0, row0, t4, len, off, scale);
  softmax_rows<NS, natural_units(MODE)>(sc, mx, m, l, alpha, scale);
  if constexpr (MODE == DROPOUT) {  // l has the undropped p; P.V takes p * keep / (1 - rate)
#pragma unroll
    for (int i = 0; i < NS; ++i)
      sc[i] *= dropout_mult(p.st, bh, row0 + 8 * ((i >> 1) & 1), kv0 + 8 * (i >> 2) + 2 * t4 + (i & 1),
                            p.Skv);
  }
}

// One work tile: 128 query rows of one (batch row, head), and the key tiles
// its rows can see.
struct Work {
  int h, b, q0, kv_begin, n_tiles, len;
};

// Work tile t of the persistent loop: heads fastest, then batch rows, then
// query blocks, the longest (last) causal block first, so a CTA's tiles
// come in falling cost and the heads that share a (B, 1, Sq, Skv) bias tile
// run side by side.
template <int BKV, int MODE>
__device__ __forceinline__ Work work_tile(const Params& p, int t) {
  Work w;
  const int nqb = (p.Sq + BQ - 1) / BQ;
  w.h = t % p.Hq;
  const int r = t / p.Hq;
  w.b = r % p.B;
  const int i = r / p.B;
  w.q0 = (p.causal ? nqb - 1 - i : i) * BQ;
  const int off = p.Skv - p.Sq;
  w.len = MODE == STREAMS && p.lens != nullptr ? max(0, min(p.lens[w.b], p.Skv)) : p.Skv;
  w.kv_begin = MODE == WINDOW ? band_kv_begin(p.st, w.q0, off, BKV) : 0;
  const int kv_end = band_kv_end(p.st, w.q0, BQ, off, p.causal, w.len);
  w.n_tiles = kv_end > w.kv_begin ? (kv_end - w.kv_begin + BKV - 1) / BKV : 0;
  return w;
}

// Persistent: gridDim.x CTAs (one a SM) walk the work tiles in snake order
// (snake_tile); the K/V ring and its phases run on across tiles, and Q is
// double-buffered (single at D 256, released after the tile's last Q K^T),
// so the producer loads the next tile while the consumers finish this one
// and write its output.
template <int D, int MODE>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_sm90(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_bias,
               const Params p) {
  using C = Cfg<D, MODE>;
  constexpr int BKV = C::BKV, STAGES = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms need 1024-byte alignment
  unsigned char* smem = smem_raw + (base - raw);
  // K's (with SPLIT; else K and V's) full and empty, then V's (SPLIT), then Q's.
  const uint32_t bar_full = base + C::OFF_BAR, bar_empty = bar_full + 8 * STAGES;
  const uint32_t bar_vfull = bar_empty + 8 * STAGES, bar_vempty = bar_vfull + 8 * STAGES;
  const uint32_t bar_qfull = bar_empty + 8 * STAGES * (C::SPLIT ? 3 : 1);
  const uint32_t bar_qempty = bar_qfull + 8 * C::QBUF;
  const int n_work = p.n_work, off = p.Skv - p.Sq;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, CONSUMERS * 4);  // one arrival a consumer warp
      if constexpr (C::SPLIT) {
        mbar_init(bar_vfull + 8 * s, 1);
        mbar_init(bar_vempty + 8 * s, CONSUMERS * 4);
      }
    }
    for (int s = 0; s < C::QBUF; ++s) {
      mbar_init(bar_qfull + 8 * s, 1);
      mbar_init(bar_qempty + 8 * s, CONSUMERS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Warp-uniform in the compiler's eyes (a shuffled value), so that ptxas
  // sees the roles' branches and the wgmma in them as uniform and does not
  // serialise the products.
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int warp = __shfl_sync(0xffffffffu, (threadIdx.x / 32) % 4, 0), lane = threadIdx.x % 32;
  if (wg == CONSUMERS) {
    // --- producer: its first warp issues every load -------------------------
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp != 0) return;
    int it = 0;  // key tiles loaded so far, over all work tiles
    for (int n = 0; n * (int)gridDim.x < n_work; ++n) {
      const int t = snake_tile(n);
      if (t >= n_work) continue;  // the last round only
      const Work w = work_tile<BKV, MODE>(p, t);
      const int hk = w.h / (p.Hq / p.Hkv), hb = p.Hb == 1 ? 0 : w.h, q0 = w.q0;
      const int qb = q_buf<C::QBUF>(n);
      const uint32_t qf = bar_qfull + 8 * qb;
      mbar_wait(bar_qempty + 8 * qb, q_phase<C::QBUF>(n) ^ 1);
      if (lane == 0) {
        mbar_expect_tx(qf, C::Q_BYTES);
        for (int r = 0; r < CONSUMERS; ++r)
          for (int hf = 0; hf < C::HALVES; ++hf)
            tma_load_4d(base + qb * C::Q_BYTES + (r * C::HALVES + hf) * BOX_BYTES, &tm_q, qf,
                        hf * 64, w.h, q0 + r * 64, w.b);
      }
      for (int j = 0; j < w.n_tiles; ++j, ++it) {
        const int s = it % STAGES, kv0 = w.kv_begin + j * BKV;
        const uint32_t full = bar_full + 8 * s;
        mbar_wait(bar_empty + 8 * s, ((it / STAGES) & 1) ^ 1);
        if constexpr (MODE == STREAMS || MODE == REL || MODE == DENSE) {
          const uint32_t vec = base + C::OFF_VEC + s * C::VEC_BYTES;
          bool staged = false;
          if (MODE == STREAMS && p.kbias != nullptr) {
            const float* row = p.kbias + (long long)w.b * p.Skv;
            for (int i = lane; i < BKV; i += 32) {
              const bool ok = kv0 + i < p.Skv;
              cp_async4(vec + 4 * i, ok ? row + kv0 + i : row, ok);
            }
            staged = true;
          }
          if (MODE == REL) {
            const int nv = p.Sq + p.Skv - 1;
            const float* row = p.relvec + (long long)w.h * nv;
            for (int i = lane; i < BQ + BKV - 1; i += 32) {
              const int gi = kv0 - q0 - (BQ - 1) + i + p.Sq - 1;
              const bool ok = gi >= 0 && gi < nv;
              cp_async4(vec + 4 * i, ok ? row + gi : row, ok);
            }
            staged = true;
          }
          if (MODE == DENSE && !p.bias_tma) {
            const float* tile = p.qkbias + ((long long)w.b * p.Hb + hb) * p.Sq * (long long)p.Skv;
            const uint32_t dst = base + C::OFF_BIAS + s * C::BIAS_BYTES;
            for (int r = 0; r < BQ; ++r) {
              const int row = q0 + r;
              for (int c = lane; c < BKV; c += 32) {
                const int col = kv0 + c;
                const bool ok = row < p.Sq && col < p.Skv;
                cp_async4(dst + bias_offset(r, c), ok ? tile + (long long)row * p.Skv + col : tile,
                          ok);
              }
            }
            staged = true;
          }
          if (staged) cp_async_mbar_arrive(full);
        }
        __syncwarp();
        if constexpr (C::SPLIT) {  // K on "full", then V on "vfull" once its slot is free
          if (lane == 0) {
            mbar_expect_tx(full, C::KV_BYTES);
            for (int hf = 0; hf < C::HALVES; ++hf)
              tma_load_4d(base + C::OFF_K + s * C::KV_BYTES + hf * BKV * 128, &tm_k, full,
                          hf * 64, hk, kv0, w.b);
          }
          const uint32_t vfull = bar_vfull + 8 * s;
          mbar_wait(bar_vempty + 8 * s, ((it / STAGES) & 1) ^ 1);
          if (lane == 0) {
            mbar_expect_tx(vfull, C::KV_BYTES);
            for (int hf = 0; hf < C::HALVES; ++hf)
              tma_load_4d(base + C::OFF_V + s * C::KV_BYTES + hf * BKV * 128, &tm_v, vfull,
                          hf * 64, hk, kv0, w.b);
          }
        } else if (lane == 0) {
          const bool bias_tma = MODE == DENSE && p.bias_tma;
          mbar_expect_tx(full, 2 * C::KV_BYTES + (bias_tma ? C::BIAS_BYTES : 0));
          for (int hf = 0; hf < C::HALVES; ++hf) {
            tma_load_4d(base + C::OFF_K + s * C::KV_BYTES + hf * BKV * 128, &tm_k, full, hf * 64,
                        hk, kv0, w.b);
            tma_load_4d(base + C::OFF_V + s * C::KV_BYTES + hf * BKV * 128, &tm_v, full, hf * 64,
                        hk, kv0, w.b);
          }
          if (bias_tma)
            for (int c = 0; c < BKV / 32; ++c)
              tma_load_4d(base + C::OFF_BIAS + s * C::BIAS_BYTES + c * BQ * 128, &tm_bias, full,
                          kv0 + c * 32, q0, hb, w.b);
        }
      }
    }
  } else {
    // --- consumers: 64 query rows each ---------------------------------------
    setmaxnreg_inc<CONSUMER_REGS>();
    constexpr int NS = BKV / 2, NO = D / 2;  // accumulator floats a thread
    const int g = lane / 4, t4 = lane % 4;
    const float scale = natural_units(MODE) ? p.sm_scale : p.sm_scale * LOG2E;
    // Ping-pong: the two warpgroups take turns to issue their products
    // (named barrier 1 + wg is this one's turn), so one's softmax runs under
    // the other's products. Warpgroup 0 goes first in each work tile; the
    // last turn of warpgroup 1 hands nothing on, so every wait has its
    // arrival.
    auto turn_begin = [&] { named_bar_sync(1 + wg, 2 * 128); };
    auto turn_end = [&](bool last) {
      if (wg == 0 || !last) named_bar_arrive(2 - wg, 2 * 128);
    };
    float sc[NS], o_acc[NO];
    uint32_t pa[BKV / 16][4];
    int it = 0;  // key tiles consumed so far, over all work tiles
    for (int n = 0; n * (int)gridDim.x < n_work; ++n) {
      const int t = snake_tile(n);
      if (t >= n_work) continue;  // the last round only
      const Work w = work_tile<BKV, MODE>(p, t);
      const int q0 = w.q0, n_tiles = w.n_tiles;
      const int wrow = q0 + wg * 64;          // the warpgroup's first row
      const int row0 = wrow + warp * 16 + g;  // this thread's rows: row0, row0 + 8
      const uint32_t bh = static_cast<uint32_t>(w.b * p.Hq + w.h);
      const uint32_t q_base = base + q_buf<C::QBUF>(n) * C::Q_BYTES + wg * C::HALVES * BOX_BYTES;
#pragma unroll
      for (int i = 0; i < NO; ++i) o_acc[i] = 0.f;
      float m[2] = {-INFINITY, -INFINITY};  // running max: raw scores (log2 modes) or natural units
      float l[2] = {0.f, 0.f};              // this thread's share of the running sum
      mbar_wait(bar_qfull + 8 * q_buf<C::QBUF>(n), q_phase<C::QBUF>(n));
      if (wg == 1 && n_tiles > 0) named_bar_arrive(1, 2 * 128);

      // Tile j's Q K^T is issued with the previous tile's P V behind it; the
      // softmax of tile j runs while P V finishes on the tensor cores. O
      // then takes tile j's rescale, and P (bf16, registers) tile j's
      // probabilities for the next step: P's registers are read by the P V
      // in flight, so they change only after it is done. The first tile is
      // peeled off, so no product is issued under a branch.
      auto issue_qk = [&](int k) {  // k: the ring's key tile
        const int s = k % STAGES;
        mbar_wait(bar_full + 8 * s, (k / STAGES) & 1);
        const uint32_t k_base = base + C::OFF_K + s * C::KV_BYTES;
        turn_begin();
        wgmma_fence();
        qk_tile<D, BKV>(sc, q_base, k_base);
      };
      auto release = [&](uint32_t bar) {  // this warp is done with what `bar` guards
        __syncwarp();
        if (lane == 0) mbar_arrive(bar);
      };
      // SPLIT: P V of ring tile k waits for V's own barrier (outside a turn),
      // and tile k's K (with its stage vector) and, after the work tile's
      // last Q K^T, Q are released once its softmax is done.
      const uint32_t bar_pv_empty = C::SPLIT ? bar_vempty : bar_empty;
      auto wait_v = [&](int k) { mbar_wait(bar_vfull + 8 * (k % STAGES), (k / STAGES) & 1); };
      auto release_k = [&](int k, bool last) {
        release(bar_empty + 8 * (k % STAGES));
        if (last) release(bar_qempty);
      };
      if (n_tiles > 0) {
        issue_qk(it);
        turn_end(false);
        wgmma_wait<0>();
        fence_regs(sc);
        float alpha[2];
        softmax_step<D, MODE>(sc, m, l, alpha, p, smem, it % STAGES, q0, w.kv_begin, wrow, row0,
                              t4, w.len, off, scale, bh);
        if constexpr (C::SPLIT) release_k(it, n_tiles == 1);
        pack_frag<BKV>(pa, sc);
      }
      for (int j = 1; j < n_tiles; ++j) {
        if constexpr (C::SPLIT) wait_v(it + j - 1);
        issue_qk(it + j);
        pv_tile<D, BKV>(o_acc, pa, base + C::OFF_V + ((it + j - 1) % STAGES) * C::KV_BYTES);
        turn_end(false);
        wgmma_wait<1>();
        fence_regs(sc);
        float alpha[2];
        softmax_step<D, MODE>(sc, m, l, alpha, p, smem, (it + j) % STAGES, q0,
                              w.kv_begin + j * BKV, wrow, row0, t4, w.len, off, scale, bh);
        if constexpr (C::SPLIT) release_k(it + j, j == n_tiles - 1);
        wgmma_wait<0>();
        fence_regs(o_acc);
        release(bar_pv_empty + 8 * ((it + j - 1) % STAGES));
#pragma unroll
        for (int i = 0; i < NO; ++i) o_acc[i] *= alpha[(i >> 1) & 1];
        pack_frag<BKV>(pa, sc);
      }
      if (n_tiles > 0) {  // the last tile's P V
        if constexpr (C::SPLIT) wait_v(it + n_tiles - 1);
        turn_begin();
        wgmma_fence();
        pv_tile<D, BKV>(o_acc, pa, base + C::OFF_V + ((it + n_tiles - 1) % STAGES) * C::KV_BYTES);
        turn_end(true);
        wgmma_wait<0>();
        fence_regs(o_acc);
        release(bar_pv_empty + 8 * ((it + n_tiles - 1) % STAGES));
      }
      if (!C::SPLIT || n_tiles == 0) release(bar_qempty + 8 * q_buf<C::QBUF>(n));
      it += n_tiles;

#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
        const int row = row0 + 8 * i;
        if (row >= p.Sq) continue;
        const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
        __nv_bfloat16* orow = p.o + (((long long)w.b * p.Sq + row) * p.Hq + w.h) * p.d;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)  // columns d..D-1 (zero) are not stored
          if (8 * j < p.d)
            store2(orow + 8 * j + 2 * t4, o_acc[4 * j + 2 * i] * inv, o_acc[4 * j + 2 * i + 1] * inv);
        if (p.lse != nullptr && t4 == 0) {
          const float mn = natural_units(MODE) ? m[i] : m[i] * p.sm_scale;
          p.lse[((long long)w.b * p.Hq + w.h) * p.Sq + row] = l[i] > 0.f ? mn + logf(l[i]) : -INFINITY;
        }
      }
    }
  }
}

// --- host side -------------------------------------------------------------------

template <int D, int MODE>
cudaError_t launch(const K1Args& a, cudaStream_t stream) {
  using C = Cfg<D, MODE>;
  // The maps' innermost dimension is the real head dim d: the boxes'
  // columns d..D-1 arrive as zeros and add nothing to Q K^T or P V.
  const uint64_t B = a.B, Sq = a.Sq, Skv = a.Skv, d = a.D;
  CUtensorMap tq, tk, tv, tb;
  memset(&tb, 0, sizeof(tb));
  const auto bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (!encode_4d(&tq, bf16, 2, a.q, {d, (uint64_t)a.Hq, Sq, B}, {64, 1, 64, 1}) ||
      !encode_4d(&tk, bf16, 2, a.k, {d, (uint64_t)a.Hkv, Skv, B}, {64, 1, C::BKV, 1}) ||
      !encode_4d(&tv, bf16, 2, a.v, {d, (uint64_t)a.Hkv, Skv, B}, {64, 1, C::BKV, 1}))
    return cudaErrorInvalidValue;
  const int bias_tma = MODE == DENSE && Skv % 4 == 0 && aligned16(a.qkbias);
  if (bias_tma && !encode_4d(&tb, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, a.qkbias,
                             {Skv, Sq, (uint64_t)a.Hb, B}, {32, BQ, 1, 1}))
    return cudaErrorInvalidValue;
  const long long work = (long long)((a.Sq + BQ - 1) / BQ) * a.Hq * a.B;
  if (work > INT_MAX) return cudaErrorInvalidValue;
  const int n_work = static_cast<int>(work);
  const Params p{static_cast<__nv_bfloat16*>(a.o), a.lse, a.lens, a.kbias, a.relvec, a.qkbias,
                 a.B, a.Hb, a.Sq, a.Skv, a.Hq, a.Hkv, a.D, n_work, a.scale, a.causal, bias_tma,
                 a.st};
  auto kernel = flash_fwd_sm90<D, MODE>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return e;
  int sms = 0;
  if ((e = sm_count(&sms)) != cudaSuccess) return e;
  kernel<<<n_work < sms ? n_work : sms, THREADS, C::SMEM, stream>>>(tq, tk, tv, tb, p);
  return cudaGetLastError();
}

// The design of one instantiation: keys a tile, dynamic shared memory,
// threads a CTA, CTAs an SM can hold, ring stages, the producer's and the
// consumers' registers.
template <int D, int MODE>
cudaError_t info(int* out) {
  using C = Cfg<D, MODE>;
  auto kernel = flash_fwd_sm90<D, MODE>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return e;
  out[0] = C::BKV, out[1] = C::SMEM, out[2] = THREADS;
  out[4] = C::STAGES, out[5] = PRODUCER_REGS, out[6] = CONSUMER_REGS;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3], kernel, THREADS, C::SMEM);
}

template <int MODE>
cudaError_t info_mode(int D, int* out) {
  if (D == 64) return info<64, MODE>(out);
  if (D == 128) return info<128, MODE>(out);
  if constexpr (wide_mode(MODE))
    if (D == 256) return info<256, MODE>(out);
  return cudaErrorInvalidValue;
}

// Head dim d on the width that holds it: 64 for d <= 64, 128 for d <= 128,
// else 256 (wide modes only).
template <int MODE>
cudaError_t launch_mode(const K1Args& a, cudaStream_t stream) {
  if (a.D <= 128) return a.D <= 64 ? launch<64, MODE>(a, stream) : launch<128, MODE>(a, stream);
  if constexpr (wide_mode(MODE)) return launch<256, MODE>(a, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

cudaError_t k1_bf16_sm90(const K1Args& a, int mode, cudaStream_t stream) {
  // TMA reads 16-byte-aligned bases and rows of whole 16-byte units (d a
  // multiple of 8, up to 256 in the wide modes, else 128:
  // ops/_build.py::head_dim_plan pads the rest and refuses what is not
  // compiled); the log2 modes keep the max on the raw scores and scale them
  // inside the exponent, which needs a scale > 0.
  if (!aligned16(a.q) || !aligned16(a.k) || !aligned16(a.v) || a.D < 8 || a.D > 256 ||
      a.D % 8 != 0 || (!natural_units(mode) && !(a.scale > 0.f)))
    return cudaErrorInvalidValue;
  switch (mode) {
    case PLAIN: return launch_mode<PLAIN>(a, stream);
    case STREAMS: return launch_mode<STREAMS>(a, stream);
    case REL: return launch_mode<REL>(a, stream);
    case DENSE: return launch_mode<DENSE>(a, stream);
    case WINDOW: return launch_mode<WINDOW>(a, stream);
    case DROPOUT: return launch_mode<DROPOUT>(a, stream);
  }
  return cudaErrorInvalidValue;
}

// out[7]: keys a tile, dynamic shared memory bytes, threads a CTA, CTAs a
// SM, ring stages, producer and consumer registers (setmaxnreg) of the
// bf16 kernel at head dim D in `mode` (K1Mode); no launch.
extern "C" int pfa_k1_sm90_info(int D, int mode, int* out) {
  switch (mode) {
    case PLAIN: return info_mode<PLAIN>(D, out);
    case STREAMS: return info_mode<STREAMS>(D, out);
    case REL: return info_mode<REL>(D, out);
    case DENSE: return info_mode<DENSE>(D, out);
    case WINDOW: return info_mode<WINDOW>(D, out);
    case DROPOUT: return info_mode<DROPOUT>(D, out);
  }
  return cudaErrorInvalidValue;
}
