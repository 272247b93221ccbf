// K1: flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernels photonic_flash_attention_tpu/ops/flash.py::
// _flash_fwd_kernel (plain causal contract) and ops/flash_unrolled.py::
// _kernel. One kernel serves both public entry points of the port
// (ops/flash.py::flash_attention, ops/flash_unrolled.py::flash_attention_best).
//
// Contract: q (B, Sq, Hq, D), k/v (B, Skv, Hkv, D), contiguous, Hq % Hkv == 0
// (GQA: q head h reads kv head h / (Hq/Hkv)), D in {64, 128}, bf16 or fp32;
// causal aligned to the sequence end (row i sees keys j <= i + Skv - Sq);
// fp32 online softmax; output in q's dtype. When `lse` is not null it also
// writes the row logsumexp (B, Hq, Sq) fp32 in natural log (the residual
// of the backward, K4/K5 in flash_bwd.cu): the kernel runs in the log2
// domain, so lse = (m + log2 l) * ln 2; a row with no valid key gets
// lse = -inf and o = 0. The inference path passes null and writes nothing.
//
// Key-padding streams (the lens_ref / kbias_ref streams of the TPU kernel,
// ops/flash.py:77-78, 159-161, 266-271, 299-300): `lens` (B,) int32 ends the
// kv loop of batch row b at lens[b] (whole tiles past it are never loaded)
// and masks col >= lens[b]; `kbias` (B, Skv) fp32 is added to the scaled
// score. Both null keeps the plain path below, unchanged. With either
// stream the kernel runs its softmax in natural units: the bias is
// DEFAULT_MASK_VALUE (-0.7 FLT_MAX) for a masked key, and that value times
// log2(e) overflows to -inf, which would turn a row whose keys are all
// bias-masked into 0/0 instead of the reference's average over them. So the
// score s*scale + bias is clamped at DEFAULT_MASK_VALUE, the running max is
// kept in natural units, and only differences (s - m), which are finite or
// -inf, are scaled by log2(e) inside exp2f. Structurally invalid keys
// (past lens or Skv, above the causal diagonal) stay -inf and drop out; a
// row with lens[b] == 0 gets o = 0 and lse = -inf.
//
// Window and dropout streams (the TPU kernel's `window` and `seed_ref`,
// ops/flash.py:139-154, 309-327, 372-391; callers ops/flash.py::
// flash_attention(window=..., dropout_rate=..., dropout_seed=...)), in the
// plain path's log2 units:
// * window (lo, hi): a key is valid when lo <= col - (row + Skv - Sq) <= hi
//   (open sides at -/+ WINDOW_OPEN, common.cuh). Each 64-row query block
//   walks only the K/V tiles that can hold a valid key: the loop starts at
//   the tile of the block's first row's lowest key (row + off + lo) and
//   ends after its last row's highest (min(hi, 0) when causal), so the cost
//   scales with S * w as the TPU's banded grid (ops/flash.py:478-491). A row
//   with no key in its window gets o = 0 and lse = -inf (keys out of the
//   window are -inf, not the TPU kernel's finite mask value).
// * dropout: the keep mask is regenerated per score from (b * Hq + h, row,
//   col, seed) (common.cuh::dropout_keep, the TPU kernel's hash) at the
//   exact global coordinates a lane holds; it multiplies p by 1 / (1 - rate)
//   after the running sum l took the undropped p and before p becomes the
//   P.V operand (rounded to bf16 there), so l and lse keep the full sum.
//   The seed is a kernel argument; nothing is read from the device for it.
//
// Structured-bias modes (pfa_flash_fwd_bias; the TPU kernel's tab_ref and
// qkbias_ref streams, ops/flash.py:76, 82, 213-284; callers
// ops/flash.py::flash_attention(rel_bias=..., attn_bias=...)), in natural
// units with the score clamped at MASK_VALUE, as the key streams:
// * relative bias (T5 buckets, ALiBi): `relvec` (Hq, Sq+Skv-1) fp32 holds
//   head h's bias of every offset rel = col - (row + Skv - Sq), from
//   -(Skv-1) at index 0 to Sq-1, so element (row, col) reads index
//   col - row + Sq - 1. Each block stages the BQ+BKV-1 entries its tile
//   can see in shared memory. The wrapper builds the vector from one set
//   of buckets (ops/rel_bias.py), so kernel and plain version share them,
//   and no log runs here. Not carried over: the TPU's far/band split (two
//   kernels merged by logsumexp), a Mosaic scheduling choice. With `lse`
//   not null it writes the row logsumexp, the residual of the relative-bias
//   backward (ops/flash.py::_FlashAttentionRelFn).
// * dense bias: `qkbias` (B, Hb, Sq, Skv) fp32, Hb 1 (broadcast over heads)
//   or Hq; each visited score reads its own entry from device memory (the
//   (BQ, BKV) tile of the step), after the scale and before the causal
//   mask; tiles above the causal diagonal are never visited, so they read
//   nothing. Cost: Sq*Skv*4 bytes per head of Hb, against the fused path's
//   materialised scores.
//
// What bounds it on the H100: prefill attention over S ~ 1k-2k tokens does
// ~S/2 multiply-adds per loaded K/V byte (causal), far above the bf16 ridge
// (H100 SXM data sheet at its 700 W limit: 989 TFLOP/s over 3.35 TB/s,
// ~295 FLOP/byte), so the tensor-core rate is the limit, not HBM.
// Design: the bf16 path is flash_fwd_sm90.cu (TMA, wgmma, warp
// specialisation, 128 query rows a CTA); the entry points below route
// every bf16 mode there. This file keeps the fp32 path, which keeps fp32
// inputs in fp32 (FMA loops, no bf16 or TF32 rounding, 64 query rows a
// block, one 64-key K/V tile), and the quantized modes (mma.sync, below).
//
// Not carried over from the TPU: the lane-replicated (.,128) softmax
// statistics, the one-launch-per-row-block "triangular" scheme of the
// unrolled kernel, and the 128-lane padding of S and D: ragged edges are
// masked in the kernel.
//
// Quantized modes (pfa_flash_fwd_quant; the TPU kernel's scale_ref,
// pv_quant and vs_ref, ops/flash.py:79-81, 192-211, 356-362, 394-401, 422;
// callers ops/flash_fp8.py::flash_attention_int8qk / fp8qk / int8full and
// ops/flash_unrolled.py::_kernel with int8_qk):
// * Q and K are 8-bit payloads with ONE per-tensor scale each, folded with
//   sm_scale into one fp32 device scalar (`score_scale`, a pointer: the
//   host never reads it). int8 Q.K runs on mma.sync m16n8k32 s8*s8->s32,
//   converted to fp32 once per score; e4m3 Q.K runs natively on
//   mma.sync m16n8k32 e4m3*e4m3->f32 (CUDA >= 12.4 for sm_89+; each e4m3
//   product is exact in fp32, only the sums round, as on the TPU), not
//   widened to bf16.
// * P.V in bf16 (int8/fp8 QK: V bf16, P rounded to bf16 as the TPU kernel's
//   p.astype(v.dtype)), or int8 (int8 full, `pv_quant`): P is exponentiated
//   with log2(127) folded in, so it lies in [0, 127], and truncated from
//   p + 0.5 to int8; V is int8 with per-(b, kv head, column) fp32 scales
//   `v_scales`, applied once at the store; the folded 127 cancels in
//   acc / l. P.V runs on s8 mma.sync; the score fragments are not s8 A
//   fragments, so V's rows are read in the order the fragments hold their
//   keys (common.cuh: v_frag8).
// * P is requantized against the running max after each kv block, so the
//   result depends on the block: these modes walk 128-key blocks (the
//   JAX kernel's smallest block_kv, which the tests compare against) with
//   the max taken over all 128 keys before the exp, and the plain version
//   (ops/flash.py::quant_blocks_plain) walks the same blocks.
// * Masked keys score DEFAULT_MASK_VALUE as in the TPU kernel (not -inf),
//   with the softmax in natural units (exp2f of differences times log2 e).
// Bound on the H100: the two products at the 8-bit (Q.K) and bf16 or
// 8-bit (P.V) tensor-core rates; the 8-bit payloads halve the Q/K bytes.
// This first version stages one 128-key K/V tile per 64 query rows in
// shared memory.

#include "flash_fwd_sm90.cuh"

namespace {

constexpr int BQ = 64;            // query rows per block
constexpr int BKV = 64;           // keys per K/V tile
constexpr int BF16_THREADS = 128; // quantized modes: 4 warps x 16 query rows
constexpr int F32_THREADS = 256;  // 4 threads per query row

// K1's score modes (K1Mode) and natural_units: flash_fwd_sm90.cuh.

// Masked, scaled score of one key: with a bias, added and clamped at
// MASK_VALUE.
template <int MODE>
__device__ __forceinline__ float stream_score(float s, bool ok, float scale, float bias) {
  if (!ok) return -INFINITY;
  return natural_units(MODE) ? fmaxf(s * scale + bias, MASK_VALUE) : s * scale;
}

// exp of (x - base) for a score and a running max in the kernel's units.
template <int MODE>
__device__ __forceinline__ float stream_exp(float x, float base) {
  return natural_units(MODE) ? exp2f((x - base) * LOG2E) : exp2f(x - base);
}

// Final lse in natural log from the running max and sum.
template <int MODE>
__device__ __forceinline__ float stream_lse(float m, float l) {
  if (!(l > 0.f)) return -INFINITY;
  return natural_units(MODE) ? m + logf(l) : (m + log2f(l)) * LN2;
}

// Per-block bias staging, before a tile's scores: STREAMS stages the
// tile's BKV key biases, REL its BQ+BKV-1 relative offsets (index i is
// rel = kv0 + i - (BQ-1) - q0 - off, vector index kv0 - q0 - (BQ-1) + i +
// Sq - 1). Entries outside the call read 0; they belong to masked scores.
template <int MODE, int THREADS>
__device__ __forceinline__ void stage_bias(float* Bs, const float* bias_row, const float* rel_row,
                                           int q0, int kv0, int Sq, int Skv) {
  if (MODE == STREAMS)
    for (int i = threadIdx.x; i < BKV; i += THREADS)
      Bs[i] = bias_row != nullptr && kv0 + i < Skv ? bias_row[kv0 + i] : 0.f;
  if (MODE == REL)
    for (int i = threadIdx.x; i < BQ + BKV - 1; i += THREADS) {
      const int gi = kv0 - q0 - (BQ - 1) + i + Sq - 1;
      Bs[i] = gi >= 0 && gi < Sq + Skv - 1 ? rel_row[gi] : 0.f;
    }
}

// The bias of score (row, col), c = col - kv0 within the tile; DENSE reads
// its entry only for a visible score of a real row.
template <int MODE>
__device__ __forceinline__ float score_bias(const float* Bs, const float* dense, int row, int col,
                                            int c, int q0, int Sq, int Skv, bool ok) {
  if (MODE == STREAMS) return Bs[c];
  if (MODE == REL) return Bs[c - (row - q0) + BQ - 1];
  if (MODE == DENSE) return ok && row < Sq ? __ldg(dense + (long long)row * Skv + col) : 0.f;
  return 0.f;
}

// fp32: 4 threads per query row (thread quarter qd owns keys qd + 4j of a
// tile and output columns qd + 4j); plain FMA, no reduced-precision math.
template <int D, int MODE>
__global__ void __launch_bounds__(F32_THREADS)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o,
              float* __restrict__ lse, const int* __restrict__ lens,
              const float* __restrict__ kbias, const float* __restrict__ relvec,
              const float* __restrict__ qkbias, int Hb, int Sq, int Skv, int Hq, int Hkv,
              float sm_scale, int causal, Streams st) {
  constexpr int LDK = D + 1;    // padded rows: conflict-free column reads
  constexpr int LDP = BKV + 1;
  constexpr int NJ = BKV / 4;   // scores per thread per tile
  constexpr int DJ = D / 4;     // output columns per thread
  extern __shared__ float smf[];
  float* Qs = smf;
  float* Ks = Qs + BQ * LDK;
  float* Vs = Ks + BKV * LDK;
  float* Ps = Vs + BKV * D;
  __shared__ float Bs[BQ + BKV];  // the tile's staged bias (STREAMS, REL)

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int r = threadIdx.x >> 2, qd = threadIdx.x & 3;
  const long long qstr = (long long)Hq * D, kvstr = (long long)Hkv * D;
  const float* qb = q + (long long)b * Sq * qstr + (long long)h * D;
  const float* kb = k + (long long)b * Skv * kvstr + (long long)hk * D;
  const float* vb = v + (long long)b * Skv * kvstr + (long long)hk * D;

  for (int i = threadIdx.x; i < BQ * D; i += F32_THREADS) {
    const int rr = i / D, c = i % D;
    Qs[rr * LDK + c] = q0 + rr < Sq ? qb[(q0 + rr) * qstr + c] : 0.f;
  }
  float acc[DJ];
#pragma unroll
  for (int j = 0; j < DJ; ++j) acc[j] = 0.f;
  float m = -INFINITY, l = 0.f;
  const int off = Skv - Sq, row = q0 + r;
  const float scale = natural_units(MODE) ? sm_scale : sm_scale * LOG2E;
  const int len = MODE == STREAMS && lens != nullptr ? max(0, min(lens[b], Skv)) : Skv;
  const uint32_t bh = static_cast<uint32_t>(b * Hq + h);
  const int kv_begin = MODE == WINDOW ? band_kv_begin(st, q0, off, BKV) : 0;
  const int kv_end = band_kv_end(st, q0, BQ, off, causal, len);
  const float* bias_row = MODE == STREAMS && kbias != nullptr ? kbias + (long long)b * Skv : nullptr;
  const float* rel_row = MODE == REL ? relvec + (long long)h * (Sq + Skv - 1) : nullptr;
  const float* dense = MODE == DENSE ? qkbias + ((long long)b * Hb + (Hb == 1 ? 0 : h)) * Sq * Skv
                                     : nullptr;

  for (int kv0 = kv_begin; kv0 < kv_end; kv0 += BKV) {
    __syncthreads();
    for (int i = threadIdx.x; i < BKV * D; i += F32_THREADS) {
      const int rr = i / D, c = i % D;
      const bool ok = kv0 + rr < Skv;
      Ks[rr * LDK + c] = ok ? kb[(kv0 + rr) * kvstr + c] : 0.f;
      Vs[rr * D + c] = ok ? vb[(kv0 + rr) * kvstr + c] : 0.f;
    }
    stage_bias<MODE, F32_THREADS>(Bs, bias_row, rel_row, q0, kv0, Sq, Skv);
    __syncthreads();

    float s[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qv = Qs[r * LDK + d];
#pragma unroll
      for (int j = 0; j < NJ; ++j) s[j] = fmaf(qv, Ks[(qd + 4 * j) * LDK + d], s[j]);
    }
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = kv0 + qd + 4 * j;
      const bool ok = col < len && (!causal || col <= row + off) &&
                      (MODE != WINDOW || st.in_window(col - row - off));
      const float bias = score_bias<MODE>(Bs, dense, row, col, qd + 4 * j, q0, Sq, Skv, ok);
      s[j] = stream_score<MODE>(s[j], ok, scale, bias);
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float base = m_new == -INFINITY ? 0.f : m_new;
    const float alpha = stream_exp<MODE>(m, base);
    m = m_new;
    l *= alpha;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float p = stream_exp<MODE>(s[j], base);
      l += p;  // the undropped p; P.V takes p * keep / (1 - rate)
      Ps[r * LDP + qd + 4 * j] =
          MODE == DROPOUT ? p * dropout_mult(st, bh, row, kv0 + qd + 4 * j, Skv) : p;
    }
    __syncwarp();  // a row's 4 threads share one warp
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[j] *= alpha;
    for (int c = 0; c < BKV; ++c) {
      const float p = Ps[r * LDP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[j] = fmaf(p, Vs[c * D + qd + 4 * j], acc[j]);
    }
  }

  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  if (row >= Sq) return;
  const float inv = l > 0.f ? 1.f / l : 0.f;
  float* orow = o + ((long long)b * Sq + row) * qstr + (long long)h * D;
#pragma unroll
  for (int j = 0; j < DJ; ++j) orow[qd + 4 * j] = acc[j] * inv;
  if (lse != nullptr && qd == 0) lse[((long long)b * Hq + h) * Sq + row] = stream_lse<MODE>(m, l);
}

constexpr int QBKV = 128;                       // keys per block of the quantized modes
constexpr float LOG2_127 = 6.988684686772166f;  // the folded P scale, log2(127)

// Quantized modes: QK8 0 = int8, 1 = e4m3 Q/K payloads; PV8 = int8 V with
// per-column scales (int8 full), else bf16 V; OutT bf16 or fp32. Each warp
// owns 16 query rows; in the m16n8k16 / m16n8k32 fragments a lane (g =
// lane/4, t4 = lane%4) holds rows g and g+8 of its score tiles. The keys of
// a block go in 128-key tiles.
template <int D, int QK8, bool PV8, typename OutT>
__global__ void __launch_bounds__(BF16_THREADS)
flash_fwd_quant(const uint8_t* __restrict__ q, const uint8_t* __restrict__ k,
                const void* __restrict__ v, OutT* __restrict__ o,
                const float* __restrict__ score_scale, const float* __restrict__ v_scales,
                int Sq, int Skv, int Hq, int Hkv, int causal) {
  constexpr int LDB = D + 16;   // byte pitch of 8-bit rows: conflict-free fragment loads
  constexpr int LDV = D + 8;    // bf16 V pitch
  constexpr int NT = QBKV / 8;  // 8-wide score tiles per block
  constexpr int DT = D / 8;     // 8-wide output tiles
  constexpr int DK = D / 32;    // 32-deep k-steps over D
  extern __shared__ __align__(16) unsigned char smem[];
  uint8_t* Qs = smem;
  uint8_t* Ks = Qs + BQ * LDB;
  uint8_t* V8s = Ks + QBKV * LDB;                             // PV8: int8 V
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(V8s);  // else bf16 V

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const long long qstr = (long long)Hq * D, kvstr = (long long)Hkv * D;
  const long long kv_base = (long long)b * Skv * kvstr + (long long)hk * D;
  const uint8_t* qb = q + (long long)b * Sq * qstr + (long long)h * D;

  load_tile_u8<D, LDB, BF16_THREADS>(Qs, qb + q0 * qstr, qstr, BQ, Sq - q0);
  __syncthreads();
  const int wr = warp * 16;
  uint32_t qf[DK][4];
#pragma unroll
  for (int kc = 0; kc < DK; ++kc) load_a_frag8<LDB>(qf[kc], Qs, wr, kc * 32, g, t4);

  float acc[DT][4];
#pragma unroll
  for (int dn = 0; dn < DT; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max (natural units), rows g, g+8
  float l[2] = {0.f, 0.f};              // this lane's share of the running sum
  const int off = Skv - Sq;
  const int rows[2] = {q0 + wr + g, q0 + wr + g + 8};
  const float sc = *score_scale;  // (qs * ks) * sm_scale, on the device
  const int kv_end = causal ? min(Skv, q0 + BQ + off) : Skv;

  for (int kv0 = 0; kv0 < kv_end; kv0 += QBKV) {
    __syncthreads();  // the previous tile is consumed
    load_tile_u8<D, LDB, BF16_THREADS>(Ks, k + kv_base + kv0 * kvstr, kvstr, QBKV, Skv - kv0);
    if (PV8)
      load_tile_u8<D, LDB, BF16_THREADS>(V8s, static_cast<const uint8_t*>(v) + kv_base + kv0 * kvstr,
                                         kvstr, QBKV, Skv - kv0);
    else
      load_tile_bf16<D, LDV, BF16_THREADS>(
          Vs, static_cast<const __nv_bfloat16*>(v) + kv_base + kv0 * kvstr, kvstr, QBKV, Skv - kv0);
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      int ci[4] = {0, 0, 0, 0};
      float cf[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kc = 0; kc < DK; ++kc) {
        uint32_t b0, b1;
        b_frag8_t<LDB>(b0, b1, Ks, n * 8, kc * 32, g, t4);
        mma_8bit<QK8>(ci, cf, qf[kc], b0, b1);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = QK8 == 0 ? static_cast<float>(ci[e]) : cf[e];
    }

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kv0 + n * 8 + t4 * 2 + (e & 1);
        const bool ok = col < Skv && (!causal || col <= rows[e >> 1] + off);
        s[n][e] = ok ? s[n][e] * sc : MASK_VALUE;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);  // >= MASK_VALUE: finite
      alpha[i] = exp2f((m[i] - m_new) * LOG2E);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
    // PV8: p = exp(s - m + ln 127), in [0, 127]; l carries the factor 127.
    const float shift = PV8 ? LOG2_127 : 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f((s[n][e] - m[e >> 1]) * LOG2E + shift);
        l[e >> 1] += s[n][e];
      }
    }
    if (PV8) {
      // P to int8 by truncating p + 0.5; chunk c holds keys 32c..32c+31 in
      // the order of common.cuh's v_frag8.
      auto p8 = [](float p) { return static_cast<uint32_t>(min(__float2int_rz(p + 0.5f), 127)); };
      uint32_t pa[QBKV / 32][4];
#pragma unroll
      for (int c = 0; c < QBKV / 32; ++c) {
        pa[c][0] = pack_bytes(p8(s[4 * c][0]), p8(s[4 * c][1]), p8(s[4 * c + 1][0]), p8(s[4 * c + 1][1]));
        pa[c][1] = pack_bytes(p8(s[4 * c][2]), p8(s[4 * c][3]), p8(s[4 * c + 1][2]), p8(s[4 * c + 1][3]));
        pa[c][2] = pack_bytes(p8(s[4 * c + 2][0]), p8(s[4 * c + 2][1]), p8(s[4 * c + 3][0]), p8(s[4 * c + 3][1]));
        pa[c][3] = pack_bytes(p8(s[4 * c + 2][2]), p8(s[4 * c + 2][3]), p8(s[4 * c + 3][2]), p8(s[4 * c + 3][3]));
      }
#pragma unroll
      for (int dn = 0; dn < DT; ++dn) {
        int pv[4] = {0, 0, 0, 0};  // the block's exact int32 P.V sum
#pragma unroll
        for (int c = 0; c < QBKV / 32; ++c) {
          uint32_t b0, b1;
          v_frag8<LDB>(b0, b1, V8s, c * 32, dn * 8, g, t4);
          mma_s8_16832(pv, pa[c], b0, b1);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)  // acc * alpha + pv, rounded as written (no FMA)
          acc[dn][e] = __fadd_rn(__fmul_rn(acc[dn][e], alpha[e >> 1]), static_cast<float>(pv[e]));
      }
    } else {
#pragma unroll
      for (int dn = 0; dn < DT; ++dn) {
        acc[dn][0] *= alpha[0];
        acc[dn][1] *= alpha[0];
        acc[dn][2] *= alpha[1];
        acc[dn][3] *= alpha[1];
      }
#pragma unroll
      for (int kc = 0; kc < QBKV / 16; ++kc) {
        uint32_t pa[4];
        pa[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
        pa[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
        pa[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
        pa[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
        for (int dn = 0; dn < DT; ++dn) mma_bn<LDV>(acc[dn], pa, Vs, kc * 16, dn * 8, g, t4);
      }
    }
  }

  const float* vsr = PV8 ? v_scales + ((long long)b * Hkv + hk) * D : nullptr;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    if (rows[i] >= Sq) continue;
    const float inv = l[i] == 0.f ? 1.f : 1.f / l[i];
    OutT* orow = o + ((long long)b * Sq + rows[i]) * qstr + (long long)h * D;
#pragma unroll
    for (int dn = 0; dn < DT; ++dn) {
      const int c0 = dn * 8 + t4 * 2;
      float a0 = acc[dn][2 * i] * inv, a1 = acc[dn][2 * i + 1] * inv;
      if (PV8) {
        a0 *= vsr[c0];
        a1 *= vsr[c0 + 1];
      }
      store2(orow + c0, a0, a1);
    }
  }
}

struct FwdArgs {
  const void *q, *k, *v;
  void* o;
  float* lse;
  const int* lens;
  const float *kbias, *relvec, *qkbias;
  int Hb, Sq, Skv, Hq, Hkv;
  float scale;
  int causal;
  Streams st;
};

template <int D, int MODE>
cudaError_t run_f32(const FwdArgs& a, dim3 grid, cudaStream_t st) {
  constexpr int smem = (2 * BQ * (D + 1) + BKV * D + BQ * (BKV + 1)) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_f32<D, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  flash_fwd_f32<D, MODE><<<grid, F32_THREADS, smem, st>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.lse, a.lens, a.kbias,
      a.relvec, a.qkbias, a.Hb, a.Sq, a.Skv, a.Hq, a.Hkv, a.scale, a.causal, a.st);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t run(const FwdArgs& a, int D, int dtype, dim3 grid, cudaStream_t st) {
  if (dtype == PFA_BF16)  // grid.z is B
    return k1_bf16_sm90(K1Args{a.q, a.k, a.v, a.o, a.lse, a.lens, a.kbias, a.relvec, a.qkbias,
                               static_cast<int>(grid.z), a.Hb, a.Sq, a.Skv, a.Hq, a.Hkv, D, a.scale,
                               a.causal, a.st},
                        MODE, st);
  if (dtype == PFA_F32 && D == 64) return run_f32<64, MODE>(a, grid, st);
  if (dtype == PFA_F32 && D == 128) return run_f32<128, MODE>(a, grid, st);
  return cudaErrorInvalidValue;
}

struct QuantArgs {
  const void *q, *k, *v;
  void* o;
  const float *score_scale, *v_scales;
  int Sq, Skv, Hq, Hkv, causal;
};

template <int D, int QK8, bool PV8, typename OutT>
cudaError_t run_quant(const QuantArgs& a, dim3 grid, cudaStream_t st) {
  constexpr int smem = (BQ + QBKV) * (D + 16) +
                       (PV8 ? QBKV * (D + 16) : QBKV * (D + 8) * (int)sizeof(__nv_bfloat16));
  auto kernel = flash_fwd_quant<D, QK8, PV8, OutT>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, BF16_THREADS, smem, st>>>(
      static_cast<const uint8_t*>(a.q), static_cast<const uint8_t*>(a.k), a.v,
      static_cast<OutT*>(a.o), a.score_scale, a.v_scales, a.Sq, a.Skv, a.Hq, a.Hkv, a.causal);
  return cudaGetLastError();
}

template <int QK8, bool PV8>
cudaError_t run_quant_mode(const QuantArgs& a, int D, int out_dtype, dim3 grid, cudaStream_t st) {
  const bool bf = out_dtype == PFA_BF16;
  if (out_dtype != PFA_BF16 && out_dtype != PFA_F32) return cudaErrorInvalidValue;
  if (D == 64)
    return bf ? run_quant<64, QK8, PV8, __nv_bfloat16>(a, grid, st) : run_quant<64, QK8, PV8, float>(a, grid, st);
  if (D == 128)
    return bf ? run_quant<128, QK8, PV8, __nv_bfloat16>(a, grid, st) : run_quant<128, QK8, PV8, float>(a, grid, st);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" const char* pfa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// lens (B,) int32 and kbias (B, Skv) fp32 may each be null; both null runs
// the plain path. win_lo/win_hi bound the window (-/+ WINDOW_OPEN when
// open); thresh 0 turns dropout off, else seed, thresh and inv_keep are
// the hash's seed, its keep threshold and 1 / (1 - rate).
extern "C" int pfa_flash_fwd(const void* q, const void* k, const void* v, void* o,
                             void* lse_out, const void* lens, const void* kbias, int B, int Sq,
                             int Skv, int Hq, int Hkv, int D, float sm_scale, int causal,
                             int win_lo, int win_hi, unsigned seed, unsigned thresh,
                             float inv_keep, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || Hq % Hkv != 0)
    return cudaErrorInvalidValue;
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  const FwdArgs a{q, k, v, o, static_cast<float*>(lse_out), static_cast<const int*>(lens),
                  static_cast<const float*>(kbias), nullptr, nullptr, 0, Sq, Skv, Hq, Hkv,
                  sm_scale, causal, Streams{win_lo, win_hi, seed, thresh, inv_keep}};
  const bool keys = lens != nullptr || kbias != nullptr, drop = thresh != 0u;
  const bool window = win_lo > -WINDOW_OPEN || win_hi < WINDOW_OPEN;
  if (keys + drop + window > 1) return cudaErrorInvalidValue;  // not combined (JAX's rules)
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (keys) return run<STREAMS>(a, D, dtype, grid, st);
  if (drop) return run<DROPOUT>(a, D, dtype, grid, st);
  if (window) return run<WINDOW>(a, D, dtype, grid, st);
  return run<PLAIN>(a, D, dtype, grid, st);
}

// Structured-bias modes: exactly one of relvec (Hq, Sq+Skv-1) fp32 and
// qkbias (B, Hb, Sq, Skv) fp32, Hb 1 or Hq; lse (B, Hq, Sq) fp32 is written
// when not null.
extern "C" int pfa_flash_fwd_bias(const void* q, const void* k, const void* v, void* o,
                                  void* lse_out, const void* relvec, const void* qkbias, int B,
                                  int Sq, int Skv, int Hq, int Hkv, int D, int Hb, float sm_scale,
                                  int causal, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      (relvec == nullptr) == (qkbias == nullptr) || (qkbias != nullptr && Hb != 1 && Hb != Hq))
    return cudaErrorInvalidValue;
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  const FwdArgs a{q, k, v, o, static_cast<float*>(lse_out), nullptr, nullptr,
                  static_cast<const float*>(relvec), static_cast<const float*>(qkbias), Hb, Sq,
                  Skv, Hq, Hkv, sm_scale, causal,
                  Streams{-WINDOW_OPEN, WINDOW_OPEN, 0u, 0u, 1.f}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (relvec != nullptr) return run<REL>(a, D, dtype, grid, st);
  return run<DENSE>(a, D, dtype, grid, st);
}

// Quantized modes. q (B, Sq, Hq, D) and k (B, Skv, Hkv, D) 8-bit payloads
// (qk_dtype int8 or e4m3); v (B, Skv, Hkv, D) bf16, or int8 with v_scales
// (B, Hkv, D) fp32 when pv_int8 (int8 Q/K only); score_scale a (1,) fp32
// device scalar; o (B, Sq, Hq, D) bf16 or fp32 (out_dtype).
extern "C" int pfa_flash_fwd_quant(const void* q, const void* k, const void* v, void* o,
                                   const void* score_scale, const void* v_scales, int B, int Sq,
                                   int Skv, int Hq, int Hkv, int D, int causal, int qk_dtype,
                                   int pv_int8, int out_dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || Hq % Hkv != 0 || score_scale == nullptr ||
      (pv_int8 && v_scales == nullptr))
    return cudaErrorInvalidValue;
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  const QuantArgs a{q, k, v, o, static_cast<const float*>(score_scale),
                    static_cast<const float*>(v_scales), Sq, Skv, Hq, Hkv, causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (qk_dtype == PFA_INT8 && pv_int8) return run_quant_mode<0, true>(a, D, out_dtype, grid, st);
  if (qk_dtype == PFA_INT8) return run_quant_mode<0, false>(a, D, out_dtype, grid, st);
  if (qk_dtype == PFA_E4M3 && !pv_int8) return run_quant_mode<1, false>(a, D, out_dtype, grid, st);
  return cudaErrorInvalidValue;
}
