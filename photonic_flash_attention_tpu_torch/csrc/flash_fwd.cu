// K1: flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernels photonic_flash_attention_tpu/ops/flash.py::
// _flash_fwd_kernel (plain causal contract) and ops/flash_unrolled.py::
// _kernel. One kernel serves both public entry points of the port
// (ops/flash.py::flash_attention, ops/flash_unrolled.py::flash_attention_best).
//
// Contract: q (B, Sq, Hq, D), k/v (B, Skv, Hkv, D), contiguous, Hq % Hkv == 0
// (GQA: q head h reads kv head h / (Hq/Hkv)), D from 1 to 128 on the
// widths 64 and 128 (bf16: a multiple of 8, ops/_build.py::head_dim_plan
// pads the rest; fp32: any), bf16 or fp32;
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
// block, one 64-key K/V tile).
//
// Not carried over from the TPU: the lane-replicated (.,128) softmax
// statistics, the one-launch-per-row-block "triangular" scheme of the
// unrolled kernel, and the 128-lane padding of S and D: ragged edges are
// masked in the kernel.
//
// The quantized modes (pfa_flash_fwd_quant: int8-QK, fp8-QK, int8-full)
// are flash_quant_sm90.cu (TMA, 8-bit wgmma, warp-specialised), beside K6.

#include "flash_fwd_sm90.cuh"

namespace {

constexpr int BQ = 64;            // query rows per block
constexpr int BKV = 64;           // keys per K/V tile
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
// Two CTAs a SM: unbounded, ptxas gave the relative-bias body at D 128 64
// registers and a spill.
__global__ void __launch_bounds__(F32_THREADS, 2)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o,
              float* __restrict__ lse, const int* __restrict__ lens,
              const float* __restrict__ kbias, const float* __restrict__ relvec,
              const float* __restrict__ qkbias, int Hb, int Sq, int Skv, int Hq, int Hkv,
              int d, float sm_scale, int causal, Streams st) {
  // D: the compiled width; d: the real head dim, the rows' pitch. Columns
  // d..D-1 load as zeros (nothing in Q K^T) and are not stored.
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
  const long long qstr = (long long)Hq * d, kvstr = (long long)Hkv * d;
  const float* qb = q + (long long)b * Sq * qstr + (long long)h * d;
  const float* kb = k + (long long)b * Skv * kvstr + (long long)hk * d;
  const float* vb = v + (long long)b * Skv * kvstr + (long long)hk * d;

  for (int i = threadIdx.x; i < BQ * D; i += F32_THREADS) {
    const int rr = i / D, c = i % D;
    Qs[rr * LDK + c] = q0 + rr < Sq && c < d ? qb[(q0 + rr) * qstr + c] : 0.f;
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
      const bool ok = kv0 + rr < Skv && c < d;
      Ks[rr * LDK + c] = ok ? kb[(kv0 + rr) * kvstr + c] : 0.f;
      Vs[rr * D + c] = ok ? vb[(kv0 + rr) * kvstr + c] : 0.f;
    }
    stage_bias<MODE, F32_THREADS>(Bs, bias_row, rel_row, q0, kv0, Sq, Skv);
    __syncthreads();

    float s[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[j] = 0.f;
    for (int c = 0; c < D; ++c) {
      const float qv = Qs[r * LDK + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) s[j] = fmaf(qv, Ks[(qd + 4 * j) * LDK + c], s[j]);
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
  float* orow = o + ((long long)b * Sq + row) * qstr + (long long)h * d;
#pragma unroll
  for (int j = 0; j < DJ; ++j)
    if (qd + 4 * j < d) orow[qd + 4 * j] = acc[j] * inv;
  if (lse != nullptr && qd == 0) lse[((long long)b * Hq + h) * Sq + row] = stream_lse<MODE>(m, l);
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
cudaError_t run_f32(const FwdArgs& a, int d, dim3 grid, cudaStream_t st) {
  constexpr int smem = (2 * BQ * (D + 1) + BKV * D + BQ * (BKV + 1)) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_f32<D, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  flash_fwd_f32<D, MODE><<<grid, F32_THREADS, smem, st>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.lse, a.lens, a.kbias,
      a.relvec, a.qkbias, a.Hb, a.Sq, a.Skv, a.Hq, a.Hkv, d, a.scale, a.causal, a.st);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t run(const FwdArgs& a, int D, int dtype, dim3 grid, cudaStream_t st) {
  if (dtype == PFA_BF16)  // grid.z is B
    return k1_bf16_sm90(K1Args{a.q, a.k, a.v, a.o, a.lse, a.lens, a.kbias, a.relvec, a.qkbias,
                               static_cast<int>(grid.z), a.Hb, a.Sq, a.Skv, a.Hq, a.Hkv, D, a.scale,
                               a.causal, a.st},
                        MODE, st);
  if (dtype != PFA_F32 || D < 1 || D > 128) return cudaErrorInvalidValue;
  return D <= 64 ? run_f32<64, MODE>(a, D, grid, st) : run_f32<128, MODE>(a, D, grid, st);
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
