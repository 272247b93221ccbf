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
// What bounds it on the H100: prefill attention over S ~ 1k-2k tokens does
// ~S/2 multiply-adds per loaded K/V byte (causal), far above the bf16 ridge
// (H100 SXM data sheet at its 700 W limit: 989 TFLOP/s over 3.35 TB/s,
// ~295 FLOP/byte), so the tensor-core rate is the limit, not HBM.
// Design: the bf16 path runs every product on the tensor cores
// (mma.sync m16n8k16, fp32 accumulate) and keeps the scores in registers
// (the FA2 register layout: a score tile's accumulator fragment is reused
// as the A operand of P.V), so nothing of size S^2 touches memory. Each
// block stages one 64-row K/V tile in shared memory for 64 query rows and
// skips tiles above the causal diagonal. wgmma, TMA and warp
// specialisation are left to later work. The fp32 path keeps fp32 inputs
// in fp32 (FMA loops, no bf16 or TF32 rounding).
//
// Not carried over from the TPU: the lane-replicated (.,128) softmax
// statistics, the one-launch-per-row-block "triangular" scheme of the
// unrolled kernel, and the 128-lane padding of S and D: ragged edges are
// masked in the kernel.

#include "common.cuh"

namespace {

constexpr int BQ = 64;            // query rows per block
constexpr int BKV = 64;           // keys per K/V tile
constexpr int BF16_THREADS = 128; // 4 warps x 16 query rows
constexpr int F32_THREADS = 256;  // 4 threads per query row
// bf16: each warp owns 16 query rows. In the m16n8k16 fragments a lane
// (g = lane/4, t4 = lane%4) holds rows g and g+8 and columns 2*t4, 2*t4+1
// of every 8-wide score tile.
template <int D>
__global__ void __launch_bounds__(BF16_THREADS)
flash_fwd_bf16(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int Sq,
               int Skv, int Hq, int Hkv, float scale_log2, int causal) {
  constexpr int LD = D + 8;   // padded shared row: conflict-free fragment loads
  constexpr int NT = BKV / 8; // 8-wide score tiles per K/V tile
  constexpr int DT = D / 8;   // 8-wide output tiles
  constexpr int DK = D / 16;  // k-steps over D
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + BQ * LD;
  __nv_bfloat16* Vs = Ks + BKV * LD;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const long long qstr = (long long)Hq * D, kvstr = (long long)Hkv * D;
  const __nv_bfloat16* qb = q + (long long)b * Sq * qstr + (long long)h * D;
  const __nv_bfloat16* kb = k + (long long)b * Skv * kvstr + (long long)hk * D;
  const __nv_bfloat16* vb = v + (long long)b * Skv * kvstr + (long long)hk * D;

  load_tile_bf16<D, LD, BF16_THREADS>(Qs, qb + q0 * qstr, qstr, BQ, Sq - q0);
  __syncthreads();
  const int wr = warp * 16;
  uint32_t qf[DK][4];
#pragma unroll
  for (int kc = 0; kc < DK; ++kc) {
    const __nv_bfloat16* p = Qs + (wr + g) * LD + kc * 16 + t4 * 2;
    qf[kc][0] = *reinterpret_cast<const uint32_t*>(p);
    qf[kc][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LD);
    qf[kc][2] = *reinterpret_cast<const uint32_t*>(p + 8);
    qf[kc][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LD + 8);
  }

  float acc[DT][4];
#pragma unroll
  for (int dn = 0; dn < DT; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max (log2 domain), rows g, g+8
  float l[2] = {0.f, 0.f};              // this lane's share of the running sum
  const int off = Skv - Sq;
  const int rows[2] = {q0 + wr + g, q0 + wr + g + 8};
  const int kv_end = causal ? min(Skv, q0 + BQ + off) : Skv;

  for (int kv0 = 0; kv0 < kv_end; kv0 += BKV) {
    __syncthreads();  // the previous tile is consumed
    load_tile_bf16<D, LD, BF16_THREADS>(Ks, kb + kv0 * kvstr, kvstr, BKV, Skv - kv0);
    load_tile_bf16<D, LD, BF16_THREADS>(Vs, vb + kv0 * kvstr, kvstr, BKV, Skv - kv0);
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < DK; ++kc) {
        const __nv_bfloat16* p = Ks + (n * 8 + g) * LD + kc * 16 + t4 * 2;
        mma_16816(s[n], qf[kc], *reinterpret_cast<const uint32_t*>(p),
                  *reinterpret_cast<const uint32_t*>(p + 8));
      }
    }

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kv0 + n * 8 + t4 * 2 + (e & 1);
        const bool ok = col < Skv && (!causal || col <= rows[e >> 1] + off);
        s[n][e] = ok ? s[n][e] * scale_log2 : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    }
    float alpha[2], base[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      base[i] = m_new == -INFINITY ? 0.f : m_new;  // row fully masked so far
      alpha[i] = exp2f(m[i] - base[i]);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(s[n][e] - base[e >> 1]);
        l[e >> 1] += s[n][e];
      }
    }
#pragma unroll
    for (int dn = 0; dn < DT; ++dn) {
      acc[dn][0] *= alpha[0];
      acc[dn][1] *= alpha[0];
      acc[dn][2] *= alpha[1];
      acc[dn][3] *= alpha[1];
    }
#pragma unroll
    for (int kc = 0; kc < BKV / 16; ++kc) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      pa[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      pa[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      pa[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
      for (int dn = 0; dn < DT; ++dn) {
        const __nv_bfloat16* p = Vs + (kc * 16 + t4 * 2) * LD + dn * 8 + g;
        mma_16816(acc[dn], pa, pack_raw(p[0], p[LD]), pack_raw(p[8 * LD], p[9 * LD]));
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    if (rows[i] >= Sq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    __nv_bfloat16* orow = o + ((long long)b * Sq + rows[i]) * qstr + (long long)h * D;
#pragma unroll
    for (int dn = 0; dn < DT; ++dn) {
      *reinterpret_cast<__nv_bfloat162*>(orow + dn * 8 + t4 * 2) =
          __floats2bfloat162_rn(acc[dn][2 * i] * inv, acc[dn][2 * i + 1] * inv);
    }
    if (lse != nullptr && t4 == 0)
      lse[((long long)b * Hq + h) * Sq + rows[i]] =
          l[i] > 0.f ? (m[i] + log2f(l[i])) * LN2 : -INFINITY;
  }
}

// fp32: 4 threads per query row (thread quarter qd owns keys qd + 4j of a
// tile and output columns qd + 4j); plain FMA, no reduced-precision math.
template <int D>
__global__ void __launch_bounds__(F32_THREADS)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o,
              float* __restrict__ lse, int Sq, int Skv, int Hq, int Hkv,
              float scale_log2, int causal) {
  constexpr int LDK = D + 1;    // padded rows: conflict-free column reads
  constexpr int LDP = BKV + 1;
  constexpr int NJ = BKV / 4;   // scores per thread per tile
  constexpr int DJ = D / 4;     // output columns per thread
  extern __shared__ float smf[];
  float* Qs = smf;
  float* Ks = Qs + BQ * LDK;
  float* Vs = Ks + BKV * LDK;
  float* Ps = Vs + BKV * D;

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
  const int kv_end = causal ? min(Skv, q0 + BQ + off) : Skv;

  for (int kv0 = 0; kv0 < kv_end; kv0 += BKV) {
    __syncthreads();
    for (int i = threadIdx.x; i < BKV * D; i += F32_THREADS) {
      const int rr = i / D, c = i % D;
      const bool ok = kv0 + rr < Skv;
      Ks[rr * LDK + c] = ok ? kb[(kv0 + rr) * kvstr + c] : 0.f;
      Vs[rr * D + c] = ok ? vb[(kv0 + rr) * kvstr + c] : 0.f;
    }
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
      const bool ok = col < Skv && (!causal || col <= row + off);
      s[j] = ok ? s[j] * scale_log2 : -INFINITY;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float base = m_new == -INFINITY ? 0.f : m_new;
    const float alpha = exp2f(m - base);
    m = m_new;
    l *= alpha;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float p = exp2f(s[j] - base);
      l += p;
      Ps[r * LDP + qd + 4 * j] = p;
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
  if (lse != nullptr && qd == 0)
    lse[((long long)b * Hq + h) * Sq + row] = l > 0.f ? (m + log2f(l)) * LN2 : -INFINITY;
}

template <int D>
cudaError_t run_bf16(const void* q, const void* k, const void* v, void* o, float* lse, dim3 grid,
                     int Sq, int Skv, int Hq, int Hkv, float sl2, int causal,
                     cudaStream_t st) {
  constexpr int smem = (BQ + 2 * BKV) * (D + 8) * sizeof(__nv_bfloat16);
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  flash_fwd_bf16<D><<<grid, BF16_THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, Sq,
      Skv, Hq, Hkv, sl2, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t run_f32(const void* q, const void* k, const void* v, void* o, float* lse, dim3 grid,
                    int Sq, int Skv, int Hq, int Hkv, float sl2, int causal,
                    cudaStream_t st) {
  constexpr int smem = (2 * BQ * (D + 1) + BKV * D + BQ * (BKV + 1)) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  flash_fwd_f32<D><<<grid, F32_THREADS, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, Sq, Skv, Hq, Hkv,
      sl2, causal);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* pfa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int pfa_flash_fwd(const void* q, const void* k, const void* v, void* o,
                             void* lse_out, int B, int Sq, int Skv, int Hq, int Hkv, int D,
                             float sm_scale, int causal, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || Hq % Hkv != 0)
    return cudaErrorInvalidValue;
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  const float sl2 = sm_scale * LOG2E;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lse = static_cast<float*>(lse_out);  // may be null
  if (dtype == PFA_BF16 && D == 64) return run_bf16<64>(q, k, v, o, lse, grid, Sq, Skv, Hq, Hkv, sl2, causal, st);
  if (dtype == PFA_BF16 && D == 128) return run_bf16<128>(q, k, v, o, lse, grid, Sq, Skv, Hq, Hkv, sl2, causal, st);
  if (dtype == PFA_F32 && D == 64) return run_f32<64>(q, k, v, o, lse, grid, Sq, Skv, Hq, Hkv, sl2, causal, st);
  if (dtype == PFA_F32 && D == 128) return run_f32<128>(q, k, v, o, lse, grid, Sq, Skv, Hq, Hkv, sl2, causal, st);
  return cudaErrorInvalidValue;
}
