// K4 (dK/dV) and K5 (dQ): flash-attention backward for Hopper (sm_90a).
//
// Replace the TPU kernels photonic_flash_attention_tpu/ops/flash_bwd.py::
// _dkv_kernel and _dq_kernel (the grid pair, flash_attention_bwd_pallas)
// and _dkv_kernel_unrolled and _dq_kernel_unrolled (the unrolled pair,
// flash_attention_bwd_unrolled). Both TPU pairs compute the same dq/dk/dv;
// the split exists only because of how Mosaic schedules a grid step, so
// one pair serves every shape here (ops/flash_bwd.py::flash_attention_bwd).
//
// Contract: q, o, dO (B, Sq, H, D) and k, v (B, Skv, H, D) contiguous, with
// K/V already repeated to the q heads for GQA (the caller sums dk/dv over
// the group); lse (B, H, Sq) fp32 in natural log (K1's residual) and
// di = rowsum(o * dO) (B, H, Sq) fp32; D in {64, 128}; bf16 or fp32;
// causal aligned to the sequence end (key j visible to row i iff
// j <= i + Skv - Sq). dq/dk/dv come out in the input dtype.
//
// Math (flash_bwd.py::_p_and_ds), with scale = sm_scale:
//   P = exp(S*scale - lse)   dV += P^T dO   dP = dO V^T
//   dS = P * (dP - di) * scale   dK += dS^T Q   dQ += dS K
// The exponent runs in the log2 domain: P = exp2(S*scale*log2e - lse*log2e).
// The mask is applied BEFORE the exp (a row with lse = -inf gives P = 0,
// not NaN), and padded q rows / kv columns are masked in the kernel, so
// they contribute nothing and nothing is padded in memory.
//
// What bounds it on the H100: like the forward, S/2 multiply-adds per
// loaded byte at S ~ 1k-2k, far above the bf16 ridge (~295 FLOP/byte at
// the data sheet's 989 TFLOP/s over 3.35 TB/s); the backward does 2.5x the
// forward's products (5 per tile against 2), so the tensor-core rate is the
// limit. Design: the bf16 path runs every product on mma.sync m16n8k16
// with fp32 accumulation and keeps score tiles in registers. K4 works in
// the transposed score domain of the JAX kernels, s_t = K Q^T (kv rows x q
// columns), so the accumulator fragments of P_t and dS_t are directly the
// A operands of dV += P_t dO and dK += dS_t Q (dO and Q read k-major, as K1
// reads V); lse and di are indexed by the q column. K5 works in the q-major
// domain (s = Q K^T), where dS is the A operand of dQ += dS K. Two kernels,
// as in JAX: dQ needs no atomics and the result is deterministic. dK/dV and
// dQ live in fp32 registers and are written once. Rounding follows JAX
// (flash_bwd.py:235-240, 316-321): P is rounded to the input dtype before
// the dV product, dS before the dK and dQ products. The fp32 path keeps
// fp32 in fp32 (FMA loops, no bf16 or TF32 rounding). wgmma, TMA and warp
// specialisation are later work.
//
// Not carried over from the TPU: the skip-aware prefetch index maps (a
// block's loop simply starts or ends at the causal diagonal), the
// lse-padded-with-0 trick for padded q rows (masked here), the VMEM
// envelope of the unrolled pair, and the dropout / window streams (later
// slice: ROADMAP B10).

#include "common.cuh"

namespace {

constexpr int BR = 64;            // rows a block owns: kv rows (K4), q rows (K5)
constexpr int BF16_THREADS = 128; // 4 warps x 16 rows
constexpr int F32_THREADS = 256;  // 4 threads per row

// Width of the inner tile (q columns in K4, kv columns in K5) in the bf16
// path: 32 at D 128 keeps the per-thread fp32 accumulators under the
// register limit.
template <int D>
struct Inner {
  static constexpr int W = D == 64 ? 64 : 32;
};

template <int D>
constexpr int smem_bf16() {
  return (2 * BR + 2 * Inner<D>::W) * (D + 8) * 2 + 2 * Inner<D>::W * 4;
}

// --- K4: dK, dV -------------------------------------------------------------

// bf16: each warp owns 16 kv rows of the block; a lane holds kv rows g, g+8
// and q columns 2*t4, 2*t4+1 of every 8-wide tile of s_t.
template <int D>
__global__ void __launch_bounds__(BF16_THREADS)
bwd_dkv_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ di,
             __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Sq,
             int Skv, int H, float scale, float scale_log2, int causal) {
  constexpr int W = Inner<D>::W;  // q columns per tile
  constexpr int LD = D + 8;       // padded shared row: conflict-free fragments
  constexpr int NT = W / 8;       // 8-wide s_t tiles across q
  constexpr int DT = D / 8;       // 8-wide output tiles
  constexpr int DK = D / 16;      // k-steps over D
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + BR * LD;
  __nv_bfloat16* Qs = Vs + BR * LD;
  __nv_bfloat16* Os = Qs + W * LD;  // dO tile
  float* Ls = reinterpret_cast<float*>(Os + W * LD);  // lse * log2e
  float* Dis = Ls + W;

  const int kv0 = blockIdx.x * BR, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3, wr = warp * 16;
  const long long str = (long long)H * D;
  const __nv_bfloat16* qb = q + (long long)b * Sq * str + (long long)h * D;
  const __nv_bfloat16* ob = dout + (long long)b * Sq * str + (long long)h * D;
  const long long kvoff = (long long)b * Skv * str + (long long)h * D;
  const float* lseb = lse + ((long long)b * H + h) * Sq;
  const float* dib = di + ((long long)b * H + h) * Sq;

  load_tile_bf16<D, LD, BF16_THREADS>(Ks, k + kvoff + kv0 * str, str, BR, Skv - kv0);
  load_tile_bf16<D, LD, BF16_THREADS>(Vs, v + kvoff + kv0 * str, str, BR, Skv - kv0);

  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int dn = 0; dn < DT; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[dn][e] = dva[dn][e] = 0.f;
  const int off = Skv - Sq;
  const int rows[2] = {kv0 + wr + g, kv0 + wr + g + 8};
  // The first q tile that sees this kv tile under the causal mask.
  const int q_begin = causal ? max(0, kv0 - off) / W * W : 0;

  for (int q0 = q_begin; q0 < Sq; q0 += W) {
    __syncthreads();  // the previous q tile is consumed
    load_tile_bf16<D, LD, BF16_THREADS>(Qs, qb + q0 * str, str, W, Sq - q0);
    load_tile_bf16<D, LD, BF16_THREADS>(Os, ob + q0 * str, str, W, Sq - q0);
    for (int i = threadIdx.x; i < W; i += BF16_THREADS) {
      const bool ok = q0 + i < Sq;
      Ls[i] = ok ? lseb[q0 + i] * LOG2E : 0.f;
      Dis[i] = ok ? dib[q0 + i] : 0.f;
    }
    __syncthreads();

    // s_t = K Q^T, dp_t = V dO^T: (16 kv rows x W q columns) per warp.
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < DK; ++kc) {
      uint32_t ka[4], va[4];
      load_a_frag<LD>(ka, Ks, wr, kc * 16, g, t4);
      load_a_frag<LD>(va, Vs, wr, kc * 16, g, t4);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        mma_bt<LD>(s[n], ka, Qs, n * 8, kc * 16, g, t4);
        mma_bt<LD>(dp[n], va, Os, n * 8, kc * 16, g, t4);
      }
    }
    // p_t (in s) and ds_t (in dp), masked before the exp.
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = n * 8 + t4 * 2 + (e & 1);
        const int kr = rows[e >> 1];
        const bool ok = q0 + qc < Sq && kr < Skv && (!causal || kr <= q0 + qc + off);
        const float p = ok ? exp2f(s[n][e] * scale_log2 - Ls[qc]) : 0.f;
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - Dis[qc]) * scale;
      }
    }
    // dV += P_t dO, dK += dS_t Q: contraction over the tile's q columns.
#pragma unroll
    for (int kc = 0; kc < W / 16; ++kc) {
      uint32_t pa[4], da[4];
      pa[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      pa[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      pa[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      pa[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
      da[0] = pack_bf16(dp[2 * kc][0], dp[2 * kc][1]);
      da[1] = pack_bf16(dp[2 * kc][2], dp[2 * kc][3]);
      da[2] = pack_bf16(dp[2 * kc + 1][0], dp[2 * kc + 1][1]);
      da[3] = pack_bf16(dp[2 * kc + 1][2], dp[2 * kc + 1][3]);
#pragma unroll
      for (int dn = 0; dn < DT; ++dn) {
        mma_bn<LD>(dva[dn], pa, Os, kc * 16, dn * 8, g, t4);
        mma_bn<LD>(dka[dn], da, Qs, kc * 16, dn * 8, g, t4);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= Skv) continue;
    const long long at = kvoff + rows[i] * str;
#pragma unroll
    for (int dn = 0; dn < DT; ++dn) {
      const int c = dn * 8 + t4 * 2;
      *reinterpret_cast<__nv_bfloat162*>(dk + at + c) =
          __floats2bfloat162_rn(dka[dn][2 * i], dka[dn][2 * i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + at + c) =
          __floats2bfloat162_rn(dva[dn][2 * i], dva[dn][2 * i + 1]);
    }
  }
}

// fp32: 4 threads per kv row (thread quarter qd owns q columns qd + 4j of a
// tile and output columns qd + 4j); plain FMA.
template <int D>
__global__ void __launch_bounds__(F32_THREADS)
bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ di,
            float* __restrict__ dk, float* __restrict__ dv, int Sq, int Skv, int H,
            float scale, float scale_log2, int causal) {
  constexpr int LDK = D + 1;  // padded rows: conflict-free column reads
  constexpr int LDP = BR + 1;
  constexpr int NJ = BR / 4;  // q columns per thread per tile
  constexpr int DJ = D / 4;   // output columns per thread
  extern __shared__ float smf[];
  float* Ks = smf;
  float* Vs = Ks + BR * LDK;
  float* Qs = Vs + BR * LDK;
  float* Os = Qs + BR * LDK;
  float* Ps = Os + BR * LDK;
  float* Ss = Ps + BR * LDP;
  float* Ls = Ss + BR * LDP;
  float* Dis = Ls + BR;

  const int kv0 = blockIdx.x * BR, h = blockIdx.y, b = blockIdx.z;
  const int r = threadIdx.x >> 2, qd = threadIdx.x & 3;
  const long long str = (long long)H * D;
  const float* qb = q + (long long)b * Sq * str + (long long)h * D;
  const float* ob = dout + (long long)b * Sq * str + (long long)h * D;
  const long long kvoff = (long long)b * Skv * str + (long long)h * D;
  const float* lseb = lse + ((long long)b * H + h) * Sq;
  const float* dib = di + ((long long)b * H + h) * Sq;

  load_tile_f32<D, LDK, F32_THREADS>(Ks, k + kvoff + kv0 * str, str, BR, Skv - kv0);
  load_tile_f32<D, LDK, F32_THREADS>(Vs, v + kvoff + kv0 * str, str, BR, Skv - kv0);
  float dka[DJ], dva[DJ];
#pragma unroll
  for (int j = 0; j < DJ; ++j) dka[j] = dva[j] = 0.f;
  const int off = Skv - Sq, krow = kv0 + r;
  const int q_begin = causal ? max(0, kv0 - off) / BR * BR : 0;

  for (int q0 = q_begin; q0 < Sq; q0 += BR) {
    __syncthreads();
    load_tile_f32<D, LDK, F32_THREADS>(Qs, qb + q0 * str, str, BR, Sq - q0);
    load_tile_f32<D, LDK, F32_THREADS>(Os, ob + q0 * str, str, BR, Sq - q0);
    for (int i = threadIdx.x; i < BR; i += F32_THREADS) {
      const bool ok = q0 + i < Sq;
      Ls[i] = ok ? lseb[q0 + i] * LOG2E : 0.f;
      Dis[i] = ok ? dib[q0 + i] : 0.f;
    }
    __syncthreads();

    float s[NJ], dp[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[j] = dp[j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float kd = Ks[r * LDK + d], vd = Vs[r * LDK + d];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        s[j] = fmaf(kd, Qs[(qd + 4 * j) * LDK + d], s[j]);
        dp[j] = fmaf(vd, Os[(qd + 4 * j) * LDK + d], dp[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int qc = qd + 4 * j;
      const bool ok = q0 + qc < Sq && krow < Skv && (!causal || krow <= q0 + qc + off);
      const float p = ok ? exp2f(s[j] * scale_log2 - Ls[qc]) : 0.f;
      Ps[r * LDP + qc] = p;
      Ss[r * LDP + qc] = p * (dp[j] - Dis[qc]) * scale;
    }
    __syncwarp();  // a row's 4 threads share one warp
    for (int c = 0; c < BR; ++c) {
      const float p = Ps[r * LDP + c], ds = Ss[r * LDP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        dva[j] = fmaf(p, Os[c * LDK + qd + 4 * j], dva[j]);
        dka[j] = fmaf(ds, Qs[c * LDK + qd + 4 * j], dka[j]);
      }
    }
  }

  if (krow >= Skv) return;
  const long long at = kvoff + krow * str;
#pragma unroll
  for (int j = 0; j < DJ; ++j) {
    dk[at + qd + 4 * j] = dka[j];
    dv[at + qd + 4 * j] = dva[j];
  }
}

// --- K5: dQ -----------------------------------------------------------------

// bf16: each warp owns 16 q rows; a lane holds q rows g, g+8 and kv columns
// 2*t4, 2*t4+1 of every 8-wide score tile (K1's layout).
template <int D>
__global__ void __launch_bounds__(BF16_THREADS)
bwd_dq_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
            const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ di,
            __nv_bfloat16* __restrict__ dq, int Sq, int Skv, int H, float scale,
            float scale_log2, int causal) {
  constexpr int W = Inner<D>::W;  // kv columns per tile
  constexpr int LD = D + 8;
  constexpr int NT = W / 8;
  constexpr int DT = D / 8;
  constexpr int DK = D / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Os = Qs + BR * LD;  // dO rows
  __nv_bfloat16* Ks = Os + BR * LD;
  __nv_bfloat16* Vs = Ks + W * LD;

  const int q0 = blockIdx.x * BR, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3, wr = warp * 16;
  const long long str = (long long)H * D;
  const long long qoff = (long long)b * Sq * str + (long long)h * D;
  const __nv_bfloat16* kb = k + (long long)b * Skv * str + (long long)h * D;
  const __nv_bfloat16* vb = v + (long long)b * Skv * str + (long long)h * D;
  const float* lseb = lse + ((long long)b * H + h) * Sq;
  const float* dib = di + ((long long)b * H + h) * Sq;

  load_tile_bf16<D, LD, BF16_THREADS>(Qs, q + qoff + q0 * str, str, BR, Sq - q0);
  load_tile_bf16<D, LD, BF16_THREADS>(Os, dout + qoff + q0 * str, str, BR, Sq - q0);
  __syncthreads();
  uint32_t qf[DK][4], of[DK][4];
#pragma unroll
  for (int kc = 0; kc < DK; ++kc) {
    load_a_frag<LD>(qf[kc], Qs, wr, kc * 16, g, t4);
    load_a_frag<LD>(of[kc], Os, wr, kc * 16, g, t4);
  }
  const int rows[2] = {q0 + wr + g, q0 + wr + g + 8};
  float lrow[2], drow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lrow[i] = rows[i] < Sq ? lseb[rows[i]] * LOG2E : 0.f;
    drow[i] = rows[i] < Sq ? dib[rows[i]] : 0.f;
  }
  float dqa[DT][4];
#pragma unroll
  for (int dn = 0; dn < DT; ++dn) dqa[dn][0] = dqa[dn][1] = dqa[dn][2] = dqa[dn][3] = 0.f;
  const int off = Skv - Sq;
  const int kv_end = causal ? min(Skv, q0 + BR + off) : Skv;

  for (int kv0 = 0; kv0 < kv_end; kv0 += W) {
    __syncthreads();
    load_tile_bf16<D, LD, BF16_THREADS>(Ks, kb + kv0 * str, str, W, Skv - kv0);
    load_tile_bf16<D, LD, BF16_THREADS>(Vs, vb + kv0 * str, str, W, Skv - kv0);
    __syncthreads();

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < DK; ++kc) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        mma_bt<LD>(s[n], qf[kc], Ks, n * 8, kc * 16, g, t4);
        mma_bt<LD>(dp[n], of[kc], Vs, n * 8, kc * 16, g, t4);
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kv0 + n * 8 + t4 * 2 + (e & 1);
        const int row = rows[e >> 1];
        const bool ok = row < Sq && col < Skv && (!causal || col <= row + off);
        const float p = ok ? exp2f(s[n][e] * scale_log2 - lrow[e >> 1]) : 0.f;
        s[n][e] = p * (dp[n][e] - drow[e >> 1]) * scale;  // dS
      }
    }
    // dQ += dS K: contraction over the tile's kv rows.
#pragma unroll
    for (int kc = 0; kc < W / 16; ++kc) {
      uint32_t da[4];
      da[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      da[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      da[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      da[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
      for (int dn = 0; dn < DT; ++dn) mma_bn<LD>(dqa[dn], da, Ks, kc * 16, dn * 8, g, t4);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= Sq) continue;
    __nv_bfloat16* drow_out = dq + qoff + rows[i] * str;
#pragma unroll
    for (int dn = 0; dn < DT; ++dn) {
      *reinterpret_cast<__nv_bfloat162*>(drow_out + dn * 8 + t4 * 2) =
          __floats2bfloat162_rn(dqa[dn][2 * i], dqa[dn][2 * i + 1]);
    }
  }
}

// fp32: 4 threads per q row (quarter qd owns kv columns qd + 4j of a tile
// and output columns qd + 4j); plain FMA.
template <int D>
__global__ void __launch_bounds__(F32_THREADS)
bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ di,
           float* __restrict__ dq, int Sq, int Skv, int H, float scale,
           float scale_log2, int causal) {
  constexpr int LDK = D + 1;
  constexpr int LDP = BR + 1;
  constexpr int NJ = BR / 4;
  constexpr int DJ = D / 4;
  extern __shared__ float smf[];
  float* Qs = smf;
  float* Os = Qs + BR * LDK;
  float* Ks = Os + BR * LDK;
  float* Vs = Ks + BR * LDK;
  float* Ss = Vs + BR * LDK;

  const int q0 = blockIdx.x * BR, h = blockIdx.y, b = blockIdx.z;
  const int r = threadIdx.x >> 2, qd = threadIdx.x & 3;
  const long long str = (long long)H * D;
  const long long qoff = (long long)b * Sq * str + (long long)h * D;
  const float* kb = k + (long long)b * Skv * str + (long long)h * D;
  const float* vb = v + (long long)b * Skv * str + (long long)h * D;
  const int off = Skv - Sq, row = q0 + r;
  const float lrow = row < Sq ? lse[((long long)b * H + h) * Sq + row] * LOG2E : 0.f;
  const float drow = row < Sq ? di[((long long)b * H + h) * Sq + row] : 0.f;

  load_tile_f32<D, LDK, F32_THREADS>(Qs, q + qoff + q0 * str, str, BR, Sq - q0);
  load_tile_f32<D, LDK, F32_THREADS>(Os, dout + qoff + q0 * str, str, BR, Sq - q0);
  float dqa[DJ];
#pragma unroll
  for (int j = 0; j < DJ; ++j) dqa[j] = 0.f;
  const int kv_end = causal ? min(Skv, q0 + BR + off) : Skv;

  for (int kv0 = 0; kv0 < kv_end; kv0 += BR) {
    __syncthreads();
    load_tile_f32<D, LDK, F32_THREADS>(Ks, kb + kv0 * str, str, BR, Skv - kv0);
    load_tile_f32<D, LDK, F32_THREADS>(Vs, vb + kv0 * str, str, BR, Skv - kv0);
    __syncthreads();

    float s[NJ], dp[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[j] = dp[j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qv = Qs[r * LDK + d], ov = Os[r * LDK + d];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        s[j] = fmaf(qv, Ks[(qd + 4 * j) * LDK + d], s[j]);
        dp[j] = fmaf(ov, Vs[(qd + 4 * j) * LDK + d], dp[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = kv0 + qd + 4 * j;
      const bool ok = row < Sq && col < Skv && (!causal || col <= row + off);
      const float p = ok ? exp2f(s[j] * scale_log2 - lrow) : 0.f;
      Ss[r * LDP + qd + 4 * j] = p * (dp[j] - drow) * scale;
    }
    __syncwarp();
    for (int c = 0; c < BR; ++c) {
      const float ds = Ss[r * LDP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) dqa[j] = fmaf(ds, Ks[c * LDK + qd + 4 * j], dqa[j]);
    }
  }

  if (row >= Sq) return;
  float* orow = dq + qoff + row * str;
#pragma unroll
  for (int j = 0; j < DJ; ++j) orow[qd + 4 * j] = dqa[j];
}

// --- launchers ----------------------------------------------------------------

struct BwdArgs {
  const void *q, *k, *v, *dout;
  const float *lse, *di;
  int Sq, Skv, H;
  float scale, scale_log2;
  int causal;
  cudaStream_t st;
};

template <typename Kern>
cudaError_t prepare(Kern kern, int smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int D>
cudaError_t dkv_bf16(const BwdArgs& a, void* dk, void* dv, dim3 grid) {
  constexpr int smem = smem_bf16<D>();
  cudaError_t e = prepare(bwd_dkv_bf16<D>, smem);
  if (e != cudaSuccess) return e;
  bwd_dkv_bf16<D><<<grid, BF16_THREADS, smem, a.st>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), static_cast<const __nv_bfloat16*>(a.dout),
      a.lse, a.di, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
      a.Sq, a.Skv, a.H, a.scale, a.scale_log2, a.causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t dkv_f32(const BwdArgs& a, void* dk, void* dv, dim3 grid) {
  constexpr int smem = (4 * BR * (D + 1) + 2 * BR * (BR + 1) + 2 * BR) * sizeof(float);
  cudaError_t e = prepare(bwd_dkv_f32<D>, smem);
  if (e != cudaSuccess) return e;
  bwd_dkv_f32<D><<<grid, F32_THREADS, smem, a.st>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.di,
      static_cast<float*>(dk), static_cast<float*>(dv), a.Sq, a.Skv, a.H, a.scale,
      a.scale_log2, a.causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t dq_bf16(const BwdArgs& a, void* dq, dim3 grid) {
  constexpr int smem = (2 * BR + 2 * Inner<D>::W) * (D + 8) * 2;
  cudaError_t e = prepare(bwd_dq_bf16<D>, smem);
  if (e != cudaSuccess) return e;
  bwd_dq_bf16<D><<<grid, BF16_THREADS, smem, a.st>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), static_cast<const __nv_bfloat16*>(a.dout),
      a.lse, a.di, static_cast<__nv_bfloat16*>(dq), a.Sq, a.Skv, a.H, a.scale,
      a.scale_log2, a.causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t dq_f32(const BwdArgs& a, void* dq, dim3 grid) {
  constexpr int smem = (4 * BR * (D + 1) + BR * (BR + 1)) * sizeof(float);
  cudaError_t e = prepare(bwd_dq_f32<D>, smem);
  if (e != cudaSuccess) return e;
  bwd_dq_f32<D><<<grid, F32_THREADS, smem, a.st>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.di,
      static_cast<float*>(dq), a.Sq, a.Skv, a.H, a.scale, a.scale_log2, a.causal);
  return cudaGetLastError();
}

bool bad_shape(int B, int Sq, int Skv, int H, int causal) {
  return B <= 0 || Sq <= 0 || Skv <= 0 || H <= 0 || (causal && Sq > Skv);
}

}  // namespace

extern "C" int pfa_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse, const void* di,
                                 void* dk, void* dv, int B, int Sq, int Skv, int H, int D,
                                 float sm_scale, int causal, int dtype, void* stream) {
  if (bad_shape(B, Sq, Skv, H, causal)) return cudaErrorInvalidValue;
  const BwdArgs a{q, k, v, dout, static_cast<const float*>(lse),
                  static_cast<const float*>(di), Sq, Skv, H, sm_scale,
                  sm_scale * LOG2E, causal, static_cast<cudaStream_t>(stream)};
  const dim3 grid((Skv + BR - 1) / BR, H, B);
  if (dtype == PFA_BF16 && D == 64) return dkv_bf16<64>(a, dk, dv, grid);
  if (dtype == PFA_BF16 && D == 128) return dkv_bf16<128>(a, dk, dv, grid);
  if (dtype == PFA_F32 && D == 64) return dkv_f32<64>(a, dk, dv, grid);
  if (dtype == PFA_F32 && D == 128) return dkv_f32<128>(a, dk, dv, grid);
  return cudaErrorInvalidValue;
}

extern "C" int pfa_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse, const void* di,
                                void* dq, int B, int Sq, int Skv, int H, int D,
                                float sm_scale, int causal, int dtype, void* stream) {
  if (bad_shape(B, Sq, Skv, H, causal)) return cudaErrorInvalidValue;
  const BwdArgs a{q, k, v, dout, static_cast<const float*>(lse),
                  static_cast<const float*>(di), Sq, Skv, H, sm_scale,
                  sm_scale * LOG2E, causal, static_cast<cudaStream_t>(stream)};
  const dim3 grid((Sq + BR - 1) / BR, H, B);
  if (dtype == PFA_BF16 && D == 64) return dq_bf16<64>(a, dq, grid);
  if (dtype == PFA_BF16 && D == 128) return dq_bf16<128>(a, dq, grid);
  if (dtype == PFA_F32 && D == 64) return dq_f32<64>(a, dq, grid);
  if (dtype == PFA_F32 && D == 128) return dq_f32<128>(a, dq, grid);
  return cudaErrorInvalidValue;
}
