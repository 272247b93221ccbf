// K4 (dK/dV) and K5 (dQ): flash-attention backward for Hopper (sm_90a).
//
// Replace the TPU kernels photonic_flash_attention_tpu/ops/flash_bwd.py::
// _dkv_kernel and _dq_kernel (the grid pair, flash_attention_bwd_pallas)
// and _dkv_kernel_unrolled and _dq_kernel_unrolled (the unrolled pair,
// flash_attention_bwd_unrolled). Both TPU pairs compute the same dq/dk/dv;
// the split exists only because of how Mosaic schedules a grid step, so
// one pair serves every shape here (ops/flash_bwd.py::flash_attention_bwd).
//
// Contract: q, o, dO (B, Sq, Hq, D) and k, v (B, Skv, Hkv, D) contiguous,
// Hq a multiple of Hkv, query head h on KV head h / (Hq / Hkv) (K1's
// mapping, JAX's jnp.repeat order); lse (B, Hq, Sq) fp32 in natural log
// (K1's residual); D from 1 to 128 on the widths 64 and 128 (bf16: a
// multiple of 8, ops/_build.py::head_dim_plan pads the rest; fp32: any);
// bf16 or fp32; causal aligned to the
// sequence end (key j visible to row i iff j <= i + Skv - Sq). K5 computes
// di = rowsum(o * dO) (B, Hq, Sq) fp32 in its prologue and writes it; K4
// reads it, so K5 launches first. dq comes out (B, Sq, Hq, D) and dk, dv
// (B, Skv, Hkv, D), summed over the group in fp32 inside K4 and rounded to
// the input dtype once: the pair is the whole backward function (JAX
// ops/flash.py::_flash_core_bwd, which repeats K/V and sums in XLA around
// its Pallas pair).
//
// Math (flash_bwd.py::_p_and_ds), with scale = sm_scale:
//   P = exp(S*scale - lse)   dV += P^T dO   dP = dO V^T
//   dS = P * (dP - di) * scale   dK += dS^T Q   dQ += dS K
// The exponent runs in the log2 domain: P = exp2(S*scale*log2e - lse*log2e).
// The mask is applied BEFORE the exp (a row with lse = -inf gives P = 0,
// not NaN), and nothing is padded in memory: the fp32 path masks padded q
// rows / kv columns; the bf16 path reads zeros past the ends (TMA) and
// masks the ragged tiles (flash_bwd_sm90.cu).
//
// What bounds it on the H100: like the forward, S/2 multiply-adds per
// loaded byte at S ~ 1k-2k, far above the bf16 ridge (~295 FLOP/byte at
// the data sheet's 989 TFLOP/s over 3.35 TB/s); the backward does 2.5x the
// forward's products (5 per tile against 2), so the tensor-core rate is the
// limit. The bf16 path is flash_bwd_sm90.cu (TMA, wgmma, warp-specialised,
// persistent; its header has the design); the fp32 path here keeps fp32 in
// fp32 (FMA loops, no bf16 or TF32 rounding). K4 works in the transposed
// score domain of the JAX kernels, s_t = K Q^T (kv rows x q columns), so
// P_t and dS_t are the left operands of dV += P_t dO and dK += dS_t Q; lse
// and di are indexed by the q column. K5 works in the q-major domain (s =
// Q K^T), where dS is the left operand of dQ += dS K. Two kernels, as in
// JAX: dQ needs no atomics and the result is deterministic. dK/dV and dQ
// are accumulated in fp32 and written once. Rounding follows JAX
// (flash_bwd.py:235-240, 316-321): in bf16, P is rounded to the input
// dtype before the dV product, dS before the dK and dQ products.
//
// Window and dropout streams (the grid pair's `window` and `seed_ref`,
// flash_bwd.py:59-164, 187, 267; common.cuh): a key is valid when
// lo <= col - (row + Skv - Sq) <= hi, and each block walks only the tiles
// of its band: K5 the KV tiles of its query block (K1's range), K4, in the
// transposed domain, the query tiles from which its KV block is seen. With
// dropout the keep mask is regenerated from (b * H + h, row, col, seed) at
// the global coordinates a lane holds; in K4's transposed tiles the hash's
// row is the tile's COLUMN (the query) and its column the tile's row (the
// key), as the TPU's _dropout_mscale_t. The multiplier M = keep / (1 -
// rate) scales dV's P and dP (JAX _p_and_ds): dV += (P M)^T dO,
// dS = P (dP M - di) scale; di = rowsum(o dO) over the dropped output.
//
// GQA: K5's block of a query head reads its KV head's tiles; K4's block
// of a KV head walks its group's query heads in turn (bf16: split into
// slices, flash_bwd_sm90.cu), dK/dV in fp32 registers throughout. The fp32
// path takes the same contract: K4's grid over Hkv, a loop over the group.
//
// Not carried over from the TPU: the skip-aware prefetch index maps (a
// block's loop simply starts and ends at its band) and the VMEM envelope of
// the unrolled pair.

#include "flash_bwd_sm90.cuh"

namespace {

constexpr int BR = 64;            // rows a block owns: kv rows (K4), q rows (K5)
constexpr int F32_THREADS = 256;  // 4 threads per row

// --- K4: dK, dV -------------------------------------------------------------

// fp32: 4 threads per kv row (thread quarter qd owns q columns qd + 4j of a
// tile and output columns qd + 4j); plain FMA. A block is 64 keys of one
// (batch row, KV head) and walks the group's query heads in turn.
template <int D, int SM>
__global__ void __launch_bounds__(F32_THREADS)
bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ di,
            float* __restrict__ dk, float* __restrict__ dv, int Sq, int Skv, int H, int Hkv,
            int d, float scale, float scale_log2, int causal, Streams st) {
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

  const int kv0 = blockIdx.x * BR, kvh = blockIdx.y, b = blockIdx.z, group = H / Hkv;
  const int r = threadIdx.x >> 2, qd = threadIdx.x & 3;
  // D: the compiled width; d: the real head dim, the rows' pitch (columns
  // d..D-1 load as zeros and are not stored).
  const long long str = (long long)H * d, kstr = (long long)Hkv * d;
  const long long kvoff = (long long)b * Skv * kstr + (long long)kvh * d;

  load_tile_f32<D, LDK, F32_THREADS>(Ks, k + kvoff + kv0 * kstr, kstr, BR, Skv - kv0, d);
  load_tile_f32<D, LDK, F32_THREADS>(Vs, v + kvoff + kv0 * kstr, kstr, BR, Skv - kv0, d);
  float dka[DJ], dva[DJ];
#pragma unroll
  for (int j = 0; j < DJ; ++j) dka[j] = dva[j] = 0.f;
  const int off = Skv - Sq, krow = kv0 + r;
  const int q_begin = band_q_begin(st, kv0, off, causal, BR);
  const int q_end = band_q_end(st, kv0, BR, off, Sq);

  for (int h = kvh * group; h < (kvh + 1) * group; ++h)  // the group's query heads in turn
  for (int q0 = q_begin; q0 < q_end; q0 += BR) {
    const float* qb = q + (long long)b * Sq * str + (long long)h * d;
    const float* ob = dout + (long long)b * Sq * str + (long long)h * d;
    const float* lseb = lse + ((long long)b * H + h) * Sq;
    const float* dib = di + ((long long)b * H + h) * Sq;
    const uint32_t bh = static_cast<uint32_t>(b * H + h);
    __syncthreads();
    load_tile_f32<D, LDK, F32_THREADS>(Qs, qb + q0 * str, str, BR, Sq - q0, d);
    load_tile_f32<D, LDK, F32_THREADS>(Os, ob + q0 * str, str, BR, Sq - q0, d);
    for (int i = threadIdx.x; i < BR; i += F32_THREADS) {
      const bool ok = q0 + i < Sq;
      Ls[i] = ok ? lseb[q0 + i] * LOG2E : 0.f;
      Dis[i] = ok ? dib[q0 + i] : 0.f;
    }
    __syncthreads();

    float s[NJ], dp[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[j] = dp[j] = 0.f;
    for (int c = 0; c < D; ++c) {
      const float kd = Ks[r * LDK + c], vd = Vs[r * LDK + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        s[j] = fmaf(kd, Qs[(qd + 4 * j) * LDK + c], s[j]);
        dp[j] = fmaf(vd, Os[(qd + 4 * j) * LDK + c], dp[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int qc = qd + 4 * j;
      const bool ok = q0 + qc < Sq && krow < Skv && (!causal || krow <= q0 + qc + off) &&
                      (SM != WINDOW || st.in_window(krow - (q0 + qc) - off));
      const float p = ok ? exp2f(s[j] * scale_log2 - Ls[qc]) : 0.f;
      const float mult = SM == DROPOUT ? dropout_mult(st, bh, q0 + qc, krow, Skv) : 1.f;  // transposed
      Ps[r * LDP + qc] = p * mult;
      Ss[r * LDP + qc] = p * (dp[j] * mult - Dis[qc]) * scale;
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
  const long long at = kvoff + krow * kstr;
#pragma unroll
  for (int j = 0; j < DJ; ++j) {
    if (qd + 4 * j >= d) continue;
    dk[at + qd + 4 * j] = dka[j];
    dv[at + qd + 4 * j] = dva[j];
  }
}

// --- K5: dQ -----------------------------------------------------------------

// fp32: 4 threads per q row (quarter qd owns kv columns qd + 4j of a tile
// and output columns qd + 4j); plain FMA. A block is 64 rows of one (batch
// row, query head) on its KV head; it computes the rows' di from O and the
// staged dO first and writes it for K4.
template <int D, int SM>
__global__ void __launch_bounds__(F32_THREADS)
bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ o,
           const float* __restrict__ dout, const float* __restrict__ lse,
           float* __restrict__ di, float* __restrict__ dq, int Sq, int Skv, int H, int Hkv,
           int d, float scale, float scale_log2, int causal, Streams st) {
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

  const int q0 = blockIdx.x * BR, h = blockIdx.y, b = blockIdx.z, kvh = h / (H / Hkv);
  const int r = threadIdx.x >> 2, qd = threadIdx.x & 3;
  const long long str = (long long)H * d, kstr = (long long)Hkv * d;
  const long long qoff = (long long)b * Sq * str + (long long)h * d;
  const float* kb = k + (long long)b * Skv * kstr + (long long)kvh * d;
  const float* vb = v + (long long)b * Skv * kstr + (long long)kvh * d;
  const int off = Skv - Sq, row = q0 + r;
  const long long vrow = ((long long)b * H + h) * Sq + row;  // the row's lse and di
  const float lrow = row < Sq ? lse[vrow] * LOG2E : 0.f;

  load_tile_f32<D, LDK, F32_THREADS>(Qs, q + qoff + q0 * str, str, BR, Sq - q0, d);
  load_tile_f32<D, LDK, F32_THREADS>(Os, dout + qoff + q0 * str, str, BR, Sq - q0, d);
  __syncthreads();
  // di = rowsum(o dO): the quarter's columns, then the row's four threads
  // (neighbouring lanes) by shuffles; 0 past Sq.
  float drow = 0.f;
  if (row < Sq) {
    const float* orow = o + qoff + (long long)row * str;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      if (qd + 4 * j < d) drow = fmaf(orow[qd + 4 * j], Os[r * LDK + qd + 4 * j], drow);
  }
  drow += __shfl_xor_sync(0xffffffffu, drow, 1);
  drow += __shfl_xor_sync(0xffffffffu, drow, 2);
  if (qd == 0 && row < Sq) di[vrow] = drow;
  float dqa[DJ];
#pragma unroll
  for (int j = 0; j < DJ; ++j) dqa[j] = 0.f;
  const uint32_t bh = static_cast<uint32_t>(b * H + h);
  const int kv_begin = SM == WINDOW ? band_kv_begin(st, q0, off, BR) : 0;
  const int kv_end = band_kv_end(st, q0, BR, off, causal, Skv);

  for (int kv0 = kv_begin; kv0 < kv_end; kv0 += BR) {
    __syncthreads();
    load_tile_f32<D, LDK, F32_THREADS>(Ks, kb + kv0 * kstr, kstr, BR, Skv - kv0, d);
    load_tile_f32<D, LDK, F32_THREADS>(Vs, vb + kv0 * kstr, kstr, BR, Skv - kv0, d);
    __syncthreads();

    float s[NJ], dp[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[j] = dp[j] = 0.f;
    for (int c = 0; c < D; ++c) {
      const float qv = Qs[r * LDK + c], ov = Os[r * LDK + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        s[j] = fmaf(qv, Ks[(qd + 4 * j) * LDK + c], s[j]);
        dp[j] = fmaf(ov, Vs[(qd + 4 * j) * LDK + c], dp[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = kv0 + qd + 4 * j;
      const bool ok = row < Sq && col < Skv && (!causal || col <= row + off) &&
                      (SM != WINDOW || st.in_window(col - row - off));
      const float p = ok ? exp2f(s[j] * scale_log2 - lrow) : 0.f;
      const float mult = SM == DROPOUT ? dropout_mult(st, bh, row, col, Skv) : 1.f;
      Ss[r * LDP + qd + 4 * j] = p * (dp[j] * mult - drow) * scale;
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
  for (int j = 0; j < DJ; ++j)
    if (qd + 4 * j < d) orow[qd + 4 * j] = dqa[j];
}

// --- launchers ----------------------------------------------------------------

struct BwdArgs {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* di;  // K5 writes it, K4 reads it
  int Sq, Skv, H, Hkv;
  float scale, scale_log2;
  int causal;
  Streams streams;
  cudaStream_t st;
};

template <typename Kern>
cudaError_t prepare(Kern kern, int smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int D, int SM>
cudaError_t dkv_f32(const BwdArgs& a, void* dk, void* dv, dim3 grid, int d) {
  constexpr int smem = (4 * BR * (D + 1) + 2 * BR * (BR + 1) + 2 * BR) * sizeof(float);
  cudaError_t e = prepare(bwd_dkv_f32<D, SM>, smem);
  if (e != cudaSuccess) return e;
  bwd_dkv_f32<D, SM><<<grid, F32_THREADS, smem, a.st>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.di,
      static_cast<float*>(dk), static_cast<float*>(dv), a.Sq, a.Skv, a.H, a.Hkv, d, a.scale,
      a.scale_log2, a.causal, a.streams);
  return cudaGetLastError();
}

template <int D, int SM>
cudaError_t dq_f32(const BwdArgs& a, void* dq, dim3 grid, int d) {
  constexpr int smem = (4 * BR * (D + 1) + BR * (BR + 1)) * sizeof(float);
  cudaError_t e = prepare(bwd_dq_f32<D, SM>, smem);
  if (e != cudaSuccess) return e;
  bwd_dq_f32<D, SM><<<grid, F32_THREADS, smem, a.st>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.o),
      static_cast<const float*>(a.dout), a.lse, a.di, static_cast<float*>(dq), a.Sq, a.Skv, a.H,
      a.Hkv, d, a.scale, a.scale_log2, a.causal, a.streams);
  return cudaGetLastError();
}

template <int SM>
cudaError_t run_dkv(const BwdArgs& a, void* dk, void* dv, dim3 grid, int D) {
  if (D < 1 || D > 128) return cudaErrorInvalidValue;
  return D <= 64 ? dkv_f32<64, SM>(a, dk, dv, grid, D) : dkv_f32<128, SM>(a, dk, dv, grid, D);
}

template <int SM>
cudaError_t run_dq(const BwdArgs& a, void* dq, dim3 grid, int D) {
  if (D < 1 || D > 128) return cudaErrorInvalidValue;
  return D <= 64 ? dq_f32<64, SM>(a, dq, grid, D) : dq_f32<128, SM>(a, dq, grid, D);
}

// The stream mode of the forward's window and dropout; -1 when both are
// given (JAX's rules forbid it).
int stream_mode(const Streams& st) {
  const bool window = st.lo > -WINDOW_OPEN || st.hi < WINDOW_OPEN, drop = st.thresh != 0u;
  return window && drop ? -1 : drop ? DROPOUT : window ? WINDOW : PLAIN;
}

bool bad_shape(int B, int Sq, int Skv, int Hq, int Hkv, int causal) {
  return B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || Hq <= 0 || Hq % Hkv ||
         (causal && Sq > Skv);
}

}  // namespace

// win_lo, win_hi, seed, thresh, inv_keep: the forward's window and
// dropout (common.cuh::Streams; thresh 0 = no dropout). K4: di from K5;
// `slices` (a divisor of Hq / Hkv; 1 in fp32) cuts each group of query
// heads for the bf16 body, which sums the slices' partials through `ws`
// (2 x slices x B x Hkv x ceil(Skv / 128) x 128 x D fp32) and `counters`
// (B x Hkv x ceil(Skv / 128) int32, zero) where slices > 1 (else both may
// be null).
extern "C" int pfa_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse, const void* di,
                                 void* dk, void* dv, void* ws, void* counters, int B, int Sq,
                                 int Skv, int Hq, int Hkv, int D, int slices, float sm_scale,
                                 int causal, int win_lo, int win_hi, unsigned seed,
                                 unsigned thresh, float inv_keep, int dtype, void* stream) {
  const Streams streams{win_lo, win_hi, seed, thresh, inv_keep};
  const int mode = stream_mode(streams);
  if (bad_shape(B, Sq, Skv, Hq, Hkv, causal) || mode < 0 || di == nullptr)
    return cudaErrorInvalidValue;
  const auto* lse_f = static_cast<const float*>(lse);
  const auto* di_f = static_cast<const float*>(di);
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == PFA_BF16)
    return k4_bf16_sm90(BwdSm90Args{q, k, v, nullptr, dout, lse_f, di_f, nullptr, B, Sq, Skv, Hq,
                                    Hkv, D, sm_scale, causal, streams, static_cast<float*>(ws),
                                    static_cast<int*>(counters), slices},
                        dk, dv, mode, st);
  if (dtype != PFA_F32 || slices != 1) return cudaErrorInvalidValue;
  const BwdArgs a{q, k, v, nullptr, dout, lse_f, const_cast<float*>(di_f), Sq, Skv, Hq, Hkv,
                  sm_scale, sm_scale * LOG2E, causal, streams, st};
  const dim3 grid((Skv + BR - 1) / BR, Hkv, B);
  switch (mode) {
    case PLAIN: return run_dkv<PLAIN>(a, dk, dv, grid, D);
    case WINDOW: return run_dkv<WINDOW>(a, dk, dv, grid, D);
    default: return run_dkv<DROPOUT>(a, dk, dv, grid, D);
  }
}

// K5: o (like q) in, di (B, Hq, Sq) fp32 out beside dq.
extern "C" int pfa_flash_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                                const void* dout, const void* lse, void* dq, void* di, int B,
                                int Sq, int Skv, int Hq, int Hkv, int D, float sm_scale,
                                int causal, int win_lo, int win_hi, unsigned seed,
                                unsigned thresh, float inv_keep, int dtype, void* stream) {
  const Streams streams{win_lo, win_hi, seed, thresh, inv_keep};
  const int mode = stream_mode(streams);
  if (bad_shape(B, Sq, Skv, Hq, Hkv, causal) || mode < 0 || o == nullptr || di == nullptr)
    return cudaErrorInvalidValue;
  const auto* lse_f = static_cast<const float*>(lse);
  auto* di_f = static_cast<float*>(di);
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == PFA_BF16)
    return k5_bf16_sm90(BwdSm90Args{q, k, v, o, dout, lse_f, nullptr, di_f, B, Sq, Skv, Hq, Hkv,
                                    D, sm_scale, causal, streams, nullptr, nullptr, 1},
                        dq, mode, st);
  if (dtype != PFA_F32) return cudaErrorInvalidValue;
  const BwdArgs a{q, k, v, o, dout, lse_f, di_f, Sq, Skv, Hq, Hkv, sm_scale, sm_scale * LOG2E,
                  causal, streams, st};
  const dim3 grid((Sq + BR - 1) / BR, Hq, B);
  switch (mode) {
    case PLAIN: return run_dq<PLAIN>(a, dq, grid, D);
    case WINDOW: return run_dq<WINDOW>(a, dq, grid, D);
    default: return run_dq<DROPOUT>(a, dq, grid, D);
  }
}
