// K20 (dQ, one launch per query row-block) and K21 (dK/dV, one launch per
// key block): the unrolled-backward experiment's kernels on mma.sync
// (sm_90a), for fp32 inputs only: in bf16 K20 is K5's Hopper body
// (flash_bwd_sm90.cu, pfa_flash_bwd_dq_rowblock_sm90) and K21 K4's
// (pfa_flash_bwd_dkv_colblock_sm90), since TMA cannot convert fp32 on load.
//
// Replace the TPU kernels benchmarks/flash_bwd_unrolled_experiment.py::
// _dq_kernel_unrolled (:41, called at :150) and _dkv_kernel_unrolled (:83,
// called at :178). What that experiment varies is the launch structure: one
// pallas_call per block_q row-block for dq, over a static kv extent, and
// one per block_kv key block for dk/dv, over the static suffix of query
// blocks from the diagonal on, with the mask only on tiles that cross it.
// The kernels keep that structure (the host loop in
// experiments/flash_bwd_unrolled_experiment.py launches them) and not
// JAX's VMEM-resident blocks: a launch covers its block with one CTA per 64
// rows (K20: query rows, K21: keys) and head, and each CTA streams 64- or
// 32-wide tiles of the other side through shared memory, as K4/K5 do
// (csrc/flash_bwd.cu).
//
// Contract: q, k, v, dO (B, H, S, D) contiguous (JAX's [B, H, S, D]
// domain; no GQA), lse and di = rowsum(o * dO) (B, H, S) fp32, lse in
// natural log; D in {64, 128}; fp32 inputs, converted to bf16 on load as
// JAX's bodies cast them; S, the first row or key of a launch and its row
// or key count multiples of 64; causal is top-left (col <= row). dq/dk/dv
// come out in fp32, each launch writing its rows of one (B, H, S, D) output
// in place (JAX concatenates the calls' outputs).
//
// Math and rounding are JAX's (:46-77, :88-125), with scale = sm_scale:
//   P = exp(S*scale - lse)   dP = dO V^T   dS = P * (dP - di) * scale
//   dV += bf16(P)^T dO   dK += bf16(dS)^T Q   dQ += bf16(dS) K
// all products on mma.sync m16n8k16 with fp32 accumulation; the exponent
// in the log2 domain (exp2(S*scale*log2e - lse*log2e)).
//
// Where the causal diagonal cuts: K20's CTA walks the key tiles up to its
// own last row (kv0 < q0 + 64), K21's the query tiles from its own first
// key (q0 >= kv0) to S; JAX's static extents only add tiles that are
// wholly masked. The mask is compiled into the tile body only for tiles
// that cross the diagonal (JAX's (j+1)*bkv > q_row0 and kv_col0 + bkv >
// j*bq, at the CTA's 64 rows), so the other tiles carry no compare.
//
// What bounds it on the H100: as K4/K5, the tensor cores (the backward
// does 2.5x the forward's products per score, at S/2 multiply-adds per
// loaded byte); the launch structure adds a wave tail per launch: a launch
// of block/64 x H x B CTAs (96 at B1 S8192 H12 with 512-row blocks, for
// 132 SMs) ends with its longest CTA. Simple first: no cp.async, wgmma or
// TMA (later work, with K4/K5's).

#include "common.cuh"

namespace {

constexpr int BR = 64;       // rows a CTA owns: query rows (K20), keys (K21)
constexpr int THREADS = 128; // 4 warps x 16 rows

// Width of the streamed tile (keys in K20, query rows in K21): 32 at D 128
// keeps the fp32 accumulators under the register limit, as in K4/K5.
template <int D>
struct Inner {
  static constexpr int W = D == 64 ? 64 : 32;
};

template <int D>
constexpr int smem_bytes() {
  return (2 * BR + 2 * Inner<D>::W) * (D + 8) * 2 + 2 * Inner<D>::W * 4;
}

// rows x D values of a (., D) row-major fp32 source into bf16 shared
// memory with row pitch LD, rounded to bf16.
template <int D, int LD>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const float* src, int rows) {
  constexpr int CH = D / 4;  // float4 chunks per row
  for (int i = threadIdx.x; i < rows * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * 4;
    const float4 x = *reinterpret_cast<const float4*>(src + (long long)r * D + c);
    __nv_bfloat162* d2 = reinterpret_cast<__nv_bfloat162*>(dst + r * LD + c);
    d2[0] = __floats2bfloat162_rn(x.x, x.y);
    d2[1] = __floats2bfloat162_rn(x.z, x.w);
  }
}

// --- K20: dQ of one 64-row slice of a row-block ------------------------------

// One streamed key tile of K20: s = Q K^T and dp = dO V^T for the warp's 16
// rows, dS, then dQ += bf16(dS) K. MASK: the tile crosses the diagonal.
template <int D, bool MASK>
__device__ __forceinline__ void dq_tile(float (&dqa)[D / 8][4], const uint32_t (&qf)[D / 16][4],
                                        const uint32_t (&of)[D / 16][4],
                                        const __nv_bfloat16* Ks, const __nv_bfloat16* Vs,
                                        const int (&rows)[2], const float (&lrow)[2],
                                        const float (&drow)[2], int kv0, float scale,
                                        float scale_log2, int g, int t4) {
  constexpr int W = Inner<D>::W, LD = D + 8, NT = W / 8, DT = D / 8, DK = D / 16;
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
      float p = exp2f(s[n][e] * scale_log2 - lrow[e >> 1]);
      if (MASK && kv0 + n * 8 + t4 * 2 + (e & 1) > rows[e >> 1]) p = 0.f;
      s[n][e] = p * (dp[n][e] - drow[e >> 1]) * scale;  // dS
    }
  }
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

// Grid (rows / 64, H, B) from the launch's first row q_row0: each CTA owns
// query rows q0 .. q0 + 63 and walks the key tiles up to its diagonal when
// causal (to S when not). Lane layout as K5: a warp owns 16 rows, a lane
// rows g, g + 8 and columns 2*t4, 2*t4 + 1 of every 8-wide score tile.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
dq_rowblock(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ di, T* __restrict__ dq, int S, int H, int q_row0,
            float scale, float scale_log2, int causal) {
  constexpr int W = Inner<D>::W, LD = D + 8, DT = D / 8, DK = D / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Os = Qs + BR * LD;  // dO rows
  __nv_bfloat16* Ks = Os + BR * LD;
  __nv_bfloat16* Vs = Ks + W * LD;

  const int q0 = q_row0 + blockIdx.x * BR, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3, wr = warp * 16;
  const long long head = ((long long)b * H + h) * S;  // first row of (b, h)
  const T* kh = k + head * D;
  const T* vh = v + head * D;

  load_rows<D, LD>(Qs, q + (head + q0) * D, BR);
  load_rows<D, LD>(Os, dout + (head + q0) * D, BR);
  __syncthreads();
  uint32_t qf[DK][4], of[DK][4];
#pragma unroll
  for (int kc = 0; kc < DK; ++kc) {
    load_a_frag<LD>(qf[kc], Qs, wr, kc * 16, g, t4);
    load_a_frag<LD>(of[kc], Os, wr, kc * 16, g, t4);
  }
  const int rows[2] = {q0 + wr + g, q0 + wr + g + 8};
  const float lrow[2] = {lse[head + rows[0]] * LOG2E, lse[head + rows[1]] * LOG2E};
  const float drow[2] = {di[head + rows[0]], di[head + rows[1]]};
  float dqa[DT][4];
#pragma unroll
  for (int dn = 0; dn < DT; ++dn) dqa[dn][0] = dqa[dn][1] = dqa[dn][2] = dqa[dn][3] = 0.f;

  const int kv_end = causal ? q0 + BR : S;
  for (int kv0 = 0; kv0 < kv_end; kv0 += W) {
    __syncthreads();  // the previous tile is consumed
    load_rows<D, LD>(Ks, kh + (long long)kv0 * D, W);
    load_rows<D, LD>(Vs, vh + (long long)kv0 * D, W);
    __syncthreads();
    if (causal && kv0 + W > q0)
      dq_tile<D, true>(dqa, qf, of, Ks, Vs, rows, lrow, drow, kv0, scale, scale_log2, g, t4);
    else
      dq_tile<D, false>(dqa, qf, of, Ks, Vs, rows, lrow, drow, kv0, scale, scale_log2, g, t4);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    T* out = dq + (head + rows[i]) * D;
#pragma unroll
    for (int dn = 0; dn < DT; ++dn)
      store2(out + dn * 8 + t4 * 2, dqa[dn][2 * i], dqa[dn][2 * i + 1]);
  }
}

// --- K21: dK, dV of one 64-key slice of a key block -----------------------

// One streamed query tile of K21, in the transposed score domain of K4 (s_t
// = K Q^T, keys x query columns): P_t, dS_t, then dV += bf16(P_t) dO and
// dK += bf16(dS_t) Q. MASK: the tile crosses the diagonal.
template <int D, bool MASK>
__device__ __forceinline__ void dkv_tile(float (&dka)[D / 8][4], float (&dva)[D / 8][4],
                                         const __nv_bfloat16* Ks, const __nv_bfloat16* Vs,
                                         const __nv_bfloat16* Qs, const __nv_bfloat16* Os,
                                         const float* Ls, const float* Dis, const int (&keys)[2],
                                         int q0, int wr, float scale, float scale_log2, int g,
                                         int t4) {
  constexpr int W = Inner<D>::W, LD = D + 8, NT = W / 8, DT = D / 8, DK = D / 16;
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
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qc = n * 8 + t4 * 2 + (e & 1);
      float p = exp2f(s[n][e] * scale_log2 - Ls[qc]);
      if (MASK && keys[e >> 1] > q0 + qc) p = 0.f;
      s[n][e] = p;
      dp[n][e] = p * (dp[n][e] - Dis[qc]) * scale;  // dS_t
    }
  }
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

// Grid (cols / 64, H, B) from the launch's first key kv_col0: each CTA owns
// keys kv0 .. kv0 + 63, keeps their dK and dV in fp32 registers and walks
// the query tiles from its diagonal (from 0 when not causal) to S. Lane
// layout as K4: a warp owns 16 keys, a lane keys g, g + 8 and query columns
// 2*t4, 2*t4 + 1 of every 8-wide tile of s_t.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
dkv_colblock(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const T* __restrict__ dout, const float* __restrict__ lse,
             const float* __restrict__ di, T* __restrict__ dk, T* __restrict__ dv, int S, int H,
             int kv_col0, float scale, float scale_log2, int causal) {
  constexpr int W = Inner<D>::W, LD = D + 8, DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + BR * LD;
  __nv_bfloat16* Qs = Vs + BR * LD;
  __nv_bfloat16* Os = Qs + W * LD;  // dO tile
  float* Ls = reinterpret_cast<float*>(Os + W * LD);  // lse * log2e
  float* Dis = Ls + W;

  const int kv0 = kv_col0 + blockIdx.x * BR, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3, wr = warp * 16;
  const long long head = ((long long)b * H + h) * S;
  const T* qh = q + head * D;
  const T* oh = dout + head * D;

  load_rows<D, LD>(Ks, k + (head + kv0) * D, BR);
  load_rows<D, LD>(Vs, v + (head + kv0) * D, BR);
  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int dn = 0; dn < DT; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[dn][e] = dva[dn][e] = 0.f;
  const int keys[2] = {kv0 + wr + g, kv0 + wr + g + 8};

  for (int q0 = causal ? kv0 : 0; q0 < S; q0 += W) {
    __syncthreads();  // the previous tile is consumed
    load_rows<D, LD>(Qs, qh + (long long)q0 * D, W);
    load_rows<D, LD>(Os, oh + (long long)q0 * D, W);
    for (int i = threadIdx.x; i < W; i += THREADS) {
      Ls[i] = lse[head + q0 + i] * LOG2E;
      Dis[i] = di[head + q0 + i];
    }
    __syncthreads();
    if (causal && kv0 + BR > q0)
      dkv_tile<D, true>(dka, dva, Ks, Vs, Qs, Os, Ls, Dis, keys, q0, wr, scale, scale_log2, g,
                        t4);
    else
      dkv_tile<D, false>(dka, dva, Ks, Vs, Qs, Os, Ls, Dis, keys, q0, wr, scale, scale_log2, g,
                         t4);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long at = (head + keys[i]) * D;
#pragma unroll
    for (int dn = 0; dn < DT; ++dn) {
      const int c = dn * 8 + t4 * 2;
      store2(dk + at + c, dka[dn][2 * i], dka[dn][2 * i + 1]);
      store2(dv + at + c, dva[dn][2 * i], dva[dn][2 * i + 1]);
    }
  }
}

// --- launchers ----------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *di;
  int S, H, first;  // first: the launch's first row (K20) or key (K21)
  float scale;
  int causal;
  dim3 grid;
  cudaStream_t st;
};

template <typename T, int D>
cudaError_t dq_launch(const Args& a, void* dq) {
  constexpr int smem = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(dq_rowblock<T, D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dq_rowblock<T, D><<<a.grid, THREADS, smem, a.st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.di, static_cast<T*>(dq), a.S, a.H, a.first,
      a.scale, a.scale * LOG2E, a.causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dkv_launch(const Args& a, void* dk, void* dv) {
  constexpr int smem = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(dkv_colblock<T, D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dkv_colblock<T, D><<<a.grid, THREADS, smem, a.st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.di, static_cast<T*>(dk), static_cast<T*>(dv),
      a.S, a.H, a.first, a.scale, a.scale * LOG2E, a.causal);
  return cudaGetLastError();
}

// A launch covers [first, first + count) of S in whole 64-row slices.
bool bad_block(int B, int S, int H, int first, int count) {
  return B <= 0 || H <= 0 || S <= 0 || S % BR || first < 0 || first % BR || count <= 0 ||
         count % BR || first + count > S;
}

Args make_args(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* di, int B, int S, int H, int first, int count, float sm_scale,
               int causal, void* stream) {
  return Args{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(di),
              S, H, first, sm_scale, causal, dim3(count / BR, H, B),
              static_cast<cudaStream_t>(stream)};
}

}  // namespace

// K20 in fp32 (bf16: flash_bwd_sm90.cu, pfa_flash_bwd_dq_rowblock_sm90):
// dq rows [q_row0, q_row0 + rows) of every (b, h).
extern "C" int pfa_flash_bwd_dq_rowblock(const void* q, const void* k, const void* v,
                                         const void* dout, const void* lse, const void* di,
                                         void* dq, int B, int S, int H, int D, int q_row0,
                                         int rows, float sm_scale, int causal, int dtype,
                                         void* stream) {
  if (bad_block(B, S, H, q_row0, rows)) return cudaErrorInvalidValue;
  const Args a = make_args(q, k, v, dout, lse, di, B, S, H, q_row0, rows, sm_scale, causal,
                           stream);
  if (dtype == PFA_F32 && D == 64) return dq_launch<float, 64>(a, dq);
  if (dtype == PFA_F32 && D == 128) return dq_launch<float, 128>(a, dq);
  return cudaErrorInvalidValue;
}

// K21 in fp32 (bf16: flash_bwd_sm90.cu, pfa_flash_bwd_dkv_colblock_sm90):
// dk, dv rows [kv_col0, kv_col0 + cols) of every (b, h).
extern "C" int pfa_flash_bwd_dkv_colblock(const void* q, const void* k, const void* v,
                                          const void* dout, const void* lse, const void* di,
                                          void* dk, void* dv, int B, int S, int H, int D,
                                          int kv_col0, int cols, float sm_scale, int causal,
                                          int dtype, void* stream) {
  if (bad_block(B, S, H, kv_col0, cols)) return cudaErrorInvalidValue;
  const Args a = make_args(q, k, v, dout, lse, di, B, S, H, kv_col0, cols, sm_scale, causal,
                           stream);
  if (dtype == PFA_F32 && D == 64) return dkv_launch<float, 64>(a, dk, dv);
  if (dtype == PFA_F32 && D == 128) return dkv_launch<float, 128>(a, dk, dv);
  return cudaErrorInvalidValue;
}
