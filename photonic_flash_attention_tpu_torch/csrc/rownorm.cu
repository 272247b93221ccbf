// K7 (row softmax) and K8 (LayerNorm / RMSNorm rows) for Hopper (sm_90a).
//
// K7 replaces photonic_flash_attention_tpu/ops/nonlinearity.py::
// _softmax_kernel (fused_softmax); K8 replaces ::_norm_kernel
// (fused_layer_norm, fused_rms_norm), with the RMS mode chosen at compile
// time. The TPU kernels take a (block_rows, D padded to 128 lanes) tile per
// grid step and mask the padded lanes (-0.7 * FLT_MAX for the softmax, 0 for
// the norms). Here one block takes one row: its threads stride the row's D
// values and stop at D, so there is no padding to mask and any D works.
//
// What bounds them on the H100: each reads its input once and writes its
// output once, with a few operations per element, so HBM bandwidth is the
// ceiling (bytes over 3.35 TB/s, the H100 SXM data sheet at its 700 W
// limit); e.g. softmax over a (98304, 2048) bf16 score block moves
// 805.3 MB, 0.2404 ms. What the design does about it: 16-byte loads and
// stores where the row's bytes allow (D * sizeof(T) % 16 == 0 and aligned
// pointers), else one element per thread per step, neighbouring threads on
// neighbouring addresses either way; fp32 arithmetic throughout.
//
// K7 makes two passes over its row: an online (max, sum) in fp32 per thread
// (one exp per element plus one per chunk), then the block's max (warp
// shuffles, then shared memory), each thread's sum rescaled to it once, and
// the block's sum; then a second read, mostly from L2 (the row was just
// read), that writes exp(x - m) * (1 / s) in x's dtype. A row of at most
// one 16-byte vector per thread (2048 bf16 values at 256 threads) stays in
// registers instead of being read twice.
// K8 stages the row in shared memory as fp32 (D <= MAX_NORM_D), so HBM is
// read once: the mean, then the centred variance over the staged values
// (the TPU kernel's two passes, which keep the digits that E[x^2] - mu^2
// loses for rows far from 0), rsqrtf(var + eps), times gamma, plus beta in LN
// mode, both fp32; RMS mode scales x by rsqrtf(mean(x^2) + eps) and gamma.

#include "common.cuh"

namespace {

constexpr int MAX_THREADS = 1024;
constexpr int MAX_NORM_D = 16384;  // K8's fp32 row in shared memory: 64 KB

// 16 bytes of T as floats, and back (bf16 rounded to nearest even).
__device__ __forceinline__ void load_vec(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    out[2 * j] = f.x;
    out[2 * j + 1] = f.y;
  }
}

__device__ __forceinline__ void store_vec(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* v) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Fold N values into (m, s): one rescale per chunk. -inf values add 0.
template <int N>
__device__ __forceinline__ void fold_chunk(float& m, float& s, const float* v) {
  float cm = v[0];
#pragma unroll
  for (int j = 1; j < N; ++j) cm = fmaxf(cm, v[j]);
  const float mn = fmaxf(m, cm);
  if (mn == -INFINITY) return;
  float cs = 0.f;
#pragma unroll
  for (int j = 0; j < N; ++j) cs += expf(v[j] - mn);
  s = s * expf(m - mn) + cs;
  m = mn;
}

// Max of v over the block, in every thread; `red` holds 32 floats (see
// block_sum for the barriers).
__device__ __forceinline__ float block_max(float v, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  return warp_max(lane < nw ? red[lane] : -INFINITY);
}

// Sum of v over the block, in every thread; `red` holds 32 floats. The
// first barrier keeps a previous call's readers ahead of this call's
// writers (and publishes whatever the block wrote to shared memory).
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  return warp_sum(lane < nw ? red[lane] : 0.f);
}

// The block's (max, sum) from each thread's pair: the block max, then each
// thread rescales its sum once and the sums are added.
__device__ __forceinline__ void block_max_sum(float& m, float& s, float* red) {
  const float mb = block_max(m, red);
  s = m == -INFINITY ? 0.f : s * expf(m - mb);
  s = block_sum(s, red);
  m = mb;
}

// K7. grid (rows); one block per row of D values. A row of at most one
// 16-byte vector per thread stays in registers between the two passes.
template <typename T, bool VEC>
__global__ void __launch_bounds__(MAX_THREADS)
softmax_rows(const T* __restrict__ x, T* __restrict__ y, int D) {
  __shared__ float red[32];
  const long long base = (long long)blockIdx.x * D;
  const T* xr = x + base;
  T* yr = y + base;
  const int tid = threadIdx.x, nt = blockDim.x;
  float m = -INFINITY, s = 0.f;
  if constexpr (VEC) {
    constexpr int V = 16 / sizeof(T);  // D % V == 0
    if (D <= nt * V) {
      const int i = tid * V;
      float v[V];
      if (i < D) {
        load_vec(xr + i, v);
        fold_chunk<V>(m, s, v);
      }
      block_max_sum(m, s, red);
      if (i < D) {
        const float inv = 1.f / s;
#pragma unroll
        for (int j = 0; j < V; ++j) v[j] = expf(v[j] - m) * inv;
        store_vec(yr + i, v);
      }
      return;
    }
    for (int i = tid * V; i < D; i += nt * V) {
      float v[V];
      load_vec(xr + i, v);
      fold_chunk<V>(m, s, v);
    }
  } else {
    constexpr int U = 4;  // four strided elements per chunk
    for (int i0 = tid; i0 < D; i0 += nt * U) {
      float v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + u * nt;
        v[u] = i < D ? to_float(xr[i]) : -INFINITY;
      }
      fold_chunk<U>(m, s, v);
    }
  }
  block_max_sum(m, s, red);
  const float inv = 1.f / s;
  if constexpr (VEC) {
    constexpr int V = 16 / sizeof(T);
    for (int i = tid * V; i < D; i += nt * V) {
      float v[V];
      load_vec(xr + i, v);
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = expf(v[j] - m) * inv;
      store_vec(yr + i, v);
    }
  } else {
    for (int i = tid; i < D; i += nt) store1(yr + i, expf(to_float(xr[i]) - m) * inv);
  }
}

// K8. grid (rows); one block per row, staged in `row` (D fp32, dynamic
// shared memory). gamma and beta (D,) are fp32; beta is unused in RMS mode.
template <typename T, bool VEC, bool RMS>
__global__ void __launch_bounds__(MAX_THREADS)
rownorm_rows(const T* __restrict__ x, const float* __restrict__ gamma,
             const float* __restrict__ beta, T* __restrict__ y, int D, float inv_d, float eps) {
  extern __shared__ __align__(16) float row[];
  __shared__ float red[32];
  const long long base = (long long)blockIdx.x * D;
  const T* xr = x + base;
  T* yr = y + base;
  const int tid = threadIdx.x, nt = blockDim.x;
  constexpr int V = VEC ? 16 / sizeof(T) : 1;

  float acc = 0.f;  // sum (LN) or sum of squares (RMS)
  for (int i = tid * V; i < D; i += nt * V) {
    float v[V];
    if constexpr (VEC) {
      load_vec(xr + i, v);
#pragma unroll
      for (int j = 0; j < V; j += 4)
        *reinterpret_cast<float4*>(row + i + j) = make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
    } else {
      v[0] = to_float(xr[i]);
      row[i] = v[0];
    }
#pragma unroll
    for (int j = 0; j < V; ++j) acc += RMS ? v[j] * v[j] : v[j];
  }
  const float total = block_sum(acc, red);
  float mu = 0.f, rstd;
  if constexpr (RMS) {
    rstd = rsqrtf(total * inv_d + eps);
  } else {
    mu = total * inv_d;
    acc = 0.f;
    for (int i = tid * V; i < D; i += nt * V) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float c = row[i + j] - mu;
        acc += c * c;
      }
    }
    rstd = rsqrtf(block_sum(acc, red) * inv_d + eps);
  }
  for (int i = tid * V; i < D; i += nt * V) {
    float out[V], g[V], b[V];
    if constexpr (VEC) {  // i % 4 == 0: 16-byte aligned fp32 vectors
#pragma unroll
      for (int j = 0; j < V; j += 4) {
        load_vec(gamma + i + j, g + j);
        if constexpr (!RMS) load_vec(beta + i + j, b + j);
      }
    } else {
      g[0] = gamma[i];
      if constexpr (!RMS) b[0] = beta[i];
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float o = (row[i + j] - mu) * rstd;
      o = o * g[j];
      if constexpr (!RMS) o = o + b[j];
      out[j] = o;
    }
    if constexpr (VEC) store_vec(yr + i, out);
    else store1(yr + i, out[0]);
  }
}

// Threads for a row of D values taken `per` at a time: a multiple of 32,
// at most MAX_THREADS.
int row_threads(int D, int per) {
  const int want = (D + per - 1) / per;
  const int t = (want + 31) / 32 * 32;
  return t < 32 ? 32 : t > MAX_THREADS ? MAX_THREADS : t;
}

// 16-byte vectors fit when every row starts 16-byte aligned.
bool vectorizable(const void* a, const void* b, int D, int elt) {
  return (static_cast<long long>(D) * elt) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(a) % 16 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;
}

template <typename T>
cudaError_t run_softmax(const void* x, void* y, int rows, int D, cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  if (vectorizable(x, y, D, sizeof(T))) {
    softmax_rows<T, true><<<rows, row_threads(D, 16 / sizeof(T)), 0, st>>>(xp, yp, D);
  } else {
    softmax_rows<T, false><<<rows, row_threads(D, 1), 0, st>>>(xp, yp, D);
  }
  return cudaGetLastError();
}

template <typename T, bool VEC, bool RMS>
cudaError_t launch_rownorm(const T* x, const float* g, const float* b, T* y, int rows, int D,
                           float inv_d, float eps, cudaStream_t st) {
  auto kernel = rownorm_rows<T, VEC, RMS>;
  const size_t smem = static_cast<size_t>(D) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<rows, row_threads(D, VEC ? 16 / sizeof(T) : 1), smem, st>>>(x, g, b, y, D, inv_d, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_rownorm(const void* x, const float* g, const float* b, void* y, int rows, int D,
                        float inv_d, float eps, bool rms, cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  const bool vec = vectorizable(x, y, D, sizeof(T)) &&
                   vectorizable(g, rms ? g : b, D, sizeof(float));
  if (vec && rms) return launch_rownorm<T, true, true>(xp, g, b, yp, rows, D, inv_d, eps, st);
  if (vec) return launch_rownorm<T, true, false>(xp, g, b, yp, rows, D, inv_d, eps, st);
  if (rms) return launch_rownorm<T, false, true>(xp, g, b, yp, rows, D, inv_d, eps, st);
  return launch_rownorm<T, false, false>(xp, g, b, yp, rows, D, inv_d, eps, st);
}

}  // namespace

// K7: y = softmax(x) over the last axis of (rows, D), fp32 or bf16.
extern "C" int pfa_softmax(const void* x, void* y, int rows, int D, int dtype, void* stream) {
  if (rows <= 0 || D <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == PFA_F32) return run_softmax<float>(x, y, rows, D, st);
  if (dtype == PFA_BF16) return run_softmax<__nv_bfloat16>(x, y, rows, D, st);
  return cudaErrorInvalidValue;
}

// K8: LayerNorm (rms = 0; beta required) or RMSNorm (rms = 1) of each row
// of (rows, D), fp32 or bf16; gamma and beta (D,) fp32; inv_d = 1 / D.
extern "C" int pfa_rownorm(const void* x, const float* gamma, const float* beta, void* y,
                           int rows, int D, float inv_d, float eps, int rms, int dtype,
                           void* stream) {
  if (rows <= 0 || D <= 0 || D > MAX_NORM_D || gamma == nullptr || (!rms && beta == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == PFA_F32) return run_rownorm<float>(x, gamma, beta, y, rows, D, inv_d, eps, rms, st);
  if (dtype == PFA_BF16)
    return run_rownorm<__nv_bfloat16>(x, gamma, beta, y, rows, D, inv_d, eps, rms, st);
  return cudaErrorInvalidValue;
}
