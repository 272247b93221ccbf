// K2 (paged token write) and K3 (paged decode attention) for Hopper (sm_90a).
//
// Both replace the TPU kernel photonic_flash_attention_tpu/ops/paged.py::
// _fused_decode_kernel, which writes every sequence's new K/V token into
// the paged pool at grid step (0,0) and then attends over the pool,
// relying on the TPU grid running in order. On the H100 blocks run in
// parallel and in no order, so the write is its own launch (K2) on the same
// stream, before the attend (K3). The TPU fused the two only to keep XLA
// from copying an aliased pool; a PyTorch tensor is updated in place.
//
// Pool layout (the port's choice): token-major (L, Hkv, P, page, D), so a
// token's D values are contiguous (16-byte loads along D) and a flat slot
// pid * page + off addresses a token row directly. int8 pools carry fp32
// per-token scales (L, Hkv, P, page).
//
// What bounds them on the H100: decode reads every cached K/V byte once
// per step and does ~2 FLOPs per byte, so HBM bandwidth is the ceiling
// (3.35 TB/s on the H100 SXM data sheet at its 700 W limit); at serving
// batch 8 the launch and latency of a small kernel come first.
// Design: K3 runs one block per (sequence, kv head) with every query head
// of the group inside it (no TPU g_pad padding),
// reads only lengths[b] tokens (a sequence of length 0 writes zeros and
// reads nothing), keeps scores and the fp32 online-softmax state in shared
// memory, folds the int8 K scale into the score and the V scale into P.
// K2 runs one warp per (sequence, kv head, K or V): absmax reduction by
// shuffles, then round-half-even (rintf) quantization, bit-exact with
// torch.round. Empty serving slots all write to trash page 0; concurrent
// writes there are harmless because page 0 is never read.

#include "common.cuh"

namespace {

constexpr int ATT_THREADS = 128;
constexpr int CH = ATT_THREADS;  // tokens per chunk: one per thread when scoring

// 8 consecutive pool values as floats. Rows are D % 8 == 0 elements long,
// so the loads are aligned (8 bytes for int8, 16 for bf16, 32 for fp32).
__device__ __forceinline__ void load8(const int8_t* p, float out[8]) {
  const int2 raw = *reinterpret_cast<const int2*>(p);
  const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int j = 0; j < 8; ++j) out[j] = static_cast<float>(e[j]);
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float out[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int j = 0; j < 8; ++j) out[j] = __bfloat162float(e[j]);
}

__device__ __forceinline__ void load8(const float* p, float out[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 c = reinterpret_cast<const float4*>(p)[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = c.x; out[5] = c.y; out[6] = c.z; out[7] = c.w;
}

// K2. grid (B, Hkv, 2): z = 0 writes K, z = 1 writes V. One warp each.
template <typename Tin, typename Tpool, bool QUANT>
__global__ void __launch_bounds__(32)
paged_token_write(const Tin* __restrict__ k_new, const Tin* __restrict__ v_new,
                  Tpool* __restrict__ k_pool, Tpool* __restrict__ v_pool,
                  float* __restrict__ k_scales, float* __restrict__ v_scales,
                  const int* __restrict__ slots, long long layer_base,
                  long long head_stride, int Hkv, int D) {
  const int b = blockIdx.x, h = blockIdx.y, lane = threadIdx.x;
  const bool is_v = blockIdx.z == 1;
  const Tin* src = (is_v ? v_new : k_new) + ((long long)b * Hkv + h) * D;
  const long long tok = layer_base + h * head_stride + slots[b];
  Tpool* dst = (is_v ? v_pool : k_pool) + tok * D;
  if constexpr (QUANT) {
    float amax = 0.f;
    for (int d = lane; d < D; d += 32) amax = fmaxf(amax, fabsf(to_float(src[d])));
    amax = warp_max(amax);
    const float scale = amax == 0.f ? 1.f : amax / 127.f;
    for (int d = lane; d < D; d += 32) {
      const float qv = fminf(fmaxf(rintf(to_float(src[d]) / scale), -127.f), 127.f);
      dst[d] = static_cast<int8_t>(qv);
    }
    if (lane == 0) (is_v ? v_scales : k_scales)[tok] = scale;
  } else {
    for (int d = lane; d < D; d += 32) dst[d] = src[d];
  }
}

// K3. grid (B, Hkv); the block's G = Hq / Hkv query heads share the kv
// head's pages. Per chunk of CH tokens: (a) one thread per token computes
// the G scores; (b) one warp per head updates max, sum and rescale factor;
// (c) one thread per output element (head, d) accumulates P.V.
template <typename Tpool, bool QUANT>
__global__ void __launch_bounds__(ATT_THREADS)
paged_decode_attend(const float* __restrict__ q, const Tpool* __restrict__ k_pool,
                    const Tpool* __restrict__ v_pool,
                    const float* __restrict__ k_scales,
                    const float* __restrict__ v_scales,
                    const int* __restrict__ lengths, const int* __restrict__ tables,
                    float* __restrict__ o, long long layer_base,
                    long long head_stride, int Hq, int Hkv, int D, int page_size,
                    int pages_per_seq, float sm_scale) {
  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  constexpr int NWARPS = ATT_THREADS / 32;
  const int G = Hq / Hkv, GD = G * D;
  extern __shared__ __align__(16) unsigned char smem[];
  long long* tok_s = reinterpret_cast<long long*>(smem);  // CH token rows
  float* qs = reinterpret_cast<float*>(tok_s + CH);       // G*D scaled q
  float* acc = qs + GD;                                   // G*D
  float* p = acc + GD;                                    // G*CH scores, then P
  float* vsc = p + G * CH;                                // CH V scales
  float* m_s = vsc + CH;                                  // G running max
  float* l_s = m_s + G;                                   // G running sum
  float* a_s = l_s + G;                                   // G rescale factor

  const long long q_off = ((long long)b * Hq + (long long)h * G) * D;
  float* out = o + q_off;
  const int len = lengths[b];
  if (len <= 0) {
    for (int i = tid; i < GD; i += ATT_THREADS) out[i] = 0.f;
    return;
  }
  for (int i = tid; i < GD; i += ATT_THREADS) {
    qs[i] = q[q_off + i] * sm_scale;
    acc[i] = 0.f;
  }
  for (int i = tid; i < G; i += ATT_THREADS) {
    m_s[i] = -INFINITY;
    l_s[i] = 0.f;
  }
  __syncthreads();

  const int* tab = tables + (long long)b * pages_per_seq;
  const long long head_base = layer_base + (long long)h * head_stride;
  for (int t0 = 0; t0 < len; t0 += CH) {
    const int n = min(CH, len - t0);
    if (tid < n) {
      const int t = t0 + tid;
      const long long tok = head_base + (long long)tab[t / page_size] * page_size + t % page_size;
      tok_s[tid] = tok;
      const float ks = QUANT ? k_scales[tok] : 1.f;
      vsc[tid] = QUANT ? v_scales[tok] : 1.f;
      const Tpool* kr = k_pool + tok * D;
      for (int gi = 0; gi < G; ++gi) {
        const float* qg = qs + gi * D;
        float dot = 0.f;
        for (int d = 0; d < D; d += 8) {
          float kv[8];
          load8(kr + d, kv);
#pragma unroll
          for (int j = 0; j < 8; ++j) dot = fmaf(qg[d + j], kv[j], dot);
        }
        p[gi * CH + tid] = dot * ks;
      }
    }
    __syncthreads();
    for (int gi = warp; gi < G; gi += NWARPS) {
      float* pg = p + gi * CH;
      float mx = -INFINITY;
      for (int i = lane; i < n; i += 32) mx = fmaxf(mx, pg[i]);
      mx = warp_max(mx);
      const float m_new = fmaxf(m_s[gi], mx);  // finite: the chunk has n >= 1 tokens
      const float alpha = expf(m_s[gi] - m_new);
      float sum = 0.f;
      for (int i = lane; i < n; i += 32) {
        const float e = expf(pg[i] - m_new);
        sum += e;
        pg[i] = e * vsc[i];  // V scale folded into P
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        l_s[gi] = l_s[gi] * alpha + sum;
        m_s[gi] = m_new;
        a_s[gi] = alpha;
      }
    }
    __syncthreads();
    for (int e = tid; e < GD; e += ATT_THREADS) {
      const int gi = e / D, d = e - gi * D;
      const float* pg = p + gi * CH;
      float a = acc[e] * a_s[gi];
      for (int i = 0; i < n; ++i) a = fmaf(pg[i], to_float(v_pool[tok_s[i] * D + d]), a);
      acc[e] = a;
    }
    __syncthreads();
  }
  for (int e = tid; e < GD; e += ATT_THREADS) out[e] = acc[e] / l_s[e / D];
}

}  // namespace

extern "C" int pfa_paged_token_write(const void* k_new, const void* v_new, void* k_pool,
                                     void* v_pool, void* k_scales, void* v_scales,
                                     const void* slots, int layer, int B, int Hkv, int D,
                                     int num_pages, int page_size, int in_dtype,
                                     int pool_dtype, void* stream) {
  const long long head_stride = (long long)num_pages * page_size;
  const long long layer_base = (long long)layer * Hkv * head_stride;
  const dim3 grid(B, Hkv, 2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* sl = static_cast<const int*>(slots);
  float* ks = static_cast<float*>(k_scales);
  float* vs = static_cast<float*>(v_scales);
  if (pool_dtype == PFA_INT8 && in_dtype == PFA_BF16) {
    paged_token_write<__nv_bfloat16, int8_t, true><<<grid, 32, 0, st>>>(
        static_cast<const __nv_bfloat16*>(k_new), static_cast<const __nv_bfloat16*>(v_new),
        static_cast<int8_t*>(k_pool), static_cast<int8_t*>(v_pool), ks, vs, sl, layer_base,
        head_stride, Hkv, D);
  } else if (pool_dtype == PFA_INT8 && in_dtype == PFA_F32) {
    paged_token_write<float, int8_t, true><<<grid, 32, 0, st>>>(
        static_cast<const float*>(k_new), static_cast<const float*>(v_new),
        static_cast<int8_t*>(k_pool), static_cast<int8_t*>(v_pool), ks, vs, sl, layer_base,
        head_stride, Hkv, D);
  } else if (pool_dtype == PFA_BF16 && in_dtype == PFA_BF16) {
    paged_token_write<__nv_bfloat16, __nv_bfloat16, false><<<grid, 32, 0, st>>>(
        static_cast<const __nv_bfloat16*>(k_new), static_cast<const __nv_bfloat16*>(v_new),
        static_cast<__nv_bfloat16*>(k_pool), static_cast<__nv_bfloat16*>(v_pool), ks, vs, sl,
        layer_base, head_stride, Hkv, D);
  } else if (pool_dtype == PFA_F32 && in_dtype == PFA_F32) {
    paged_token_write<float, float, false><<<grid, 32, 0, st>>>(
        static_cast<const float*>(k_new), static_cast<const float*>(v_new),
        static_cast<float*>(k_pool), static_cast<float*>(v_pool), ks, vs, sl, layer_base,
        head_stride, Hkv, D);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

extern "C" int pfa_paged_decode_attend(const void* q, const void* k_pool, const void* v_pool,
                                       const void* k_scales, const void* v_scales,
                                       const void* lengths, const void* tables, void* o,
                                       int layer, int B, int Hq, int Hkv, int D,
                                       int num_pages, int page_size, int pages_per_seq,
                                       float sm_scale, int pool_dtype, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || D % 8 != 0) return cudaErrorInvalidValue;
  const long long head_stride = (long long)num_pages * page_size;
  const long long layer_base = (long long)layer * Hkv * head_stride;
  const int G = Hq / Hkv;
  const size_t smem = CH * sizeof(long long) + (size_t)(2 * G * D + G * CH + CH + 3 * G) * sizeof(float);
  const dim3 grid(B, Hkv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* ks = static_cast<const float*>(k_scales);
  const float* vs = static_cast<const float*>(v_scales);
  const int* len = static_cast<const int*>(lengths);
  const int* tab = static_cast<const int*>(tables);
  float* out = static_cast<float*>(o);
  if (pool_dtype == PFA_INT8) {
    paged_decode_attend<int8_t, true><<<grid, ATT_THREADS, smem, st>>>(
        qf, static_cast<const int8_t*>(k_pool), static_cast<const int8_t*>(v_pool), ks, vs, len,
        tab, out, layer_base, head_stride, Hq, Hkv, D, page_size, pages_per_seq, sm_scale);
  } else if (pool_dtype == PFA_BF16) {
    paged_decode_attend<__nv_bfloat16, false><<<grid, ATT_THREADS, smem, st>>>(
        qf, static_cast<const __nv_bfloat16*>(k_pool), static_cast<const __nv_bfloat16*>(v_pool),
        ks, vs, len, tab, out, layer_base, head_stride, Hq, Hkv, D, page_size, pages_per_seq,
        sm_scale);
  } else if (pool_dtype == PFA_F32) {
    paged_decode_attend<float, false><<<grid, ATT_THREADS, smem, st>>>(
        qf, static_cast<const float*>(k_pool), static_cast<const float*>(v_pool), ks, vs, len,
        tab, out, layer_base, head_stride, Hq, Hkv, D, page_size, pages_per_seq, sm_scale);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
