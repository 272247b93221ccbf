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
//
// K3's token-bias mode (the TPU kernel's bias_ref, ops/paged.py:419,
// 635-641; T5 decode self-attention, models/t5_serving.py): `tbias` (B,
// Hkv, bias_len) fp32 adds bias[b, h, t] to the scaled score of the token
// at LOGICAL position t of the sequence (not its pool slot), shared by the
// group's query heads, before the length mask (only t < lengths[b] is ever
// scored). The wrapper pads or cuts the bias to the page-table capacity.
//
// K3 also serves the read-only head-folded decode of the TPU kernel
// ops/paged.py::_paged_hf_kernel (paged_attention_hf, the engine's
// PAGED_DECODE kind) through pfa_paged_hf. Its float mode is the attend
// above, in chunks of the TPU kernel's blocks of pages_per_block pages. Its
// int8_compute mode (the default for int8 pools) takes q already quantized
// per tensor by the wrapper: scores are int8 x int8 products summed in
// int32 (exact in any order) times the score scale and the per-token K
// scale; P, after the V scales are folded in, is requantized per (head,
// block) as trunc(p * 127/pmax + 0.5) and multiplied with the int8 V rows
// in int32, then scaled by pmax/127. The requant block must be the TPU
// kernel's block of pages_per_block * page_size tokens: another
// granularity rounds P differently. Its DMA pipelining (num_buffers) has no
// counterpart: a block reads its own pages.

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

__device__ __forceinline__ void load8i(const int8_t* p, int out[8]) {
  const int2 raw = *reinterpret_cast<const int2*>(p);
  const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int j = 0; j < 8; ++j) out[j] = e[j];
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
// head's pages. Per chunk of `chunk` tokens: (a) one thread per token
// computes the G scores; (b) one warp per head updates max, sum and rescale
// factor (and, in I8C mode, requantizes P); (c) one thread per output
// element (head, d) accumulates P.V. I8C (int8 pools only): q8 holds the
// per-tensor int8 query and score_scale its dequant scale x sm_scale.
template <typename Tpool, bool QUANT, bool I8C>
__global__ void __launch_bounds__(ATT_THREADS)
paged_decode_attend(const float* __restrict__ q, const int8_t* __restrict__ q8,
                    const Tpool* __restrict__ k_pool, const Tpool* __restrict__ v_pool,
                    const float* __restrict__ k_scales,
                    const float* __restrict__ v_scales,
                    const int* __restrict__ lengths, const int* __restrict__ tables,
                    const float* __restrict__ tbias, float* __restrict__ o,
                    long long layer_base, long long head_stride, int Hq, int Hkv, int D,
                    int page_size, int pages_per_seq, int bias_len, float sm_scale, int chunk) {
  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  constexpr int NWARPS = ATT_THREADS / 32;
  const int G = Hq / Hkv, GD = G * D;
  extern __shared__ __align__(16) unsigned char smem[];
  long long* tok_s = reinterpret_cast<long long*>(smem);  // chunk token rows
  float* qs = reinterpret_cast<float*>(tok_s + chunk);    // G*D scaled q (I8C: int q8)
  float* acc = qs + GD;                                   // G*D
  float* p = acc + GD;                                    // G*chunk scores, then P
  float* vsc = p + G * chunk;                             // chunk V scales
  float* m_s = vsc + chunk;                               // G running max
  float* l_s = m_s + G;                                   // G running sum
  float* a_s = l_s + G;                                   // G rescale factor
  float* ps_s = a_s + G;                                  // G P dequant scale (I8C)
  int* qi = reinterpret_cast<int*>(qs);

  const long long q_off = ((long long)b * Hq + (long long)h * G) * D;
  float* out = o + q_off;
  const int len = lengths[b];
  if (len <= 0) {
    for (int i = tid; i < GD; i += ATT_THREADS) out[i] = 0.f;
    return;
  }
  for (int i = tid; i < GD; i += ATT_THREADS) {
    if (I8C) qi[i] = q8[q_off + i];
    else qs[i] = q[q_off + i] * sm_scale;
    acc[i] = 0.f;
  }
  for (int i = tid; i < G; i += ATT_THREADS) {
    m_s[i] = -INFINITY;
    l_s[i] = 0.f;
  }
  __syncthreads();

  const int* tab = tables + (long long)b * pages_per_seq;
  const long long head_base = layer_base + (long long)h * head_stride;
  const float* brow = tbias != nullptr ? tbias + ((long long)b * Hkv + h) * bias_len : nullptr;
  for (int t0 = 0; t0 < len; t0 += chunk) {
    const int n = min(chunk, len - t0);
    for (int i = tid; i < n; i += ATT_THREADS) {
      const int t = t0 + i;
      const long long tok = head_base + (long long)tab[t / page_size] * page_size + t % page_size;
      tok_s[i] = tok;
      const float ks = QUANT ? k_scales[tok] : 1.f;
      const float tb = brow != nullptr ? brow[t] : 0.f;  // logical position t
      vsc[i] = QUANT ? v_scales[tok] : 1.f;
      const Tpool* kr = k_pool + tok * D;
      for (int gi = 0; gi < G; ++gi) {
        if constexpr (I8C) {
          const int* qg = qi + gi * D;
          int dot = 0;
          for (int d = 0; d < D; d += 8) {
            int kv[8];
            load8i(reinterpret_cast<const int8_t*>(kr) + d, kv);
#pragma unroll
            for (int j = 0; j < 8; ++j) dot += qg[d + j] * kv[j];
          }
          p[gi * chunk + i] = __fmul_rn(__fmul_rn(static_cast<float>(dot), sm_scale), ks) + tb;
        } else {
          const float* qg = qs + gi * D;
          float dot = 0.f;
          for (int d = 0; d < D; d += 8) {
            float kv[8];
            load8(kr + d, kv);
#pragma unroll
            for (int j = 0; j < 8; ++j) dot = fmaf(qg[d + j], kv[j], dot);
          }
          p[gi * chunk + i] = dot * ks + tb;
        }
      }
    }
    __syncthreads();
    for (int gi = warp; gi < G; gi += NWARPS) {
      float* pg = p + gi * chunk;
      float mx = -INFINITY;
      for (int i = lane; i < n; i += 32) mx = fmaxf(mx, pg[i]);
      mx = warp_max(mx);
      const float m_new = fmaxf(m_s[gi], mx);  // finite: the chunk has n >= 1 tokens
      const float alpha = expf(m_s[gi] - m_new);
      float sum = 0.f, pmax = 0.f;
      for (int i = lane; i < n; i += 32) {
        const float e = expf(pg[i] - m_new);
        sum += e;
        pg[i] = e * vsc[i];  // V scale folded into P
        pmax = fmaxf(pmax, pg[i]);
      }
      sum = warp_sum(sum);
      if (I8C) {
        // Per-(head, block) P requant: p8 = trunc(p * 127/pmax + 0.5).
        pmax = warp_max(pmax);
        const float pinv = pmax == 0.f ? 0.f : 127.f / pmax;
        for (int i = lane; i < n; i += 32)
          pg[i] = truncf(__fadd_rn(__fmul_rn(pg[i], pinv), 0.5f));
      }
      if (lane == 0) {
        l_s[gi] = l_s[gi] * alpha + sum;
        m_s[gi] = m_new;
        a_s[gi] = alpha;
        if (I8C) ps_s[gi] = pmax == 0.f ? 0.f : pmax / 127.f;
      }
    }
    __syncthreads();
    for (int e = tid; e < GD; e += ATT_THREADS) {
      const int gi = e / D, d = e - gi * D;
      const float* pg = p + gi * chunk;
      if constexpr (I8C) {
        int pv = 0;
        for (int i = 0; i < n; ++i)
          pv += static_cast<int>(pg[i]) * static_cast<int>(v_pool[tok_s[i] * D + d]);
        acc[e] = __fadd_rn(__fmul_rn(acc[e], a_s[gi]),
                           __fmul_rn(static_cast<float>(pv), ps_s[gi]));
      } else {
        float a = acc[e] * a_s[gi];
        for (int i = 0; i < n; ++i) a = fmaf(pg[i], to_float(v_pool[tok_s[i] * D + d]), a);
        acc[e] = a;
      }
    }
    __syncthreads();
  }
  for (int e = tid; e < GD; e += ATT_THREADS) out[e] = acc[e] / l_s[e / D];
}

size_t attend_smem(int G, int D, int chunk) {
  return chunk * sizeof(long long) + (size_t)(2 * G * D + G * chunk + chunk + 4 * G) * sizeof(float);
}

// Launch K3 (with the opt-in to more than 48 KB of shared memory when the
// chunk needs it).
template <typename Tpool, bool QUANT, bool I8C>
cudaError_t run_attend(dim3 grid, size_t smem, cudaStream_t st, const float* q,
                       const int8_t* q8, const void* k_pool, const void* v_pool,
                       const float* ks, const float* vs, const int* len, const int* tab,
                       const float* tbias, float* out, long long layer_base,
                       long long head_stride, int Hq, int Hkv, int D, int page_size,
                       int pages_per_seq, int bias_len, float scale, int chunk) {
  auto kernel = paged_decode_attend<Tpool, QUANT, I8C>;
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, ATT_THREADS, smem, st>>>(
      q, q8, static_cast<const Tpool*>(k_pool), static_cast<const Tpool*>(v_pool), ks, vs, len,
      tab, tbias, out, layer_base, head_stride, Hq, Hkv, D, page_size, pages_per_seq, bias_len,
      scale, chunk);
  return cudaGetLastError();
}

// K3 over layer `layer` of the pool in chunks of `chunk` tokens; i8c
// selects the int8-compute mode (int8 pools, q8 and score_scale given);
// tbias (B, Hkv, bias_len >= pages_per_seq * page_size) or null.
cudaError_t attend(const void* q, const void* q8, const void* k_pool, const void* v_pool,
                   const void* k_scales, const void* v_scales, const void* lengths,
                   const void* tables, const void* tbias, void* o, int layer, int B, int Hq,
                   int Hkv, int D, int num_pages, int page_size, int pages_per_seq,
                   int bias_len, float scale, int pool_dtype, int chunk, int i8c,
                   cudaStream_t st) {
  if (Hkv <= 0 || Hq % Hkv != 0 || D % 8 != 0 || chunk <= 0) return cudaErrorInvalidValue;
  if (tbias != nullptr && bias_len < pages_per_seq * page_size) return cudaErrorInvalidValue;
  if (i8c && pool_dtype != PFA_INT8) return cudaErrorInvalidValue;
  const long long head_stride = (long long)num_pages * page_size;
  const long long layer_base = (long long)layer * Hkv * head_stride;
  const size_t smem = attend_smem(Hq / Hkv, D, chunk);
  const dim3 grid(B, Hkv);
  const float* qf = static_cast<const float*>(q);
  const int8_t* qi = static_cast<const int8_t*>(q8);
  const float* ks = static_cast<const float*>(k_scales);
  const float* vs = static_cast<const float*>(v_scales);
  const int* len = static_cast<const int*>(lengths);
  const int* tab = static_cast<const int*>(tables);
  const float* tb = static_cast<const float*>(tbias);
  float* out = static_cast<float*>(o);
#define PFA_ATTEND(T, QU, I8)                                                                 \
  run_attend<T, QU, I8>(grid, smem, st, qf, qi, k_pool, v_pool, ks, vs, len, tab, tb, out,    \
                        layer_base, head_stride, Hq, Hkv, D, page_size, pages_per_seq,         \
                        bias_len, scale, chunk)
  if (pool_dtype == PFA_INT8 && i8c) return PFA_ATTEND(int8_t, true, true);
  if (pool_dtype == PFA_INT8) return PFA_ATTEND(int8_t, true, false);
  if (pool_dtype == PFA_BF16) return PFA_ATTEND(__nv_bfloat16, false, false);
  if (pool_dtype == PFA_F32) return PFA_ATTEND(float, false, false);
#undef PFA_ATTEND
  return cudaErrorInvalidValue;
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

// token_bias (B, Hkv, bias_len) fp32 or null (the token-bias mode).
extern "C" int pfa_paged_decode_attend(const void* q, const void* k_pool, const void* v_pool,
                                       const void* k_scales, const void* v_scales,
                                       const void* lengths, const void* tables, void* o,
                                       const void* token_bias, int layer, int B, int Hq,
                                       int Hkv, int D, int num_pages, int page_size,
                                       int pages_per_seq, int bias_len, float sm_scale,
                                       int pool_dtype, void* stream) {
  return attend(q, nullptr, k_pool, v_pool, k_scales, v_scales, lengths, tables, token_bias, o,
                layer, B, Hq, Hkv, D, num_pages, page_size, pages_per_seq, bias_len, sm_scale,
                pool_dtype, CH, 0, static_cast<cudaStream_t>(stream));
}

// paged_attention_hf: q (B, Hq, D) fp32, or q8 (B, Hq, D) int8 with
// score_scale = q dequant scale x sm_scale when int8_compute; chunks of
// block_tokens = pages_per_block * page_size tokens.
extern "C" int pfa_paged_hf(const void* q, const void* q8, const void* k_pool,
                            const void* v_pool, const void* k_scales, const void* v_scales,
                            const void* lengths, const void* tables, void* o, int layer, int B,
                            int Hq, int Hkv, int D, int num_pages, int page_size,
                            int pages_per_seq, float score_scale, int pool_dtype,
                            int block_tokens, int int8_compute, void* stream) {
  return attend(q, q8, k_pool, v_pool, k_scales, v_scales, lengths, tables, nullptr, o, layer,
                B, Hq, Hkv, D, num_pages, page_size, pages_per_seq, 0, score_scale, pool_dtype,
                block_tokens, int8_compute, static_cast<cudaStream_t>(stream));
}
