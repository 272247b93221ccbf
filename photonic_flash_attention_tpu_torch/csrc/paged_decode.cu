// K2 (paged token write) for Hopper (sm_90a): the standalone write of each
// sequence's new K/V token into the paged pool.
//
// It is the write half of the TPU kernel photonic_flash_attention_tpu/ops/
// paged.py::_fused_decode_kernel, which writes every sequence's token at
// grid step (0,0) and then attends over the pool. The decode path runs the
// two halves in ONE launch (K3's fused mode, paged_decode_sm90.cu); this
// kernel serves ops/paged.py::paged_token_write, the write alone.
//
// Pool layout (the port's choice): token-major (L, Hkv, P, page, D), so a
// token's D values are contiguous and a flat slot pid * page + off
// addresses a token row directly. int8 pools carry fp32 per-token scales
// (L, Hkv, P, page).
//
// What bounds it: a few KB of writes, so the launch itself. Design: one
// warp per (sequence, kv head, K or V): absmax reduction by shuffles, then
// round-half-even (rintf) quantization, bit-exact with torch.round
// (common.cuh::quant_token_value, shared with K3's fused write). Empty
// serving slots all write to trash page 0; concurrent writes there are
// harmless because page 0 is never read.

#include "common.cuh"

namespace {

// grid (B, Hkv, 2): z = 0 writes K, z = 1 writes V. One warp each.
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
    const float scale = token_scale(warp_max(amax));
    for (int d = lane; d < D; d += 32) dst[d] = quant_token_value(to_float(src[d]), scale);
    if (lane == 0) (is_v ? v_scales : k_scales)[tok] = scale;
  } else {
    for (int d = lane; d < D; d += 32) dst[d] = src[d];
  }
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
