// Shared helpers of the port's CUDA kernels (plain C interface, no PyTorch
// headers: see ops/_build.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// dtype codes, as ops/_build.py::DTYPE_CODES.
enum PfaDtype { PFA_F32 = 0, PFA_BF16 = 1, PFA_INT8 = 2 };

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(int8_t x) { return static_cast<float>(x); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// --- mma.sync m16n8k16 (bf16 in, fp32 accumulate) -------------------------
//
// Fragment layout, lane = 4 * g + t4: the A tile (16x16, row-major) gives a
// lane rows g, g+8 and columns 2*t4, 2*t4+1 (+8); the B tile (16x8,
// column-major) rows 2*t4, 2*t4+1 (+8) of column g; the accumulator (16x8)
// rows g, g+8 and columns 2*t4, 2*t4+1. An accumulator pair of two
// neighbouring 8-wide tiles is therefore directly an A fragment
// (pack_bf16 of its values), which keeps score tiles in registers.

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// c += A (16x16 bf16, row-major) * B (16x8 bf16, column-major), fp32.
__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of rows r0..r0+15, columns c0..c0+15 of a row-major shared
// tile with row pitch LD.
template <int LD>
__device__ __forceinline__ void load_a_frag(uint32_t a[4], const __nv_bfloat16* s,
                                            int r0, int c0, int g, int t4) {
  const __nv_bfloat16* p = s + (r0 + g) * LD + c0 + t4 * 2;
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * LD);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * LD + 8);
}

// B operand = the TRANSPOSE of rows n0..n0+7 of a row-major shared tile
// (contraction over its columns c0..c0+15): s = Q K^T reads K this way.
template <int LD>
__device__ __forceinline__ void mma_bt(float c[4], const uint32_t a[4],
                                       const __nv_bfloat16* s, int n0, int c0,
                                       int g, int t4) {
  const __nv_bfloat16* p = s + (n0 + g) * LD + c0 + t4 * 2;
  mma_16816(c, a, *reinterpret_cast<const uint32_t*>(p),
            *reinterpret_cast<const uint32_t*>(p + 8));
}

// B operand = rows k0..k0+15, columns n0..n0+7 of a row-major shared tile
// (contraction over its rows): P V reads V this way.
template <int LD>
__device__ __forceinline__ void mma_bn(float c[4], const uint32_t a[4],
                                       const __nv_bfloat16* s, int k0, int n0,
                                       int g, int t4) {
  const __nv_bfloat16* p = s + (k0 + t4 * 2) * LD + n0 + g;
  mma_16816(c, a, pack_raw(p[0], p[LD]), pack_raw(p[8 * LD], p[9 * LD]));
}

// rows x D bf16 from global (row stride `stride` elements) into shared
// memory with row pitch LD; rows at or past `valid` are zero-filled.
template <int D, int LD, int NT>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
                                               long long stride, int rows,
                                               int valid) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < rows * CH; i += NT) {
    const int r = i / CH, c = (i % CH) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) val = *reinterpret_cast<const uint4*>(src + r * stride + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// rows x D fp32 from global into shared memory with row pitch LD;
// rows at or past `valid` are zero-filled.
template <int D, int LD, int NT>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              long long stride, int rows, int valid) {
  for (int i = threadIdx.x; i < rows * D; i += NT) {
    const int r = i / D, c = i % D;
    dst[r * LD + c] = r < valid ? src[r * stride + c] : 0.f;
  }
}
