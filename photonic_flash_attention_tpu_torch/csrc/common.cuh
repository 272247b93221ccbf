// Shared helpers of the port's CUDA kernels (plain C interface, no PyTorch
// headers: see ops/_build.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// dtype codes, as ops/_build.py::DTYPE_CODES.
enum PfaDtype { PFA_F32 = 0, PFA_BF16 = 1, PFA_INT8 = 2, PFA_E4M3 = 3 };

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float MASK_VALUE = -0.7f * 3.4028234663852886e38f;  // DEFAULT_MASK_VALUE

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(int8_t x) { return static_cast<float>(x); }

// --- window and dropout streams of K1, K4 and K5 ---------------------------
//
// Window: a key is valid when lo <= rel <= hi, rel = col - (row + Skv - Sq)
// (the row aligned to the sequence end, as the causal mask); an open side
// is passed as -/+ WINDOW_OPEN (ops/flash_bwd.py::kernel_window), which no
// rel reaches. Dropout: the TPU kernels' positional hash
// (photonic_flash_attention_tpu/ops/pallas_utils.py::dropout_keep, ported
// in ops/dropout.py) over the UNALIGNED global query row, the key column,
// the stride Skv and bh = b * Hq + h over the query heads; a score is kept
// where the hash is >= thresh (thresh 0 keeps all).

constexpr int WINDOW_OPEN = 1 << 30;

struct Streams {
  int lo, hi;         // window bounds on rel (WINDOW_OPEN when open)
  uint32_t seed;      // dropout seed
  uint32_t thresh;    // keep threshold; 0 = no dropout
  float inv_keep;     // 1 / (1 - rate)

  __device__ __forceinline__ bool in_window(int rel) const { return rel >= lo && rel <= hi; }
};

__device__ __forceinline__ bool dropout_keep(uint32_t seed, uint32_t bh, int row, int col,
                                             uint32_t kv_stride, uint32_t thresh) {
  uint32_t x = (static_cast<uint32_t>(row) * kv_stride + static_cast<uint32_t>(col)) ^ seed;
  x ^= bh * 0x9E3779B1u;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x >= thresh;
}

// The P.V multiplier of score (row, col): 1 / (1 - rate) where kept, 0
// where dropped.
__device__ __forceinline__ float dropout_mult(const Streams& st, uint32_t bh, int row, int col,
                                              int Skv) {
  return dropout_keep(st.seed, bh, row, col, static_cast<uint32_t>(Skv), st.thresh) ? st.inv_keep
                                                                                    : 0.f;
}

// The first multiple of `tile` at or below the first key a query block
// [q0, q0 + rows) can see under the window (its lo side), clipped at 0.
__device__ __forceinline__ int band_kv_begin(const Streams& st, int q0, int off, int tile) {
  const long long first = (long long)q0 + off + st.lo;
  return first <= 0 ? 0 : static_cast<int>(first / tile * tile);
}

// One past the last key the query block [q0, q0 + rows) can see: the
// window's hi side, or the causal diagonal if it is lower; at most `end`.
__device__ __forceinline__ int band_kv_end(const Streams& st, int q0, int rows, int off,
                                           bool causal, int end) {
  const int hi = causal && st.hi > 0 ? 0 : st.hi;
  const long long stop = (long long)q0 + rows + off + hi;  // last + 1
  return stop <= 0 ? 0 : stop >= end ? end : static_cast<int>(stop);
}

// The transposed ranges (K4): the query rows a key block [kv0, kv0 + rows)
// is seen from, [first, last + 1), the first floored to a multiple of
// `tile` and both clipped to [0, Sq].
__device__ __forceinline__ int band_q_begin(const Streams& st, int kv0, int off, bool causal,
                                            int tile) {
  const int hi = causal && st.hi > 0 ? 0 : st.hi;
  const long long first = (long long)kv0 - off - hi;
  return first <= 0 ? 0 : static_cast<int>(first / tile * tile);
}

__device__ __forceinline__ int band_q_end(const Streams& st, int kv0, int rows, int off, int Sq) {
  const long long stop = (long long)kv0 + rows - off - st.lo;  // last + 1
  return stop <= 0 ? 0 : stop >= Sq ? Sq : static_cast<int>(stop);
}

// K2's per-token int8 quantization (ops/paged.py::_quant_token_write),
// shared with K3's fused decode: scale absmax / 127 (1 for an all-zero
// token), payload rintf(x / scale) clipped at +-127. IEEE division and
// round-half-even, so bit-exact with the plain version.
__device__ __forceinline__ float token_scale(float amax) {
  return amax == 0.f ? 1.f : amax / 127.f;
}
__device__ __forceinline__ int8_t quant_token_value(float x, float scale) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(x / scale), -127.f), 127.f));
}

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

// --- mma.sync m16n8k32 (8-bit in: s8 -> s32) -------------------------------
//
// Fragment layout (the same for s8 and e4m3, checked on the H100), lane =
// 4 * g + t4, four 8-bit values per register, lowest byte first: the A tile
// (16x32, row-major) gives a lane row g in a[0] and a[2], row g+8 in a[1]
// and a[3], columns 4*t4..4*t4+3 in a[0], a[1] and 16+4*t4.. in a[2], a[3];
// the B tile (32x8, column-major) column g, rows 4*t4.. in b0 and 16+4*t4..
// in b1; the accumulator as in m16n8k16 (rows g, g+8, columns 2*t4, 2*t4+1).
// K18's int8 Q.K (flash_experiments.cu) runs on it; the quantized
// forward's 8-bit products are wgmma (sm90.cuh, flash_quant_sm90.cu).

__device__ __forceinline__ void mma_s8_16832(int c[4], const uint32_t a[4], uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of rows r0..r0+15, 8-bit columns c0..c0+31 of a row-major
// shared tile with byte pitch LDB.
template <int LDB>
__device__ __forceinline__ void load_a_frag8(uint32_t a[4], const uint8_t* s, int r0, int c0,
                                             int g, int t4) {
  const uint8_t* p = s + (r0 + g) * LDB + c0 + t4 * 4;
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * LDB);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 16);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * LDB + 16);
}

// B operand = the transpose of rows n0..n0+7 of a row-major 8-bit shared
// tile, contraction over its columns c0..c0+31 (s = Q K^T reads K so).
template <int LDB>
__device__ __forceinline__ void b_frag8_t(uint32_t& b0, uint32_t& b1, const uint8_t* s, int n0,
                                          int c0, int g, int t4) {
  const uint8_t* p = s + (n0 + g) * LDB + c0 + t4 * 4;
  b0 = *reinterpret_cast<const uint32_t*>(p);
  b1 = *reinterpret_cast<const uint32_t*>(p + 16);
}

// Two neighbouring output values, rounded to the output type.
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
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

// rows x D fp32 from global into shared memory with row pitch LD; rows at
// or past `valid` and columns at or past `cols` (a head dim below the
// width D) are zero-filled.
template <int D, int LD, int NT>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              long long stride, int rows, int valid, int cols) {
  for (int i = threadIdx.x; i < rows * D; i += NT) {
    const int r = i / D, c = i % D;
    dst[r * LD + c] = r < valid && c < cols ? src[r * stride + c] : 0.f;
  }
}

// --- cp.async (sm_80+): 16-byte global -> shared copies, no registers ------
//
// A copy with valid == false reads nothing and zero-fills its 16 bytes
// (src-size 0); `src` must still be a mapped address.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows x D bf16 from global (row stride `stride` elements) into shared
// memory with row pitch LD by cp.async; rows at or past `valid` are
// zero-filled. The caller commits and waits.
template <int D, int LD, int NT>
__device__ __forceinline__ void load_tile_bf16_async(__nv_bfloat16* dst,
                                                     const __nv_bfloat16* src,
                                                     long long stride, int rows, int valid) {
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < rows * CH; i += NT) {
    const int r = i / CH, c = (i % CH) * 8;
    cp_async16(dst + r * LD + c, r < valid ? src + r * stride + c : src, r < valid);
  }
}
