// K6: full-quant flash attention (fp8 e4m3 or int8) for Hopper (sm_90a).
//
// Replaces the TPU kernel photonic_flash_attention_tpu/ops/flash_fp8.py::
// _flash_quant_kernel (pallas_call :259), behind ops/flash_fp8.py::
// flash_attention_quant (flash_attention_fp8 / flash_attention_int8), the
// engine's FLASH_FP8 kind.
//
// Contract: q (B, Sq, Hq, D), k/v (B, Skv, Hkv, D) 8-bit payloads, all
// int8 or all e4m3, contiguous; Q/K carry fp32 scales per 128-row block of
// each (b, head), given repeated per row: qs (B, Hq, Sq), ks (B, Hkv, Skv);
// V per-(b, kv head, column) scales vs (B, Hkv, D). GQA native: q head h
// reads kv head h / (Hq/Hkv) and its scales. D in {64, 128}; causal aligned
// to the sequence end; output (B, Sq, Hq, D) bf16 or fp32. The arithmetic
// is the TPU kernel's:
// * scores s = s_raw * (qs_row * sm_scale) * ks_col (a rank-1 dequant per
//   element), s_raw from mma.sync m16n8k32 s8*s8->s32 (int8) or e4m3*e4m3->
//   f32 (fp8, native on sm_90a: each e4m3 product is exact in fp32);
// * masked keys (past Skv, above the causal diagonal) score
//   DEFAULT_MASK_VALUE, not -inf, so a row with no valid key averages as in
//   the TPU kernel; the softmax runs in natural units (exp2f of differences
//   times log2 e);
// * after each 128-key block P = exp(s - m) is requantized against that
//   block's running max: int8 rint(p * 127) (half to even), fp8 (p * 448)
//   to e4m3 (round to nearest even, saturating); P.V runs on the same 8-bit
//   mma.sync (int32 sums for int8, fp32 for fp8), is scaled by vs / qmax per
//   column and added to the fp32 accumulator, acc = acc * alpha + pv;
// * o = acc * (1 / l).
// The plain version (ops/flash_fp8.py::flash_attention_block_quant_plain) walks
// the same 128-key blocks.
//
// What bounds it on the H100: both products at the 8-bit tensor-core rate
// (1,979 TOP/s dense, data sheet at 700 W); 8-bit payloads halve the bytes
// of bf16, which only matters at short sequences. Design: one block per (64
// query rows, head, batch), 4 warps of 16 rows, one 128-key K/V tile and its
// key scales in shared memory, scores in registers. The score accumulators
// are not 8-bit A fragments; V's rows are read in the order the fragments
// hold their keys (common.cuh: v_frag8), so P needs no shuffle. No wgmma,
// TMA or pipelining yet.

#include <cuda_fp8.h>

#include "common.cuh"

namespace {

constexpr int BQ = 64;       // query rows per block
constexpr int BKV = 128;     // keys per block: the P requant block
constexpr int THREADS = 128;  // 4 warps x 16 query rows

// QK8: 0 int8, 1 e4m3 (Q, K, V and P alike).
template <int D, int QK8, typename OutT>
__global__ void __launch_bounds__(THREADS)
flash_quant(const uint8_t* __restrict__ q, const uint8_t* __restrict__ k,
            const uint8_t* __restrict__ v, const float* __restrict__ qs,
            const float* __restrict__ ks, const float* __restrict__ vs, OutT* __restrict__ o,
            int Sq, int Skv, int Hq, int Hkv, float sm_scale, int causal) {
  constexpr int LDB = D + 16;  // byte pitch of 8-bit rows: conflict-free fragment loads
  constexpr int NT = BKV / 8;  // 8-wide score tiles per block
  constexpr int DT = D / 8;    // 8-wide output tiles
  constexpr int DK = D / 32;   // 32-deep k-steps over D
  constexpr float QMAX = QK8 == 0 ? 127.f : 448.f;
  extern __shared__ __align__(16) unsigned char smem[];
  uint8_t* Qs = smem;
  uint8_t* Ks = Qs + BQ * LDB;
  uint8_t* Vs = Ks + BKV * LDB;
  __shared__ float KSs[BKV];  // the tile's key scales
  __shared__ float VQ[D];     // vs / qmax per column

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const long long qstr = (long long)Hq * D, kvstr = (long long)Hkv * D;
  const long long kv_base = (long long)b * Skv * kvstr + (long long)hk * D;
  const float* qsr = qs + ((long long)b * Hq + h) * Sq;
  const float* ksr = ks + ((long long)b * Hkv + hk) * Skv;

  load_tile_u8<D, LDB, THREADS>(Qs, q + (long long)b * Sq * qstr + (long long)h * D + q0 * qstr,
                                qstr, BQ, Sq - q0);
  for (int i = threadIdx.x; i < D; i += THREADS) VQ[i] = vs[((long long)b * Hkv + hk) * D + i] / QMAX;
  __syncthreads();
  const int wr = warp * 16;
  uint32_t qf[DK][4];
#pragma unroll
  for (int kc = 0; kc < DK; ++kc) load_a_frag8<LDB>(qf[kc], Qs, wr, kc * 32, g, t4);

  float acc[DT][4];
#pragma unroll
  for (int dn = 0; dn < DT; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max, rows g, g+8
  float l[2] = {0.f, 0.f};              // this lane's share of the running sum
  const int off = Skv - Sq;
  const int rows[2] = {q0 + wr + g, q0 + wr + g + 8};
  float row_scale[2];  // qs_row * sm_scale
#pragma unroll
  for (int i = 0; i < 2; ++i) row_scale[i] = rows[i] < Sq ? qsr[rows[i]] * sm_scale : 0.f;
  const int kv_end = causal ? min(Skv, q0 + BQ + off) : Skv;

  for (int kv0 = 0; kv0 < kv_end; kv0 += BKV) {
    __syncthreads();  // the previous tile is consumed
    load_tile_u8<D, LDB, THREADS>(Ks, k + kv_base + kv0 * kvstr, kvstr, BKV, Skv - kv0);
    load_tile_u8<D, LDB, THREADS>(Vs, v + kv_base + kv0 * kvstr, kvstr, BKV, Skv - kv0);
    for (int i = threadIdx.x; i < BKV; i += THREADS) KSs[i] = kv0 + i < Skv ? ksr[kv0 + i] : 0.f;
    __syncthreads();

    float s[NT][4];
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      int ci[4] = {0, 0, 0, 0};
      float cf[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kc = 0; kc < DK; ++kc) {
        uint32_t b0, b1;
        b_frag8_t<LDB>(b0, b1, Ks, n * 8, kc * 32, g, t4);
        mma_8bit<QK8>(ci, cf, qf[kc], b0, b1);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + t4 * 2 + (e & 1), col = kv0 + c;
        const bool ok = col < Skv && (!causal || col <= rows[e >> 1] + off);
        const float raw = QK8 == 0 ? static_cast<float>(ci[e]) : cf[e];
        s[n][e] = ok ? raw * row_scale[e >> 1] * KSs[c] : MASK_VALUE;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);  // >= MASK_VALUE: finite
      alpha[i] = exp2f((m[i] - m_new) * LOG2E);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
    // P in [0, 1], summed unrounded, then requantized for P.V.
    auto p8 = [](float p) -> uint32_t {
      if (QK8 == 0) return static_cast<uint32_t>(__float2int_rn(p * QMAX));
      return __nv_cvt_float_to_fp8(p * QMAX, __NV_SATFINITE, __NV_E4M3);
    };
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f((s[n][e] - m[e >> 1]) * LOG2E);
        l[e >> 1] += s[n][e];
      }
    }
    uint32_t pa[BKV / 32][4];  // chunk c: keys 32c..32c+31 in v_frag8's order
#pragma unroll
    for (int c = 0; c < BKV / 32; ++c) {
      pa[c][0] = pack_bytes(p8(s[4 * c][0]), p8(s[4 * c][1]), p8(s[4 * c + 1][0]), p8(s[4 * c + 1][1]));
      pa[c][1] = pack_bytes(p8(s[4 * c][2]), p8(s[4 * c][3]), p8(s[4 * c + 1][2]), p8(s[4 * c + 1][3]));
      pa[c][2] = pack_bytes(p8(s[4 * c + 2][0]), p8(s[4 * c + 2][1]), p8(s[4 * c + 3][0]), p8(s[4 * c + 3][1]));
      pa[c][3] = pack_bytes(p8(s[4 * c + 2][2]), p8(s[4 * c + 2][3]), p8(s[4 * c + 3][2]), p8(s[4 * c + 3][3]));
    }
#pragma unroll
    for (int dn = 0; dn < DT; ++dn) {
      int pi[4] = {0, 0, 0, 0};
      float pf[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int c = 0; c < BKV / 32; ++c) {
        uint32_t b0, b1;
        v_frag8<LDB>(b0, b1, Vs, c * 32, dn * 8, g, t4);
        mma_8bit<QK8>(pi, pf, pa[c], b0, b1);
      }
      const int c0 = dn * 8 + t4 * 2;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float raw = QK8 == 0 ? static_cast<float>(pi[e]) : pf[e];
        acc[dn][e] = __fadd_rn(__fmul_rn(acc[dn][e], alpha[e >> 1]), __fmul_rn(raw, VQ[c0 + (e & 1)]));
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    if (rows[i] >= Sq) continue;
    const float inv = l[i] == 0.f ? 1.f : 1.f / l[i];
    OutT* orow = o + ((long long)b * Sq + rows[i]) * qstr + (long long)h * D;
#pragma unroll
    for (int dn = 0; dn < DT; ++dn) {
      const int c0 = dn * 8 + t4 * 2;
      store2(orow + c0, acc[dn][2 * i] * inv, acc[dn][2 * i + 1] * inv);
    }
  }
}

struct QuantArgs {
  const uint8_t *q, *k, *v;
  const float *qs, *ks, *vs;
  void* o;
  int Sq, Skv, Hq, Hkv;
  float sm_scale;
  int causal;
};

template <int D, int QK8, typename OutT>
cudaError_t run(const QuantArgs& a, dim3 grid, cudaStream_t st) {
  constexpr int smem = (BQ + 2 * BKV) * (D + 16);
  auto kernel = flash_quant<D, QK8, OutT>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, THREADS, smem, st>>>(a.q, a.k, a.v, a.qs, a.ks, a.vs, static_cast<OutT*>(a.o),
                                      a.Sq, a.Skv, a.Hq, a.Hkv, a.sm_scale, a.causal);
  return cudaGetLastError();
}

template <int QK8>
cudaError_t run_mode(const QuantArgs& a, int D, int out_dtype, dim3 grid, cudaStream_t st) {
  const bool bf = out_dtype == PFA_BF16;
  if (out_dtype != PFA_BF16 && out_dtype != PFA_F32) return cudaErrorInvalidValue;
  if (D == 64) return bf ? run<64, QK8, __nv_bfloat16>(a, grid, st) : run<64, QK8, float>(a, grid, st);
  if (D == 128) return bf ? run<128, QK8, __nv_bfloat16>(a, grid, st) : run<128, QK8, float>(a, grid, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// q (B, Sq, Hq, D), k/v (B, Skv, Hkv, D): int8 or e4m3 payloads (qdtype);
// qs (B, Hq, Sq), ks (B, Hkv, Skv), vs (B, Hkv, D) fp32 scales; o (B, Sq,
// Hq, D) bf16 or fp32 (out_dtype).
extern "C" int pfa_flash_quant(const void* q, const void* k, const void* v, const void* qs,
                               const void* ks, const void* vs, void* o, int B, int Sq, int Skv,
                               int Hq, int Hkv, int D, float sm_scale, int causal, int qdtype,
                               int out_dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  const QuantArgs a{static_cast<const uint8_t*>(q), static_cast<const uint8_t*>(k),
                    static_cast<const uint8_t*>(v), static_cast<const float*>(qs),
                    static_cast<const float*>(ks), static_cast<const float*>(vs), o,
                    Sq, Skv, Hq, Hkv, sm_scale, causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (qdtype == PFA_INT8) return run_mode<0>(a, D, out_dtype, grid, st);
  if (qdtype == PFA_E4M3) return run_mode<1>(a, D, out_dtype, grid, st);
  return cudaErrorInvalidValue;
}
