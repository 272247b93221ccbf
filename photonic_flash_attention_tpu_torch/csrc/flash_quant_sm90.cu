// K1's quantized modes (int8-QK, fp8-QK, int8-full) and K6 (fp8, int8
// full quantization) redesigned for Hopper (sm_90a): TMA loads, 8-bit
// wgmma products and warp specialisation, one kernel body templated on the
// mode.
//
// Replaces the TPU kernels photonic_flash_attention_tpu/ops/flash.py::
// _flash_fwd_kernel with scale_ref / pv_quant / vs_ref (ops/flash.py:79-83,
// 203-206, 356-362, 394-401, 422) and ops/flash_unrolled.py::_kernel's
// int8 Q.K, behind ops/flash.py::flash_attention_qk_quant; and ops/
// flash_fp8.py::_flash_quant_kernel (pallas_call :259), behind ops/
// flash_fp8.py::flash_attention_block_quant. It takes the place of the
// first mma.sync bodies (one 64-row block of 4 warps, one 128-key tile
// loaded synchronously), whose times PERF.md keeps.
//
// Contract (K1's and K6's entry points below; K18 int8's is at its entry):
// q (B, Sq, Hq, D), k/v (B, Skv, Hkv, D), contiguous, 16-byte-aligned
// bases, Hq % Hkv == 0 (GQA: q head h reads kv head h / (Hq / Hkv)), D a
// multiple of 16 up to 128 on the widths 64 and 128 (the tensor maps keep
// the real D innermost, so a box's columns past it arrive as zeros; the
// stores are strided and guarded by it; the wrapper pads other head dims
// into copies), causal aligned to the sequence end (row i sees keys j <= i
// + Skv - Sq), output (B, Sq, Hq, D) bf16 or fp32.
// * Q.K^T: int8 (s32 sums, exact) or e4m3 (f32 sums) payloads. K1's modes
//   scale the raw score by one fp32 device scalar (`score_scale` = qs * ks
//   * sm_scale, read on the device only, so a call stays graph-capturable);
//   K6 by a rank-1 dequant, s_raw * (qs_row * sm_scale) * ks_col, with qs
//   (B, Hq, Sq) and ks (B, Hkv, Skv) repeated per row.
// * Masked keys (above the causal diagonal, past Skv) score MASK_VALUE, not
//   -inf; the softmax runs in natural units (ex2 of differences times
//   log2 e), with the max over a block's 128 keys taken before the exp.
// * P.V: int8-QK and fp8-QK round P to bf16 against bf16 V (the TPU
//   kernel's p.astype(v.dtype)); int8-full exponentiates with log2(127)
//   folded in, truncates p + 0.5 to int8 and takes int8 V with per-(b, kv
//   head, column) scales applied at the store; K6 requantizes P as
//   rint(p * 127) (int8) or e4m3(p * 448) and scales P.V by vs / qmax per
//   column (once, at the store: hazard 4). The 8-bit P.V sums a 128-key
//   block in its own accumulator, and O takes it as acc * alpha + pv,
//   rounded as written (no FMA), as the plain versions do (ops/flash.py::
//   quant_blocks_plain).
// * P is requantized against the running max after each 128-key block, so
//   the result depends on the block: every mode walks exactly 128-key
//   blocks at D 64 and 128 (QUANT_BLOCK_KV).
//
// What bounds it on the H100: at D 64 and 128 over S ~ 1k-4k both products
// do far more operations per loaded byte than the ridge, so the limit is
// the tensor cores (1,979 TOP/s for 8-bit operands, 989 TFLOP/s for the
// bf16 P.V; data sheet at 700 W) and, beside them, the softmax's MUFU
// stream: at twice the bf16 rate a 128 x 128 tile of 8-bit products takes
// about as long as its 16,384 ex2 at 16 a clock an SM. The design follows
// K1's bf16 body (flash_fwd_sm90.cu), after FlashAttention-3's FP8 path:
// * A CTA is three warpgroups: two consumers of 64 query rows each (128
//   rows a work tile) and one producer. The producer's first warp issues
//   every load by TMA into an mbarrier ring (Q double-buffered; K, V and
//   K6's key scales a stage); setmaxnreg moves registers to the consumers.
// * S = Q K^T runs on wgmma m64n128k32 (.s32.s8.s8 or .f32.e4m3.e4m3), both
//   operands K-major in shared memory. The bf16-V modes run O += P V on
//   wgmma m64nDk16 with P from registers and V MN-major (the transpose
//   bit), as K1; the 8-bit P.V on wgmma m64nDk32 with P from registers and
//   V^T from shared memory.
// * Tile j's Q K^T is issued ahead of tile j-1's P V (OVERLAP; not in K6,
//   hazard 4), the two consumer warpgroups take turns at the tensor cores
//   (ping-pong, named barriers), the per-score predicate runs only on
//   diagonal and ragged tiles, and the grid is persistent (one CTA a SM,
//   snake order, causal query blocks longest first).
// Hazards, and what the design does about each:
// 1. 8-bit wgmma takes K-major operands only. Q and K are D-contiguous,
//    which is K-major for Q K^T; V is D-contiguous in HBM, which is
//    MN-major for P V. The 8-bit P.V modes transpose V in shared memory:
//    TMA lands the V tile, producer warps 1-3 rewrite it as V^T (D rows of
//    128 keys, 128-byte swizzle) into a double buffer the consumers read
//    (transpose_v: 4-byte loads, a 4 x 4 byte transpose by prmt, 4-byte
//    stores, no bank conflict on the stores). No extra pass over HBM.
// 2. P's register layout: the accumulator holds columns {8j + 2t, 8j + 2t
//    + 1} in a thread, the A fragment of m64nNk32 wants k in {4t .. 4t + 3,
//    16 + 4t ..}. The transpose writes V's keys in the accumulator's order
//    (a 32-key chunk's slots hold keys in v_word_key's order), so P packs
//    into A fragments with no shuffle: the transpose has to run anyway, and
//    the permutation costs it nothing.
// 3. Swizzle: an 8-bit row of D 64 is 64 bytes, so D 64 takes the 64-byte
//    swizzle in the tensor maps of Q, K and V and in the descriptor
//    (sw64_desc); D 128 (and V^T's 128-key rows) the 128-byte one.
// 4. Registers: S is 64 a thread, O D / 2, an 8-bit P 16, the 8-bit P.V's
//    block accumulator D / 2. Overlapping tile j's Q K^T with tile j-1's
//    8-bit P V at D 128 holds S, P, the block sum and O at once (208 +
//    addresses): int8-full fits in the consumers' 232 without a spill.
//    K6 with its per-column vs / qmax in registers spilled 120-128 bytes,
//    so K6 keeps O in units of V's payload (O' = O / (vs / qmax) per
//    column: acc' * alpha + pv) and scales it once at the store, as
//    int8-full applies its vs; with its row and key scales it still
//    spilled 8 bytes at D 128, and at D 64 the overlap gained K6 int8
//    nothing and cost K6 fp8 10 % (PERF.md's A/B): K6 runs without it.
// 5. Scales on the card: K6's per-key ks are staged a tile at a time beside
//    K by 4-byte cp.async tied to the stage's "full" barrier
//    (cp.async.mbarrier.arrive), and the stage is freed only after the
//    softmax has read them; its per-row qs are read once a work tile into
//    registers, its per-column vs / qmax at the store.
// 6. The e4m3 wgmma's sums are not fp32: measured on the H100, K6 fp8's
//    output moved 3.3e-3 (rel_err_norm, fp32 output) from its plain version
//    with Q.K^T on .e4m3, which a model of sums that keep ~14 bits below the
//    largest product reproduces (3.2e-3): the score errors move K6's coarse
//    e4m3 requantization of P. So K6 fp8's Q.K^T runs on f16 wgmma
//    (m64n128k16) over Q and K widened exactly from e4m3 in shared memory
//    (widen_e4m3, by the producer warps that transpose V: products exact,
//    sums in fp32), and only its P.V on .e4m3 (the same model moves the
//    output 1e-4 there). fp8-QK keeps its .e4m3 Q.K^T: its bf16 P does not
//    amplify the score errors (within 2e-3 of its plain version at fp32).
//
// K18's int8-QK mode (one launch per q row-block: benchmarks/
// flash_pipeline_experiment.py::_kernel_tri_i8 :548) with a bf16 V is the
// int8-QK body, flash_quant_sm90<D, INT8QK, true> (ROWBLOCK): a launch
// takes the query rows [row0, row_end) of every (b, h) of a square S
// (Params::row0, row_end), its work tiles the range's 128-row blocks x Hq x
// B on the persistent grid, the last (longest, causal) first, each walking
// the 128-key tiles up to its diagonal (col <= row: the end-aligned
// diagonal of Sq = Skv) or, not causal, all of S. row0 may be any row:
// Q's TMA box starts there, and the rows of the last work tile past the
// range end are computed and not stored (rows past S are TMA's zero fill);
// the launch that owns them writes them. The launches of one call read
// the same inputs and write disjoint rows, so each after the first is a
// programmatic dependent launch (`chained`, as K20's on K5's body): a CTA
// lets the next launch start at once (griddepcontrol.launch_dependents)
// and its producer warp 0 waits, once it has issued its last load, for the
// launch ahead to complete (griddepcontrol.wait; a wait in the consumers'
// code made K21's spill), so no launch completes before the one ahead of
// it. A call's first launch is a plain one, ordered after the quantization
// passes before it. Only these two instantiations hold the range and the
// griddepcontrol instructions (if constexpr), so K1's and K6's ten keep
// their code. K18's int8 mode with an fp32 V stays on the mma.sync body of
// flash_experiments.cu.

#include <cuda_fp8.h>
#include <limits.h>
#include <string.h>

#include <type_traits>

#include "sm90.cuh"

namespace {

// The kernel's modes: Q.K^T in int8 or e4m3; P.V in bf16 (INT8QK, FP8QK)
// or 8-bit (INT8FULL, K6_INT8, K6_FP8); the score scale a device scalar
// (K1) or rank-1 (K6).
enum QuantMode { INT8QK = 0, FP8QK = 1, INT8FULL = 2, K6_INT8 = 3, K6_FP8 = 4 };
__host__ __device__ constexpr bool qk_e4m3(int m) { return m == FP8QK || m == K6_FP8; }
__host__ __device__ constexpr bool pv_8bit(int m) { return m >= INT8FULL; }
__host__ __device__ constexpr bool rank1(int m) { return m >= K6_INT8; }
__host__ __device__ constexpr bool qk_f16(int m) { return m == K6_FP8; }  // hazard 6

constexpr int BQ = 128;        // query rows a CTA: CONSUMERS warpgroups x 64
constexpr int BKV = 128;       // keys a tile: the P requant block
constexpr int CONSUMERS = 2;   // consumer warpgroups
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int TRANSPOSERS = 3;  // producer warps 1-3 transpose V (8-bit P.V)
constexpr float LOG2_127 = 6.988684686772166f;  // int8-full's folded P scale
// Two levers of the A/B measurements (the third is Cfg::OVERLAP): the
// consumers' turns at the tensor cores, and one CTA a SM walking the work
// tiles (else one CTA a work tile).
constexpr bool PINGPONG = true;
constexpr bool PERSISTENT = true;

template <int D, int MODE>
struct Cfg {
  static constexpr bool PV8 = pv_8bit(MODE);
  // The transposing producer warps need more than 24 registers: 40 + 2 x
  // 232 = 24 + 2 x 240 = 504 of the 512 a thread of three warpgroups.
  static constexpr int PRODUCER_REGS = PV8 ? 40 : 24;
  static constexpr int CONSUMER_REGS = PV8 ? 232 : 240;
  // Tile j's Q.K^T over tile j-1's P.V: not for K6 (hazard 4).
  static constexpr bool OVERLAP = !rank1(MODE);
  static constexpr int Q_BYTES = BQ * D;                // 8-bit, both warpgroups
  static constexpr int K_BYTES = BKV * D;
  static constexpr int V_BYTES = BKV * D * (PV8 ? 1 : 2);
  static constexpr int KS_BYTES = rank1(MODE) ? BKV * 4 : 0;
  static constexpr int VT_BYTES = PV8 ? D * BKV : 0;  // one V^T buffer (two)
  static constexpr bool QK16 = qk_f16(MODE);
  static constexpr int Q16_BYTES = QK16 ? BQ * D * 2 : 0;   // Q widened to f16 (one)
  static constexpr int K16_BYTES = QK16 ? BKV * D * 2 : 0;  // K widened to f16 (two)
  static constexpr int FIXED = 2 * Q_BYTES + 2 * VT_BYTES + Q16_BYTES + 2 * K16_BYTES + 8 * 12 + 1024;
  static constexpr int PER_STAGE = K_BYTES + V_BYTES + KS_BYTES + 16;
  static constexpr int STAGES = FIXED + 4 * PER_STAGE <= SMEM_MAX   ? 4
                                : FIXED + 3 * PER_STAGE <= SMEM_MAX ? 3
                                                                    : 2;
  static constexpr int OFF_K = 2 * Q_BYTES;  // every buffer offset a multiple of 1024
  static constexpr int OFF_V = OFF_K + STAGES * K_BYTES;
  static constexpr int OFF_VT = OFF_V + STAGES * V_BYTES;
  static constexpr int OFF_Q16 = OFF_VT + 2 * VT_BYTES;
  static constexpr int OFF_K16 = OFF_Q16 + Q16_BYTES;
  static constexpr int OFF_KS = OFF_K16 + 2 * K16_BYTES;
  static constexpr int OFF_BAR = OFF_KS + STAGES * KS_BYTES;
  static constexpr int SMEM = OFF_BAR + 8 * (2 * STAGES + 12) + 1024;  // + alignment slack
  static_assert(SMEM <= SMEM_MAX, "shared memory");
};

struct Params {
  void* o;
  const float* score_scale;        // K1's modes: one fp32 on the device
  const float *qs, *ks, *vs;       // K6: qs, ks, vs; int8-full: vs
  int B, Sq, Skv, Hq, Hkv;
  int n_work;                      // work tiles: query blocks x Hq x B
  float sm_scale;                  // K6
  int causal, out_f32;
  int row0, row_end;               // ROWBLOCK (K18 int8): the launch's query rows
  int d;                           // the real head dim: o's and vs's pitch (D: the width)
};

// Shared-memory descriptor of a K-major 8-bit operand with rows of D bytes.
template <int D>
__device__ __forceinline__ uint64_t desc8(uint32_t addr) {
  return D == 128 ? sw128_desc(addr, 16) : sw64_desc(addr);
}

// An exact int32 (|x| < 2^22: a Q.K or a block's P.V sum of 8-bit values
// at D <= 128 and 128 keys) as fp32, by the 1.5 x 2^23 bias: one integer
// and one float add instead of I2F.
__device__ __forceinline__ float exact_f32(uint32_t x) {
  return __int_as_float(static_cast<int>(x) + 0x4B400000) - 12582912.f;
}
__device__ __forceinline__ float exact_f32(float x) { return x; }

// Byte offset of element (key, c) of a TMA-staged 8-bit V tile: rows of D
// bytes, 16-byte chunks swizzled by the key (128-byte swizzle at D 128,
// 64-byte at D 64).
template <int D>
__device__ __forceinline__ int v_offset(int key, int c) {
  const int chunk = D == 128 ? (c >> 4) ^ (key & 7) : (c >> 4) ^ ((key >> 1) & 3);
  return key * D + (chunk << 4) + (c & 15);
}

// Hazard 2: slot s of a 32-key chunk of V^T holds key (s & 16) | ((s & 2)
// << 2) | (((s >> 2) & 3) << 1) | (s & 1), the key the accumulator's
// thread t holds in its A fragment's byte s. A 4-slot word w (slots 4 w ..
// 4 w + 3) so holds keys v_word_key(w) + {0, 1, 8, 9}.
__device__ __forceinline__ int v_word_key(int w) {
  return 32 * (w >> 3) + 16 * ((w >> 2) & 1) + 2 * (w & 3);
}

// Hazard 1: V (BKV keys x D, TMA-staged) to V^T (D rows x BKV key slots,
// 128-byte swizzle, keys in the slots' order) by producer warp `tw` of
// TRANSPOSERS. A lane takes 4 columns x 4 keys a step: four 4-byte loads,
// a 4 x 4 byte transpose (prmt), four 4-byte stores; the lanes of a warp
// take 16 slot words x 2 column groups, so the stores hit 32 banks.
template <int D>
__device__ __forceinline__ void transpose_v(const unsigned char* v, unsigned char* vt, int tw,
                                            int lane) {
#pragma unroll 1
  for (int item = tw; item < D / 4; item += TRANSPOSERS) {
    const int w = (item & 1) * 16 + (lane & 15), c = 4 * ((item >> 1) * 2 + (lane >> 4));
    const int key = v_word_key(w);
    const uint32_t x0 = *reinterpret_cast<const uint32_t*>(v + v_offset<D>(key, c));
    const uint32_t x1 = *reinterpret_cast<const uint32_t*>(v + v_offset<D>(key + 1, c));
    const uint32_t x2 = *reinterpret_cast<const uint32_t*>(v + v_offset<D>(key + 8, c));
    const uint32_t x3 = *reinterpret_cast<const uint32_t*>(v + v_offset<D>(key + 9, c));
    const uint32_t lo01 = __byte_perm(x0, x1, 0x5140), hi01 = __byte_perm(x0, x1, 0x7362);
    const uint32_t lo23 = __byte_perm(x2, x3, 0x5140), hi23 = __byte_perm(x2, x3, 0x7362);
    const uint32_t out[4] = {__byte_perm(lo01, lo23, 0x5410), __byte_perm(lo01, lo23, 0x7632),
                             __byte_perm(hi01, hi23, 0x5410), __byte_perm(hi01, hi23, 0x7632)};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int d = c + i;
      *reinterpret_cast<uint32_t*>(vt + d * 128 + ((((w >> 2) ^ (d & 7)) << 4) | (4 * (w & 3)))) =
          out[i];
    }
  }
}

// Hazard 6: an e4m3 tile (128 rows x D, TMA-staged as in v_offset) widened
// exactly to f16 in K1's bf16 layout (64-column boxes of 128 rows, 128-byte
// swizzle) by producer warp `tw` of TRANSPOSERS: 8 values a lane a step
// (one 8-byte load, four cvt, one 16-byte store), consecutive lanes on
// consecutive rows.
template <int D>
__device__ __forceinline__ void widen_e4m3(const unsigned char* src, unsigned char* dst, int tw,
                                           int lane) {
#pragma unroll 1
  for (int u = tw * 32 + lane; u < 128 * D / 8; u += TRANSPOSERS * 32) {
    const int row = u % 128, c = 8 * (u / 128);
    const uint2 x = *reinterpret_cast<const uint2*>(src + v_offset<D>(row, c));
    const uint4 y = make_uint4(e4m3x2_to_f16x2(x.x), e4m3x2_to_f16x2(x.x >> 16),
                               e4m3x2_to_f16x2(x.y), e4m3x2_to_f16x2(x.y >> 16));
    *reinterpret_cast<uint4*>(dst + (c >> 6) * (128 * 128) + row * 128 +
                              ((((c & 63) >> 3) ^ (row & 7)) << 4)) = y;
  }
}

// Four P values (the A fragment's bytes, lowest first) as 8-bit payloads:
// int8-full min(trunc(p + 0.5), 127) of p in [0, 127]; K6 int8 rint(p *
// 127) (half to even); K6 fp8 e4m3(p * 448), round to nearest even,
// saturating. The int8 ones take no F2I (a quarter-rate conversion that
// would double the exp's pipe): adding 1.5 x 2^23 rounds to an integer in
// the sum's low byte, toward zero (trunc) or to nearest even (rint). Both
// clamp first: p at the row max may exceed 1 (or 127) by the exp
// argument's rounding.
template <int MODE>
__device__ __forceinline__ uint32_t p_bytes(float a, float b, float c, float d) {
  if constexpr (MODE == K6_FP8) {
    const uint32_t lo = __nv_cvt_float2_to_fp8x2(make_float2(a * 448.f, b * 448.f), __NV_SATFINITE,
                                                 __NV_E4M3);
    const uint32_t hi = __nv_cvt_float2_to_fp8x2(make_float2(c * 448.f, d * 448.f), __NV_SATFINITE,
                                                 __NV_E4M3);
    return lo | (hi << 16);
  } else {
    auto q = [](float p) {
      return __float_as_uint(MODE == INT8FULL
                                 ? __fadd_rz(fminf(__fadd_rn(p, 0.5f), 127.5f), 12582912.f)
                                 : __fadd_rn(fminf(__fmul_rn(p, 127.f), 127.f), 12582912.f));
    };
    return __byte_perm(__byte_perm(q(a), q(b), 0x0040), __byte_perm(q(c), q(d), 0x0040), 0x5410);
  }
}

// One work tile: 128 query rows of one (batch row, head) and the 128-key
// tiles its rows can see.
struct Work {
  int h, b, q0, n_tiles;
};

// Work tile t: heads fastest, then batch rows, then query blocks, the
// longest (last) causal block first. ROWBLOCK (K18 int8): the query blocks
// of the rows from row0.
template <bool ROWBLOCK>
__device__ __forceinline__ Work work_tile(const Params& p, int t) {
  Work w;
  const int nqb = ROWBLOCK ? (p.row_end - p.row0 + BQ - 1) / BQ : (p.Sq + BQ - 1) / BQ;
  w.h = t % p.Hq;
  const int r = t / p.Hq;
  w.b = r % p.B;
  const int i = r / p.B;
  w.q0 = (p.causal ? nqb - 1 - i : i) * BQ;
  if constexpr (ROWBLOCK) w.q0 += p.row0;
  const int kv_end = p.causal ? min(p.Skv, w.q0 + BQ + p.Skv - p.Sq) : p.Skv;
  w.n_tiles = (kv_end + BKV - 1) / BKV;
  return w;
}

// The n-th work tile of this CTA.
__device__ __forceinline__ int nth_tile(int n) {
  return PERSISTENT ? snake_tile(n) : n == 0 ? static_cast<int>(blockIdx.x) : INT_MAX;
}

// S accumulator: s32 (int8 Q.K) or f32 (e4m3); the 8-bit P.V's block
// accumulator likewise.
template <int MODE>
using SAcc = typename std::conditional<qk_e4m3(MODE), float, uint32_t>::type;

// One tile's scores in natural units, in place in sc: the raw sums
// dequantized, masked keys at MASK_VALUE (MASKED: the per-score predicate);
// mx gets this thread's row maxima.
template <int MODE, bool MASKED, typename A>
__device__ __forceinline__ void tile_scores(float (&sc)[64], const A (&acc)[64], float (&mx)[2],
                                            const Params& p, const float* ks, float qk_scale,
                                            const float (&row_scale)[2], int kv0, int row0, int t4,
                                            int off) {
#pragma unroll
  for (int j = 0; j < BKV / 8; ++j) {
    const int c = 8 * j + 2 * t4;
    float2 kc = make_float2(0.f, 0.f);
    if constexpr (rank1(MODE)) kc = *reinterpret_cast<const float2*>(ks + c);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * rr + e;
        float x = exact_f32(acc[i]);
        x = rank1(MODE) ? x * row_scale[rr] * (e ? kc.y : kc.x) : x * qk_scale;
        if constexpr (MASKED) {
          const int col = kv0 + c + e;
          if (!(col < p.Skv && (!p.causal || col <= row0 + 8 * rr + off))) x = MASK_VALUE;
        }
        sc[i] = x;
        mx[rr] = fmaxf(mx[rr], x);
      }
    }
  }
}

// Persistent: gridDim.x CTAs (one a SM) walk the work tiles in snake order;
// the ring's phases run on across work tiles. ROWBLOCK: K18 int8's
// instantiation (the query range, the chained launches).
template <int D, int MODE, bool ROWBLOCK = false>
__global__ void __launch_bounds__(THREADS, 1)
flash_quant_sm90(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, const Params p) {
  using C = Cfg<D, MODE>;
  constexpr int STAGES = C::STAGES;
  constexpr bool PV8 = C::PV8;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms need 1024-byte alignment
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bar_full = base + C::OFF_BAR, bar_empty = bar_full + 8 * STAGES;
  const uint32_t bar_qfull = bar_empty + 8 * STAGES, bar_qempty = bar_qfull + 16;
  // vtfull: V^T (and, QK16, K widened) ready; k16empty: QK16's widened K
  // free; q16full/q16empty: QK16's widened Q (one buffer).
  const uint32_t bar_vtfull = bar_qempty + 16, bar_vtempty = bar_vtfull + 16;
  const uint32_t bar_k16empty = bar_vtempty + 16, bar_q16full = bar_k16empty + 16;
  const uint32_t bar_q16empty = bar_q16full + 8;
  const int n_work = p.n_work, off = p.Skv - p.Sq;
  if constexpr (ROWBLOCK) pdl_launch_dependents();

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      // A stage is free once every consumer warp is done with its K (and
      // its bf16 V) and, for an 8-bit V, every transposing warp with V.
      mbar_init(bar_empty + 8 * s, CONSUMERS * 4 + (PV8 ? TRANSPOSERS : 0));
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(bar_qfull + 8 * s, 1);
      mbar_init(bar_qempty + 8 * s, C::QK16 ? TRANSPOSERS : CONSUMERS * 4);  // who reads Q8
      mbar_init(bar_vtfull + 8 * s, TRANSPOSERS);
      mbar_init(bar_vtempty + 8 * s, CONSUMERS * 4);
      mbar_init(bar_k16empty + 8 * s, CONSUMERS * 4);
    }
    mbar_init(bar_q16full, TRANSPOSERS);
    mbar_init(bar_q16empty, CONSUMERS * 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Warp-uniform in the compiler's eyes (a shuffled value), so that ptxas
  // sees the roles' branches and the wgmma in them as uniform.
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int warp = __shfl_sync(0xffffffffu, (threadIdx.x / 32) % 4, 0), lane = threadIdx.x % 32;
  if (wg == CONSUMERS) {
    setmaxnreg_dec<C::PRODUCER_REGS>();
    if (warp == 0) {
      // --- producer warp 0: every load, by TMA (K6's key scales by cp.async)
      int it = 0;  // key tiles loaded so far, over all work tiles
      for (int n = 0; n * (int)gridDim.x < n_work; ++n) {
        const int t = nth_tile(n);
        if (t >= n_work) continue;
        const Work w = work_tile<ROWBLOCK>(p, t);
        const int hk = w.h / (p.Hq / p.Hkv);
        const uint32_t qf = bar_qfull + 8 * (n & 1);
        mbar_wait(bar_qempty + 8 * (n & 1), ((n >> 1) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(qf, C::Q_BYTES);
          tma_load_4d(base + (n & 1) * C::Q_BYTES, &tm_q, qf, 0, w.h, w.q0, w.b);
        }
        for (int j = 0; j < w.n_tiles; ++j, ++it) {
          const int s = it % STAGES, kv0 = j * BKV;
          const uint32_t full = bar_full + 8 * s;
          mbar_wait(bar_empty + 8 * s, ((it / STAGES) & 1) ^ 1);
          if constexpr (rank1(MODE)) {
            const float* row = p.ks + ((long long)w.b * p.Hkv + hk) * p.Skv;
            const uint32_t dst = base + C::OFF_KS + s * C::KS_BYTES;
            for (int i = lane; i < BKV; i += 32) {
              const bool ok = kv0 + i < p.Skv;
              cp_async4(dst + 4 * i, ok ? row + kv0 + i : row, ok);
            }
            cp_async_mbar_arrive(full);
          }
          __syncwarp();
          if (lane == 0) {
            mbar_expect_tx(full, C::K_BYTES + C::V_BYTES);
            tma_load_4d(base + C::OFF_K + s * C::K_BYTES, &tm_k, full, 0, hk, kv0, w.b);
            if constexpr (PV8) {
              tma_load_4d(base + C::OFF_V + s * C::V_BYTES, &tm_v, full, 0, hk, kv0, w.b);
            } else {
              for (int hf = 0; hf < D / 64; ++hf)
                tma_load_4d(base + C::OFF_V + s * C::V_BYTES + hf * BKV * 128, &tm_v, full, hf * 64,
                            hk, kv0, w.b);
            }
          }
        }
      }
      // K18 int8: the CTA does not exit before the launch ahead of it has.
      if constexpr (ROWBLOCK) pdl_wait();
    } else if constexpr (PV8) {
      // --- producer warps 1-3: V to V^T for the 8-bit P.V (hazards 1, 2);
      // QK16: Q and K widened to f16 (hazard 6) ---------------------------
      int it = 0;
      for (int n = 0; n * (int)gridDim.x < n_work; ++n) {
        const int t = nth_tile(n);
        if (t >= n_work) continue;
        const int n_tiles = work_tile<ROWBLOCK>(p, t).n_tiles;
        if constexpr (C::QK16) {
          mbar_wait(bar_qfull + 8 * (n & 1), (n >> 1) & 1);
          mbar_wait(bar_q16empty, (n & 1) ^ 1);
          widen_e4m3<D>(smem + (n & 1) * C::Q_BYTES, smem + C::OFF_Q16, warp - 1, lane);
          fence_proxy_async();
          __syncwarp();
          if (lane == 0) {
            mbar_arrive(bar_q16full);
            mbar_arrive(bar_qempty + 8 * (n & 1));
          }
        }
        for (int j = 0; j < n_tiles; ++j, ++it) {
          const int s = it % STAGES, vb = it & 1;
          mbar_wait(bar_full + 8 * s, (it / STAGES) & 1);
          mbar_wait(bar_vtempty + 8 * vb, ((it >> 1) & 1) ^ 1);
          transpose_v<D>(smem + C::OFF_V + s * C::V_BYTES, smem + C::OFF_VT + vb * C::VT_BYTES,
                         warp - 1, lane);
          if constexpr (C::QK16) {
            mbar_wait(bar_k16empty + 8 * vb, ((it >> 1) & 1) ^ 1);
            widen_e4m3<D>(smem + C::OFF_K + s * C::K_BYTES, smem + C::OFF_K16 + vb * C::K16_BYTES,
                          warp - 1, lane);
          }
          fence_proxy_async();  // the stores before the consumers' wgmma reads
          __syncwarp();
          if (lane == 0) {
            mbar_arrive(bar_vtfull + 8 * vb);
            mbar_arrive(bar_empty + 8 * s);
          }
        }
      }
    }
  } else {
    // --- consumers: 64 query rows each -------------------------------------
    setmaxnreg_inc<C::CONSUMER_REGS>();
    constexpr int NO = D / 2;  // O's floats a thread
    const int g = lane / 4, t4 = lane % 4;
    const float qk_scale = rank1(MODE) ? 0.f : *p.score_scale;
    constexpr float SHIFT = MODE == INT8FULL ? LOG2_127 : 0.f;
    // Ping-pong: warpgroup 0 takes the first turn of a work tile; the last
    // turn of warpgroup 1 hands nothing on, so every wait has its arrival.
    auto turn_begin = [&] {
      if (PINGPONG) named_bar_sync(1 + wg, 2 * 128);
    };
    auto turn_end = [&](bool last) {
      if (PINGPONG && (wg == 0 || !last)) named_bar_arrive(2 - wg, 2 * 128);
    };
    auto release = [&](uint32_t bar) {  // this warp is done with what `bar` guards
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    SAcc<MODE> sacc[64];
    float sc[64], o_acc[NO];
    SAcc<MODE> pv[NO];       // an 8-bit P.V block's sum (unused with a bf16 V)
    uint32_t pa[BKV / 16][4];  // P as A fragments: bf16 (8 k16 steps) or 8-bit (the first 4, k32)
    int it = 0;  // key tiles consumed so far, over all work tiles
    for (int n = 0; n * (int)gridDim.x < n_work; ++n) {
      const int t = nth_tile(n);
      if (t >= n_work) continue;
      const Work w = work_tile<ROWBLOCK>(p, t);
      const int q0 = w.q0, n_tiles = w.n_tiles, hk = w.h / (p.Hq / p.Hkv);
      const int wrow = q0 + wg * 64;          // the warpgroup's first row
      const int row0 = wrow + warp * 16 + g;  // this thread's rows: row0, row0 + 8
      const uint32_t q_base = base + (n & 1) * C::Q_BYTES + wg * 64 * D;
      float row_scale[2] = {0.f, 0.f};
      if constexpr (rank1(MODE)) {
        const float* qs = p.qs + ((long long)w.b * p.Hq + w.h) * p.Sq;
#pragma unroll
        for (int i = 0; i < 2; ++i)
          row_scale[i] = row0 + 8 * i < p.Sq ? qs[row0 + 8 * i] * p.sm_scale : 0.f;
      }
#pragma unroll
      for (int i = 0; i < NO; ++i) o_acc[i] = 0.f;
      float m[2] = {-INFINITY, -INFINITY};  // running max, natural units
      float l[2] = {0.f, 0.f};              // this thread's share of the running sum
      if constexpr (C::QK16) mbar_wait(bar_q16full, n & 1);
      else mbar_wait(bar_qfull + 8 * (n & 1), (n >> 1) & 1);
      if (PINGPONG && wg == 1 && n_tiles > 0) named_bar_arrive(1, 2 * 128);

      auto wait_kv = [&](int k) {  // QK16: K widened too
        mbar_wait(bar_full + 8 * (k % STAGES), (k / STAGES) & 1);
        if constexpr (C::QK16) mbar_wait(bar_vtfull + 8 * (k & 1), (k >> 1) & 1);
      };
      auto wait_vt = [&](int k) {
        if constexpr (PV8) mbar_wait(bar_vtfull + 8 * (k & 1), (k >> 1) & 1);
      };
      auto issue_qk = [&](int k) {
        if constexpr (C::QK16) {  // f16, K1's layout: 64-column boxes of 128 rows
          const uint32_t q16 = base + C::OFF_Q16 + wg * 64 * 128;
          const uint32_t k16 = base + C::OFF_K16 + (k & 1) * C::K16_BYTES;
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            const uint32_t o = (kk / 4) * (128 * 128) + (kk % 4) * 32;
            if (kk == 0) wgmma_ss_f16_n128_init(sacc, sw128_desc(q16, 16), sw128_desc(k16, 16));
            else wgmma_ss_f16_n128(sacc, sw128_desc(q16 + o, 16), sw128_desc(k16 + o, 16));
          }
        } else {
          const uint32_t k_base = base + C::OFF_K + (k % STAGES) * C::K_BYTES;
#pragma unroll
          for (int kk = 0; kk < D / 32; ++kk) {
            if (kk == 0) wgmma_ss_k32<0>(sacc, desc8<D>(q_base), desc8<D>(k_base));
            else wgmma_ss_k32<1>(sacc, desc8<D>(q_base + kk * 32), desc8<D>(k_base + kk * 32));
          }
        }
        wgmma_commit();
      };
      auto issue_pv = [&](int k) {
        if constexpr (PV8) {
          const uint32_t vt_base = base + C::OFF_VT + (k & 1) * C::VT_BYTES;
          wgmma_rs_k32<0>(pv, pa[0], sw128_desc(vt_base, 16));
#pragma unroll
          for (int c = 1; c < 4; ++c) wgmma_rs_k32<1>(pv, pa[c], sw128_desc(vt_base + c * 32, 16));
        } else {
          const uint32_t v_base = base + C::OFF_V + (k % STAGES) * C::V_BYTES;
#pragma unroll
          for (int kk = 0; kk < BKV / 16; ++kk)
            wgmma_rs<D>(o_acc, pa[kk], sw128_desc(v_base + kk * 16 * 128, BKV * 128));
        }
        wgmma_commit();
      };
      // Q.K^T is done with K: QK16 frees the widened K.
      auto release_qk = [&](int k) {
        if constexpr (C::QK16) release(bar_k16empty + 8 * (k & 1));
      };
      // The softmax is done with the stage (its K and K6's key scales): for
      // an 8-bit V the stage waits on the transposers too; a bf16 V stays
      // until its P.V is done.
      auto release_stage = [&](int k) {
        if constexpr (PV8) release(bar_empty + 8 * (k % STAGES));
      };
      auto release_pv = [&](int k) {
        release(PV8 ? bar_vtempty + 8 * (k & 1) : bar_empty + 8 * (k % STAGES));
      };
      // Tile k's online softmax: sc gets P, m and l move on, alpha the
      // factors that bring O to the new max.
      auto softmax = [&](int k, int j, float (&alpha)[2]) {
        const int kv0 = j * BKV;
        const bool masked = kv0 + BKV > p.Skv || (p.causal && kv0 + BKV - 1 > wrow + off);
        const float* ks = reinterpret_cast<const float*>(smem + C::OFF_KS + (k % STAGES) * C::KS_BYTES);
        float mx[2] = {-INFINITY, -INFINITY}, nb[2];
        if (masked)
          tile_scores<MODE, true>(sc, sacc, mx, p, ks, qk_scale, row_scale, kv0, row0, t4, off);
        else
          tile_scores<MODE, false>(sc, sacc, mx, p, ks, qk_scale, row_scale, kv0, row0, t4, off);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
          const float m_new = fmaxf(m[i], mx[i]);  // >= MASK_VALUE: finite
          alpha[i] = ex2((m[i] - m_new) * LOG2E);
          m[i] = m_new;
          l[i] *= alpha[i];
          nb[i] = SHIFT - m_new * LOG2E;
        }
        // p = exp(s - m) (int8-full: times 127), one FFMA and one ex2 a
        // score; a masked score's s log2 e overflows to -inf, so its p is 0
        // (m is a real score's: every row sees key 0 of its first tile).
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int r = (i >> 1) & 1;
          sc[i] = ex2(fmaf(sc[i], LOG2E, nb[r]));
          l[r] += sc[i];
        }
      };
      auto pack = [&] {
        if constexpr (PV8) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float* s = sc + 16 * c;
            pa[c][0] = p_bytes<MODE>(s[0], s[1], s[4], s[5]);
            pa[c][1] = p_bytes<MODE>(s[2], s[3], s[6], s[7]);
            pa[c][2] = p_bytes<MODE>(s[8], s[9], s[12], s[13]);
            pa[c][3] = p_bytes<MODE>(s[10], s[11], s[14], s[15]);
          }
        } else {
          pack_frag<BKV>(pa, sc);
        }
      };
      // O takes a finished 8-bit block: acc * alpha + pv, rounded as
      // written (the per-column scale comes at the store).
      auto fold = [&](const float (&alpha)[2]) {
#pragma unroll
        for (int i = 0; i < NO; ++i)
          o_acc[i] = __fadd_rn(__fmul_rn(o_acc[i], alpha[(i >> 1) & 1]), exact_f32(pv[i]));
      };

      float alpha[2], alpha_prev[2];
      if constexpr (C::OVERLAP) {
        // Tile j's Q K^T is issued with tile j-1's P V behind it; tile j's
        // softmax runs while P V finishes. P's registers are read by the P V
        // in flight, so they change only after it is done. The first tile
        // is peeled off, so no product is issued under a branch.
        if (n_tiles > 0) {
          wait_kv(it);
          turn_begin();
          wgmma_fence();
          issue_qk(it);
          turn_end(false);
          wgmma_wait<0>();
          fence_regs(sacc);
          release_qk(it);
          softmax(it, 0, alpha);
          release_stage(it);
          pack();
          alpha_prev[0] = alpha[0], alpha_prev[1] = alpha[1];
        }
        for (int j = 1; j < n_tiles; ++j) {
          const int k = it + j;
          wait_kv(k);
          wait_vt(k - 1);
          turn_begin();
          wgmma_fence();
          issue_qk(k);
          issue_pv(k - 1);
          turn_end(false);
          wgmma_wait<1>();
          fence_regs(sacc);
          release_qk(k);
          softmax(k, j, alpha);
          release_stage(k);
          wgmma_wait<0>();
          if constexpr (PV8) {
            fence_regs(pv);
            release_pv(k - 1);
            fold(alpha_prev);
          } else {
            fence_regs(o_acc);
            release_pv(k - 1);
#pragma unroll
            for (int i = 0; i < NO; ++i) o_acc[i] *= alpha[(i >> 1) & 1];
          }
          pack();
          alpha_prev[0] = alpha[0], alpha_prev[1] = alpha[1];
        }
        if (n_tiles > 0) {  // the last tile's P V
          const int k = it + n_tiles - 1;
          wait_vt(k);
          turn_begin();
          wgmma_fence();
          issue_pv(k);
          turn_end(true);
          wgmma_wait<0>();
          if constexpr (PV8) {
            fence_regs(pv);
            release_pv(k);
            fold(alpha_prev);
          } else {
            fence_regs(o_acc);
            release_pv(k);
          }
        }
      } else {
        // One tile at a time: Q K^T, the softmax, P V (two turns a tile).
        for (int j = 0; j < n_tiles; ++j) {
          const int k = it + j;
          wait_kv(k);
          turn_begin();
          wgmma_fence();
          issue_qk(k);
          turn_end(false);
          wgmma_wait<0>();
          fence_regs(sacc);
          release_qk(k);
          softmax(k, j, alpha);
          release_stage(k);
          pack();
          if constexpr (!PV8) {
#pragma unroll
            for (int i = 0; i < NO; ++i) o_acc[i] *= alpha[(i >> 1) & 1];
          }
          wait_vt(k);
          turn_begin();
          wgmma_fence();
          issue_pv(k);
          turn_end(j == n_tiles - 1);
          wgmma_wait<0>();
          if constexpr (PV8) {
            fence_regs(pv);
            release_pv(k);
            fold(alpha);
          } else {
            fence_regs(o_acc);
            release_pv(k);
          }
        }
      }
      release(C::QK16 ? bar_q16empty : bar_qempty + 8 * (n & 1));
      it += n_tiles;

      // The 8-bit P.V's per-column scale: int8-full vs, K6 vs / qmax.
      const float* vs_row = PV8 ? p.vs + ((long long)w.b * p.Hkv + hk) * p.d : nullptr;
      constexpr float QMAX = MODE == K6_FP8 ? 448.f : MODE == K6_INT8 ? 127.f : 1.f;
      int row_end = p.Sq;  // K18 int8: rows past the range are another launch's
      if constexpr (ROWBLOCK) row_end = p.row_end;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
        const int row = row0 + 8 * i;
        if (row >= row_end) continue;
        const float inv = l[i] == 0.f ? 1.f : 1.f / l[i];
        const long long orow = (((long long)w.b * p.Sq + row) * p.Hq + w.h) * p.d;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          if (8 * j >= p.d) continue;  // columns d..D-1 (zero) are not stored
          const int c0 = 8 * j + 2 * t4;
          float a0 = o_acc[4 * j + 2 * i] * inv, a1 = o_acc[4 * j + 2 * i + 1] * inv;
          if constexpr (PV8) {
            a0 *= rank1(MODE) ? __fdiv_rn(vs_row[c0], QMAX) : vs_row[c0];
            a1 *= rank1(MODE) ? __fdiv_rn(vs_row[c0 + 1], QMAX) : vs_row[c0 + 1];
          }
          if (p.out_f32)
            store2(static_cast<float*>(p.o) + orow + c0, a0, a1);
          else
            store2(static_cast<__nv_bfloat16*>(p.o) + orow + c0, a0, a1);
        }
      }
    }
  }
}

// --- host side -------------------------------------------------------------------

struct QuantCall {
  const void *q, *k, *v;
  void* o;
  const float *score_scale, *qs, *ks, *vs;
  int B, Sq, Skv, Hq, Hkv, D;
  float sm_scale;
  int causal, out_f32;
};

// The tensor maps of Q, K (8-bit, hazard 3's swizzle) and V (8-bit, or
// bf16 in 64-column boxes), the real head dim d innermost: a box's columns
// d..D-1 arrive as zeros (nothing in Q.K^T; zero P.V columns, not stored).
template <int D, int MODE>
bool encode_maps(const QuantCall& a, CUtensorMap& tq, CUtensorMap& tk, CUtensorMap& tv) {
  const uint64_t B = a.B, Sq = a.Sq, Skv = a.Skv, d = a.D;
  const auto u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const auto sw = D == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;  // hazard 3
  return encode_4d(&tq, u8, 1, a.q, {d, (uint64_t)a.Hq, Sq, B}, {D, 1, BQ, 1}, sw) &&
         encode_4d(&tk, u8, 1, a.k, {d, (uint64_t)a.Hkv, Skv, B}, {D, 1, BKV, 1}, sw) &&
         (pv_8bit(MODE)
              ? encode_4d(&tv, u8, 1, a.v, {d, (uint64_t)a.Hkv, Skv, B}, {D, 1, BKV, 1}, sw)
              : encode_4d(&tv, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.v,
                          {d, (uint64_t)a.Hkv, Skv, B}, {64, 1, BKV, 1}));
}

template <int D, int MODE>
cudaError_t launch(const QuantCall& a, cudaStream_t stream) {
  using C = Cfg<D, MODE>;
  CUtensorMap tq, tk, tv;
  if (!encode_maps<D, MODE>(a, tq, tk, tv)) return cudaErrorInvalidValue;
  const long long work = (long long)((a.Sq + BQ - 1) / BQ) * a.Hq * a.B;
  if (work > INT_MAX) return cudaErrorInvalidValue;
  const int n_work = static_cast<int>(work);
  Params p{a.o, a.score_scale, a.qs, a.ks, a.vs, a.B, a.Sq, a.Skv, a.Hq, a.Hkv,
           n_work, a.sm_scale, a.causal, a.out_f32};
  p.d = a.D;
  auto kernel = flash_quant_sm90<D, MODE>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return e;
  int sms = 0;
  if ((e = sm_count(&sms)) != cudaSuccess) return e;
  const int grid = PERSISTENT ? (n_work < sms ? n_work : sms) : n_work;
  kernel<<<grid, THREADS, C::SMEM, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

// K18 int8: one launch over query rows [row0, row0 + rows) of the square
// S (a.Sq == a.Skv) on the plan's ring stages, shared memory and grid (1
// to the range's work tiles), which must be this file's; `chained`: a
// programmatic dependent launch. bf16 V and output.
template <int D>
cudaError_t launch_rowblock(const QuantCall& a, int row0, int rows, bool chained, int stages,
                            int smem, int grid, cudaStream_t stream) {
  using C = Cfg<D, INT8QK>;
  if (stages != C::STAGES || smem != C::SMEM) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if (!encode_maps<D, INT8QK>(a, tq, tk, tv)) return cudaErrorInvalidValue;
  const long long work = (long long)((rows + BQ - 1) / BQ) * a.Hq * a.B;
  if (work > INT_MAX || grid < 1 || grid > work) return cudaErrorInvalidValue;
  Params p{a.o, a.score_scale, nullptr, nullptr, nullptr, a.B, a.Sq, a.Skv, a.Hq, a.Hkv,
           static_cast<int>(work), 0.f, a.causal, 0};
  p.row0 = row0;
  p.row_end = row0 + rows;
  p.d = a.D;
  const auto kernel = flash_quant_sm90<D, INT8QK, true>;
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  return launch_chained(kernel, chained, grid, THREADS, smem, stream, tq, tk, tv, p);
}

// Head dim d on the width that holds it: 64 for d <= 64, else 128.
template <int MODE>
cudaError_t launch_mode(const QuantCall& a, cudaStream_t stream) {
  return a.D <= 64 ? launch<64, MODE>(a, stream) : launch<128, MODE>(a, stream);
}

cudaError_t run(const QuantCall& a, int mode, cudaStream_t stream) {
  switch (mode) {
    case INT8QK: return launch_mode<INT8QK>(a, stream);
    case FP8QK: return launch_mode<FP8QK>(a, stream);
    case INT8FULL: return launch_mode<INT8FULL>(a, stream);
    case K6_INT8: return launch_mode<K6_INT8>(a, stream);
    case K6_FP8: return launch_mode<K6_FP8>(a, stream);
  }
  return cudaErrorInvalidValue;
}

// The checks the entry points share: sizes, GQA, the head dim (a multiple
// of 16 up to 128: 8-bit rows of whole 16-byte units, which TMA needs;
// ops/_build.py::head_dim_plan pads the rest), the output dtypes and TMA's
// 16-byte-aligned bases.
bool valid(const void* q, const void* k, const void* v, int B, int Sq, int Skv, int Hq, int Hkv,
           int D, int out_dtype) {
  return B > 0 && Sq > 0 && Skv > 0 && Hkv > 0 && Hq % Hkv == 0 && D >= 16 && D <= 128 &&
         D % 16 == 0 &&
         (out_dtype == PFA_BF16 || out_dtype == PFA_F32) && aligned16(q) && aligned16(k) &&
         aligned16(v);
}

template <int D, int MODE, bool ROWBLOCK = false>
cudaError_t info(int* out) {
  using C = Cfg<D, MODE>;
  auto kernel = flash_quant_sm90<D, MODE, ROWBLOCK>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return e;
  out[0] = BKV, out[1] = C::SMEM, out[2] = THREADS, out[4] = C::STAGES;
  out[5] = C::PRODUCER_REGS, out[6] = C::CONSUMER_REGS, out[7] = C::OVERLAP;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3], kernel, THREADS, C::SMEM);
}

template <int MODE>
cudaError_t info_mode(int D, int* out) {
  if (D == 64) return info<64, MODE>(out);
  if (D == 128) return info<128, MODE>(out);
  return cudaErrorInvalidValue;
}

}  // namespace

// K1's quantized modes. q (B, Sq, Hq, D) and k (B, Skv, Hkv, D) 8-bit payloads
// (qk_dtype int8 or e4m3); v (B, Skv, Hkv, D) bf16, or int8 with v_scales
// (B, Hkv, D) fp32 when pv_int8 (int8 Q/K only); score_scale a (1,) fp32
// device scalar; o (B, Sq, Hq, D) bf16 or fp32 (out_dtype).
extern "C" int pfa_flash_fwd_quant(const void* q, const void* k, const void* v, void* o,
                                   const void* score_scale, const void* v_scales, int B, int Sq,
                                   int Skv, int Hq, int Hkv, int D, int causal, int qk_dtype,
                                   int pv_int8, int out_dtype, void* stream) {
  if (!valid(q, k, v, B, Sq, Skv, Hq, Hkv, D, out_dtype) || score_scale == nullptr ||
      (pv_int8 && (v_scales == nullptr || qk_dtype != PFA_INT8)))
    return cudaErrorInvalidValue;
  const int mode = pv_int8 ? INT8FULL : qk_dtype == PFA_INT8 ? INT8QK
                                      : qk_dtype == PFA_E4M3 ? FP8QK
                                                             : -1;
  const QuantCall a{q, k, v, o, static_cast<const float*>(score_scale), nullptr, nullptr,
                    static_cast<const float*>(v_scales), B, Sq, Skv, Hq, Hkv, D, 0.f, causal,
                    out_dtype == PFA_F32};
  return run(a, mode, static_cast<cudaStream_t>(stream));
}

// K6: q (B, Sq, Hq, D), k/v (B, Skv, Hkv, D) int8 or e4m3 payloads (qdtype);
// qs (B, Hq, Sq), ks (B, Hkv, Skv), vs (B, Hkv, D) fp32 scales; o (B, Sq,
// Hq, D) bf16 or fp32 (out_dtype).
extern "C" int pfa_flash_quant(const void* q, const void* k, const void* v, const void* qs,
                               const void* ks, const void* vs, void* o, int B, int Sq, int Skv,
                               int Hq, int Hkv, int D, float sm_scale, int causal, int qdtype,
                               int out_dtype, void* stream) {
  if (!valid(q, k, v, B, Sq, Skv, Hq, Hkv, D, out_dtype) || (qdtype != PFA_INT8 && qdtype != PFA_E4M3))
    return cudaErrorInvalidValue;
  const QuantCall a{q, k, v, o, nullptr, static_cast<const float*>(qs),
                    static_cast<const float*>(ks), static_cast<const float*>(vs), B, Sq, Skv, Hq,
                    Hkv, D, sm_scale, causal, out_dtype == PFA_F32};
  return run(a, qdtype == PFA_INT8 ? K6_INT8 : K6_FP8, static_cast<cudaStream_t>(stream));
}

// out[8]: keys a tile, dynamic shared memory bytes, threads a CTA, CTAs a
// SM, ring stages, producer and consumer registers (setmaxnreg), and 1 when
// tile j's Q.K^T overlaps tile j-1's P.V, of the quantized kernel at head
// dim D in `mode` (0 int8-QK, 1 fp8-QK, 2 int8-full, 3 K6 int8, 4 K6 fp8);
// no launch.
extern "C" int pfa_quant_sm90_info(int D, int mode, int* out) {
  switch (mode) {
    case INT8QK: return info_mode<INT8QK>(D, out);
    case FP8QK: return info_mode<FP8QK>(D, out);
    case INT8FULL: return info_mode<INT8FULL>(D, out);
    case K6_INT8: return info_mode<K6_INT8>(D, out);
    case K6_FP8: return info_mode<K6_FP8>(D, out);
  }
  return cudaErrorInvalidValue;
}

// K18's int8-QK mode with a bf16 V: one launch over query rows [q_row0,
// q_row0 + rows) of every (b, h). q (B, S, Hq, D) and k (B, S, Hkv, D)
// int8 payloads, v (B, S, Hkv, D) bf16, contiguous, 16-byte-aligned bases,
// Hq % Hkv == 0, D 64 or 128; score_scale a (1,) fp32 device scalar (qs *
// ks * sm_scale); o (B, S, Hq, D) bf16, the range's rows written in place;
// causal (col <= row) or not; 0 <= q_row0 < q_row0 + rows <= S; stages,
// smem and grid from experiments/flash_pipeline_experiment.py::k18_i8_plan.
// `chained` (every launch of a call after its first): a programmatic
// dependent launch on the one ahead of it in the stream.
extern "C" int pfa_flash_tri_i8_sm90(const void* q, const void* k, const void* v, void* o,
                                     const void* score_scale, int B, int S, int Hq, int Hkv, int D,
                                     int q_row0, int rows, int causal, int chained, int stages,
                                     int smem, int grid, void* stream) {
  if (!valid(q, k, v, B, S, S, Hq, Hkv, D, PFA_BF16) || (D != 64 && D != 128) ||
      score_scale == nullptr || q_row0 < 0 || rows <= 0 || (long long)q_row0 + rows > S)
    return cudaErrorInvalidValue;
  const QuantCall a{q, k, v, o, static_cast<const float*>(score_scale), nullptr, nullptr, nullptr,
                    B, S, S, Hq, Hkv, D, 0.f, causal, 0};
  const auto st = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch_rowblock<64>(a, q_row0, rows, chained != 0, stages, smem, grid, st);
  return launch_rowblock<128>(a, q_row0, rows, chained != 0, stages, smem, grid, st);
}

// out[8], as pfa_quant_sm90_info's, of K18 int8's instantiation at head dim
// D; no launch.
extern "C" int pfa_flash_tri_i8_sm90_info(int D, int* out) {
  if (D == 64) return info<64, INT8QK, true>(out);
  if (D == 128) return info<128, INT8QK, true>(out);
  return cudaErrorInvalidValue;
}
