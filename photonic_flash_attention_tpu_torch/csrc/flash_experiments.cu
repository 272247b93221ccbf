// K13-K16: the D=64 forward design-space experiments for Hopper (sm_90a).
//
// Replace the TPU kernels of benchmarks/ (B15a-d):
// * K13 pfa_flash_fixedmax: flash_fixedmax_experiment.py::_kernel (VFA's
//   precomputed row bound: no running max, no alpha, no rescale; the
//   Schraudolph `fast_exp` mode);
// * K14 pfa_flash_aug: flash_aug_experiment.py::_aug_kernel (the row sum l
//   folded into the P.V product by a ones column of V);
// * K15 pfa_flash_pair: flash_pair_experiment.py::_pair_kernel (nchain
//   independent query chains against one staged K/V tile);
// * K16 pfa_flash_pipelined: flash_pipeline_experiment.py::_kernel (the KV
//   loop software-pipelined so QK(j+1) overlaps softmax(j)).
// Callers: experiments/flash_*_experiment.py in the port package.
//
// What bounds them on the H100: the same work as K1 (csrc/flash_fwd.cu).
// At D = 64 the tensor cores need ~26 us at B4 S2048 H12 causal, the
// softmax stream (one exp and its FP32 work per score, MUFU at 16 a clock
// per SM) ~41 us: the exps, not the products, set the ceiling. Each kernel
// removes or hides one part of that stream, and is otherwise K1's bf16 path
// (mma.sync m16n8k16, the FA2 register layout, a quad per row, exp2f in
// log2 units, one 64-key K/V tile per step for 64 query rows).
//
// Shared structure, not K1's: a tile is masked only where it must be (the
// causal diagonal tile of a warp, the ragged last tile); every other tile
// runs a body with no predicate. `p` takes one FFMA before its exp
// (s * scale * log2 e - m * scale * log2 e), where K1 takes an FMUL and an
// FADD. K15 with nchain 1 is this structure without any lever: the control
// the experiments are read against besides K1.
//
// The causal mask of all four is the experiments' `col <= row` (top-left),
// not K1's end-aligned diagonal; the two agree for square shapes. Every
// row sees key 0, so after the first tile every running max is finite and
// masked keys can be -inf where JAX uses a finite mask value: they
// contribute exactly 0 either way (fixed-max's fast_exp excepted: JAX's
// clip gives a masked key 2^-126, and so does K13).

#include "common.cuh"

namespace {

constexpr int XBQ = 64;       // query rows of one chain: 4 warps x 16
constexpr int XBKV = 64;      // keys per K/V tile
constexpr int XTHREADS = 128;
constexpr int NT = XBKV / 8;  // 8-wide score tiles per K/V tile

// The Schraudolph bit-trick exp of the fixed-max experiment, with JAX's
// constants in natural units (flash_fixedmax_experiment.py:96-101): the
// fp32 literals round as jnp.float32 rounds them (1064986823 -> 1064986816,
// 2139095039 -> 2139095040, whose int is +inf's bits). The float-to-int
// conversion truncates, as astype(int32).
constexpr float FEXP_A = 12102203.0f;
constexpr float FEXP_B = 1064986823.0f;
constexpr float FEXP_LO = 8388608.0f;
constexpr float FEXP_HI = 2139095039.0f;

__device__ __forceinline__ float fast_exp(float x) {
  const float y = fminf(fmaxf(fmaf(x, FEXP_A, FEXP_B), FEXP_LO), FEXP_HI);
  return __int_as_float(__float2int_rz(y));
}

// Q fragments of a warp's 16 rows from row r0 of the staged Q tile.
template <int D, int LD>
__device__ __forceinline__ void q_frags(uint32_t qf[D / 16][4], const __nv_bfloat16* Qs, int r0,
                                        int g, int t4) {
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) load_a_frag<LD>(qf[kc], Qs, r0, kc * 16, g, t4);
}

// s = Q K^T over one 64-key tile (raw scores, fp32).
template <int D, int LD>
__device__ __forceinline__ void qk_tile(float s[NT][4], uint32_t qf[D / 16][4],
                                        const __nv_bfloat16* Ks, int g, int t4) {
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) mma_bt<LD>(s[n], qf[kc], Ks, n * 8, kc * 16, g, t4);
  }
}

// Masked keys to -inf: past Skv, or above the row when causal (col > row).
__device__ __forceinline__ void mask_tile(float s[NT][4], int kv0, const int rows[2], int Skv,
                                          bool causal, int t4) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = kv0 + n * 8 + t4 * 2 + (e & 1);
      if (col >= Skv || (causal && col > rows[e >> 1])) s[n][e] = -INFINITY;
    }
}

// The online-softmax statistics of one tile: m becomes the running max of
// the raw scores, alpha = exp2((m_old - m_new) * sc), base = m_new * sc;
// with WITH_L the running sum l is rescaled by alpha. A row with no key
// yet (only in a masked tile) keeps base 0.
template <bool MASKED, bool WITH_L>
__device__ __forceinline__ void softmax_stats(float s[NT][4], float m[2], float l[2],
                                              float alpha[2], float base[2], float sc) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    base[i] = MASKED && mx[i] == -INFINITY ? 0.f : mx[i] * sc;
    alpha[i] = exp2f(m[i] * sc - base[i]);  // m = -inf before the first tile: 0
    m[i] = mx[i];
    if (WITH_L) l[i] *= alpha[i];
  }
}

// p = exp2(s * sc - base) for score tiles n0..n1-1, one FFMA and one exp
// each; with WITH_L each p is added into l.
template <bool WITH_L, int N0 = 0, int N1 = NT>
__device__ __forceinline__ void exp_tiles(float s[NT][4], float l[2], const float base[2],
                                          float sc) {
#pragma unroll
  for (int n = N0; n < N1; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[n][e] = exp2f(fmaf(s[n][e], sc, -base[e >> 1]));
      if (WITH_L) l[e >> 1] += s[n][e];
    }
}

__device__ __forceinline__ void pack_p(uint32_t pa[4], float s[NT][4], int kc) {
  pa[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
  pa[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
  pa[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
  pa[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
}

template <int NDT>
__device__ __forceinline__ void rescale(float acc[NDT][4], const float alpha[2]) {
#pragma unroll
  for (int dn = 0; dn < NDT; ++dn) {
    acc[dn][0] *= alpha[0];
    acc[dn][1] *= alpha[0];
    acc[dn][2] *= alpha[1];
    acc[dn][3] *= alpha[1];
  }
}

// acc += P V over the 16 keys of k-step kc, NDT 8-wide output tiles.
template <int NDT, int LD>
__device__ __forceinline__ void pv_step(float acc[NDT][4], float s[NT][4], int kc,
                                        const __nv_bfloat16* Vs, int g, int t4) {
  uint32_t pa[4];
  pack_p(pa, s, kc);
#pragma unroll
  for (int dn = 0; dn < NDT; ++dn) mma_bn<LD>(acc[dn], pa, Vs, kc * 16, dn * 8, g, t4);
}

template <int NDT, int LD>
__device__ __forceinline__ void pv_tile(float acc[NDT][4], float s[NT][4],
                                        const __nv_bfloat16* Vs, int g, int t4) {
#pragma unroll
  for (int kc = 0; kc < XBKV / 16; ++kc) pv_step<NDT, LD>(acc, s, kc, Vs, g, t4);
}

// The quad's full row sums from each lane's share.
__device__ __forceinline__ void quad_sum(float l[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
}

// o = acc / l (l == 0 -> 1, as the experiments' l_inv) for rows < Sq.
template <int D, typename OutT>
__device__ __forceinline__ void store_rows(OutT* o, float acc[D / 8][4], const float l[2],
                                           const int rows[2], int Sq, long long ostr,
                                           long long obase, int t4) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= Sq) continue;
    const float inv = l[i] == 0.f ? 1.f : 1.f / l[i];
    OutT* orow = o + obase + rows[i] * ostr;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      store2(orow + dn * 8 + t4 * 2, acc[dn][2 * i] * inv, acc[dn][2 * i + 1] * inv);
  }
}

// --- K13: fixed max ---------------------------------------------------------
//
// M (B, H, S) fp32 is the prolog's Cauchy-Schwarz bound of each row's
// scaled scores (experiments/flash_fixedmax_experiment.py::fixed_max_bound),
// read once per row. Per score: exp mode one FFMA (s * scale * log2 e -
// M * log2 e), exp2f, the FADD into l and half a bf16 pack; fast_exp one
// FFMA to the natural-unit x = s * scale - M, then JAX's FFMA, two clamps
// and the truncating conversion, no MUFU. No max, no alpha, no rescale: the
// final acc / l cancels the uniform exp(m_true - M). Exact while M - m_true
// stays inside fp32's exp range (~87; JAX's contract, not clamped here).
template <int D, bool FAST, bool MASKED>
__device__ __forceinline__ void fixedmax_tile(float acc[D / 8][4], float l[2],
                                              uint32_t qf[D / 16][4],
                                              const __nv_bfloat16* Ks, const __nv_bfloat16* Vs,
                                              const float mb[2], float sc, int kv0,
                                              const int rows[2], int S, bool causal, int g,
                                              int t4) {
  float s[NT][4];
  qk_tile<D, D + 8>(s, qf, Ks, g, t4);
  if (MASKED) mask_tile(s, kv0, rows, S, causal, t4);
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = fmaf(s[n][e], sc, -mb[e >> 1]);
      s[n][e] = FAST ? fast_exp(x) : exp2f(x);
      l[e >> 1] += s[n][e];
    }
  pv_tile<D / 8, D + 8>(acc, s, Vs, g, t4);
}

template <int D, bool FAST>
__global__ void __launch_bounds__(XTHREADS)
flash_fixedmax_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                      const float* __restrict__ M, int S, int H, float scale, int causal) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + XBQ * LD;
  __nv_bfloat16* Vs = Ks + XBKV * LD;

  const int q0 = blockIdx.x * XBQ, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3, wr = warp * 16;
  const long long str = (long long)H * D, base = (long long)b * S * str + (long long)h * D;

  load_tile_bf16<D, LD, XTHREADS>(Qs, q + base + q0 * str, str, XBQ, S - q0);
  __syncthreads();
  uint32_t qf[D / 16][4];
  q_frags<D, LD>(qf, Qs, wr, g, t4);
  const int rows[2] = {q0 + wr + g, q0 + wr + g + 8};
  const float* mrow = M + ((long long)b * H + h) * S;
  // exp mode in log2 units, fast_exp in natural units (JAX's constants).
  const float sc = FAST ? scale : scale * LOG2E;
  float mb[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) mb[i] = rows[i] < S ? (FAST ? 1.f : LOG2E) * mrow[rows[i]] : 0.f;

  float acc[D / 8][4] = {};
  float l[2] = {0.f, 0.f};
  const int kv_end = causal ? min(S, q0 + XBQ) : S;
  for (int kv0 = 0; kv0 < kv_end; kv0 += XBKV) {
    __syncthreads();
    load_tile_bf16<D, LD, XTHREADS>(Ks, k + base + kv0 * str, str, XBKV, S - kv0);
    load_tile_bf16<D, LD, XTHREADS>(Vs, v + base + kv0 * str, str, XBKV, S - kv0);
    __syncthreads();
    if (kv0 + XBKV > S || (causal && kv0 + XBKV - 1 > q0 + wr))
      fixedmax_tile<D, FAST, true>(acc, l, qf, Ks, Vs, mb, sc, kv0, rows, S, causal, g, t4);
    else
      fixedmax_tile<D, FAST, false>(acc, l, qf, Ks, Vs, mb, sc, kv0, rows, S, causal, g, t4);
  }
  quad_sum(l);
  store_rows<D>(o, acc, l, rows, S, str, base, t4);
}

// --- K14: augmented V -------------------------------------------------------
//
// The staged V tile's padding columns (the shared row is D + 8 wide for
// conflict-free fragment loads) hold [1, 0 x 7], written once: one extra n8
// tile of the P.V product then yields, in its column 0, the sum of the
// bf16-rounded p of each row (what JAX's product sums), rescaled by alpha
// with the accumulator. No per-score FADD into l; max and alpha stay. Cost:
// one more mma.sync per k16 step (+1/8 of P.V at D = 64). No augmented copy
// of V goes through device memory.
constexpr int AUG_D = 64;
constexpr int AUG_LD = AUG_D + 8;
constexpr int AUG_NDT = AUG_D / 8 + 1;  // + the ones column's tile

template <bool MASKED>
__device__ __forceinline__ void aug_tile(float acc[AUG_NDT][4], float m[2],
                                         uint32_t qf[AUG_D / 16][4],
                                         const __nv_bfloat16* Ks, const __nv_bfloat16* Vs,
                                         float sc, int kv0, const int rows[2], int Skv, int g,
                                         int t4) {
  float s[NT][4], alpha[2], base[2], unused[2];
  qk_tile<AUG_D, AUG_LD>(s, qf, Ks, g, t4);
  if (MASKED) mask_tile(s, kv0, rows, Skv, true, t4);
  softmax_stats<MASKED, false>(s, m, unused, alpha, base, sc);
  exp_tiles<false>(s, unused, base, sc);
  rescale<AUG_NDT>(acc, alpha);
  pv_tile<AUG_NDT, AUG_LD>(acc, s, Vs, g, t4);
}

__global__ void __launch_bounds__(XTHREADS)
flash_aug_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int Sq,
                 int Skv, int H, float scale) {
  constexpr int D = AUG_D, LD = AUG_LD;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + XBQ * LD;
  __nv_bfloat16* Vs = Ks + XBKV * LD;

  const int q0 = blockIdx.x * XBQ, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3, wr = warp * 16;
  const long long str = (long long)H * D;
  const long long qbase = (long long)b * Sq * str + (long long)h * D;
  const long long kvbase = (long long)b * Skv * str + (long long)h * D;

  for (int i = threadIdx.x; i < XBKV * 8; i += XTHREADS)  // V's [1, 0 x 7] columns
    Vs[(i >> 3) * LD + D + (i & 7)] = __float2bfloat16((i & 7) == 0 ? 1.f : 0.f);
  load_tile_bf16<D, LD, XTHREADS>(Qs, q + qbase + q0 * str, str, XBQ, Sq - q0);
  __syncthreads();
  uint32_t qf[D / 16][4];
  q_frags<D, LD>(qf, Qs, wr, g, t4);
  const int rows[2] = {q0 + wr + g, q0 + wr + g + 8};
  const float sc = scale * LOG2E;

  float acc[AUG_NDT][4] = {};
  float m[2] = {-INFINITY, -INFINITY};
  const int kv_end = min(Skv, q0 + XBQ);  // causal only
  for (int kv0 = 0; kv0 < kv_end; kv0 += XBKV) {
    __syncthreads();
    load_tile_bf16<D, LD, XTHREADS>(Ks, k + kvbase + kv0 * str, str, XBKV, Skv - kv0);
    load_tile_bf16<D, LD, XTHREADS>(Vs, v + kvbase + kv0 * str, str, XBKV, Skv - kv0);
    __syncthreads();
    if (kv0 + XBKV > Skv || kv0 + XBKV - 1 > q0 + wr)
      aug_tile<true>(acc, m, qf, Ks, Vs, sc, kv0, rows, Skv, g, t4);
    else
      aug_tile<false>(acc, m, qf, Ks, Vs, sc, kv0, rows, Skv, g, t4);
  }
  // l sits in column D: lane t4 == 0 of each quad holds it for rows g, g+8.
  float l[2] = {__shfl_sync(0xffffffffu, acc[D / 8][0], lane & ~3),
                __shfl_sync(0xffffffffu, acc[D / 8][2], lane & ~3)};
  store_rows<D>(o, acc, l, rows, Sq, str, qbase, t4);
}

// --- K15: paired chains -----------------------------------------------------
//
// A block stages NCHAIN x 64 query rows and one 64-key K/V tile per step;
// warp w carries NCHAIN independent 16-row chains (rows c * 64 + 16 w of
// the block, chain c being JAX's q block qp * nchain + c), each its own
// online softmax. So one K/V tile fill serves NCHAIN times K1's rows, and a
// warp holds NCHAIN independent instruction streams: the Q.K products of
// all chains share each K fragment (chains innermost); chain c's exps are
// issued between chain c-1's P.V products (a skew), so the MUFU work of one
// chain sits beside the tensor-core work of another. Q fragments are read
// from shared memory each step (registers go to the chains' scores and
// accumulators: 64 fp32 a thread a chain at D = 64). Chains below FIRST
// have passed the causal diagonal and skip the tile.
//
// Registers decide the chain count: nchain 1 and 2 compile without spills
// (98 and 245 registers a thread); 3 and 4 hit the 255-register limit and
// spill (196 and 1980 bytes of spill stores), so the library holds 1 and 2.
// Compiling this file with -DPFA_PAIR_NCHAIN_MAX=4 -Xptxas -v instantiates 3
// and 4 as well and shows their spills.
#ifndef PFA_PAIR_NCHAIN_MAX
#define PFA_PAIR_NCHAIN_MAX 2
#endif
constexpr int PAIR_D = 64;
constexpr int PAIR_LD = PAIR_D + 8;
constexpr int PAIR_DT = PAIR_D / 8;

template <int NCHAIN, bool MASKED, int FIRST>
__device__ __forceinline__ void pair_tile(float acc[NCHAIN][PAIR_DT][4], float m[NCHAIN][2],
                                          float l[NCHAIN][2], const __nv_bfloat16* Qs,
                                          const __nv_bfloat16* Ks, const __nv_bfloat16* Vs,
                                          float sc, int kv0, int rows[NCHAIN][2], int Skv,
                                          int wr, int g, int t4) {
  float s[NCHAIN][NT][4];
#pragma unroll
  for (int c = FIRST; c < NCHAIN; ++c)
#pragma unroll
    for (int n = 0; n < NT; ++n) s[c][n][0] = s[c][n][1] = s[c][n][2] = s[c][n][3] = 0.f;
#pragma unroll
  for (int kc = 0; kc < PAIR_D / 16; ++kc) {
    uint32_t a[NCHAIN][4];
#pragma unroll
    for (int c = FIRST; c < NCHAIN; ++c)
      load_a_frag<PAIR_LD>(a[c], Qs, c * XBQ + wr, kc * 16, g, t4);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const __nv_bfloat16* p = Ks + (n * 8 + g) * PAIR_LD + kc * 16 + t4 * 2;
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(p);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(p + 8);
#pragma unroll
      for (int c = FIRST; c < NCHAIN; ++c) mma_16816(s[c][n], a[c], b0, b1);
    }
  }
  float alpha[NCHAIN][2], base[NCHAIN][2];
#pragma unroll
  for (int c = FIRST; c < NCHAIN; ++c) {
    if (MASKED) mask_tile(s[c], kv0, rows[c], Skv, true, t4);
    softmax_stats<MASKED, true>(s[c], m[c], l[c], alpha[c], base[c], sc);
    rescale<PAIR_DT>(acc[c], alpha[c]);
  }
  exp_tiles<true>(s[FIRST], l[FIRST], base[FIRST], sc);
#pragma unroll
  for (int c = FIRST + 1; c < NCHAIN; ++c) {
    // chain c-1's products, chain c's exps between them
    pv_step<PAIR_DT, PAIR_LD>(acc[c - 1], s[c - 1], 0, Vs, g, t4);
    exp_tiles<true, 0, 2>(s[c], l[c], base[c], sc);
    pv_step<PAIR_DT, PAIR_LD>(acc[c - 1], s[c - 1], 1, Vs, g, t4);
    exp_tiles<true, 2, 4>(s[c], l[c], base[c], sc);
    pv_step<PAIR_DT, PAIR_LD>(acc[c - 1], s[c - 1], 2, Vs, g, t4);
    exp_tiles<true, 4, 6>(s[c], l[c], base[c], sc);
    pv_step<PAIR_DT, PAIR_LD>(acc[c - 1], s[c - 1], 3, Vs, g, t4);
    exp_tiles<true, 6, 8>(s[c], l[c], base[c], sc);
  }
  pv_tile<PAIR_DT, PAIR_LD>(acc[NCHAIN - 1], s[NCHAIN - 1], Vs, g, t4);
}

template <int NCHAIN, int FIRST>
__device__ __forceinline__ void pair_masked(float acc[NCHAIN][PAIR_DT][4], float m[NCHAIN][2],
                                            float l[NCHAIN][2], const __nv_bfloat16* Qs,
                                            const __nv_bfloat16* Ks, const __nv_bfloat16* Vs,
                                            float sc, int kv0, int rows[NCHAIN][2],
                                            int Skv, int wr, int g, int t4, int first) {
  if constexpr (FIRST + 1 < NCHAIN) {
    if (first > FIRST) {
      pair_masked<NCHAIN, FIRST + 1>(acc, m, l, Qs, Ks, Vs, sc, kv0, rows, Skv, wr, g, t4, first);
      return;
    }
  }
  pair_tile<NCHAIN, true, FIRST>(acc, m, l, Qs, Ks, Vs, sc, kv0, rows, Skv, wr, g, t4);
}

template <int NCHAIN>
__global__ void __launch_bounds__(XTHREADS)
flash_pair_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int Sq,
                  int Skv, int H, float scale) {
  constexpr int D = PAIR_D, LD = PAIR_LD, ROWS = NCHAIN * XBQ;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + ROWS * LD;
  __nv_bfloat16* Vs = Ks + XBKV * LD;

  const int q0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3, wr = warp * 16;
  const long long str = (long long)H * D;
  const long long qbase = (long long)b * Sq * str + (long long)h * D;
  const long long kvbase = (long long)b * Skv * str + (long long)h * D;

  load_tile_bf16<D, LD, XTHREADS>(Qs, q + qbase + q0 * str, str, ROWS, Sq - q0);
  int rows[NCHAIN][2];
  float acc[NCHAIN][PAIR_DT][4] = {};
  float m[NCHAIN][2], l[NCHAIN][2];
#pragma unroll
  for (int c = 0; c < NCHAIN; ++c) {
    rows[c][0] = q0 + c * XBQ + wr + g;
    rows[c][1] = rows[c][0] + 8;
    m[c][0] = m[c][1] = -INFINITY;
    l[c][0] = l[c][1] = 0.f;
  }
  const float sc = scale * LOG2E;
  const int kv_end = min(Skv, q0 + ROWS);  // causal only
  for (int kv0 = 0; kv0 < kv_end; kv0 += XBKV) {
    __syncthreads();
    load_tile_bf16<D, LD, XTHREADS>(Ks, k + kvbase + kv0 * str, str, XBKV, Skv - kv0);
    load_tile_bf16<D, LD, XTHREADS>(Vs, v + kvbase + kv0 * str, str, XBKV, Skv - kv0);
    __syncthreads();
    if (kv0 + XBKV <= Skv && kv0 < q0)
      pair_tile<NCHAIN, false, 0>(acc, m, l, Qs, Ks, Vs, sc, kv0, rows, Skv, wr, g, t4);
    else  // the diagonal tile of chain `first` (chains below it are done), or the ragged end
      pair_masked<NCHAIN, 0>(acc, m, l, Qs, Ks, Vs, sc, kv0, rows, Skv, wr, g, t4,
                             kv0 < q0 ? 0 : (kv0 - q0) / XBQ);
  }
#pragma unroll
  for (int c = 0; c < NCHAIN; ++c) {
    quad_sum(l[c]);
    store_rows<D>(o, acc[c], l[c], rows[c], Sq, str, qbase, t4);
  }
}

// --- K16: the pipelined KV loop ---------------------------------------------
//
// The mma.sync form of FA3's intra-warpgroup overlap: at step j the scores
// of tile j+1 are issued into a second fragment (QK(j+1)) before the
// softmax of tile j, so the exps of one tile and the products of the next
// are independent instructions of one basic block. K and V are
// double-buffered in shared memory and copied by cp.async one step ahead
// (K_{j+2} and V_{j+1} are issued at the start of step j, into the buffers
// step j-1 released), with one barrier a step where K1 has two. q, k, v in
// bf16 or fp32; fp32 is converted to bf16 on load (JAX's body casts them),
// synchronously; P is rounded to bf16 for P.V, fp32 accumulate; the output
// is in q's dtype. GQA: q head h reads kv head h / (Hq/Hkv). JAX keeps all
// of a head's K/V in VMEM; that is a VMEM choice and does not carry over.

// rows x D fp32 from global into bf16 shared memory (pitch LD), 8 values a
// thread a chunk; rows at or past `valid` are zero-filled.
template <int D, int LD, int NTH>
__device__ __forceinline__ void load_tile_cvt(__nv_bfloat16* dst, const float* src,
                                              long long stride, int rows, int valid) {
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < rows * CH; i += NTH) {
    const int r = i / CH, c = (i % CH) * 8;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), bq = a;
    if (r < valid) {
      a = *reinterpret_cast<const float4*>(src + r * stride + c);
      bq = *reinterpret_cast<const float4*>(src + r * stride + c + 4);
    }
    uint4 out;
    out.x = pack_bf16(a.x, a.y);
    out.y = pack_bf16(a.z, a.w);
    out.z = pack_bf16(bq.x, bq.y);
    out.w = pack_bf16(bq.z, bq.w);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = out;
  }
}

template <int D, int LD>
__device__ __forceinline__ void load_kv(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                        long long stride, int valid) {
  load_tile_bf16_async<D, LD, XTHREADS>(dst, src, stride, XBKV, valid);
}
template <int D, int LD>
__device__ __forceinline__ void load_kv(__nv_bfloat16* dst, const float* src, long long stride,
                                        int valid) {
  load_tile_cvt<D, LD, XTHREADS>(dst, src, stride, XBKV, valid);
}

template <int D, bool MASKED>
__device__ __forceinline__ void pipelined_softmax_pv(float s[NT][4], float acc[D / 8][4],
                                                     float m[2], float l[2], float sc, int kv0,
                                                     const int rows[2], int S, bool causal,
                                                     const __nv_bfloat16* Vs, int g, int t4) {
  float alpha[2], base[2];
  if (MASKED) mask_tile(s, kv0, rows, S, causal, t4);
  softmax_stats<MASKED, true>(s, m, l, alpha, base, sc);
  exp_tiles<true>(s, l, base, sc);
  rescale<D / 8>(acc, alpha);
  pv_tile<D / 8, D + 8>(acc, s, Vs, g, t4);
}

template <int D, typename T>
__global__ void __launch_bounds__(XTHREADS)
flash_pipelined_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       T* __restrict__ o, int S, int Hq, int Hkv, float scale, int causal) {
  constexpr int LD = D + 8, TILE = XBKV * LD;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Kb = Qs + XBQ * LD;  // two K buffers
  __nv_bfloat16* Vb = Kb + 2 * TILE;  // two V buffers

  const int q0 = blockIdx.x * XBQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3, wr = warp * 16;
  const long long qstr = (long long)Hq * D, kvstr = (long long)Hkv * D;
  const long long qbase = (long long)b * S * qstr + (long long)h * D;
  const T* kb = k + (long long)b * S * kvstr + (long long)hk * D;
  const T* vb = v + (long long)b * S * kvstr + (long long)hk * D;
  const int kv_end = causal ? min(S, q0 + XBQ) : S;
  const int n = (kv_end + XBKV - 1) / XBKV;

  load_kv<D, LD>(Qs, q + qbase + q0 * qstr, qstr, S - q0);  // 64 rows, as a K/V tile
  load_kv<D, LD>(Kb, kb, kvstr, S);
  cp_async_commit();
  if (n > 1) load_kv<D, LD>(Kb + TILE, kb + XBKV * kvstr, kvstr, S - XBKV);
  load_kv<D, LD>(Vb, vb, kvstr, S);
  cp_async_commit();
  cp_async_wait<1>();  // Q and K_0
  __syncthreads();

  uint32_t qf[D / 16][4];
  q_frags<D, LD>(qf, Qs, wr, g, t4);
  const int rows[2] = {q0 + wr + g, q0 + wr + g + 8};
  const float sc = scale * LOG2E;
  float acc[D / 8][4] = {};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float s[NT][4];
  qk_tile<D, LD>(s, qf, Kb, g, t4);

  for (int j = 0; j < n; ++j) {
    cp_async_wait<0>();  // K_{j+1} and V_j
    __syncthreads();     // and every warp is past step j-1
    const int kv0 = j * XBKV;
    if (j + 2 < n) load_kv<D, LD>(Kb + (j & 1) * TILE, kb + (kv0 + 2 * XBKV) * kvstr, kvstr,
                                  S - kv0 - 2 * XBKV);
    if (j + 1 < n) load_kv<D, LD>(Vb + ((j + 1) & 1) * TILE, vb + (kv0 + XBKV) * kvstr, kvstr,
                                  S - kv0 - XBKV);
    cp_async_commit();
    const __nv_bfloat16* Vs = Vb + (j & 1) * TILE;
    if (j + 1 < n) {  // an inner tile: never masked
      float s_next[NT][4];
      qk_tile<D, LD>(s_next, qf, Kb + ((j + 1) & 1) * TILE, g, t4);  // QK(j+1) first
      pipelined_softmax_pv<D, false>(s, acc, m, l, sc, kv0, rows, S, causal, Vs, g, t4);
#pragma unroll
      for (int nn = 0; nn < NT; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nn][e] = s_next[nn][e];
    } else if (causal || kv0 + XBKV > S) {  // the last tile: diagonal or ragged
      pipelined_softmax_pv<D, true>(s, acc, m, l, sc, kv0, rows, S, causal, Vs, g, t4);
    } else {
      pipelined_softmax_pv<D, false>(s, acc, m, l, sc, kv0, rows, S, causal, Vs, g, t4);
    }
  }
  quad_sum(l);
  store_rows<D>(o, acc, l, rows, S, qstr, qbase, t4);
}

template <typename Kern, typename... Args>
cudaError_t launch_k(Kern kern, dim3 grid, int smem, cudaStream_t st, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kern<<<grid, XTHREADS, smem, st>>>(args...);
  return cudaGetLastError();
}

using bf16p = const __nv_bfloat16*;

template <int D>
cudaError_t run_fixedmax(const void* q, const void* k, const void* v, void* o, const float* fm,
                         int B, int S, int H, float scale, int causal, int fast,
                         cudaStream_t st) {
  const dim3 grid((S + XBQ - 1) / XBQ, H, B);
  const int smem = (XBQ + 2 * XBKV) * (D + 8) * (int)sizeof(__nv_bfloat16);
  auto kern = fast ? flash_fixedmax_kernel<D, true> : flash_fixedmax_kernel<D, false>;
  return launch_k(kern, grid, smem, st, static_cast<bf16p>(q), static_cast<bf16p>(k),
                  static_cast<bf16p>(v), static_cast<__nv_bfloat16*>(o), fm, S, H, scale, causal);
}

template <int NCHAIN>
cudaError_t run_pair(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                     int Skv, int H, float scale, cudaStream_t st) {
  const dim3 grid((Sq + NCHAIN * XBQ - 1) / (NCHAIN * XBQ), H, B);
  const int smem = (NCHAIN * XBQ + 2 * XBKV) * PAIR_LD * (int)sizeof(__nv_bfloat16);
  return launch_k(flash_pair_kernel<NCHAIN>, grid, smem, st, static_cast<bf16p>(q),
                  static_cast<bf16p>(k), static_cast<bf16p>(v), static_cast<__nv_bfloat16*>(o),
                  Sq, Skv, H, scale);
}

template <int D, typename T>
cudaError_t run_pipelined(const void* q, const void* k, const void* v, void* o, int B, int S,
                          int Hq, int Hkv, float scale, int causal, cudaStream_t st) {
  const dim3 grid((S + XBQ - 1) / XBQ, Hq, B);
  const int smem = (XBQ + 4 * XBKV) * (D + 8) * (int)sizeof(__nv_bfloat16);
  return launch_k(flash_pipelined_kernel<D, T>, grid, smem, st, static_cast<const T*>(q),
                  static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(o), S, Hq,
                  Hkv, scale, causal);
}

}  // namespace

// K13. q, k, v, o (B, S, H, D) bf16, D in {64, 128}; fm (B, H, S) fp32.
extern "C" int pfa_flash_fixedmax(const void* q, const void* k, const void* v, void* o,
                                  const void* fm, int B, int S, int H, int D, float sm_scale,
                                  int causal, int fast_exp, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(fm);
  if (D == 64) return run_fixedmax<64>(q, k, v, o, m, B, S, H, sm_scale, causal, fast_exp, st);
  if (D == 128) return run_fixedmax<128>(q, k, v, o, m, B, S, H, sm_scale, causal, fast_exp, st);
  return cudaErrorInvalidValue;
}

// K14. q (B, Sq, H, 64), k/v (B, Skv, H, 64), o like q, bf16; causal.
extern "C" int pfa_flash_aug(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                             int Skv, int H, int D, float sm_scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || H <= 0 || D != AUG_D) return cudaErrorInvalidValue;
  const dim3 grid((Sq + XBQ - 1) / XBQ, H, B);
  const int smem = (XBQ + 2 * XBKV) * AUG_LD * (int)sizeof(__nv_bfloat16);
  return launch_k(flash_aug_kernel, grid, smem, static_cast<cudaStream_t>(stream),
                  static_cast<bf16p>(q), static_cast<bf16p>(k), static_cast<bf16p>(v),
                  static_cast<__nv_bfloat16*>(o), Sq, Skv, H, sm_scale);
}

// K15. As K14, with nchain chains of 64 rows a block.
extern "C" int pfa_flash_pair(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                              int Skv, int H, int D, float sm_scale, int nchain, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || H <= 0 || D != PAIR_D) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nchain == 1) return run_pair<1>(q, k, v, o, B, Sq, Skv, H, sm_scale, st);
  if (nchain == 2) return run_pair<2>(q, k, v, o, B, Sq, Skv, H, sm_scale, st);
#if PFA_PAIR_NCHAIN_MAX >= 3
  if (nchain == 3) return run_pair<3>(q, k, v, o, B, Sq, Skv, H, sm_scale, st);
#endif
#if PFA_PAIR_NCHAIN_MAX >= 4
  if (nchain == 4) return run_pair<4>(q, k, v, o, B, Sq, Skv, H, sm_scale, st);
#endif
  return cudaErrorInvalidValue;
}

// K16. q (B, S, Hq, D), k/v (B, S, Hkv, D), o like q; bf16 or fp32 (dtype),
// D in {64, 128}, Hq % Hkv == 0.
extern "C" int pfa_flash_pipelined(const void* q, const void* k, const void* v, void* o, int B,
                                   int S, int Hq, int Hkv, int D, float sm_scale, int causal,
                                   int dtype, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == PFA_BF16 && D == 64)
    return run_pipelined<64, __nv_bfloat16>(q, k, v, o, B, S, Hq, Hkv, sm_scale, causal, st);
  if (dtype == PFA_BF16 && D == 128)
    return run_pipelined<128, __nv_bfloat16>(q, k, v, o, B, S, Hq, Hkv, sm_scale, causal, st);
  if (dtype == PFA_F32 && D == 64)
    return run_pipelined<64, float>(q, k, v, o, B, S, Hq, Hkv, sm_scale, causal, st);
  if (dtype == PFA_F32 && D == 128)
    return run_pipelined<128, float>(q, k, v, o, B, S, Hq, Hkv, sm_scale, causal, st);
  return cudaErrorInvalidValue;
}
