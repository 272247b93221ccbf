// The consumer tile step of the bf16 Hopper forwards, shared by K1
// (flash_fwd_sm90.cu) and the K14-K19 redesigns (flash_experiments_sm90.cu):
// a tile's Q K^T and P V issued as wgmma groups from 128-byte-swizzled
// shared memory, and the online-softmax update of its scores. A tile is
// BKV keys; ROWS is the row count of the shared-memory block it sits in
// (K1 and K19: one tile a stage, ROWS == BKV; K17: a chunk of tiles a
// stage, ROWS the chunk's keys), which sets the distance between a D 128
// operand's two 64-column halves.
#pragma once

#include "sm90.cuh"

// S = Q K^T over one tile: D / 16 key steps, Q (64 rows, K-major) at
// q_base, its halves BOX_BYTES apart; K (BKV rows, K-major) at k_base, its
// halves ROWS * 128 bytes apart; issued and committed as one group.
template <int D, int BKV, int ROWS = BKV>
__device__ __forceinline__ void qk_tile(float* sc, uint32_t q_base, uint32_t k_base) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t hf = kk / 4, koff = (kk % 4) * 32;
    wgmma_ss<BKV>(sc, sw128_desc(q_base + hf * BOX_BYTES + koff, 16),
                  sw128_desc(k_base + hf * ROWS * 128 + koff, 16), kk == 0);
  }
  wgmma_commit();
}

// O += P V over one tile: P's BKV / 16 key steps from registers, V (BKV x
// D, MN-major) from v_base, its halves ROWS * 128 bytes apart; issued and
// committed as one group.
template <int D, int BKV, int ROWS = BKV>
__device__ __forceinline__ void pv_tile(float* o_acc, uint32_t (&pa)[BKV / 16][4], uint32_t v_base) {
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk)
    wgmma_rs<D>(o_acc, pa[kk], sw128_desc(v_base + kk * 16 * 128, ROWS * 128));
  wgmma_commit();
}

// The online-softmax update of one tile of NS scores a thread (its rows
// row0 and row0 + 8): mx holds this thread's row maxima of the scores in
// the mode's units; m and l move on, alpha gets the factors that bring O
// to the new max, and sc becomes the probabilities. NATURAL: scores in
// natural units (p = 2^((s - m) log2 e)); else raw scores with the scale
// folded into the exponent, p = ex2(s * scale - m * scale), one FFMA and
// one ex2 a score (scale = sm_scale * log2 e > 0). SUM false leaves l
// alone: K14 takes the row sums from a product on the tensor cores.
template <int NS, bool NATURAL, bool SUM = true>
__device__ __forceinline__ void softmax_rows(float* sc, float (&mx)[2], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], float scale) {
  float nbase[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m[i], mx[i]);
    const float bs = m_new == -INFINITY ? 0.f : m_new;  // row fully masked so far
    if constexpr (NATURAL) {
      alpha[i] = ex2((m[i] - bs) * LOG2E);
      nbase[i] = bs;
    } else {
      nbase[i] = -bs * scale;
      alpha[i] = ex2(fmaf(m[i], scale, nbase[i]));
    }
    m[i] = m_new;
    if constexpr (SUM) l[i] *= alpha[i];
  }
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int r = (i >> 1) & 1;
    sc[i] = NATURAL ? ex2((sc[i] - nbase[r]) * LOG2E) : ex2(fmaf(sc[i], scale, nbase[r]));
    if constexpr (SUM) l[r] += sc[i];
  }
}
