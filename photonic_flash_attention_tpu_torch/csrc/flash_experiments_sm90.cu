// K13-K19 (bf16): the fixed-max, augmented-V, paired-chain, pipelined,
// chunked-staging, one-launch-per-row-block and full-triangle experiments
// of the flash forward, redesigned for Hopper (sm_90a): TMA loads, wgmma
// products and warp specialisation, K1's design (flash_fwd_sm90.cu) with
// each experiment's own lever kept. One body (x_body) serves all of them
// through four kernels: flash_exp_sm90<D, U> (K16-K19),
// flash_fixedmax_sm90<D, FAST> (K13), flash_aug_sm90 (K14) and
// flash_pair_sm90<nchain> (K15).
//
// Replace, in bf16, the TPU kernels benchmarks/flash_fixedmax_experiment.py::
// _kernel (K13: the online softmax given a bound M of each row's scaled
// scores, so no running max, no alpha and no rescale; JAX's Schraudolph
// exp in its fast_exp mode), benchmarks/flash_aug_experiment.py::
// _aug_kernel (K14: V augmented with a ones column, so the P V product also
// yields l, the sum of the bf16 p), benchmarks/flash_pair_experiment.py::
// _pair_kernel (K15: nchain q blocks, each its own online softmax against
// the same staged K/V tile), benchmarks/flash_pipeline_experiment.py::
// _kernel (K16: the KV loop pipelined so QK(j+1) is issued before
// softmax(j)), ::_kernel_chunked (K17: the KV loop in chunks of `unroll`
// tiles, one chunk a grid step, dead chunks skipped whole when causal),
// ::_kernel_tri (K18: one launch per q row-block, causal) and
// ::_kernel_fulltri (K19: grid (b, h), every q row-block of a head and its
// causal kv tiles in one body). They take the place of the mma.sync bodies
// of flash_experiments.cu (4 warps, 64 rows, cp.async copies by every
// thread, a __syncthreads a tile or chunk), which keep K16-K19's fp32
// inputs (TMA cannot convert on load) and K18's int8-QK mode; K13's, K14's
// and K15's are gone. The contract is the experiments' (that file's
// header): causal `col <= row` on square shapes (K14/K15: Sq and Skv
// apart; K13-K15: no GQA), GQA, p rounded to bf16 for P.V, fp32 sums, the
// output in bf16.
// K14 and K15 scale q by d^-0.5 in bf16 before Q K^T in JAX; at D 64 that
// scale is 2^-3, exact in bf16, so the scale folded into the exponent
// here is the same function.
//
// What bounds them on the H100: K1's work, so at D 64 and 128 over S 2k-8k
// the tensor cores and, at D 64, the softmax's FP32/MUFU stream beside them
// (989 TFLOP/s over 3.35 TB/s, the data sheet at 700 W). The design, K1's:
// * A CTA is three warpgroups: two consumers of 64 query rows each (a
//   128-row work tile) and a producer whose first warp issues every load by
//   TMA (a CUtensorMap per tensor over the (D, H, S, B) layout, 128-byte
//   swizzle). Q is double-buffered; K and V go through a ring of stages
//   with mbarriers ("full": the producer posts the boxes' bytes; "empty":
//   each consumer warp arrives once it is done with the stage). setmaxnreg
//   gives the producer 24 registers and the consumers 240. The ring's phases
//   and the Q buffers' run on across work tiles: nothing drains between
//   them, and the next tile's Q and first K/V are in flight while the
//   consumers finish this one's last tile and its epilogue.
// * S = Q K^T on wgmma with both operands in shared memory; O += P V with
//   P from registers and V an MN-major B operand (flash_sm90_step.cuh, K1's
//   tile step). Within a warpgroup tile j+1's Q K^T is issued ahead of tile
//   j's P V, and its softmax runs while that P V finishes; for K17 at D 128
//   and K16/K18 at D 64 the two warpgroups take turns at the tensor cores
//   (named barriers, FA3's ping-pong, PINGPONG): with 64-key tiles at D 64,
//   for K19 and for K16/K18 at D 128, the turns cost more than they hide.
//   p = ex2(s * scale - m * scale): the scale folded into the exponent, one
//   FFMA and one ex2 a score. Only
//   the tiles a warpgroup's diagonal or the ragged end reach take the
//   per-score predicate.
// * Ring depth: as many stages as fit in the 227 KB (x_max_stages). The
//   caller's plan (experiments/flash_pipeline_experiment.py::k16_plan to
//   k19_plan) gives the tile width, stages, shared memory and grid, which
//   the launcher checks against this file's constants, and the walk: the
//   q-blocks in the order the work tiles take them, each with its chunks
//   (K19: tiles) of keys, which the kernel reads as it is.
// K19 (U = 0): the grid is exactly B x Hq CTAs, one per (b, h), the
// function measured (48 CTAs at the headline B4 H12 for 132 SMs): each
// walks its head's 128-row q-blocks in the plan's order (heaviest, last,
// first), over key tiles
// of K1's width (128 at D 64, 96 at D 128: 128 spills there), one tile a
// stage. Six stages at D 64, three at D 128.
// K17 (U = 2, 4): a stage is one chunk of U 64-key tiles, loaded by TMA
// under ONE expect-tx on its "full" barrier (one box of U x 64 rows a
// column half); each consumer warpgroup waits once a chunk, runs the
// chunk's tiles unrolled at compile time (the Q K^T-ahead overlap running
// across tiles and across chunks) and arrives on "empty" once a chunk: one
// barrier a chunk against K1's one a tile is the experiment. The causal
// skip stays chunk-granular: a chunk runs when its first key is at or
// below the work tile's last row (q0 + 127), whole; its tiles past a
// warpgroup's diagonal run masked and each adds p = 0 with alpha = 1
// (every row sees key 0, so m is finite after the first tile). The grid
// is K1's persistent one (one CTA a SM, work tiles in snake order, causal
// q-blocks longest first). Stages at D 64: 6 (U 2) and 3 (U 4); at D 128:
// 2 (U 2) and 1 at U 4, whose chunk is 128 KB of K/V: there the producer
// cannot run ahead, and a chunk's last P V ends before the stage is freed
// and the next chunk's Q K^T issued (no cross-chunk overlap, CROSS).
// K16 and K18 (U = 1): K19's stage (one tile of K1's width; six stages at
// D 64, three at D 128) on K17's persistent grid, with K1's ping-pong at
// D 64. K16's lever, QK(j+1) issued before softmax(j), is the Q K^T-ahead
// overlap this body runs across stages (CROSS). K16 walks every 128-row
// q-block of S (causal: heaviest first, each to its diagonal; else over
// all of S). K18 is one launch per row-block [q_row0, q_row0 + rows): its
// walk names the q-blocks from q_row0 (any row) in steps of 128, each to
// its last row. The TMA box of Q reads past the row end (zeros past S);
// those rows are computed, every barrier arrived on, and not stored
// (row_end; S for K16, K17 and K19, whose walks start at row 0). The
// launches of one K18 call read q, k and v and write disjoint rows, so
// each after the first is a programmatic dependent launch (`chained`): a
// CTA lets the next launch start at its own start
// (griddepcontrol.launch_dependents) and waits, just before it exits, for
// the launch ahead of it to complete (griddepcontrol.wait): the next
// launch takes the SMs this one's tail frees, no launch completes before
// the one ahead of it, and whatever the stream runs after the call (a
// plain launch) sees every row. Only U = 1 holds the griddepcontrol
// instructions (XCfg::PDL; a no-op for K16's single launch).
// K14 (flash_aug_sm90): K16's instantiation at D 64 with the row sum moved
// onto the tensor cores. After each tile's Q K^T the softmax keeps its max
// and alpha but adds nothing into l (softmax_rows<..., SUM = false>); with
// the tile's P V, in the same wgmma group, one RS wgmma of N = 8 a key step
// multiplies the same bf16 P by a constant 16 x 8 block in shared memory
// whose column 0 is ones (256 bytes, no swizzle, written once by consumer
// threads before the first barrier, behind a proxy fence; TMA never loads
// it). Its 4 accumulator floats a thread hold l for the thread's rows in
// column 0 (lane t4 == 0 of each quad), rescaled by alpha with O; one
// __shfl_sync a row hands l to the quad at the store. l is the fp32 sum of
// the bf16-rounded p, as JAX's product and the plain version have it. What
// it buys: the FADD a score of the softmax's FP32 stream (about one of its
// ~7.5 CUDA-core instructions a score, the stream that sets K1's ceiling at
// D 64) for 1/8 more tensor-core work on P V.
// K15 (flash_pair_sm90<nchain>, nchain 1-4): a chain is one consumer
// warpgroup of 64 rows, a work tile nchain of them, and one TMA fill of a
// K/V stage serves every chain. The chains take turns at the tensor cores
// round robin (named barriers 1..nchain: FA3's ping-pong over nchain
// warpgroups), so one chain's exps run beside another's products; nchain
// 1 is one consumer warpgroup with no turns, the control. Each chain stops
// at its own diagonal (min(ceil((q0 + 64 c + 64) / tile), n) tiles; the
// producer loads the work tile's n, its last chain's); past it a chain
// issues no product but still takes and hands on its turn and arrives on
// each stage's "empty" barrier, so every named-barrier wait meets its
// arrival and the ring stays in step (the turns keep the chains within a
// turn of each other, far inside the ring). The CTA grows with nchain, so
// CONSUMERS, THREADS and the setmaxnreg split are the instantiation's
// (PAIR_*): at 512 and 640 threads a thread starts with 128 and 96
// registers, and the consumers get 160 and 112, the widest key tile that
// fits them with no spill being 128 keys at nchain 1-3 and 64 at 4.
// K13 (flash_fixedmax_sm90<D, FAST>): K16's instantiation (one tile of
// K1's width a stage, as many stages as fit, the Q K^T-ahead overlap, the
// ping-pong at D 64, K1's persistent grid) with the online softmax's step
// replaced by the fixed-max one. Each consumer thread reads the bound M
// (B, H, S) fp32 of its two rows once a work tile, with plain loads issued
// before it waits on Q, so they land under the first Q K^T. Per score: p =
// ex2(s * scale log2 e - M log2 e), one FFMA and one ex2, or with FAST
// JAX's arithmetic in natural units (x = s * scale - M, its FFMA with its
// fp32-rounded constants, the two clamps and the truncating F2I: fast_exp);
// l += p in fp32 over the unrounded p; no max, no shuffles, no alpha and no
// rescale of O (the final O / l cancels the uniform exp(m_true - M),
// exactly while M - m_true stays inside fp32's exp range, JAX's contract).
// The tiles the diagonal or the ragged end cross take the per-score mask
// (s = -inf: p = 0, or with FAST the clip's 2^-126, as JAX's). The
// epilogue is the body's: the quad sum of l, 1 / l (0 where l is 0: acc
// is 0 there, as JAX's l == 0 -> 1 gives).
// Not done: a TMA store of O, a cluster or split head for K19 (the
// function measured is one CTA a head).

#include <limits.h>
#include <string.h>

#include "flash_sm90_step.cuh"
#include "sm90.cuh"

namespace {

constexpr int MAX_QB = 512;       // q-blocks a head in the walk: S <= 65536 (K15 nchain 1: 32768)
constexpr int MAX_KEYS = 65536;   // K14/K15's Skv: at most 1024 tiles of 64 keys

// Dynamic shared memory of a ring of `stages`: Q double-buffered, K and V
// `stages` blocks each, K14's ones block, the mbarriers, 1024 bytes of
// alignment slack.
__host__ __device__ constexpr int x_smem(int q_bytes, int kv_bytes, int stages, int ones = 0) {
  return 2 * q_bytes + 2 * stages * kv_bytes + ones + 8 * (2 * stages + 4) + 1024;
}
__host__ __device__ constexpr int x_max_stages(int q_bytes, int kv_bytes, int ones = 0) {
  int s = 0;
  while (x_smem(q_bytes, kv_bytes, s + 1, ones) <= SMEM_MAX) ++s;
  return s;
}

// Which experiment an instantiation is: K16-K19 (told apart by U), K13, K14
// or K15.
enum XKind { PIPELINE = 0, FIXED = 13, AUG = 14, PAIR = 15 };

// K15 at nchain 1-4: the key tile (the widest whose consumer fits its
// register share with no spill, nvcc -Xptxas -v) and the setmaxnreg split.
// A CTA of 128 (nchain + 1) threads is launched with at most 65536 / that
// registers a thread (255, 168, 128, 96), and the split moves registers
// inside that allocation: producer + nchain x consumer <= 512, 504, 512, 480.
constexpr int PAIR_BKV[5] = {0, 128, 128, 128, 64};
constexpr int PAIR_PRODUCER_REGS[5] = {0, 56, 24, 32, 24};
constexpr int PAIR_CONSUMER_REGS[5] = {0, 256, 240, 160, 112};

// U = 0: K19 (one tile of K1's width a stage, one CTA per (b, h)); U = 1:
// K16 and K18 (the same stage on the persistent grid); U in {2, 4}: K17 (U
// 64-key tiles a stage). KIND AUG: K14, U = 1's instantiation with the row
// sum taken by a ones column's product; KIND PAIR: K15, NCHAIN consumer
// warpgroups (chains) on U = 1's stage, each chain to its own diagonal;
// KIND FIXED: K13, U = 1's instantiation with the fixed-max step (FAST:
// the Schraudolph exp).
template <int D_, int U, int KIND = PIPELINE, int NCHAIN = 2, bool FAST_ = false>
struct XCfg {
  static constexpr int D = D_;
  static constexpr bool IS_FIXED = KIND == FIXED;
  static constexpr bool FAST = FAST_;
  static constexpr bool IS_AUG = KIND == AUG;
  static constexpr bool IS_PAIR = KIND == PAIR;
  static constexpr bool XKV = IS_AUG || IS_PAIR;  // Skv may differ from Sq
  static constexpr int CONSUMERS = IS_PAIR ? NCHAIN : 2;  // consumer warpgroups
  static constexpr int THREADS = 128 * (CONSUMERS + 1);
  static constexpr int BQ = 64 * CONSUMERS;  // query rows a work tile
  static constexpr int PRODUCER_REGS = IS_PAIR ? PAIR_PRODUCER_REGS[NCHAIN] : 24;
  static constexpr int CONSUMER_REGS = IS_PAIR ? PAIR_CONSUMER_REGS[NCHAIN] : 240;
  static constexpr bool FULLTRI = U == 0;
  static constexpr bool WIDE = U <= 1;  // a stage is one tile of K1's width
  static constexpr int BKV = IS_PAIR ? PAIR_BKV[NCHAIN] : WIDE ? (D == 128 ? 96 : 128) : 64;
  static constexpr int TILES = WIDE ? 1 : U;                     // tiles a stage
  static constexpr int SPAN = BKV * TILES;                          // keys a stage
  static constexpr int HALVES = D / 64;  // 128-byte column boxes a row
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = SPAN * D * 2;  // K or V, one stage; a multiple of 1024
  // K14's B operand of the ones product: two 8 x 16-byte core matrices.
  static constexpr int ONES_BYTES = IS_AUG ? 256 : 0;
  static constexpr int STAGES = x_max_stages(Q_BYTES, KV_BYTES, ONES_BYTES);  // the ring's depth
  // The next chunk's Q K^T issued before this chunk's last P V: the
  // consumers then hold two stages.
  static constexpr bool CROSS = STAGES >= 2;
  // The warpgroups' turns at the tensor cores: on only where they paid
  // (PERF.md, the K16-K19 lever tables): K17 at D 128, K16/K18 (and K13 and
  // K14, their instantiation) at D 64; K15's chains always take turns,
  // round robin, where there is more than one.
  static constexpr bool PINGPONG =
      IS_PAIR ? NCHAIN >= 2 : (U >= 2 && D == 128) || (U == 1 && D == 64);
  // K18's launches chain (griddepcontrol; a no-op for K16's single launch).
  static constexpr bool PDL = U == 1 && KIND == PIPELINE;
};

template <int D, bool FAST>
using FixedCfg = XCfg<D, 1, FIXED, 2, FAST>;
using AugCfg = XCfg<64, 1, AUG>;
template <int NCHAIN>
using PairCfg = XCfg<64, 1, PAIR, NCHAIN>;

struct XParams {
  __nv_bfloat16* o;
  int B, S, Hq, Hkv;  // S: the query rows (K14/K15: Sq)
  int n_work;  // work tiles: q-blocks x Hq x B
  int nqb;     // q-blocks of BQ rows a head in the walk
  float scale;  // sm_scale * log2 e (K13's fast_exp: sm_scale)
  int causal;
  // The plan's walk: entry i is the i-th q-block taken (K19: a CTA's i-th
  // round; K14-K18: the work tiles t with t / (Hq B) == i), as its first
  // row << 11 | its chunks of keys (at most 1024).
  int walk[MAX_QB];
  int row_end;  // rows from here on are not stored (K18: its row-block's end; else S)
  int Skv;      // the keys (K16-K19: S)
  const float* fm;  // K13: the bound M of each row's scaled scores, (B, H, S) fp32
};

// One work tile: BQ query rows of one (batch row, head) and the chunks
// (K19: tiles) of keys its rows can see.
struct XWork {
  int h, b, q0, n_chunks;
};

// This CTA's n-th work tile; false where the last round has none. K19: the
// CTA's head, the walk's n-th q-block; K14-K18: K1's snake order over
// (heads, batch rows, the walk's q-blocks).
template <class C>
__device__ __forceinline__ bool x_work(const XParams& p, int n, XWork& w) {
  int i = n;
  if constexpr (C::FULLTRI) {
    w.h = blockIdx.x % p.Hq;
    w.b = blockIdx.x / p.Hq;
  } else {
    const int t = snake_tile(n);
    if (t >= p.n_work) return false;
    w.h = t % p.Hq;
    const int r = t / p.Hq;
    w.b = r % p.B;
    i = r / p.B;
  }
  w.q0 = p.walk[i] >> 11;
  w.n_chunks = p.walk[i] & 0x7ff;
  return true;
}

// The Schraudolph bit-trick exp of K13's fast_exp mode, with JAX's
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

// The raw scores of one tile, in place, with MASKED the per-score predicate
// (-inf past the keys or, causal, above the row); mx gets this thread's row
// maxima.
template <int BKV, bool MASKED>
__device__ __forceinline__ void tile_max(float* sc, float (&mx)[2], int kv0, int row0, int t4,
                                         int S, int causal) {
#pragma unroll
  for (int j = 0; j < BKV / 8; ++j) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float x[2] = {sc[4 * j + 2 * rr], sc[4 * j + 2 * rr + 1]};
      if constexpr (MASKED) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = kv0 + 8 * j + 2 * t4 + e;
          if (col >= S || (causal && col > row0 + 8 * rr)) x[e] = -INFINITY;
        }
      }
      sc[4 * j + 2 * rr] = x[0];
      sc[4 * j + 2 * rr + 1] = x[1];
      mx[rr] = fmaxf(mx[rr], fmaxf(x[0], x[1]));
    }
  }
}

// K13: a tile's masked scores to -inf in place (past the keys or, causal,
// above the row), as tile_max's MASKED, with no maxima.
template <int BKV>
__device__ __forceinline__ void tile_mask(float* sc, int kv0, int row0, int t4, int S,
                                          int causal) {
#pragma unroll
  for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = kv0 + 8 * j + 2 * t4 + (i & 1);
      if (col >= S || (causal && col > row0 + 8 * (i >> 1))) sc[4 * j + i] = -INFINITY;
    }
}

// K13's step over one tile of NS scores a thread (rows row0 and row0 + 8),
// in place: p = ex2(s * scale + nb) with scale = sm_scale log2 e and nb =
// -M log2 e, or with FAST fast_exp(s * scale + nb) with scale = sm_scale
// and nb = -M (natural units, JAX's); l += p.
template <int NS, bool FAST>
__device__ __forceinline__ void fixed_rows(float* sc, const float (&nb)[2], float (&l)[2],
                                           float scale) {
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int r = (i >> 1) & 1;
    const float x = fmaf(sc[i], scale, nb[r]);
    sc[i] = FAST ? fast_exp(x) : ex2(x);
    l[r] += sc[i];
  }
}

template <bool V>
struct Flag {
  static constexpr bool value = V;
};

// K14's l += P 1 over one tile: the ones block (no_swizzle_desc) as the B
// operand of each key step, N = 8, issued just before the tile's P V and
// committed with it, so the two are one wgmma group and the body's group
// counts hold.
template <int BKV>
__device__ __forceinline__ void ones_tile(float (&o_aug)[4], uint32_t (&pa)[BKV / 16][4],
                                          uint64_t ones_desc) {
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk) wgmma_rs_n8(o_aug, pa[kk], ones_desc);
}

// The body every instantiation runs: the kernels below differ only in C.
template <class C>
__device__ __forceinline__ void x_body(const CUtensorMap& tm_q, const CUtensorMap& tm_k,
                                       const CUtensorMap& tm_v, const XParams& p) {
  constexpr int D = C::D, BKV = C::BKV, TILES = C::TILES, SPAN = C::SPAN;
  constexpr int CONSUMERS = C::CONSUMERS;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms need 1024-byte alignment
  constexpr int stages = C::STAGES;
  const uint32_t off_k = 2 * C::Q_BYTES, off_v = off_k + stages * C::KV_BYTES;
  const uint32_t ones = base + off_v + stages * C::KV_BYTES;  // K14's ones block
  const uint32_t bar_full = ones + C::ONES_BYTES, bar_empty = bar_full + 8 * stages;
  const uint32_t bar_qfull = bar_empty + 8 * stages, bar_qempty = bar_qfull + 16;
  const int rounds = C::FULLTRI ? p.nqb : (p.n_work + gridDim.x - 1) / gridDim.x;
  if constexpr (C::PDL) pdl_launch_dependents();

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, CONSUMERS * 4);  // one arrival a consumer warp
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(bar_qfull + 8 * s, 1);
      mbar_init(bar_qempty + 8 * s, CONSUMERS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (C::IS_AUG) {
    // K14's B operand, written once and never loaded: 16 keys x 8 columns,
    // K-major, column 0 ones (bf16 0x3F80), in two 8 x 16-byte core
    // matrices (keys 0-7 and 8-15) whose row 0 is ones and rows 1-7 zero;
    // every key step of every tile reads the same block.
    if (threadIdx.x < 64)
      reinterpret_cast<uint32_t*>(smem_raw + (ones - raw))[threadIdx.x] =
          (threadIdx.x & 31) < 4 ? 0x3F803F80u : 0u;
    fence_proxy_async();  // visible to the wgmma that read it
  }
  __syncthreads();

  // Warp-uniform in the compiler's eyes (a shuffled value): the roles'
  // branches, and the wgmma in them, are uniform.
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int warp = __shfl_sync(0xffffffffu, (threadIdx.x / 32) % 4, 0), lane = threadIdx.x % 32;
  if (wg == CONSUMERS) {
    // --- producer: its first warp issues every load -------------------------
    setmaxnreg_dec<C::PRODUCER_REGS>();
    if (warp != 0) return;
    int st = 0;        // the ring's stage, over all work tiles
    uint32_t ph = 0;   // and its phase
    for (int n = 0; n < rounds; ++n) {
      XWork w;
      if (!x_work<C>(p, n, w)) continue;  // the last round only
      const int hk = w.h / (p.Hq / p.Hkv);
      const uint32_t qf = bar_qfull + 8 * (n & 1);
      mbar_wait(bar_qempty + 8 * (n & 1), ((n >> 1) & 1) ^ 1);
      if (lane == 0) {
        mbar_expect_tx(qf, C::Q_BYTES);
        for (int r = 0; r < CONSUMERS; ++r)
          for (int hf = 0; hf < C::HALVES; ++hf)
            tma_load_4d(base + (n & 1) * C::Q_BYTES + (r * C::HALVES + hf) * BOX_BYTES, &tm_q, qf,
                        hf * 64, w.h, w.q0 + r * 64, w.b);
      }
      // K15: the work tile's tiles are its last chain's; each chain runs a
      // prefix of them.
      for (int c = 0; c < w.n_chunks; ++c) {
        const uint32_t full = bar_full + 8 * st;
        mbar_wait(bar_empty + 8 * st, ph ^ 1);
        if (lane == 0) {  // one expect-tx a stage, whatever the tiles in it
          mbar_expect_tx(full, 2 * C::KV_BYTES);
          for (int hf = 0; hf < C::HALVES; ++hf) {
            tma_load_4d(base + off_k + st * C::KV_BYTES + hf * SPAN * 128, &tm_k, full, hf * 64,
                        hk, c * SPAN, w.b);
            tma_load_4d(base + off_v + st * C::KV_BYTES + hf * SPAN * 128, &tm_v, full, hf * 64,
                        hk, c * SPAN, w.b);
          }
        }
        __syncwarp();
        if (++st == stages) st = 0, ph ^= 1;
      }
    }
  } else {
    // --- consumers: 64 query rows each ---------------------------------------
    setmaxnreg_inc<C::CONSUMER_REGS>();
    constexpr int NS = BKV / 2, NO = D / 2;  // accumulator floats a thread
    const int g = lane / 4, t4 = lane % 4;
    constexpr bool pp = C::PINGPONG;
    // Ping-pong: named barrier 1 + wg is this warpgroup's turn to issue its
    // products, handed on round robin; warpgroup 0 goes first in each work
    // tile, and the last turn of the last warpgroup hands nothing on, so
    // every wait has its arrival. Each warpgroup takes the same number of
    // turns in a work tile (K15: a chain past its diagonal too, with no
    // product).
    auto turn_begin = [&] {
      if constexpr (pp) named_bar_sync(1 + wg, 2 * 128);
    };
    auto turn_end = [&](bool last) {
      if constexpr (pp) {
        const bool next = wg + 1 < CONSUMERS;
        if (next || !last) named_bar_arrive(next ? wg + 2 : 1, 2 * 128);
      }
    };
    auto release = [&](uint32_t bar) {  // this warp is done with what `bar` guards
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    // K14: column 0 of o_aug (lane t4 == 0 of a quad) gathers l, the sum of
    // the bf16 P of the thread's rows, rescaled by alpha with O.
    const uint64_t ones_desc = no_swizzle_desc(ones, 128, 128);
    float sc[NS], o_acc[NO], o_aug[4];
    uint32_t pa[BKV / 16][4];
    int st = 0;       // the ring's stage, over all work tiles
    uint32_t ph = 0;  // and its phase
    for (int n = 0; n < rounds; ++n) {
      XWork w;
      if (!x_work<C>(p, n, w)) continue;  // the last round only
      const int q0 = w.q0, nc = w.n_chunks;
      const int wrow = q0 + wg * 64;          // the warpgroup's first row
      const int row0 = wrow + warp * 16 + g;  // this thread's rows: row0, row0 + 8
      // K15: this chain's tiles, up to its own diagonal (nc: the last chain's).
      int own = nc;
      if constexpr (C::IS_PAIR) own = min((wrow + 64 + BKV - 1) / BKV, nc);
      const uint32_t q_base = base + (n & 1) * C::Q_BYTES + wg * C::HALVES * BOX_BYTES;
#pragma unroll
      for (int i = 0; i < NO; ++i) o_acc[i] = 0.f;
      if constexpr (C::IS_AUG) {
#pragma unroll
        for (int i = 0; i < 4; ++i) o_aug[i] = 0.f;
      }
      float m[2] = {-INFINITY, -INFINITY};  // running max of the raw scores
      float l[2] = {0.f, 0.f};              // this thread's share of the running sum
      // K13: -M of this thread's rows in the exponent's units (0 past S),
      // loaded before the wait on Q so the loads land under the first Q K^T.
      float nb[2];
      if constexpr (C::IS_FIXED) {
        const float* mrow = p.fm + ((long long)w.b * p.Hq + w.h) * p.S;
#pragma unroll
        for (int i = 0; i < 2; ++i)
          nb[i] = row0 + 8 * i < p.S ? -mrow[row0 + 8 * i] * (C::FAST ? 1.f : LOG2E) : 0.f;
      }
      mbar_wait(bar_qfull + 8 * (n & 1), (n >> 1) & 1);
      if constexpr (pp)
        if (wg == CONSUMERS - 1) named_bar_arrive(1, 2 * 128);  // every work tile has a chunk

      auto k_at = [&](int s, int u) { return base + off_k + s * C::KV_BYTES + u * BKV * 128; };
      auto v_at = [&](int s, int u) { return base + off_v + s * C::KV_BYTES + u * BKV * 128; };
      auto softmax = [&](int kv0, float (&alpha)[2]) {  // tile kv0's scores in sc to P
        if constexpr (C::IS_FIXED) {  // no max, no alpha
          if (kv0 + BKV > p.Skv || (p.causal && kv0 + BKV - 1 > wrow))
            tile_mask<BKV>(sc, kv0, row0, t4, p.Skv, p.causal);
          fixed_rows<NS, C::FAST>(sc, nb, l, p.scale);
        } else {
          float mx[2] = {-INFINITY, -INFINITY};
          if (kv0 + BKV > p.Skv || (p.causal && kv0 + BKV - 1 > wrow))
            tile_max<BKV, true>(sc, mx, kv0, row0, t4, p.Skv, p.causal);
          else
            tile_max<BKV, false>(sc, mx, kv0, row0, t4, p.Skv, p.causal);
          softmax_rows<NS, false, !C::IS_AUG>(sc, mx, m, l, alpha, p.scale);
        }
      };
      // Tile u of stage st holds its P in pa: issue the next tile's Q K^T
      // (tile u + 1 of this stage, or with CROSS tile 0 of the next stage,
      // the next chunk) ahead of tile u's P V, run the next tile's softmax
      // while that P V finishes, then rescale O (K13: nothing to rescale)
      // and take the next P. A stage is freed after its last tile's P V.
      auto step = [&](int u, auto cross_flag, int kv0_next) {
        constexpr bool cross = decltype(cross_flag)::value;
        const int sn = cross ? (st + 1 == stages ? 0 : st + 1) : st;
        const uint32_t phn = cross && st + 1 == stages ? ph ^ 1 : ph;
        float alpha[2];
        if constexpr (!cross || C::CROSS) {
          if constexpr (cross) mbar_wait(bar_full + 8 * sn, phn);
          turn_begin();
          wgmma_fence();
          qk_tile<D, BKV, SPAN>(sc, q_base, k_at(sn, cross ? 0 : u + 1));
          if constexpr (C::IS_AUG) ones_tile<BKV>(o_aug, pa, ones_desc);
          pv_tile<D, BKV, SPAN>(o_acc, pa, v_at(st, u));
          turn_end(false);
          wgmma_wait<1>();
          fence_regs(sc);
          softmax(kv0_next, alpha);
          wgmma_wait<0>();
          fence_regs(o_acc);
          if constexpr (C::IS_AUG) fence_regs(o_aug);
          if constexpr (cross) release(bar_empty + 8 * st);
        } else {
          // One stage: this chunk's last P V, the stage freed, then the
          // next chunk's Q K^T once it has landed.
          turn_begin();
          wgmma_fence();
          if constexpr (C::IS_AUG) ones_tile<BKV>(o_aug, pa, ones_desc);
          pv_tile<D, BKV, SPAN>(o_acc, pa, v_at(st, u));
          turn_end(false);
          wgmma_wait<0>();
          fence_regs(o_acc);
          if constexpr (C::IS_AUG) fence_regs(o_aug);
          release(bar_empty + 8 * st);
          mbar_wait(bar_full + 8 * sn, phn);
          turn_begin();
          wgmma_fence();
          qk_tile<D, BKV, SPAN>(sc, q_base, k_at(sn, 0));
          turn_end(false);
          wgmma_wait<0>();
          fence_regs(sc);
          softmax(kv0_next, alpha);
        }
        if constexpr (!C::IS_FIXED) {
#pragma unroll
          for (int i = 0; i < NO; ++i) o_acc[i] *= alpha[(i >> 1) & 1];
        }
        if constexpr (C::IS_AUG) {
#pragma unroll
          for (int i = 0; i < 4; ++i) o_aug[i] *= alpha[(i >> 1) & 1];
        }
        pack_frag<BKV>(pa, sc);
        if constexpr (cross) st = sn, ph = phn;
      };

      // The first tile, peeled: no product is issued under a branch.
      mbar_wait(bar_full + 8 * st, ph);
      turn_begin();
      wgmma_fence();
      qk_tile<D, BKV, SPAN>(sc, q_base, k_at(st, 0));
      turn_end(false);
      wgmma_wait<0>();
      fence_regs(sc);
      {
        float alpha[2];  // O is 0: nothing to rescale
        softmax(0, alpha);
      }
      pack_frag<BKV>(pa, sc);
      for (int c = 0; c + 1 < own; ++c) {
#pragma unroll
        for (int u = 0; u + 1 < TILES; ++u) step(u, Flag<false>{}, c * SPAN + (u + 1) * BKV);
        step(TILES - 1, Flag<true>{}, (c + 1) * SPAN);
      }
#pragma unroll
      for (int u = 0; u + 1 < TILES; ++u) step(u, Flag<false>{}, (own - 1) * SPAN + (u + 1) * BKV);
      // The last tile's P V.
      turn_begin();
      wgmma_fence();
      if constexpr (C::IS_AUG) ones_tile<BKV>(o_aug, pa, ones_desc);
      pv_tile<D, BKV, SPAN>(o_acc, pa, v_at(st, TILES - 1));
      turn_end(!C::IS_PAIR || own == nc);
      wgmma_wait<0>();
      fence_regs(o_acc);
      if constexpr (C::IS_AUG) fence_regs(o_aug);
      release(bar_empty + 8 * st);
      if (++st == stages) st = 0, ph ^= 1;
      if constexpr (C::IS_PAIR) {
        // K15: the tiles past this chain's diagonal, which the later chains
        // run: no product, but the turn taken and handed on and the stage
        // released, so the others' turns and the producer's waits meet
        // their arrivals (the turns keep the chains within one turn of each
        // other, far inside the ring).
        for (int c = own; c < nc; ++c) {
          turn_begin();
          turn_end(c + 1 == nc);
          release(bar_empty + 8 * st);
          if (++st == stages) st = 0, ph ^= 1;
        }
      }
      release(bar_qempty + 8 * (n & 1));

#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if constexpr (C::IS_AUG) {
          // l sits in column 0 of the ones product: lane t4 == 0 of the
          // quad holds it for the quad's rows; one shuffle a row.
          l[i] = __shfl_sync(0xffffffffu, o_aug[2 * i], lane & ~3);
        } else {
          l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
          l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
        }
        const int row = row0 + 8 * i;
        if (row >= p.row_end) continue;
        const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
        __nv_bfloat16* orow = p.o + (((long long)w.b * p.S + row) * p.Hq + w.h) * D;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          store2(orow + 8 * j + 2 * t4, o_acc[4 * j + 2 * i] * inv, o_acc[4 * j + 2 * i + 1] * inv);
      }
    }
    // The CTA exits after its consumers: not before the launch ahead of it.
    if constexpr (C::PDL) pdl_wait();
  }
}

// K16-K19: flash_exp_sm90<D, U>.
template <int D, int U>
__global__ void __launch_bounds__(XCfg<D, U>::THREADS, 1)
flash_exp_sm90(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ XParams p) {
  x_body<XCfg<D, U>>(tm_q, tm_k, tm_v, p);
}

// K13 (FAST: the Schraudolph exp).
template <int D, bool FAST>
__global__ void __launch_bounds__(FixedCfg<D, FAST>::THREADS, 1)
flash_fixedmax_sm90(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ XParams p) {
  x_body<FixedCfg<D, FAST>>(tm_q, tm_k, tm_v, p);
}

// K14 (D 64).
__global__ void __launch_bounds__(AugCfg::THREADS, 1)
flash_aug_sm90(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ XParams p) {
  x_body<AugCfg>(tm_q, tm_k, tm_v, p);
}

// K15 at NCHAIN chains (D 64).
template <int NCHAIN>
__global__ void __launch_bounds__(PairCfg<NCHAIN>::THREADS, 1)
flash_pair_sm90(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ XParams p) {
  x_body<PairCfg<NCHAIN>>(tm_q, tm_k, tm_v, p);
}

// --- host side -------------------------------------------------------------------

// setmaxnreg moves registers inside the CTA's allocation at launch: the
// split must fit it (THREADS x the kernel's registers), the consumers'
// count must not be below it and the producer's not above it, or a
// setmaxnreg.inc would wait for ever. Read once an instantiation.
template <class C, class Kernel>
bool x_regs_fit(Kernel kernel) {
  static const int regs = [kernel] {
    cudaFuncAttributes a;
    return cudaFuncGetAttributes(&a, kernel) == cudaSuccess ? a.numRegs : 0;
  }();
  return C::PRODUCER_REGS <= regs && regs <= C::CONSUMER_REGS &&
         C::THREADS * regs >= 128 * (C::PRODUCER_REGS + C::CONSUMERS * C::CONSUMER_REGS);
}

// The launch a plan describes: rows [row0, row0 + rows) of S query rows
// against Skv keys (K18: its row-block; else all of S; Skv == S but for
// K14/K15); its tile width, stages, shared memory and grid must be this
// instantiation's (K19's grid B x Hq, else at most the work tiles), and
// its walk (q0, chunks) x ceil(rows / BQ) must name q-blocks that start at
// row0 + BQ i inside the rows, with 1 to all of Skv's chunks each, else
// cudaErrorInvalidValue. `chained`: a programmatic dependent launch (K18).
// `fm`: K13's row bound.
template <class C, class Kernel>
cudaError_t x_launch(Kernel kernel, const void* q, const void* k, const void* v, void* o, int B,
                     int S, int Skv, int Hq, int Hkv, float sm_scale, int causal, int row0,
                     int rows, bool chained, int tile_keys, int stages, int smem, int grid,
                     const int* walk, cudaStream_t stream, const float* fm = nullptr) {
  const long long nqb = (rows + C::BQ - 1LL) / C::BQ, work = nqb * Hq * B;
  if (tile_keys != C::BKV || stages != C::STAGES ||
      smem != x_smem(C::Q_BYTES, C::KV_BYTES, C::STAGES, C::ONES_BYTES) ||
      S > MAX_QB * C::BQ || Skv < 1 || Skv > (C::XKV ? MAX_KEYS : S) || row0 < 0 || rows < 1 ||
      (long long)row0 + rows > S || nqb > MAX_QB || work > INT_MAX ||
      (C::FULLTRI ? (long long)grid != (long long)B * Hq : (grid < 1 || grid > work)) ||
      !x_regs_fit<C>(kernel))
    return cudaErrorInvalidValue;
  // The scale in the exponent's units: log2 (K13's fast_exp: natural).
  const float scale = C::IS_FIXED && C::FAST ? sm_scale : sm_scale * LOG2E;
  XParams p{static_cast<__nv_bfloat16*>(o), B, S, Hq, Hkv, static_cast<int>(work),
            static_cast<int>(nqb), scale, C::FULLTRI ? 1 : causal, {}, row0 + rows, Skv, fm};
  const int chunks = (Skv + C::SPAN - 1) / C::SPAN;
  for (int i = 0; i < nqb; ++i) {
    const int q0 = walk[2 * i], n = walk[2 * i + 1];
    if (q0 < row0 || q0 >= row0 + rows || (q0 - row0) % C::BQ || n < 1 || n > chunks)
      return cudaErrorInvalidValue;
    p.walk[i] = q0 << 11 | n;
  }
  CUtensorMap tq, tk, tv;
  const auto bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const uint32_t span = C::SPAN;
  const uint64_t d = C::D, b = B;
  if (!encode_4d(&tq, bf16, 2, q, {d, (uint64_t)Hq, (uint64_t)S, b}, {64, 1, 64, 1}) ||
      !encode_4d(&tk, bf16, 2, k, {d, (uint64_t)Hkv, (uint64_t)Skv, b}, {64, 1, span, 1}) ||
      !encode_4d(&tv, bf16, 2, v, {d, (uint64_t)Hkv, (uint64_t)Skv, b}, {64, 1, span, 1}))
    return cudaErrorInvalidValue;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  return launch_chained(kernel, chained, grid, C::THREADS, smem, stream, tq, tk, tv, p);
}

// The design of one instantiation: keys a tile, the ring's stages, dynamic
// shared memory, threads a CTA, CTAs a SM, the producer's and the
// consumers' registers, 1 with the cross-chunk overlap, 1 with the
// ping-pong.
template <class C, class Kernel>
cudaError_t x_info(Kernel kernel, int* out) {
  const int smem = x_smem(C::Q_BYTES, C::KV_BYTES, C::STAGES, C::ONES_BYTES);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  out[0] = C::BKV, out[1] = C::STAGES, out[2] = smem, out[3] = C::THREADS;
  out[5] = C::PRODUCER_REGS, out[6] = C::CONSUMER_REGS, out[7] = C::CROSS, out[8] = C::PINGPONG;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[4], kernel, C::THREADS, smem);
}

bool x_args_ok(const void* q, const void* k, const void* v, const void* o, int B, int S, int Hq,
               int Hkv, float sm_scale) {
  // TMA reads 16-byte-aligned bases; the max is kept on the raw scores and
  // the scale applied inside the exponent, which needs a scale > 0.
  return B > 0 && S > 0 && Hkv > 0 && Hq % Hkv == 0 && aligned16(q) && aligned16(k) &&
         aligned16(v) && aligned16(o) && sm_scale > 0.f;
}

}  // namespace

// K17 in bf16. q (B, S, Hq, D), k/v (B, S, Hkv, D), o like q; D in {64,
// 128}, Hq % Hkv == 0, 16-byte-aligned bases, sm_scale > 0; unroll (64-key
// tiles a chunk) in {2, 4}; tile_keys, stages, smem, grid and walk ((q0,
// chunks) for each of the ceil(S / 128) q-blocks, S <= 65536) from k17_plan.
extern "C" int pfa_flash_chunked_sm90(const void* q, const void* k, const void* v, void* o, int B,
                                      int S, int Hq, int Hkv, int D, float sm_scale, int causal,
                                      int unroll, int tile_keys, int stages, int smem, int grid,
                                      const int* walk, void* stream) {
  if (!x_args_ok(q, k, v, o, B, S, Hq, Hkv, sm_scale)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PFA_K17(DD, UU)                                                                       \
  if (D == DD && unroll == UU)                                                                \
    return x_launch<XCfg<DD, UU>>(flash_exp_sm90<DD, UU>, q, k, v, o, B, S, S, Hq, Hkv,       \
                                  sm_scale, causal, 0, S, false, tile_keys, stages, smem, grid, \
                                  walk, st);
  PFA_K17(64, 2)
  PFA_K17(64, 4)
  PFA_K17(128, 2)
  PFA_K17(128, 4)
#undef PFA_K17
  return cudaErrorInvalidValue;
}

// K19 in bf16. q (B, S, Hq, D), k/v (B, S, Hkv, D), o like q, causal; D in
// {64, 128}, Hq % Hkv == 0, 16-byte-aligned bases, sm_scale > 0;
// tile_keys, stages, smem, grid (B x Hq) and walk (as K17's) from k19_plan.
extern "C" int pfa_flash_fulltri_sm90(const void* q, const void* k, const void* v, void* o, int B,
                                      int S, int Hq, int Hkv, int D, float sm_scale, int tile_keys,
                                      int stages, int smem, int grid, const int* walk,
                                      void* stream) {
  if (!x_args_ok(q, k, v, o, B, S, Hq, Hkv, sm_scale)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return x_launch<XCfg<64, 0>>(flash_exp_sm90<64, 0>, q, k, v, o, B, S, S, Hq, Hkv, sm_scale, 1,
                                 0, S, false, tile_keys, stages, smem, grid, walk, st);
  if (D == 128)
    return x_launch<XCfg<128, 0>>(flash_exp_sm90<128, 0>, q, k, v, o, B, S, S, Hq, Hkv, sm_scale,
                                  1, 0, S, false, tile_keys, stages, smem, grid, walk, st);
  return cudaErrorInvalidValue;
}

// K16 in bf16. q (B, S, Hq, D), k/v (B, S, Hkv, D), o like q, causal or
// not; D in {64, 128}, Hq % Hkv == 0, 16-byte-aligned bases, sm_scale > 0;
// tile_keys, stages, smem, grid and walk ((q0, tiles) for each of the
// ceil(S / 128) q-blocks, S <= 65536) from k16_plan.
extern "C" int pfa_flash_pipelined_sm90(const void* q, const void* k, const void* v, void* o,
                                        int B, int S, int Hq, int Hkv, int D, float sm_scale,
                                        int causal, int tile_keys, int stages, int smem, int grid,
                                        const int* walk, void* stream) {
  if (!x_args_ok(q, k, v, o, B, S, Hq, Hkv, sm_scale)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return x_launch<XCfg<64, 1>>(flash_exp_sm90<64, 1>, q, k, v, o, B, S, S, Hq, Hkv, sm_scale,
                                 causal, 0, S, false, tile_keys, stages, smem, grid, walk, st);
  if (D == 128)
    return x_launch<XCfg<128, 1>>(flash_exp_sm90<128, 1>, q, k, v, o, B, S, S, Hq, Hkv, sm_scale,
                                  causal, 0, S, false, tile_keys, stages, smem, grid, walk, st);
  return cudaErrorInvalidValue;
}

// K18 in bf16: one launch, query rows [q_row0, q_row0 + rows) of q (B, S,
// Hq, D) against k/v (B, S, Hkv, D), causal, written into o (like q) in
// place; D in {64, 128}, Hq % Hkv == 0, 16-byte-aligned bases, sm_scale >
// 0, S <= 65536; tile_keys, stages, smem, grid and walk ((q0, tiles) for
// each of the ceil(rows / 128) q-blocks) from k18_plan. `chained` (every
// launch of a call after its first): a programmatic dependent launch on
// the one ahead of it in the stream.
extern "C" int pfa_flash_tri_sm90(const void* q, const void* k, const void* v, void* o, int B,
                                  int S, int Hq, int Hkv, int D, int q_row0, int rows,
                                  float sm_scale, int chained, int tile_keys, int stages, int smem,
                                  int grid, const int* walk, void* stream) {
  if (!x_args_ok(q, k, v, o, B, S, Hq, Hkv, sm_scale)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return x_launch<XCfg<64, 1>>(flash_exp_sm90<64, 1>, q, k, v, o, B, S, S, Hq, Hkv, sm_scale, 1,
                                 q_row0, rows, chained != 0, tile_keys, stages, smem, grid, walk,
                                 st);
  if (D == 128)
    return x_launch<XCfg<128, 1>>(flash_exp_sm90<128, 1>, q, k, v, o, B, S, S, Hq, Hkv, sm_scale,
                                  1, q_row0, rows, chained != 0, tile_keys, stages, smem, grid,
                                  walk, st);
  return cudaErrorInvalidValue;
}

// K13 in bf16. q, k, v (B, S, H, D), o like q, fm (B, H, S) fp32 the bound
// M of each row's scaled scores (experiments/flash_fixedmax_experiment.py::
// fixed_max_bound), causal (col <= row) or not; D in {64, 128}, 16-byte-
// aligned q, k, v and o, sm_scale > 0, S <= 65536; fast_exp: JAX's
// Schraudolph exp; tile_keys, stages, smem, grid and walk ((q0, tiles) for
// each of the ceil(S / 128) q-blocks) from k13_plan.
extern "C" int pfa_flash_fixedmax_sm90(const void* q, const void* k, const void* v, void* o,
                                       const void* fm, int B, int S, int H, int D,
                                       float sm_scale, int causal, int fast_exp, int tile_keys,
                                       int stages, int smem, int grid, const int* walk,
                                       void* stream) {
  if (fm == nullptr || !x_args_ok(q, k, v, o, B, S, H, H, sm_scale)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(fm);
#define PFA_K13(DD, FF)                                                                     \
  if (D == DD && (fast_exp != 0) == FF)                                                     \
    return x_launch<FixedCfg<DD, FF>>(flash_fixedmax_sm90<DD, FF>, q, k, v, o, B, S, S, H, H, \
                                      sm_scale, causal, 0, S, false, tile_keys, stages, smem, \
                                      grid, walk, st, m);
  PFA_K13(64, false)
  PFA_K13(64, true)
  PFA_K13(128, false)
  PFA_K13(128, true)
#undef PFA_K13
  return cudaErrorInvalidValue;
}

// K14 in bf16. q (B, Sq, H, 64), k/v (B, Skv, H, 64), o like q, causal
// (col <= row); 16-byte-aligned bases, sm_scale > 0, Sq <= 65536, Skv <=
// 65536; tile_keys, stages, smem, grid and walk ((q0, tiles) for each of
// the ceil(Sq / 128) q-blocks) from k14_plan.
extern "C" int pfa_flash_aug_sm90(const void* q, const void* k, const void* v, void* o, int B,
                                  int Sq, int Skv, int H, int D, float sm_scale, int tile_keys,
                                  int stages, int smem, int grid, const int* walk, void* stream) {
  if (D != 64 || !x_args_ok(q, k, v, o, B, Sq, H, H, sm_scale)) return cudaErrorInvalidValue;
  return x_launch<AugCfg>(flash_aug_sm90, q, k, v, o, B, Sq, Skv, H, H, sm_scale, 1, 0, Sq, false,
                          tile_keys, stages, smem, grid, walk, static_cast<cudaStream_t>(stream));
}

// K15 in bf16: as K14, with nchain in {1, 2, 3, 4} chains of 64 rows a
// work tile (Sq <= 32768 at nchain 1); the plan from k15_plan.
extern "C" int pfa_flash_pair_sm90(const void* q, const void* k, const void* v, void* o, int B,
                                   int Sq, int Skv, int H, int D, float sm_scale, int nchain,
                                   int tile_keys, int stages, int smem, int grid, const int* walk,
                                   void* stream) {
  if (D != 64 || !x_args_ok(q, k, v, o, B, Sq, H, H, sm_scale)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PFA_K15(N)                                                                             \
  if (nchain == N)                                                                             \
    return x_launch<PairCfg<N>>(flash_pair_sm90<N>, q, k, v, o, B, Sq, Skv, H, H, sm_scale, 1, \
                                0, Sq, false, tile_keys, stages, smem, grid, walk, st);
  PFA_K15(1)
  PFA_K15(2)
  PFA_K15(3)
  PFA_K15(4)
#undef PFA_K15
  return cudaErrorInvalidValue;
}

// out[9] (x_info) of K17 at `unroll` in {2, 4}, of K19 at unroll 0 or of
// K16/K18 at unroll 1, at head dim D; no launch.
extern "C" int pfa_exp_sm90_info(int unroll, int D, int* out) {
  if (D == 64 && unroll == 0) return x_info<XCfg<64, 0>>(flash_exp_sm90<64, 0>, out);
  if (D == 64 && unroll == 1) return x_info<XCfg<64, 1>>(flash_exp_sm90<64, 1>, out);
  if (D == 64 && unroll == 2) return x_info<XCfg<64, 2>>(flash_exp_sm90<64, 2>, out);
  if (D == 64 && unroll == 4) return x_info<XCfg<64, 4>>(flash_exp_sm90<64, 4>, out);
  if (D == 128 && unroll == 0) return x_info<XCfg<128, 0>>(flash_exp_sm90<128, 0>, out);
  if (D == 128 && unroll == 1) return x_info<XCfg<128, 1>>(flash_exp_sm90<128, 1>, out);
  if (D == 128 && unroll == 2) return x_info<XCfg<128, 2>>(flash_exp_sm90<128, 2>, out);
  if (D == 128 && unroll == 4) return x_info<XCfg<128, 4>>(flash_exp_sm90<128, 4>, out);
  return cudaErrorInvalidValue;
}

// out[9] (x_info) of K14 (nchain 0) or of K15 at nchain 1-4 (D 64); no
// launch.
extern "C" int pfa_aug_pair_sm90_info(int nchain, int* out) {
  if (nchain == 0) return x_info<AugCfg>(flash_aug_sm90, out);
  if (nchain == 1) return x_info<PairCfg<1>>(flash_pair_sm90<1>, out);
  if (nchain == 2) return x_info<PairCfg<2>>(flash_pair_sm90<2>, out);
  if (nchain == 3) return x_info<PairCfg<3>>(flash_pair_sm90<3>, out);
  if (nchain == 4) return x_info<PairCfg<4>>(flash_pair_sm90<4>, out);
  return cudaErrorInvalidValue;
}

// out[9] (x_info) of K13 at head dim D (fast_exp: the Schraudolph mode's
// instantiation); no launch.
extern "C" int pfa_fixedmax_sm90_info(int D, int fast_exp, int* out) {
#define PFA_K13(DD, FF)               \
  if (D == DD && (fast_exp != 0) == FF) \
    return x_info<FixedCfg<DD, FF>>(flash_fixedmax_sm90<DD, FF>, out);
  PFA_K13(64, false)
  PFA_K13(64, true)
  PFA_K13(128, false)
  PFA_K13(128, true)
#undef PFA_K13
  return cudaErrorInvalidValue;
}
