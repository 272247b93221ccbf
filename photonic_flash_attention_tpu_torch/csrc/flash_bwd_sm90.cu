// K4 (dK/dV) and K5 (dQ) in bf16: the flash-attention backward redesigned
// for Hopper (sm_90a): TMA loads, wgmma products, warp specialisation and a
// persistent grid, one body per kernel for every stream mode (plain,
// window, dropout).
//
// Replaces the TPU kernels photonic_flash_attention_tpu/ops/flash_bwd.py::
// _dkv_kernel and _dq_kernel (the grid pair) and _dkv_kernel_unrolled and
// _dq_kernel_unrolled (the unrolled pair) in bf16 (the contract and the
// maths: flash_bwd.cu's header). It takes the place of the first slice's
// mma.sync bodies (4 warps of 16 rows, synchronous 16-byte loads, the
// predicate on every score), whose times PERF.md keeps.
//
// What bounds it on the H100: K4 runs 4 products a (query, key) pair and K5
// 3, D multiply-adds each, against one exp (and with dropout one hash) a
// pair: far above the bf16 ridge at S ~ 1k-8k, so the tensor cores are the
// limit. The design follows K1 (flash_fwd_sm90.cu), with two kernels and no
// atomic additions of values, so dq, dk and dv are deterministic. The pair
// computes the whole backward function (JAX ops/flash.py::_flash_core_bwd):
// K5 computes di = rowsum(o * dO) and K4 reads it, so the wrapper launches
// K5 first; K/V come with Hkv heads (query head h reads KV head h / group,
// K1's mapping), and dK/dV leave with Hkv heads, summed over the group in
// fp32 and rounded once, with no repeat or sum outside the kernels.
// * A CTA is three warpgroups: two consumers of 64 rows each (128 rows a
//   work tile) and one producer, whose first warp issues every load by TMA
//   (a CUtensorMap per tensor over the (D, H, S, B) layout, K and V over
//   Hkv heads, 128-byte swizzle, one head and 64 columns a box) into a ring
//   of mbarrier stages. setmaxnreg gives the producer 24 registers and the
//   consumers 240.
// * K5 (dQ): a work tile is 128 query rows of one (batch row, query head).
//   Q and dO arrive once a work tile (double-buffered), K and V of its KV
//   head once a key tile through the ring. Before the key loop each thread
//   computes di of its two rows in fp32 from O, which it reads from global
//   memory (16-byte loads of its quarter of the row; the producer warp
//   prefetches the tile's O rows into L2 when it issues the tile's Q and dO,
//   and a third 128-row tile would not fit in shared memory at D 128), and
//   dO, which it reads from the staged tile; a quad's shuffles finish the
//   sum, and the row's first thread writes it for K4. lse (in log2 units)
//   and di sit in registers. S = Q K^T and dP = dO V^T are SS wgmma
//   (K-major); dS = P (dP - di) scale, rounded to bf16 in the accumulator
//   layout, is the A operand of dQ += dS K, an RS wgmma that reads the same
//   K stage as an MN-major B operand. Tile j's SS products are issued ahead
//   of tile j-1's RS product, so tile j's elementwise step runs while dQ's
//   product does.
// * K4 (dK/dV) works in the transposed domain of the JAX kernel: a work
//   tile is 128 keys of one (batch row, KV head) and one slice of the KV
//   head's group of query heads; its K and V arrive once (double-buffered
//   where they fit), and its query loop walks the slice's heads x query
//   tiles: Q, dO and the tile's lse and di (4-byte cp.async tied to the
//   stage's "full" mbarrier) of the iteration's head come through the ring.
//   S^T = K Q^T and dP^T = V dO^T are SS products; dV += (P^T M) dO and dK
//   += dS^T Q are RS products with dO and Q MN-major from the stage; dK and
//   dV stay in fp32 registers across the slice's heads. lse and di are
//   indexed by the column (the query), so they are read from the stage. At
//   D 64 the next query tile's SS products go ahead of this one's RS
//   products, as in K5; at D 128 dK and dV alone take 128 registers a
//   thread, so a warpgroup runs its products in turn (Cfg::OVERLAP) and the
//   other one fills the gaps.
// * K4's slices: one slice a group leaves too few work tiles to balance
//   (B1 Hkv8 S2048 causal: 128 tiles on 132 SMs, the first key block's 8 x
//   32 query tiles against a mean near 136), so the wrapper cuts the group
//   into slices (ops/flash_bwd.py::k4_slices). With more than one, each
//   slice writes its fp32 dK/dV to a workspace (a 128 x D block a slice
//   and key block) and counts its arrival on a per-(b, KV head, key block)
//   counter; the last to arrive reads the blocks back (its own too, the
//   same bits as its registers) in 16-byte runs of consecutive threads, a
//   slice's loads issued together, sums them in slice order, rounds once
//   to bf16, writes dK/dV and resets the counter to 0 (K3's split merge,
//   paged_decode_sm90.cu). The sum's order does not depend on
//   which slice came last, so the result is deterministic. The counters
//   serve one launch at a time: two K4 launches in flight on two streams
//   at once would share them.
// * The two consumer warpgroups take turns at the tensor cores (named
//   barriers, K1's ping-pong), so one's elementwise step runs under the
//   other's products. Not with dropout: there the hash makes the
//   elementwise step the longer one, and the turns only stall it.
// * Only the tiles that cross the causal diagonal, the ragged last tile
//   (keys in K5, queries in K4) and the window's edge tiles take the
//   per-score predicate. Past the ends TMA fills zeros, and the staged lse
//   and di are 0 there, so a padded query adds nothing to dK/dV and a
//   padded row of dQ (or dK/dV) is never written. K5 writes di for every
//   row below Sq, also in work tiles that see no key (window rows with no
//   key: o = 0, so di = 0), so K4 never reads an unwritten di.
// * The grid is persistent: one CTA a SM walks the work tiles in snake
//   order, heads fastest (K4: slices, then KV heads), the longest first
//   (causal K5: the last query blocks; causal K4: the first key blocks).
// * Head dims: the bodies are compiled at D 64 and 128; a head dim d <= 64
//   runs on D 64, 64 < d <= 128 on D 128, d a multiple of 8 (the wrapper
//   pads the rest into copies, ops/_build.py::head_dim_plan). The tensor
//   maps keep d innermost, so TMA fills a box's columns d..D-1 with zeros:
//   they add nothing to S, dP or di, and dQ, dK and dV come out zero there.
//   K5's O loads, every store of dq, dk and dv and O's L2 prefetch are
//   strided and guarded by d. K4 cuts a group into slices only at d 64 and
//   128: the slices' combine stores whole D-wide rows (a column guard
//   there made the D 128 window body spill), so other head dims take one
//   slice. sm_scale is the real d's.
//
// K21 (the unrolled backward's dK/dV, one launch per block_kv key block:
// benchmarks/flash_bwd_unrolled_experiment.py::_dkv_kernel_unrolled :83)
// in bf16 is K4's plain body, flash_bwd_dkv_sm90<D, PLAIN, true>: a launch
// takes the key range [kv_row0, kv_row0 + rows) (Params::range0, range_end),
// its work tiles the 128-key blocks of the range x heads x batch rows on
// the persistent grid, each walking K4's query tiles from its diagonal to
// S. K21's q, k, v, dO (B, H, S, D) contiguous are K4's (B', S, H', D)
// layout with B' = B H and H' = 1, and its lse and di (B, H, S) are K4's
// (B', H', S), so the launch hands its tensors to K4's tensor maps and
// indexing as they are. Where the range is not a multiple of 128 keys (64,
// 192, 320 ... are legal), the last work tile's second warpgroup holds
// keys past the range end: they are computed, every barrier arrived on,
// and not stored; the launch that owns them writes them. The launches of
// one call read the same inputs and write disjoint rows, so each after the
// first is a programmatic dependent launch (`chained`, as K18's): a CTA
// lets the next launch start at once (griddepcontrol.launch_dependents)
// and its producer warp waits, once it has issued its last load, for the
// launch ahead to complete (griddepcontrol.wait), so no launch completes
// before the one ahead of it. Only the K21 instantiation holds the range
// and the griddepcontrol instructions (the template's COLBLOCK), so K4's
// own instantiations keep their code.
//
// K20 (the unrolled backward's dQ, one launch per block_q row-block:
// benchmarks/flash_bwd_unrolled_experiment.py::_dq_kernel_unrolled :41) in
// bf16 is K5's plain body the same way, flash_bwd_dq_sm90<D, PLAIN, true>
// (ROWBLOCK): a launch takes the query rows [row0, row0 + rows) of every
// (b, h) (Params::range0, range_end), its work tiles the range's 128-row
// blocks x heads x batch rows, the last (longest, causal) first, each
// walking K5's key tiles up to its diagonal; the same fold of (B, H, S, D)
// into K5's layout; rows of the last work tile past the range computed and
// not stored; the launches after a call's first chained, the wait in the
// producer warp. K20 and K21 stay MHA (H' = Hkv = 1, one slice) and take di
// from the caller, as JAX's experiment computes it in XLA: ROWBLOCK reads
// di where K5 computes it, and neither instantiation holds the GQA walk,
// the slices' combine or the di prologue.

#include <limits.h>

#include "flash_bwd_sm90.cuh"
#include "sm90.cuh"

namespace {

constexpr int CONSUMERS = 2;  // consumer warpgroups
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;  // 24 + 2 x 240 = 3 x 168
constexpr int BLOCK = 64 * CONSUMERS;  // rows of a work tile: queries (K5), keys (K4)

// The warpgroups' turns at the tensor cores (see the header).
template <int MODE>
constexpr bool PINGPONG = MODE != DROPOUT;

// Whether `bytes` of tiles fit in a CTA's shared memory beside the barriers
// (at most 12) and the alignment slack: the configs below take the most
// ring stages (4 to 2) and double buffers that do.
constexpr bool fits(int bytes) { return bytes + 8 * 12 + 1024 <= SMEM_MAX; }

// K5: the ring carries K and V tiles of BKV keys; Q and dO are per work tile.
// At D 64, 128 keys keep S, dP, the previous tile's dS and dQ (64 + 64 + 32
// + 32 registers a thread) under 240 without spilling, but not beside the
// dropout hash: 64 there. At D 128 (dQ 64 registers) 64 keys.
template <int D, int MODE>
struct DqCfg {
  static constexpr int BKV = D == 128 || MODE == DROPOUT ? 64 : 128;
  static constexpr int HALVES = D / 64;         // 128-byte column boxes a row
  static constexpr int QO_BYTES = BLOCK * D * 2;  // Q or dO of a work tile
  static constexpr int KV_BYTES = BKV * D * 2;    // K or V, one stage
  static constexpr int QBUF = fits(4 * QO_BYTES + 4 * KV_BYTES) ? 2 : 1;
  static constexpr int STAGES = fits(2 * QBUF * QO_BYTES + 8 * KV_BYTES)   ? 4
                                : fits(2 * QBUF * QO_BYTES + 6 * KV_BYTES) ? 3
                                                                           : 2;
  static constexpr int OFF_Q = 0;  // every offset a multiple of 1024
  static constexpr int OFF_DO = OFF_Q + QBUF * QO_BYTES;
  static constexpr int OFF_K = OFF_DO + QBUF * QO_BYTES;
  static constexpr int OFF_V = OFF_K + STAGES * KV_BYTES;
  static constexpr int OFF_BAR = OFF_V + STAGES * KV_BYTES;
  static constexpr int SMEM = OFF_BAR + 8 * (2 * STAGES + 2 * QBUF) + 1024;
};

// K4: the ring carries Q and dO tiles of BQ queries and their lse and di;
// K and V are per work tile.
template <int D>
struct DkvCfg {
  static constexpr int BQ = 64;  // 128 spills at D 64, 32 is slower at D 128
  static constexpr bool OVERLAP = D == 64;  // at D 128 the overlap spills
  static constexpr int HALVES = D / 64;
  static constexpr int KV_BYTES = BLOCK * D * 2;  // K or V of a work tile
  static constexpr int QO_BYTES = BQ * D * 2;     // Q or dO, one stage
  static constexpr int VEC_BYTES = 2 * BQ * 4;    // lse and di, one stage
  static constexpr int STAGE_BYTES = 2 * QO_BYTES + VEC_BYTES;
  static constexpr int KVBUF = fits(4 * KV_BYTES + 2 * STAGE_BYTES) ? 2 : 1;
  static constexpr int STAGES = fits(2 * KVBUF * KV_BYTES + 4 * STAGE_BYTES)   ? 4
                                : fits(2 * KVBUF * KV_BYTES + 3 * STAGE_BYTES) ? 3
                                                                               : 2;
  static constexpr int OFF_K = 0;
  static constexpr int OFF_V = OFF_K + KVBUF * KV_BYTES;
  static constexpr int OFF_Q = OFF_V + KVBUF * KV_BYTES;
  static constexpr int OFF_DO = OFF_Q + STAGES * QO_BYTES;
  static constexpr int OFF_VEC = OFF_DO + STAGES * QO_BYTES;
  static constexpr int OFF_BAR = OFF_VEC + STAGES * VEC_BYTES;
  static constexpr int SMEM = OFF_BAR + 8 * (2 * STAGES + 2 * KVBUF) + 1024;
};

struct Params {
  __nv_bfloat16 *out0, *out1;  // K5: dq; K4: dk, dv
  const float *lse, *di;       // (B, H, Sq); di: K4, K20 and K21 read it
  float* di_out;               // K5 writes di here
  const __nv_bfloat16* o;      // K5: the forward's output (B, Sq, H, D)
  int B, Sq, Skv, H, Hkv;      // H: query heads
  int d;                       // the real head dim: the rows' pitch (D: the compiled width)
  int group;                   // H / Hkv
  int n_work;  // work tiles: K5 128-row blocks x H x B; K4 key blocks x Hkv x slices x B
  float scale, scale_log2;
  int causal;
  Streams st;
  int range0, range_end;  // K21: the launch's keys; K20: its query rows
  int slices, hps;        // K4: slices of a group, query heads a slice
  float* ws;              // K4 with slices > 1: fp32 dK, then dV, partials
  int* counters;          // K4 with slices > 1: arrivals a (b, KV head, key block)
};

// Named barrier 3 over the two consumer warpgroups (1 and 2 are the
// ping-pong's turns): K4's slices agree on which is the last.
constexpr int BAR_EPILOGUE = 3;

// x, opaque to the compiler: what is computed from it is not moved above
// this point (a volatile asm keeps its place among the others).
__device__ __forceinline__ int opaque(int x) {
  asm volatile("mov.b32 %0, %0;\n" : "+r"(x));
  return x;
}

// One line of global memory into L2, no register written.
__device__ __forceinline__ void prefetch_l2(const void* ptr) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(ptr));
}

// 16 bytes of shared memory.
__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

// The dot product of two runs of 8 bf16 values (16 bytes each), added to
// acc in fp32 in order; bf16 x bf16 products are exact in fp32.
__device__ __forceinline__ float dot8(uint4 a, uint4 b, float acc) {
  const uint32_t x[4] = {a.x, a.y, a.z, a.w}, y[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc = fmaf(__uint_as_float(x[i] << 16), __uint_as_float(y[i] << 16), acc);
    acc = fmaf(__uint_as_float(x[i] & 0xFFFF0000u), __uint_as_float(y[i] & 0xFFFF0000u), acc);
  }
  return acc;
}

// --- K5: dQ ---------------------------------------------------------------------

struct DqWork {
  int h, kvh, b, q0, kv_begin, n_tiles;  // kvh: the KV head h reads
};

// Work tile t: heads fastest, then batch rows, then query blocks, the last
// (longest) causal block first; its key tiles are the band its rows see.
// ROWBLOCK (K20): the query blocks of the rows from range0.
template <int BKV, int MODE, bool ROWBLOCK>
__device__ __forceinline__ DqWork dq_work(const Params& p, int t) {
  DqWork w;
  const int nqb = ROWBLOCK ? (p.range_end - p.range0 + BLOCK - 1) / BLOCK : (p.Sq + BLOCK - 1) / BLOCK;
  w.h = t % p.H;
  w.kvh = ROWBLOCK ? w.h : w.h / p.group;
  const int r = t / p.H;
  w.b = r % p.B;
  const int i = r / p.B;
  w.q0 = (p.causal ? nqb - 1 - i : i) * BLOCK;
  if constexpr (ROWBLOCK) w.q0 += p.range0;
  const int off = p.Skv - p.Sq;
  w.kv_begin = MODE == WINDOW ? band_kv_begin(p.st, w.q0, off, BKV) : 0;
  const int kv_end = band_kv_end(p.st, w.q0, BLOCK, off, p.causal, p.Skv);
  w.n_tiles = kv_end > w.kv_begin ? (kv_end - w.kv_begin + BKV - 1) / BKV : 0;
  return w;
}

// One key tile's dS in place of S (fp32, accumulator layout): P = ex2(s *
// scale * log2 e - lse * log2 e), zero where MASKED finds the key invalid
// (a select, so a row with lse = -inf gives 0), times (dP M - di) scale.
template <int BKV, int MODE, bool MASKED>
__device__ __forceinline__ void dq_scores(float* s, const float* dp, const float (&nl)[2],
                                          const float (&di)[2], const Params& p, int kv0, int row0,
                                          int t4, int off, uint32_t bh) {
#pragma unroll
  for (int i = 0; i < BKV / 2; ++i) {
    const int r = (i >> 1) & 1, row = row0 + 8 * r, col = kv0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
    float pr = ex2(fmaf(s[i], p.scale_log2, nl[r]));
    if constexpr (MASKED) {
      const bool ok = col < p.Skv && (!p.causal || col <= row + off) &&
                      (MODE != WINDOW || p.st.in_window(col - row - off));
      if (!ok) pr = 0.f;
    }
    float d = dp[i];
    if constexpr (MODE == DROPOUT) d *= dropout_mult(p.st, bh, row, col, p.Skv);
    s[i] = pr * (d - di[r]) * p.scale;
  }
}

// ROWBLOCK: K20's instantiation (the query range, the chained launches).
template <int D, int MODE, bool ROWBLOCK = false>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_sm90(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                  const Params p) {
  using C = DqCfg<D, MODE>;
  constexpr int BKV = C::BKV, STAGES = C::STAGES, QBUF = C::QBUF;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // swizzle atoms: 1024-byte aligned
  const uint32_t bar_full = base + C::OFF_BAR, bar_empty = bar_full + 8 * STAGES;
  const uint32_t bar_qfull = bar_empty + 8 * STAGES, bar_qempty = bar_qfull + 8 * QBUF;
  const int n_work = p.n_work, off = p.Skv - p.Sq;
  if constexpr (ROWBLOCK) pdl_launch_dependents();

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, CONSUMERS * 4);  // one arrival a consumer warp
    }
    for (int s = 0; s < QBUF; ++s) {
      mbar_init(bar_qfull + 8 * s, 1);
      mbar_init(bar_qempty + 8 * s, CONSUMERS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Warp-uniform in the compiler's eyes (a shuffled value): ptxas must see
  // the roles' branches, and the wgmma in them, as uniform.
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int warp = __shfl_sync(0xffffffffu, (threadIdx.x / 32) % 4, 0), lane = threadIdx.x % 32;
  if (wg == CONSUMERS) {
    // --- producer: its first warp issues every load -------------------------
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp != 0) return;
    int it = 0;  // key tiles loaded so far, over all work tiles
    for (int n = 0; n * (int)gridDim.x < n_work; ++n) {
      const int t = snake_tile(n);
      if (t >= n_work) continue;  // the last round only
      const DqWork w = dq_work<BKV, MODE, ROWBLOCK>(p, t);
      const int qb = n % QBUF;
      const uint32_t qf = bar_qfull + 8 * qb;
      mbar_wait(bar_qempty + 8 * qb, ((n / QBUF) & 1) ^ 1);
      if constexpr (!ROWBLOCK) {  // the tile's O rows into L2, for the consumers' di
        for (int r = lane; r < BLOCK && w.q0 + r < p.Sq; r += 32)
          for (int hf = 0; hf < C::HALVES && 64 * hf < p.d; ++hf)
            prefetch_l2(p.o + (((long long)w.b * p.Sq + w.q0 + r) * p.H + w.h) * p.d + 64 * hf);
      }
      if (lane == 0) {
        mbar_expect_tx(qf, 2 * C::QO_BYTES);
        for (int r = 0; r < CONSUMERS; ++r)
          for (int hf = 0; hf < C::HALVES; ++hf) {
            const uint32_t box = qb * C::QO_BYTES + (r * C::HALVES + hf) * BOX_BYTES;
            tma_load_4d(base + C::OFF_Q + box, &tm_q, qf, hf * 64, w.h, w.q0 + r * 64, w.b);
            tma_load_4d(base + C::OFF_DO + box, &tm_do, qf, hf * 64, w.h, w.q0 + r * 64, w.b);
          }
      }
      for (int j = 0; j < w.n_tiles; ++j, ++it) {
        const int s = it % STAGES, kv0 = w.kv_begin + j * BKV;
        const uint32_t full = bar_full + 8 * s;
        mbar_wait(bar_empty + 8 * s, ((it / STAGES) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(full, 2 * C::KV_BYTES);
          for (int hf = 0; hf < C::HALVES; ++hf) {
            const uint32_t at = s * C::KV_BYTES + hf * BKV * 128;
            tma_load_4d(base + C::OFF_K + at, &tm_k, full, hf * 64, w.kvh, kv0, w.b);
            tma_load_4d(base + C::OFF_V + at, &tm_v, full, hf * 64, w.kvh, kv0, w.b);
          }
        }
      }
    }
    // K20: the CTA does not exit before the launch ahead of it has (as K21).
    if constexpr (ROWBLOCK) pdl_wait();
  } else {
    // --- consumers: 64 query rows each -----------------------------------------
    setmaxnreg_inc<CONSUMER_REGS>();
    constexpr int NS = BKV / 2, ND = D / 2;  // accumulator floats a thread
    const int g = lane / 4, t4 = lane % 4;
    // Ping-pong: the warpgroups take turns to issue their products (named
    // barrier 1 + wg is this one's turn); warpgroup 0 goes first in each work
    // tile, and warpgroup 1's last turn hands nothing on.
    auto turn_begin = [&] {
      if (PINGPONG<MODE>) named_bar_sync(1 + wg, 2 * 128);
    };
    auto turn_end = [&](bool last) {
      if (PINGPONG<MODE> && (wg == 0 || !last)) named_bar_arrive(2 - wg, 2 * 128);
    };
    auto release = [&](uint32_t bar) {  // this warp is done with what `bar` guards
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    float s[NS], dp[NS], dq[ND];
    uint32_t da[BKV / 16][4];
    int it = 0;  // key tiles consumed so far, over all work tiles
    for (int n = 0; n * (int)gridDim.x < n_work; ++n) {
      const int t = snake_tile(n);
      if (t >= n_work) continue;
      const DqWork w = dq_work<BKV, MODE, ROWBLOCK>(p, t);
      const int qb = n % QBUF, nt = w.n_tiles;
      const int wrow = w.q0 + wg * 64;         // the warpgroup's first row
      const int row0 = wrow + warp * 16 + g;   // this thread's rows: row0, row0 + 8
      const uint32_t bh = static_cast<uint32_t>(w.b * p.H + w.h);
      const uint32_t q_base = base + C::OFF_Q + qb * C::QO_BYTES + wg * C::HALVES * BOX_BYTES;
      const uint32_t do_base = base + C::OFF_DO + qb * C::QO_BYTES + wg * C::HALVES * BOX_BYTES;
      const long long vrow = ((long long)w.b * p.H + w.h) * p.Sq;  // lse and di of the head
      float nl[2], di[2];  // -lse * log2 e and di of this thread's rows (0 past Sq)
      constexpr int NC = D / 32;  // 16-byte chunks of a row's O a thread reads
      [[maybe_unused]] uint4 ov[2][NC];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = row0 + 8 * i;
        nl[i] = row < p.Sq ? -p.lse[vrow + row] * LOG2E : 0.f;
        if constexpr (ROWBLOCK) {
          di[i] = row < p.Sq ? p.di[vrow + row] : 0.f;
        } else {  // the thread's quarter of the row's O: chunks t4, t4 + 4, ... (0 past Sq, d)
          const __nv_bfloat16* orow = p.o + (((long long)w.b * p.Sq + row) * p.H + w.h) * p.d;
#pragma unroll
          for (int c = 0; c < NC; ++c)
            ov[i][c] = row < p.Sq && 8 * (t4 + 4 * c) < p.d
                           ? __ldg(reinterpret_cast<const uint4*>(orow + 8 * (t4 + 4 * c)))
                           : make_uint4(0u, 0u, 0u, 0u);
        }
      }
#pragma unroll
      for (int i = 0; i < ND; ++i) dq[i] = 0.f;
      mbar_wait(bar_qfull + 8 * qb, (n / QBUF) & 1);
      if constexpr (!ROWBLOCK) {
        // di = rowsum(O dO) in fp32: dO from the staged tile (128-byte
        // swizzle: chunk c of box row lr lies at c ^ (lr & 7)), the row's
        // four threads' sums added by shuffles; the first writes it for K4.
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int lr = warp * 16 + g + 8 * i, row = row0 + 8 * i;
          float acc = 0.f;
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            const int chunk = t4 + 4 * c;
            acc = dot8(ov[i][c],
                       lds128(do_base + (chunk / 8) * BOX_BYTES + lr * 128 + ((chunk % 8) ^ (lr & 7)) * 16),
                       acc);
          }
          acc += __shfl_xor_sync(0xffffffffu, acc, 1);
          acc += __shfl_xor_sync(0xffffffffu, acc, 2);
          di[i] = acc;
          if (t4 == 0 && row < p.Sq) p.di_out[vrow + row] = acc;
        }
      }
      if (PINGPONG<MODE> && wg == 1 && nt > 0) named_bar_arrive(1, 2 * 128);

      auto issue_ss = [&](int k) {  // S and dP of the ring's key tile k
        const int st = k % STAGES;
        mbar_wait(bar_full + 8 * st, (k / STAGES) & 1);
        const uint32_t k_base = base + C::OFF_K + st * C::KV_BYTES;
        const uint32_t v_base = base + C::OFF_V + st * C::KV_BYTES;
        turn_begin();
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t hf = kk / 4, koff = (kk % 4) * 32;
          wgmma_ss<BKV>(s, sw128_desc(q_base + hf * BOX_BYTES + koff, 16),
                        sw128_desc(k_base + hf * BKV * 128 + koff, 16), kk == 0);
        }
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t hf = kk / 4, koff = (kk % 4) * 32;
          wgmma_ss<BKV>(dp, sw128_desc(do_base + hf * BOX_BYTES + koff, 16),
                        sw128_desc(v_base + hf * BKV * 128 + koff, 16), kk == 0);
        }
        wgmma_commit();
      };
      auto issue_rs = [&](int k) {  // dQ += dS K, K (BKV x D) MN-major from the stage
        const uint32_t k_base = base + C::OFF_K + (k % STAGES) * C::KV_BYTES;
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk)
          wgmma_rs<D>(dq, da[kk], sw128_desc(k_base + kk * 16 * 128, BKV * 128));
        wgmma_commit();
      };
      auto step = [&](int j) {  // tile j's dS, in s
        const int kv0 = w.kv_begin + j * BKV;
        const bool masked = kv0 + BKV > p.Skv ||
                            (p.causal && kv0 + BKV - 1 > wrow + off) ||
                            (MODE == WINDOW && (kv0 - (wrow + 63) - off < p.st.lo ||
                                                kv0 + BKV - 1 - wrow - off > p.st.hi));
        if (masked)
          dq_scores<BKV, MODE, true>(s, dp, nl, di, p, kv0, row0, t4, off, bh);
        else
          dq_scores<BKV, MODE, false>(s, dp, nl, di, p, kv0, row0, t4, off, bh);
      };

      // The first tile is peeled off, so no product is issued under a branch.
      if (nt > 0) {
        issue_ss(it);
        turn_end(false);
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);
        step(0);
        pack_frag<BKV>(da, s);
      }
      for (int j = 1; j < nt; ++j) {
        issue_ss(it + j);
        issue_rs(it + j - 1);
        turn_end(false);
        wgmma_wait<1>();  // tile j's S and dP are in; dQ's product runs on
        fence_regs(s);
        fence_regs(dp);
        step(j);
        wgmma_wait<0>();
        fence_regs(dq);
        release(bar_empty + 8 * ((it + j - 1) % STAGES));
        pack_frag<BKV>(da, s);  // da was read by the product just finished
      }
      if (nt > 0) {  // the last tile's dQ product
        turn_begin();
        wgmma_fence();
        issue_rs(it + nt - 1);
        turn_end(true);
        wgmma_wait<0>();
        fence_regs(dq);
        release(bar_empty + 8 * ((it + nt - 1) % STAGES));
      }
      release(bar_qempty + 8 * qb);
      it += nt;

      int row_end = p.Sq;  // K20: rows past the range are another launch's
      if constexpr (ROWBLOCK) row_end = p.range_end;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = row0 + 8 * i;
        if (row >= row_end) continue;
        __nv_bfloat16* out = p.out0 + (((long long)w.b * p.Sq + row) * p.H + w.h) * p.d;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)  // columns d..D-1 are not stored
          if (8 * j < p.d) store2(out + 8 * j + 2 * t4, dq[4 * j + 2 * i], dq[4 * j + 2 * i + 1]);
      }
    }
  }
}

// --- K4: dK, dV -----------------------------------------------------------------

struct DkvWork {
  int kvh, slice, h0, b, kv0, q_begin, n_tiles;  // h0: the slice's first query head
};

// Work tile t: slices fastest, then KV heads, then batch rows, then key
// blocks, the first (longest under the causal mask) first; its query tiles
// are those from which its keys are seen, the same for each of its heads.
// COLBLOCK (K21): the key blocks from range0, one head, one slice.
template <int BQ, bool COLBLOCK>
__device__ __forceinline__ DkvWork dkv_work(const Params& p, int t) {
  DkvWork w;
  const int slices = COLBLOCK ? 1 : p.slices;
  const int u = t % (p.Hkv * slices);
  w.kvh = u / slices;
  w.slice = u % slices;
  w.h0 = COLBLOCK ? w.kvh : w.kvh * p.group + w.slice * p.hps;
  const int r = t / (p.Hkv * slices);
  w.b = r % p.B;
  w.kv0 = (r / p.B) * BLOCK;
  if constexpr (COLBLOCK) w.kv0 += p.range0;
  const int off = p.Skv - p.Sq;
  w.q_begin = band_q_begin(p.st, w.kv0, off, p.causal, BQ);
  const int q_end = band_q_end(p.st, w.kv0, BLOCK, off, p.Sq);
  w.n_tiles = q_end > w.q_begin ? (q_end - w.q_begin + BQ - 1) / BQ : 0;
  return w;
}

// One query tile of the transposed domain in place: s gets P^T M (the dV
// operand), dp gets dS^T; lse and di come from the stage's vector `vec`
// at the lane's columns (the queries), staged 0 past Sq.
template <int BQ, int MODE, bool MASKED>
__device__ __forceinline__ void dkv_scores(float* s, float* dp, const float* vec, const Params& p,
                                           int q0, int key0, int t4, int off, uint32_t bh) {
#pragma unroll
  for (int j = 0; j < BQ / 8; ++j) {
    const int c = 8 * j + 2 * t4;
    const float2 l2 = *reinterpret_cast<const float2*>(vec + c);
    const float2 d2 = *reinterpret_cast<const float2*>(vec + BQ + c);
    const float nl[2] = {-l2.x * LOG2E, -l2.y * LOG2E}, di[2] = {d2.x, d2.y};
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * rr + e, key = key0 + 8 * rr, q = q0 + c + e;
        float pr = ex2(fmaf(s[i], p.scale_log2, nl[e]));
        if constexpr (MASKED) {
          const bool ok = q < p.Sq && (!p.causal || key <= q + off) &&
                          (MODE != WINDOW || p.st.in_window(key - q - off));
          if (!ok) pr = 0.f;
        }
        float d = dp[i];
        if constexpr (MODE == DROPOUT) {
          // Transposed: the hash's row is this tile's column (the query).
          const float m = dropout_mult(p.st, bh, q, key, p.Skv);
          d *= m;
          s[i] = pr * m;
        } else {
          s[i] = pr;
        }
        dp[i] = pr * (d - di[e]) * p.scale;
      }
  }
}

// COLBLOCK: K21's instantiation (the key range, the chained launches).
template <int D, int MODE, bool COLBLOCK = false>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_sm90(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                   const Params p) {
  using C = DkvCfg<D>;
  constexpr int BQ = C::BQ, STAGES = C::STAGES, KVBUF = C::KVBUF;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms: 1024-byte aligned
  const unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bar_full = base + C::OFF_BAR, bar_empty = bar_full + 8 * STAGES;
  const uint32_t bar_kvfull = bar_empty + 8 * STAGES, bar_kvempty = bar_kvfull + 8 * KVBUF;
  const int n_work = p.n_work, off = p.Skv - p.Sq;
  if constexpr (COLBLOCK) pdl_launch_dependents();

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, CONSUMERS * 4);
    }
    for (int s = 0; s < KVBUF; ++s) {
      mbar_init(bar_kvfull + 8 * s, 1);
      mbar_init(bar_kvempty + 8 * s, CONSUMERS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int warp = __shfl_sync(0xffffffffu, (threadIdx.x / 32) % 4, 0), lane = threadIdx.x % 32;
  const int hps = COLBLOCK ? 1 : p.hps;  // query heads a work tile walks
  if (wg == CONSUMERS) {
    // --- producer --------------------------------------------------------------
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp != 0) return;
    int it = 0;  // query tiles loaded so far, over all work tiles
    for (int n = 0; n * (int)gridDim.x < n_work; ++n) {
      const int t = snake_tile(n);
      if (t >= n_work) continue;
      const DkvWork w = dkv_work<BQ, COLBLOCK>(p, t);
      const int kb = n % KVBUF;
      const uint32_t kf = bar_kvfull + 8 * kb;
      mbar_wait(bar_kvempty + 8 * kb, ((n / KVBUF) & 1) ^ 1);
      if (lane == 0) {
        mbar_expect_tx(kf, 2 * C::KV_BYTES);
        for (int r = 0; r < CONSUMERS; ++r)
          for (int hf = 0; hf < C::HALVES; ++hf) {
            const uint32_t box = kb * C::KV_BYTES + (r * C::HALVES + hf) * BOX_BYTES;
            tma_load_4d(base + C::OFF_K + box, &tm_k, kf, hf * 64, w.kvh, w.kv0 + r * 64, w.b);
            tma_load_4d(base + C::OFF_V + box, &tm_v, kf, hf * 64, w.kvh, w.kv0 + r * 64, w.b);
          }
      }
      for (int hh = 0; hh < hps; ++hh) {  // the slice's query heads, each over its query tiles
        const int h = w.h0 + hh;
        const long long vrow = ((long long)w.b * p.H + h) * p.Sq;
        for (int j = 0; j < w.n_tiles; ++j, ++it) {
          const int s = it % STAGES, q0 = w.q_begin + j * BQ;
          const uint32_t full = bar_full + 8 * s;
          mbar_wait(bar_empty + 8 * s, ((it / STAGES) & 1) ^ 1);
          const uint32_t vec = base + C::OFF_VEC + s * C::VEC_BYTES;
          for (int i = lane; i < BQ; i += 32) {
            const bool ok = q0 + i < p.Sq;
            const long long at = vrow + (ok ? q0 + i : 0);
            cp_async4(vec + 4 * i, p.lse + at, ok);
            cp_async4(vec + 4 * (BQ + i), p.di + at, ok);
          }
          cp_async_mbar_arrive(full);
          __syncwarp();
          if (lane == 0) {
            mbar_expect_tx(full, 2 * C::QO_BYTES);
            for (int hf = 0; hf < C::HALVES; ++hf) {
              const uint32_t at = s * C::QO_BYTES + hf * BQ * 128;
              tma_load_4d(base + C::OFF_Q + at, &tm_q, full, hf * 64, h, q0, w.b);
              tma_load_4d(base + C::OFF_DO + at, &tm_do, full, hf * 64, h, q0, w.b);
            }
          }
        }
      }
    }
    // K21: the CTA does not exit before the launch ahead of it has (the
    // wait in the consumers' code made them spill).
    if constexpr (COLBLOCK) pdl_wait();
  } else {
    // --- consumers: 64 keys each --------------------------------------------------
    setmaxnreg_inc<CONSUMER_REGS>();
    constexpr int NS = BQ / 2, ND = D / 2;
    const int g = lane / 4, t4 = lane % 4;
    auto turn_begin = [&] {
      if (PINGPONG<MODE>) named_bar_sync(1 + wg, 2 * 128);
    };
    auto turn_end = [&](bool last) {
      if (PINGPONG<MODE> && (wg == 0 || !last)) named_bar_arrive(2 - wg, 2 * 128);
    };
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    float s[NS], dp[NS], dk[ND], dv[ND];
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];
    int it = 0;
    for (int n = 0; n * (int)gridDim.x < n_work; ++n) {
      const int t = snake_tile(n);
      if (t >= n_work) continue;
      const DkvWork w = dkv_work<BQ, COLBLOCK>(p, t);
      const int kb = n % KVBUF, nt = w.n_tiles;
      const int nr = nt * hps;                // ring tiles: the heads' query tiles in turn
      const int kw = w.kv0 + wg * 64;         // the warpgroup's first key
      const int key0 = kw + warp * 16 + g;    // this thread's keys: key0, key0 + 8
      const uint32_t k_base = base + C::OFF_K + kb * C::KV_BYTES + wg * C::HALVES * BOX_BYTES;
      const uint32_t v_base = base + C::OFF_V + kb * C::KV_BYTES + wg * C::HALVES * BOX_BYTES;
#pragma unroll
      for (int i = 0; i < ND; ++i) dk[i] = dv[i] = 0.f;
      mbar_wait(bar_kvfull + 8 * kb, (n / KVBUF) & 1);
      if (PINGPONG<MODE> && wg == 1 && nr > 0) named_bar_arrive(1, 2 * 128);

      auto issue_ss = [&](int k) {  // S^T and dP^T of the ring's query tile k
        const int st = k % STAGES;
        mbar_wait(bar_full + 8 * st, (k / STAGES) & 1);
        const uint32_t q_st = base + C::OFF_Q + st * C::QO_BYTES;
        const uint32_t do_st = base + C::OFF_DO + st * C::QO_BYTES;
        turn_begin();
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t hf = kk / 4, koff = (kk % 4) * 32;
          wgmma_ss<BQ>(s, sw128_desc(k_base + hf * BOX_BYTES + koff, 16),
                       sw128_desc(q_st + hf * BQ * 128 + koff, 16), kk == 0);
        }
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t hf = kk / 4, koff = (kk % 4) * 32;
          wgmma_ss<BQ>(dp, sw128_desc(v_base + hf * BOX_BYTES + koff, 16),
                       sw128_desc(do_st + hf * BQ * 128 + koff, 16), kk == 0);
        }
        wgmma_commit();
      };
      auto issue_rs = [&](int k) {  // dV += P^T dO, dK += dS^T Q; dO, Q MN-major
        const int st = k % STAGES;
        const uint32_t q_st = base + C::OFF_Q + st * C::QO_BYTES;
        const uint32_t do_st = base + C::OFF_DO + st * C::QO_BYTES;
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          wgmma_rs<D>(dv, pa[kk], sw128_desc(do_st + kk * 16 * 128, BQ * 128));
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          wgmma_rs<D>(dk, da[kk], sw128_desc(q_st + kk * 16 * 128, BQ * 128));
        wgmma_commit();
      };
      auto step = [&](int i, int k) {  // the work tile's ring tile i (k overall): P^T M in s, dS^T in dp
        const int hh = COLBLOCK ? 0 : i / nt, j = i - hh * nt;  // its head and query tile
        const int q0 = w.q_begin + j * BQ;
        const uint32_t bh = static_cast<uint32_t>(w.b * p.H + w.h0 + hh);
        const float* vec = reinterpret_cast<const float*>(smem + C::OFF_VEC + (k % STAGES) * C::VEC_BYTES);
        const bool masked = q0 + BQ > p.Sq || (p.causal && kw + 63 > q0 + off) ||
                            (MODE == WINDOW && (kw - (q0 + BQ - 1) - off < p.st.lo ||
                                                kw + 63 - q0 - off > p.st.hi));
        if (masked)
          dkv_scores<BQ, MODE, true>(s, dp, vec, p, q0, key0, t4, off, bh);
        else
          dkv_scores<BQ, MODE, false>(s, dp, vec, p, q0, key0, t4, off, bh);
      };
      auto pack = [&] {
        pack_frag<BQ>(pa, s);
        pack_frag<BQ>(da, dp);
      };

      if constexpr (C::OVERLAP) {
        if (nr > 0) {
          issue_ss(it);
          turn_end(false);
          wgmma_wait<0>();
          fence_regs(s);
          fence_regs(dp);
          step(0, it);
          pack();
        }
        for (int j = 1; j < nr; ++j) {
          issue_ss(it + j);
          issue_rs(it + j - 1);
          turn_end(false);
          wgmma_wait<1>();
          fence_regs(s);
          fence_regs(dp);
          step(j, it + j);
          wgmma_wait<0>();
          fence_regs(dk);
          fence_regs(dv);
          release(bar_empty + 8 * ((it + j - 1) % STAGES));
          pack();
        }
        if (nr > 0) {
          turn_begin();
          wgmma_fence();
          issue_rs(it + nr - 1);
          turn_end(true);
          wgmma_wait<0>();
          fence_regs(dk);
          fence_regs(dv);
          release(bar_empty + 8 * ((it + nr - 1) % STAGES));
        }
      } else {
        // Each query tile in turn: S^T and dP^T, the elementwise step, then
        // dV and dK; two turns a tile.
        for (int j = 0; j < nr; ++j) {
          issue_ss(it + j);
          turn_end(false);
          wgmma_wait<0>();
          fence_regs(s);
          fence_regs(dp);
          step(j, it + j);
          pack();
          turn_begin();
          wgmma_fence();
          issue_rs(it + j);
          turn_end(j == nr - 1);
          wgmma_wait<0>();
          fence_regs(dk);
          fence_regs(dv);
          release(bar_empty + 8 * ((it + j) % STAGES));
        }
      }
      release(bar_kvempty + 8 * kb);
      it += nr;

      int key_end = p.Skv;  // K21: keys past the range are another launch's
      if constexpr (COLBLOCK) key_end = p.range_end;
      // The head dim read here, after the loop's products (an opaque copy:
      // the stores' address arithmetic stays out of the loop, where dK and
      // dV already hold 128 registers at D 128).
      const int hd = opaque(p.d);
      auto out_at = [&](int key) { return (((long long)w.b * p.Skv + key) * p.Hkv + w.kvh) * hd; };
      bool direct = true;
      if constexpr (!COLBLOCK) direct = p.slices == 1;
      if (direct) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int key = key0 + 8 * i;
          if (key >= key_end) continue;
          const long long at = out_at(key);
#pragma unroll
          for (int j = 0; j < D / 8; ++j) {
            if (8 * j >= hd) continue;  // columns d..D-1 are not stored
            store2(p.out0 + at + 8 * j + 2 * t4, dk[4 * j + 2 * i], dk[4 * j + 2 * i + 1]);
            store2(p.out1 + at + 8 * j + 2 * t4, dv[4 * j + 2 * i], dv[4 * j + 2 * i + 1]);
          }
        }
      } else if constexpr (!COLBLOCK) {
        // The slices' combine: this slice's fp32 partials to the workspace
        // (a 128 x D block a (slice, b, KV head, key block), every slice's
        // dK, then every slice's dV), its arrival counted; the last to
        // arrive sums every slice's in slice order, rounds once and resets
        // the count.
        __shared__ int last_slice;
        const int nkb = (p.Skv + BLOCK - 1) / BLOCK, kblock = w.kv0 / BLOCK;
        const long long plane = (long long)p.slices * p.B * p.Hkv * nkb * BLOCK * D;  // dV's offset
        auto ws_tile = [&](int sl) {
          return p.ws + ((((long long)sl * p.B + w.b) * p.Hkv + w.kvh) * nkb + kblock) * BLOCK * D;
        };
        float* part = ws_tile(w.slice);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int key = key0 + 8 * i;
          if (key >= key_end) continue;
#pragma unroll
          for (int j = 0; j < D / 8; ++j) {
            const int at = (key - w.kv0) * D + 8 * j + 2 * t4;
            store2(part + at, dk[4 * j + 2 * i], dk[4 * j + 2 * i + 1]);
            store2(part + plane + at, dv[4 * j + 2 * i], dv[4 * j + 2 * i + 1]);
          }
        }
        __threadfence();
        named_bar_sync(BAR_EPILOGUE, CONSUMERS * 128);
        const int ctr = (w.b * p.Hkv + w.kvh) * nkb + kblock;
        if (threadIdx.x == 0) last_slice = atomicAdd(p.counters + ctr, 1) == p.slices - 1;
        named_bar_sync(BAR_EPILOGUE, CONSUMERS * 128);
        if (last_slice) {
          // Every slice's block (this one's too: the same bits as its
          // registers), read in 16-byte runs by consecutive threads, each
          // slice's loads issued together and added in slice order into
          // dk and dv, which now hold a thread's D / 8 runs of 4 columns;
          // whole D-wide rows, as slices run only at d == D (takes()).
          __threadfence();
          constexpr int RUNS = D / 8;  // float4 runs a thread: 128 x D / 4 over 256 threads
          const int ct = threadIdx.x;
#pragma unroll
          for (int i = 0; i < ND; ++i) dk[i] = dv[i] = 0.f;
          for (int sl = 0; sl < p.slices; ++sl) {
            const float4* blk = reinterpret_cast<const float4*>(ws_tile(sl));
#pragma unroll
            for (int r = 0; r < RUNS; ++r) {
              const int run = ct + r * CONSUMERS * 128;
              if (w.kv0 + run / (D / 4) >= key_end) continue;
              const float4 a = __ldcg(blk + run), c = __ldcg(blk + plane / 4 + run);
              dk[4 * r] += a.x, dk[4 * r + 1] += a.y, dk[4 * r + 2] += a.z, dk[4 * r + 3] += a.w;
              dv[4 * r] += c.x, dv[4 * r + 1] += c.y, dv[4 * r + 2] += c.z, dv[4 * r + 3] += c.w;
            }
          }
#pragma unroll
          for (int r = 0; r < RUNS; ++r) {
            const int run = ct + r * CONSUMERS * 128, key = w.kv0 + run / (D / 4);
            if (key >= key_end) continue;
            const long long at = out_at(key) + (run % (D / 4)) * 4;
            store2(p.out0 + at, dk[4 * r], dk[4 * r + 1]);
            store2(p.out0 + at + 2, dk[4 * r + 2], dk[4 * r + 3]);
            store2(p.out1 + at, dv[4 * r], dv[4 * r + 1]);
            store2(p.out1 + at + 2, dv[4 * r + 2], dv[4 * r + 3]);
          }
          if (threadIdx.x == 0) p.counters[ctr] = 0;
        }
      }
    }
  }
}

// --- host side -------------------------------------------------------------------

// One CTA a SM walks the work tiles.
cudaError_t grid_size(int n_work, int* grid) {
  int sms = 0;
  const cudaError_t e = sm_count(&sms);
  *grid = n_work < sms ? n_work : sms;
  return e;
}

// The four bf16 tensor maps over (d, H, S, B), the real head dim d
// innermost (a box's columns d..D-1 arrive as zeros: nothing in S, dP or
// di): q and dout over Hq heads in boxes of q_rows rows, k and v over Hkv
// in boxes of kv_rows; and the work tiles (128-row blocks of `rows` rows x
// `heads` x B).
cudaError_t prepare(const BwdSm90Args& a, int q_rows, int kv_rows, int rows, int heads,
                    CUtensorMap (&maps)[4], Params& p) {
  const uint64_t d = a.D, hq = a.Hq, hkv = a.Hkv, B = a.B, Sq = a.Sq, Skv = a.Skv;
  const auto bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const uint32_t qbox[4] = {64, 1, (uint32_t)q_rows, 1}, kvbox[4] = {64, 1, (uint32_t)kv_rows, 1};
  if (!encode_4d(&maps[0], bf16, 2, a.q, {d, hq, Sq, B}, qbox) ||
      !encode_4d(&maps[1], bf16, 2, a.k, {d, hkv, Skv, B}, kvbox) ||
      !encode_4d(&maps[2], bf16, 2, a.v, {d, hkv, Skv, B}, kvbox) ||
      !encode_4d(&maps[3], bf16, 2, a.dout, {d, hq, Sq, B}, qbox))
    return cudaErrorInvalidValue;
  const long long work = (long long)((rows + BLOCK - 1) / BLOCK) * heads * a.B;
  if (work > INT_MAX) return cudaErrorInvalidValue;
  p = Params{};
  p.lse = a.lse, p.di = a.di, p.di_out = a.di_out;
  p.o = static_cast<const __nv_bfloat16*>(a.o);
  p.B = a.B, p.Sq = a.Sq, p.Skv = a.Skv, p.H = a.Hq, p.Hkv = a.Hkv, p.group = a.Hq / a.Hkv;
  p.d = a.D;
  p.n_work = static_cast<int>(work);
  p.scale = a.scale, p.scale_log2 = a.scale * LOG2E, p.causal = a.causal, p.st = a.st;
  p.slices = 1, p.hps = p.group;
  return cudaSuccess;
}

template <typename Kernel>
cudaError_t run(Kernel kernel, int smem, const CUtensorMap (&maps)[4], const Params& p,
                cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  int grid = 0;
  if ((e = grid_size(p.n_work, &grid)) != cudaSuccess) return e;
  kernel<<<grid, THREADS, smem, stream>>>(maps[0], maps[1], maps[2], maps[3], p);
  return cudaGetLastError();
}

template <int D, int MODE>
cudaError_t launch_dq(const BwdSm90Args& a, void* dq, cudaStream_t stream) {
  using C = DqCfg<D, MODE>;
  CUtensorMap maps[4];
  Params p;
  cudaError_t e = prepare(a, 64, C::BKV, a.Sq, a.Hq, maps, p);
  if (e != cudaSuccess) return e;
  p.out0 = static_cast<__nv_bfloat16*>(dq);
  return run(flash_bwd_dq_sm90<D, MODE>, C::SMEM, maps, p, stream);
}

template <int D, int MODE>
cudaError_t launch_dkv(const BwdSm90Args& a, void* dk, void* dv, cudaStream_t stream) {
  using C = DkvCfg<D>;
  CUtensorMap maps[4];
  Params p;
  cudaError_t e = prepare(a, C::BQ, 64, a.Skv, a.Hkv * a.slices, maps, p);
  if (e != cudaSuccess) return e;
  p.out0 = static_cast<__nv_bfloat16*>(dk);
  p.out1 = static_cast<__nv_bfloat16*>(dv);
  p.slices = a.slices, p.hps = p.group / a.slices;
  p.ws = a.ws, p.counters = a.counters;
  return run(flash_bwd_dkv_sm90<D, MODE>, C::SMEM, maps, p, stream);
}

// K21: one launch over keys [kv_row0, kv_row0 + rows) on the plan's grid
// (1 to the work tiles), ring stages and shared memory, which must be this
// file's; `chained`: a programmatic dependent launch.
template <int D>
cudaError_t launch_colblock(const BwdSm90Args& a, void* dk, void* dv, int kv_row0, int rows,
                            bool chained, int stages, int smem, int grid, cudaStream_t stream) {
  using C = DkvCfg<D>;
  if (stages != C::STAGES || smem != C::SMEM) return cudaErrorInvalidValue;
  CUtensorMap maps[4];
  Params p;
  cudaError_t e = prepare(a, C::BQ, 64, rows, 1, maps, p);
  if (e != cudaSuccess) return e;
  if (grid < 1 || grid > p.n_work) return cudaErrorInvalidValue;
  p.out0 = static_cast<__nv_bfloat16*>(dk);
  p.out1 = static_cast<__nv_bfloat16*>(dv);
  p.range0 = kv_row0;
  p.range_end = kv_row0 + rows;
  const auto kernel = flash_bwd_dkv_sm90<D, PLAIN, true>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  return launch_chained(kernel, chained, grid, THREADS, smem, stream, maps[0], maps[1], maps[2],
                        maps[3], p);
}

// K20: one launch over query rows [q_row0, q_row0 + rows), as
// launch_colblock; K5's plain ring.
template <int D>
cudaError_t launch_rowblock(const BwdSm90Args& a, void* dq, int q_row0, int rows, bool chained,
                            int stages, int smem, int grid, cudaStream_t stream) {
  using C = DqCfg<D, PLAIN>;
  if (stages != C::STAGES || smem != C::SMEM) return cudaErrorInvalidValue;
  CUtensorMap maps[4];
  Params p;
  cudaError_t e = prepare(a, 64, C::BKV, rows, 1, maps, p);
  if (e != cudaSuccess) return e;
  if (grid < 1 || grid > p.n_work) return cudaErrorInvalidValue;
  p.out0 = static_cast<__nv_bfloat16*>(dq);
  p.range0 = q_row0;
  p.range_end = q_row0 + rows;
  const auto kernel = flash_bwd_dq_sm90<D, PLAIN, true>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  return launch_chained(kernel, chained, grid, THREADS, smem, stream, maps[0], maps[1], maps[2],
                        maps[3], p);
}

// out[8]: rows a work tile, rows of the ring's tile, dynamic shared memory
// bytes, threads a CTA, CTAs a SM, ring stages, producer and consumer
// registers (setmaxnreg).
template <typename Kernel>
cudaError_t describe(Kernel kernel, int ring_rows, int smem, int stages, int* out) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  out[0] = BLOCK, out[1] = ring_rows, out[2] = smem, out[3] = THREADS;
  out[5] = stages, out[6] = PRODUCER_REGS, out[7] = CONSUMER_REGS;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[4], kernel, THREADS, smem);
}

template <int D, int MODE>
cudaError_t info(int* out) {
  const cudaError_t e = describe(flash_bwd_dkv_sm90<D, MODE>, DkvCfg<D>::BQ, DkvCfg<D>::SMEM,
                                 DkvCfg<D>::STAGES, out);
  if (e != cudaSuccess) return e;
  using C = DqCfg<D, MODE>;
  return describe(flash_bwd_dq_sm90<D, MODE>, C::BKV, C::SMEM, C::STAGES, out + 8);
}

template <int MODE>
cudaError_t info_mode(int D, int* out) {
  if (D == 64) return info<64, MODE>(out);
  if (D == 128) return info<128, MODE>(out);
  return cudaErrorInvalidValue;
}

// TMA reads 16-byte-aligned bases and rows of whole 16-byte units (and K5
// O by 16-byte loads): a head dim d that is a multiple of 8, up to 128
// (ops/_build.py::head_dim_plan pads the rest); query heads in whole
// groups; K4's slices split each group evenly, and more than one needs the
// workspace and the counters and a head dim of the width (64 or 128): the
// slices' combine stores whole D-wide rows (a column guard there made the
// D 128 window body spill).
bool takes(const BwdSm90Args& a) {
  return aligned16(a.q) && aligned16(a.k) && aligned16(a.v) && aligned16(a.dout) &&
         (a.o == nullptr || aligned16(a.o)) && a.D >= 8 && a.D <= 128 && a.D % 8 == 0 &&
         a.Hkv > 0 &&
         a.Hq % a.Hkv == 0 && a.slices > 0 && (a.Hq / a.Hkv) % a.slices == 0 &&
         (a.slices == 1 || ((a.D == 64 || a.D == 128) && a.ws != nullptr &&
                            a.counters != nullptr));
}

// K20's and K21's launch of a range [row0, row0 + rows) of S, on the grid
// of 64 rows: (B, H, S, D) is K4/K5's (B', S, H', D) with B' = B H, H' = 1,
// and (B, H, S) lse and di their (B', H', S). False where the range or the
// tensors are not the body's.
bool unrolled_args(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                   const void* di, int B, int S, int H, int D, int row0, int rows, float sm_scale,
                   int causal, BwdSm90Args& a) {
  if (B <= 0 || H <= 0 || S <= 0 || (long long)B * H > INT_MAX || row0 < 0 || row0 % 64 ||
      rows <= 0 || rows % 64 || (long long)row0 + rows > S || (D != 64 && D != 128))
    return false;
  a = BwdSm90Args{q, k, v, nullptr, dout, static_cast<const float*>(lse),
                  static_cast<const float*>(di), nullptr, B * H, S, S, 1, 1, D, sm_scale, causal,
                  Streams{-WINDOW_OPEN, WINDOW_OPEN, 0u, 0u, 1.f}, nullptr, nullptr, 1};
  return takes(a);
}

}  // namespace

// A head dim d runs on the width that holds it: 64 for d <= 64, else 128.
cudaError_t k5_bf16_sm90(const BwdSm90Args& a, void* dq, int mode, cudaStream_t stream) {
  if (!takes(a) || a.o == nullptr || a.di_out == nullptr) return cudaErrorInvalidValue;
  const bool d64 = a.D <= 64;
  switch (mode) {
    case PLAIN: return d64 ? launch_dq<64, PLAIN>(a, dq, stream) : launch_dq<128, PLAIN>(a, dq, stream);
    case WINDOW: return d64 ? launch_dq<64, WINDOW>(a, dq, stream) : launch_dq<128, WINDOW>(a, dq, stream);
    case DROPOUT:
      return d64 ? launch_dq<64, DROPOUT>(a, dq, stream) : launch_dq<128, DROPOUT>(a, dq, stream);
  }
  return cudaErrorInvalidValue;
}

cudaError_t k4_bf16_sm90(const BwdSm90Args& a, void* dk, void* dv, int mode, cudaStream_t stream) {
  if (!takes(a) || a.di == nullptr) return cudaErrorInvalidValue;
  const bool d64 = a.D <= 64;
  switch (mode) {
    case PLAIN:
      return d64 ? launch_dkv<64, PLAIN>(a, dk, dv, stream) : launch_dkv<128, PLAIN>(a, dk, dv, stream);
    case WINDOW:
      return d64 ? launch_dkv<64, WINDOW>(a, dk, dv, stream) : launch_dkv<128, WINDOW>(a, dk, dv, stream);
    case DROPOUT:
      return d64 ? launch_dkv<64, DROPOUT>(a, dk, dv, stream)
                 : launch_dkv<128, DROPOUT>(a, dk, dv, stream);
  }
  return cudaErrorInvalidValue;
}

// out[16]: K4's design (out[0..7]) and K5's (out[8..15]) at head dim D in
// `mode` (StreamMode): rows a work tile (keys, queries), rows of the ring's
// tile (queries, keys), dynamic shared memory bytes, threads a CTA, CTAs a
// SM, ring stages, producer and consumer registers; no launch.
extern "C" int pfa_bwd_sm90_info(int D, int mode, int* out) {
  switch (mode) {
    case PLAIN: return info_mode<PLAIN>(D, out);
    case WINDOW: return info_mode<WINDOW>(D, out);
    case DROPOUT: return info_mode<DROPOUT>(D, out);
  }
  return cudaErrorInvalidValue;
}

// K21 in bf16: one launch over keys [kv_row0, kv_row0 + rows) of every
// (b, h). q, k, v, dout (B, H, S, D) bf16, contiguous, 16-byte-aligned
// bases; lse (natural log) and di (B, H, S) fp32; dk, dv (B, H, S, D) bf16,
// the range's rows written in place; causal (col <= row) or not; D in {64,
// 128}; kv_row0 and rows multiples of 64 with the range inside [0, S);
// stages, smem and grid from experiments/flash_bwd_unrolled_experiment.py::
// k21_plan. `chained` (every launch of a call after its first): a
// programmatic dependent launch on the one ahead of it in the stream.
extern "C" int pfa_flash_bwd_dkv_colblock_sm90(const void* q, const void* k, const void* v,
                                               const void* dout, const void* lse, const void* di,
                                               void* dk, void* dv, int B, int S, int H, int D,
                                               int kv_row0, int rows, float sm_scale, int causal,
                                               int chained, int stages, int smem, int grid,
                                               void* stream) {
  BwdSm90Args a;
  if (!unrolled_args(q, k, v, dout, lse, di, B, S, H, D, kv_row0, rows, sm_scale, causal, a))
    return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_colblock<64>(a, dk, dv, kv_row0, rows, chained != 0, stages, smem, grid, st);
  return launch_colblock<128>(a, dk, dv, kv_row0, rows, chained != 0, stages, smem, grid, st);
}

// K20 in bf16: one launch over query rows [q_row0, q_row0 + rows) of every
// (b, h), on K5's plain body; the contract of
// pfa_flash_bwd_dkv_colblock_sm90, dq (B, H, S, D) bf16 written in place
// on the range's rows; stages, smem and grid from experiments/
// flash_bwd_unrolled_experiment.py::k20_plan.
extern "C" int pfa_flash_bwd_dq_rowblock_sm90(const void* q, const void* k, const void* v,
                                              const void* dout, const void* lse, const void* di,
                                              void* dq, int B, int S, int H, int D, int q_row0,
                                              int rows, float sm_scale, int causal, int chained,
                                              int stages, int smem, int grid, void* stream) {
  BwdSm90Args a;
  if (!unrolled_args(q, k, v, dout, lse, di, B, S, H, D, q_row0, rows, sm_scale, causal, a))
    return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch_rowblock<64>(a, dq, q_row0, rows, chained != 0, stages, smem, grid, st);
  return launch_rowblock<128>(a, dq, q_row0, rows, chained != 0, stages, smem, grid, st);
}
