// K3 (paged decode attention) for Hopper (sm_90a): split-KV over the
// sequence, pages staged into shared memory by the TMA's 1-D bulk copy,
// the splits merged in the same launch; with K2's token write folded in
// (the fused decode).
//
// It replaces the TPU kernels of photonic_flash_attention_tpu/ops/paged.py:
//   B6  _fused_decode_kernel (:407): write each sequence's new K/V token,
//       then attend over the pool; its bias_ref is the token-bias mode
//       (T5's relative-position bias at decode, added at the token's
//       LOGICAL position t, before the length mask);
//   B7  _paged_hf_kernel (:902): the read-only head-folded decode, with its
//       int8-compute mode;
//   B14 _paged_kernel (:101): the read-only decode of paged_attention.
// All of them are one kernel here (k3_kernel), in one of three modes:
// float compute over an int8, bf16 or fp32 pool (B14, B7's float mode, B6
// without the write), the same with the new token written and used (B6,
// "fused"), and B7's int8 compute.
//
// Pool layout (the port's choice): token-major (L, Hkv, P, page, D). One
// (layer, head, page) slab of K or V is page x D contiguous elements and
// its fp32 scales page x 4 contiguous bytes, so any run of a page's rows
// is one cp.async.bulk into shared memory; no tensor map is needed.
//
// What bounds it: decode reads every cached K/V byte of the batch once and
// does about 2 operations a byte (a GEMV for G = Hq/Hkv = 1: GPT-2,
// Llama-2-7B), so HBM is the ceiling (3.35 TB/s on the H100 SXM data sheet
// at its 700 W limit) and the tensor cores have nothing to do. The TPU's
// grid walked a sequence in order; one CTA per (sequence, kv head) on the
// card is 128 CTAs at GPT-2 medium's B8 H16, each walking up to 2000
// tokens alone. So:
//   * split-KV (flash-decoding): a sequence is cut into splits of
//     split_pages pages (about 256 tokens; ops/paged.py::k3_plan, from the
//     shapes alone, never from lengths: no host read), and every (sequence,
//     kv head, head chunk, split) that holds tokens is a work item. The
//     grid is persistent: one CTA for each that fits on the card at once.
//     Each CTA reads the batch's lengths once, counts the active items
//     (a prefix over the batch in shared memory) and takes items
//     blockIdx.x, + gridDim.x, ... of them, so the CTAs' loads differ by
//     at most one item and a split past lengths[b] costs nothing. Every query head of
//     the group (up to GMAX of them) stays in the CTA, so a K/V byte is
//     read once for all of them.
//   * a producer warp keeps a ring of NST stages of `tile` tokens in
//     flight: per page run of a tile, one bulk copy of K rows, one of V
//     rows and (int8 pools) one of each's scales, completing on the
//     stage's mbarrier with complete_tx. Only the pages holding tokens
//     below lengths[b] are read. The ring runs on across a CTA's work
//     items, so the next split's pages load while this one merges.
//   * four consumer warps each take their own tokens of every tile (16-byte
//     lane loads, LPT lanes a row) and keep their own online-softmax state
//     (max, sum, accumulator), so they need no barrier per tile; scores
//     reduce over a row's lanes by shuffles, P.V accumulates in each lane's
//     16 bytes of D, and the warps merge at the end of the split in warp
//     order. The int8 K scale is folded into the score and the V scale
//     into P; int8 values convert by a byte permute and one subtraction
//     (the I2F unit is a quarter of the FMA rate).
//   * the splits merge in the same launch: each writes (m, l, acc) to an
//     fp32 workspace the wrapper allocates with torch.empty and counts its
//     arrival on a per-(b, head, chunk) counter; the last to arrive merges
//     the records in split order (so the output does not depend on which
//     split came last) and resets the counter to 0. No host sync, no
//     per-call memset: a CUDA graph can capture the launch. The counters
//     belong to one launch at a time: two K3 launches in flight on two
//     streams at once would share them.
//   * int8 compute (B7): q arrives quantized per tensor, with its dequant
//     scale x sm_scale in device memory (no host read). Scores are
//     int8 x int8 dot products by __dp4a, exact in int32. P, with the V
//     scales folded in, is requantized per (head, block of block_tokens =
//     pages_per_block x page tokens) as trunc(p x 127/pmax + 0.5), as the
//     TPU kernel does; so a block's K (with its scales) streams first, the
//     CTA reduces the block's max, sum and pmax, then the block's V streams
//     and P.V sums int8 x int8 in int32. Splits are whole blocks. A split's
//     running max differs from the sequential one by a factor common to the
//     whole block, which the requant cancels (up to rounding).
//   * the fused decode (B6): the CTA of (b, head, split holding logical
//     position lengths[b] - 1), head chunk 0, quantizes k_new and v_new
//     exactly as K2 does (common.cuh::quant_token_value; fp32 and bf16
//     pools convert) and stores them at flat_slots[b]; every CTA of the
//     sequence computes the same rows in shared memory and, wherever its
//     tile holds the slot flat_slots[b], uses them in place of the staged
//     row. The result equals "write, then attend over the pool" wherever
//     the slot lies, and no CTA waits for another's write. A length-0 row
//     still writes its token (to trash page 0 in serving) and returns
//     zeros. Pages are never shared between sequences in the port's
//     serving; a concurrent read of a slot that another sequence is
//     writing is outside the contract.
//   * head dims: the kernel is compiled at D 64 and 128, and at D 256 for
//     int8 and bf16 pools (an fp32 row of 256 would need 64 lanes of 16
//     bytes, more than a warp), and takes any head dim d up to 256 (128
//     over fp32 pools) whose rows are whole 16-byte units (int8 d % 16 == 0,
//     bf16 d % 8 == 0, fp32 d % 4 == 0; ops/paged.py pads other pools into
//     copies): d <= 64 on D 64, d <= 128 on D 128, else on D 256 (bf16: one
//     token a warp, 32 lanes a row; int8: two). A row keeps the lanes of a
//     D-wide row (LPT a power of two, so the shuffle reductions stay
//     whole); a lane whose 16-byte chunk lies past d holds a zero q and
//     re-reads its row's first chunk, so it adds nothing to a score, and
//     the output columns it fills are not written. The pools, q, k_new,
//     v_new and o keep d as their pitch;
//     the bulk copies move d-wide rows (page runs of a multiple of 16
//     bytes); the fused write's int8 absmax runs over the real d.

#include <climits>
#include <type_traits>

#include "sm90.cuh"

namespace {

constexpr int NCW = 4;                    // consumer warps
constexpr int NTHREADS = (NCW + 1) * 32;  // + one producer warp
constexpr int NCT = NCW * 32;             // consumer threads
constexpr int NST = 4;                    // ring stages
constexpr int BAR_C = 1;                  // named barrier of the consumer warps

struct K3Args {
  const float* q;            // (B, Hq, D) float mode
  const int8_t* q8;          // (B, Hq, D) int8 compute
  const float* score_scale;  // () int8 compute: q's dequant scale x sm_scale
  void* k_pool;              // (L, Hkv, P, page, D)
  void* v_pool;
  float* k_scales;           // (L, Hkv, P, page) int8 pools
  float* v_scales;
  const int* lengths;        // (B,)
  const int* tables;         // (B, pps)
  const float* tbias;        // (B, Hkv, bias_len) or null
  const void* k_new;         // (B, Hkv, D) fused, else null
  const void* v_new;
  const int* slots;          // (B,) fused, else null
  float* o;                  // (B, Hq, D)
  float* ws;                 // split records when n_split > 1
  int* counters;             // (B x Hkv x n_gchunk) arrival counters, 0 between launches
  long long layer_base;      // tokens before this layer's pool
  long long head_stride;     // tokens of one head's pool (P x page)
  int B, Hq, Hkv, G, gcmax, n_gchunk, page, pps, bias_len, split_pages, n_split, tile, block;
  int n_items;               // B x Hkv x n_gchunk x n_split
  int d;                     // the real head dim: the rows' pitch (D: the compiled width)
  int in_bf16;               // fused: k_new / v_new are bf16 (else fp32)
  float sm_scale;
};

__host__ __device__ constexpr int align_up(int x, int a) { return (x + a - 1) / a * a; }

// Shared-memory layout, the same on the host and the device: mbarriers and
// the arrival flag; the batch's lengths and its prefix of active items; the
// producer's page ids of a split; the new token's rows (fused); the warps'
// end-of-split states (float mode) or the int8-compute block state, these
// D (the compiled width) wide; the ring, whose rows are d (the real head
// dim) wide. ops/paged.py::k3_smem counts the same bytes.
struct Layout {
  int lens, tab, newrow, merge, i8c, ring, stage, total;
};

__host__ __device__ inline Layout k3_layout(int B, int D, int d, int elt, int gmax, bool i8c,
                                            int tile, int split_pages, int block) {
  Layout L;
  int off = 2 * NST * 8 + 16;
  L.lens = off;  // lengths [B], then the prefix of active items [B + 1]
  off += align_up((2 * B + 1) * 4, 16);
  L.tab = off;
  off += align_up(split_pages * 4, 16);
  L.newrow = off;
  off += align_up(2 * D * elt + 16, 16);
  L.merge = off;
  if (!i8c) off += 4 * NCW * gmax * (D + 2);
  L.i8c = off;
  // scores (then P8) [gmax][block], V scales [block], P.V int sums and the
  // accumulator [gmax][D], m, l, alpha, P scale [gmax].
  if (i8c) off += 4 * (gmax * block + block + 2 * gmax * D + 4 * gmax);
  off = align_up(off, 128);
  L.ring = off;
  L.stage = align_up(tile * (2 * d * elt + (elt == 1 ? 8 : 0)), 128);
  L.total = off + NST * L.stage;
  return L;
}

// One work item: a split of (sequence b, kv head h x head chunk) that holds
// tokens (split 0 of an empty row too).
struct Item {
  int b, row, h, chunk, gc, head0, split, len, s0, s_end, n_active, first_page, n_pages;
  long long head_base;
};

// lengths[b] clipped to the page table's capacity.
__device__ __forceinline__ int clip_len(const K3Args& a, int l) {
  const int cap = a.pps * a.page;
  return l < 0 ? 0 : (l > cap ? cap : l);
}

// Splits of row b that hold tokens (1 for an empty row).
__device__ __forceinline__ int splits_of(const K3Args& a, int len) {
  const int ST = a.split_pages * a.page;
  return len == 0 ? 1 : (len + ST - 1) / ST;
}

// The k-th active item, with pre[b] = the active items of sequences < b
// (b-major, then kv head x head chunk, then split: a row's splits go to
// neighbouring CTAs).
__device__ __forceinline__ Item item_at(const K3Args& a, const int* lens, const int* pre, int k) {
  int lo = 0, hi = a.B;  // pre[lo] <= k < pre[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (pre[mid] <= k) lo = mid;
    else hi = mid;
  }
  Item I;
  I.b = lo;
  I.len = clip_len(a, lens[lo]);
  I.n_active = splits_of(a, I.len);
  const int r = k - pre[lo];
  const int hc = r / I.n_active;
  I.split = r - hc * I.n_active;
  I.row = lo * (a.Hkv * a.n_gchunk) + hc;
  I.h = hc / a.n_gchunk;
  I.chunk = hc - I.h * a.n_gchunk;
  const int g0 = I.chunk * a.gcmax;
  I.gc = min(a.gcmax, a.G - g0);
  I.head0 = I.h * a.G + g0;
  const int ST = a.split_pages * a.page;
  I.s0 = I.split * ST;
  I.s_end = min(I.s0 + ST, I.len);
  I.first_page = I.split * a.split_pages;
  I.n_pages = (I.s_end - I.s0 + a.page - 1) / a.page;
  I.head_base = a.layer_base + (long long)I.h * a.head_stride;
  return I;
}

// 16 bytes of pool values as floats.
__device__ __forceinline__ void to_floats(const uint4 w, float (&f)[16]) {
  const uint32_t u[4] = {w.x ^ 0x80808080u, w.y ^ 0x80808080u, w.z ^ 0x80808080u,
                         w.w ^ 0x80808080u};
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int j = 0; j < 4; ++j)  // 2^23 + (x + 128), then subtract: exact
      f[4 * k + j] = __uint_as_float(__byte_perm(u[k], 0x4B000000u, 0x7440 + j)) - 8388736.f;
}
__device__ __forceinline__ void to_floats(const uint4 w, float (&f)[8]) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    f[2 * k] = __uint_as_float(u[k] << 16);
    f[2 * k + 1] = __uint_as_float(u[k] & 0xffff0000u);
  }
}
__device__ __forceinline__ void to_floats(const uint4 w, float (&f)[4]) {
  f[0] = __uint_as_float(w.x);
  f[1] = __uint_as_float(w.y);
  f[2] = __uint_as_float(w.z);
  f[3] = __uint_as_float(w.w);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// The new token's row of one head (fused mode), by one warp: as K2 for an
// int8 pool (scale into *scale, the absmax over the real d columns),
// converted for the others; columns d..D-1 are zero.
template <typename T, int D>
__device__ void new_row(const void* src, long long off, bool bf16, T* dst, float* scale, int d) {
  const int lane = threadIdx.x & 31;
  float x[D / 32];
#pragma unroll
  for (int j = 0; j < D / 32; ++j) {
    const long long i = off + lane + 32 * j;
    x[j] = lane + 32 * j >= d ? 0.f
           : bf16             ? __bfloat162float(static_cast<const __nv_bfloat16*>(src)[i])
                              : static_cast<const float*>(src)[i];
  }
  if constexpr (std::is_same<T, int8_t>::value) {
    float amax = 0.f;
#pragma unroll
    for (int j = 0; j < D / 32; ++j) amax = fmaxf(amax, fabsf(x[j]));
    const float sc = token_scale(warp_max(amax));
#pragma unroll
    for (int j = 0; j < D / 32; ++j) dst[lane + 32 * j] = quant_token_value(x[j], sc);
    if (lane == 0) *scale = sc;
  } else {
#pragma unroll
    for (int j = 0; j < D / 32; ++j) dst[lane + 32 * j] = from_float<T>(x[j]);
    if (lane == 0) *scale = 1.f;
  }
}

// The end of a split, by the consumer threads: merge the np partial states
// (m [np][GMAX], l [np][GMAX], acc [np][GMAX][D]) in order into this
// split's (m, l, acc); with one active split write o = acc / l, else write
// the record and, for the last split of (b, head, chunk) to arrive, merge
// every record in split order into o. Only the real d columns of a head:
// o (B, Hq, d); the states and records keep D columns.
template <int D, int GMAX, bool LOG2>
__device__ void finish(const K3Args& a, const Item& I, const float* pm, const float* pl,
                       const float* pacc, int np, int* flag, int d) {
  // The maxima are in log2 units in float mode (its scores carry log2 e).
  auto expo = [](float x) { return LOG2 ? ex2(x) : expf(x); };
  constexpr int REC = GMAX * (D + 2);
  // The D-wide index keeps its constant divisions; columns past d skip.
  const int ct = threadIdx.x;
  float* out = a.o + ((long long)I.b * a.Hq + I.head0) * d;
  float* rec =
      I.n_active > 1 ? a.ws + ((long long)I.row * a.n_split + I.split) * REC : nullptr;
  for (int idx = ct; idx < I.gc * D; idx += NCT) {
    const int g = idx / D, c = idx % D;
    if (c >= d) continue;
    float m = -INFINITY;
    for (int w = 0; w < np; ++w) m = fmaxf(m, pm[w * GMAX + g]);
    float o = 0.f, l = 0.f;
    for (int w = 0; w < np; ++w) {
      const float mw = pm[w * GMAX + g];
      if (mw == -INFINITY) continue;
      const float f = expo(mw - m);
      o += f * pacc[(w * GMAX + g) * D + c];
      l += f * pl[w * GMAX + g];
    }
    if (rec == nullptr) {
      out[g * d + c] = o / l;
    } else {
      rec[2 * GMAX + idx] = o;
      if (c == 0) {
        rec[g] = m;
        rec[GMAX + g] = l;
      }
    }
  }
  if (rec == nullptr) return;
  __threadfence();
  named_bar_sync(BAR_C, NCT);
  if (ct == 0) *flag = atomicAdd(a.counters + I.row, 1) == I.n_active - 1;
  named_bar_sync(BAR_C, NCT);
  if (!*flag) return;
  __threadfence();
  const float* recs = a.ws + (long long)I.row * a.n_split * REC;
  for (int idx = ct; idx < I.gc * D; idx += NCT) {
    const int g = idx / D, c = idx % D;
    if (c >= d) continue;
    float m = -INFINITY;
#pragma unroll 8
    for (int s = 0; s < I.n_active; ++s) m = fmaxf(m, __ldcg(recs + s * REC + g));
    float o = 0.f, l = 0.f;
#pragma unroll 8
    for (int s = 0; s < I.n_active; ++s) {
      const float f = expo(__ldcg(recs + s * REC + g) - m);
      o += f * __ldcg(recs + s * REC + 2 * GMAX + idx);
      l += f * __ldcg(recs + s * REC + GMAX + g);
    }
    out[g * d + c] = o / l;
  }
  if (ct == 0) a.counters[I.row] = 0;
}

// A persistent grid of NTHREADS-thread CTAs over the work items: warps
// 0..NCW-1 consume, warp NCW loads the page ids and its lane 0 issues the
// bulk copies. GMAX: query heads a CTA holds (1, or 2 x the pool's bytes an
// element, at most 4: see dispatch); I8C: the int8-compute mode (int8 pools
// only); FULL: the head dim is the compiled width D, so the row pitch is a
// constant (the address arithmetic of a D-wide head); else it is a.d. Two
// instantiations, not one body with both, whose registers would add up.
template <typename T, int D, int GMAX, bool I8C, bool FULL>
__global__ void __launch_bounds__(NTHREADS, 3) k3_kernel(const K3Args a) {
  constexpr int ELT = sizeof(T);
  constexpr bool QUANT = std::is_same<T, int8_t>::value;
  constexpr int E = 16 / ELT;        // pool values in a lane's 16 bytes
  constexpr int LPT = D * ELT / 16;  // lanes a token row of the compiled width D
  constexpr int TPW = 32 / LPT;      // tokens a warp takes at once
  constexpr int PASSES = I8C ? 2 : 1;  // int8 compute: a block's K, then its V
  // Token groups a consumer warp scores at once (fewer with more heads: the
  // scores' registers).
  constexpr int KB = GMAX == 1 ? 4 : 1;
  static_assert(!I8C || QUANT, "int8 compute takes int8 pools");
  static_assert(LPT >= 1 && LPT <= 32, "a token row takes at most one warp");

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int page = a.page;
  const int ST = a.split_pages * page;
  const int BLK = I8C ? a.block : ST;  // the requant block (int8 compute)
  const bool fused = a.slots != nullptr;
  extern __shared__ __align__(128) unsigned char smem[];
  const int d = FULL ? D : a.d;  // the rows' pitch; a lane's chunk past it reads zeros
  const Layout lay = k3_layout(a.B, D, d, ELT, GMAX, I8C, a.tile, a.split_pages, a.block);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);  // full [NST], empty [NST]
  int* flag = reinterpret_cast<int*>(smem + 2 * NST * 8);
  int* lens = reinterpret_cast<int*>(smem + lay.lens);  // the batch's lengths, read once
  int* pre = lens + a.B;
  int* tab = reinterpret_cast<int*>(smem + lay.tab);
  T* newk = reinterpret_cast<T*>(smem + lay.newrow);
  T* newv = newk + D;
  float* newsc = reinterpret_cast<float*>(newv + D);  // K, V scale
  unsigned char* ring = smem + lay.ring;
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + NST);
  if (tid == 0) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, NCW);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < a.B; i += NTHREADS) lens[i] = __ldg(a.lengths + i);
  __syncthreads();
  if (warp == 0) {
    // pre[b]: the active items of sequences before b, by a warp scan.
    const int hcs = a.Hkv * a.n_gchunk;
    int run = 0;
    for (int b0 = 0; b0 < a.B; b0 += 32) {
      const int b = b0 + lane;
      int v = b < a.B ? hcs * splits_of(a, clip_len(a, lens[b])) : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += u;
      }
      if (b < a.B) pre[b + 1] = run + v;
      run += __shfl_sync(0xffffffffu, v, 31);
    }
    if (lane == 0) pre[0] = 0;
  }
  __syncthreads();
  const int n_act = pre[a.B];  // active items of the launch

  if (warp == NCW) {
    // The producer: per item, the split's page ids into shared memory (the
    // warp), then per tile and page run, bulk copies into the ring (lane
    // 0). The tile count n runs on across items, as the consumers'.
    const int kv_row = d * ELT;
    int n = 0;
    for (int k = blockIdx.x; k < n_act; k += gridDim.x) {
      const Item I = item_at(a, lens, pre, k);
      if (I.len == 0) continue;
      __syncwarp();  // lane 0 has issued the last item's copies
      for (int i = lane; i < I.n_pages; i += 32)
        tab[i] = __ldg(a.tables + (long long)I.b * a.pps + I.first_page + i);
      __syncwarp();
      if (lane != 0) continue;
      for (int blk0 = I.s0; blk0 < I.s_end; blk0 += BLK) {
        const int blk1 = min(blk0 + BLK, I.s_end);
        for (int pass = 0; pass < PASSES; ++pass) {
          const bool with_k = pass == 0, with_v = !I8C || pass == 1;
          for (int t0 = blk0; t0 < blk1; t0 += a.tile, ++n) {
            const int t1 = min(t0 + a.tile, blk1);
            const int st = n % NST;
            if (n >= NST) mbar_wait(empty0 + 8 * st, ((n / NST) - 1) & 1);
            const uint32_t kdst = smem_u32(ring + st * lay.stage), vdst = kdst + a.tile * kv_row;
            const uint32_t ksdst = vdst + a.tile * kv_row, vsdst = ksdst + 4 * a.tile;
            uint32_t bytes = 0;
            for (int t = t0; t < t1;) {
              const int p = t / page, off = t - p * page;
              const int rows = min(t1, (p + 1) * page) - t;
              const int rc = QUANT ? min((rows + 3) & ~3, page - off) : rows;
              bytes += rc * (kv_row * (with_k + with_v) + (QUANT && with_k ? 8 : 0));
              t += rows;
            }
            const uint32_t full = full0 + 8 * st;
            mbar_expect_tx(full, bytes);
            for (int t = t0; t < t1;) {
              const int p = t / page, off = t - p * page;
              const int rows = min(t1, (p + 1) * page) - t;
              const int rc = QUANT ? min((rows + 3) & ~3, page - off) : rows;
              const long long g = I.head_base + (long long)tab[p - I.first_page] * page + off;
              const int r = t - t0;
              if (with_k) bulk_load(kdst + r * kv_row, static_cast<const T*>(a.k_pool) + g * d,
                                    rc * kv_row, full);
              if (with_v) bulk_load(vdst + r * kv_row, static_cast<const T*>(a.v_pool) + g * d,
                                    rc * kv_row, full);
              if (QUANT && with_k) {
                bulk_load(ksdst + 4 * r, a.k_scales + g, 4 * rc, full);
                bulk_load(vsdst + 4 * r, a.v_scales + g, 4 * rc, full);
              }
              t += rows;
            }
          }
        }
      }
    }
    return;
  }

  // The consumers. Lane = LPT * ts + ds: token ts of the warp's group of
  // TPW, 16-byte chunk ds of its row. A lane whose chunk lies past the
  // real d (dok false) holds a zero q and reads its row's chunk 0 (dsx):
  // its products add nothing to the scores, and the accumulator columns
  // it fills (past d) are never written out. So the K and V loads take no
  // select, and the lane map is the D-wide row's.
  const int ts = lane / LPT, ds = lane % LPT;
  const bool dok = ds * E < d;
  const int dsx = dok ? ds : 0;
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);
  int n = 0;  // tiles consumed
  for (int k = blockIdx.x; k < n_act; k += gridDim.x) {
    const Item I = item_at(a, lens, pre, k);
    // Every consumer warp is done with the last item's shared state.
    named_bar_sync(BAR_C, NCT);
    int pos_new = -1;  // the logical position of the new token's slot in this split
    if (fused) {
      const long long new_off = ((long long)I.b * a.Hkv + I.h) * d;
      if (warp == 0) new_row<T, D>(a.k_new, new_off, a.in_bf16, newk, newsc, d);
      if (warp == 1) new_row<T, D>(a.v_new, new_off, a.in_bf16, newv, newsc + 1, d);
      const int slot_new = __ldg(a.slots + I.b);
      named_bar_sync(BAR_C, NCT);
      if (warp == 0 && I.chunk == 0 && I.split == (I.len == 0 ? 0 : (I.len - 1) / ST)) {
        // The write of the TPU kernel's step (0, 0), by the one CTA that
        // owns the sequence's last position.
        const long long tok = I.head_base + slot_new;
        T* kp = static_cast<T*>(a.k_pool) + tok * d;
        T* vp = static_cast<T*>(a.v_pool) + tok * d;
        for (int c = lane; c < d; c += 32) {
          kp[c] = newk[c];
          vp[c] = newv[c];
        }
        if (QUANT && lane == 0) {
          a.k_scales[tok] = newsc[0];
          a.v_scales[tok] = newsc[1];
        }
      }
      const int pid = slot_new / page, poff = slot_new - pid * page;
      for (int p = 0; p < I.n_pages; ++p)
        if (__ldg(a.tables + (long long)I.b * a.pps + I.first_page + p) == pid) {
          const int pos = I.s0 + p * page + poff;
          pos_new = pos < I.s_end ? pos : -1;
          break;
        }
    }
    if (I.len == 0) {
      for (int idx = tid; idx < I.gc * d; idx += NCT)
        a.o[((long long)I.b * a.Hq + I.head0) * d + idx] = 0.f;
      continue;
    }
    const float* brow = a.tbias != nullptr
                            ? a.tbias + ((long long)I.b * a.Hkv + I.h) * a.bias_len
                            : nullptr;

    if constexpr (!I8C) {
      // Scores in log2 units: q carries sm_scale x log2 e, the bias log2 e.
      const float qscale = a.sm_scale * LOG2E;
      float qr[GMAX][E], acc[GMAX][E], m[GMAX], lsum[GMAX];
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        m[g] = -INFINITY;
        lsum[g] = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          acc[g][e] = 0.f;
          qr[g][e] = g < I.gc && dok
                         ? a.q[((long long)I.b * a.Hq + I.head0 + g) * d + ds * E + e] * qscale
                         : 0.f;
        }
      }
      for (int t0 = I.s0; t0 < I.s_end; t0 += a.tile, ++n) {
        const int rows = min(t0 + a.tile, I.s_end) - t0;
        const int st = n % NST;
        mbar_wait(full0 + 8 * st, (n / NST) & 1);
        const unsigned char* stage = ring + st * lay.stage;
        const T* krows = reinterpret_cast<const T*>(stage);
        const T* vrows = krows + a.tile * d;
        const float* kss = reinterpret_cast<const float*>(vrows + a.tile * d);
        const float* vss = kss + a.tile;
        // KB token groups a warp at once: their dot products and shuffle
        // reductions interleave, and one max update serves them all.
        for (int base = warp * TPW; base < rows; base += NCW * TPW * KB) {
          float sc[KB][GMAX];
#pragma unroll
          for (int k = 0; k < KB; ++k) {
            const int i = base + k * NCW * TPW + ts;
            const int ii = i < rows ? i : 0;
            const T* krow = t0 + i == pos_new ? newk : krows + ii * d;
            float kf[E];
            to_floats(*reinterpret_cast<const uint4*>(krow + dsx * E), kf);
#pragma unroll
            for (int g = 0; g < GMAX; ++g) {
              float dot = 0.f;
#pragma unroll
              for (int e = 0; e < E; ++e) dot = fmaf(qr[g][e], kf[e], dot);
              sc[k][g] = dot;
            }
          }
#pragma unroll
          for (int o = LPT / 2; o > 0; o >>= 1)
#pragma unroll
            for (int k = 0; k < KB; ++k)
#pragma unroll
              for (int g = 0; g < GMAX; ++g)
                sc[k][g] += __shfl_xor_sync(0xffffffffu, sc[k][g], o);
#pragma unroll
          for (int k = 0; k < KB; ++k) {
            const int i = base + k * NCW * TPW + ts;
            const bool valid = i < rows;
            const int ii = valid ? i : 0;
            const float ksc = QUANT ? (t0 + i == pos_new ? newsc[0] : kss[ii]) : 1.f;
            const float tb = brow != nullptr && valid ? __ldg(brow + t0 + i) * LOG2E : 0.f;
#pragma unroll
            for (int g = 0; g < GMAX; ++g)
              sc[k][g] = valid ? sc[k][g] * ksc + tb : -INFINITY;
          }
#pragma unroll
          for (int g = 0; g < GMAX; ++g) {
            if (g >= I.gc) break;
            float mx = sc[0][g];
#pragma unroll
            for (int k = 1; k < KB; ++k) mx = fmaxf(mx, sc[k][g]);
#pragma unroll
            for (int o = LPT; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
            if (mx > m[g]) {  // warp-uniform: the max is the warp's
              const float alpha = ex2(m[g] - mx);
              m[g] = mx;
              lsum[g] *= alpha;
#pragma unroll
              for (int e = 0; e < E; ++e) acc[g][e] *= alpha;
            }
#pragma unroll
            for (int k = 0; k < KB; ++k) {
              sc[k][g] = ex2(sc[k][g] - m[g]);  // 0 where masked
              lsum[g] += sc[k][g];
            }
          }
#pragma unroll
          for (int k = 0; k < KB; ++k) {
            const int i = base + k * NCW * TPW + ts;
            const bool valid = i < rows;
            const int ii = valid ? i : 0;
            const bool is_new = t0 + i == pos_new;
            const float vsc = QUANT ? (is_new ? newsc[1] : vss[ii]) : 1.f;
            const T* vrow = is_new ? newv : vrows + ii * d;
            float vf[E];
            to_floats(*reinterpret_cast<const uint4*>(vrow + dsx * E), vf);
#pragma unroll
            for (int g = 0; g < GMAX; ++g) {
              if (g >= I.gc) break;
              const float pv = QUANT ? sc[k][g] * vsc : sc[k][g];  // V scale folded into P
#pragma unroll
              for (int e = 0; e < E; ++e) acc[g][e] = fmaf(pv, valid ? vf[e] : 0.f, acc[g][e]);
            }
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty0 + 8 * st);
      }
      // The warp's state: sums over its token groups (a fixed butterfly).
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
#pragma unroll
        for (int o = LPT; o < 32; o <<= 1) {
          lsum[g] += __shfl_xor_sync(0xffffffffu, lsum[g], o);
#pragma unroll
          for (int e = 0; e < E; ++e) acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);
        }
      }
      float* pm = reinterpret_cast<float*>(smem + lay.merge);
      float* pl = pm + NCW * GMAX;
      float* pacc = pl + NCW * GMAX;
      if (ts == 0) {
#pragma unroll
        for (int g = 0; g < GMAX; ++g) {
          if (g >= I.gc) break;
#pragma unroll
          for (int e = 0; e < E; ++e) pacc[(warp * GMAX + g) * D + ds * E + e] = acc[g][e];
          if (ds == 0) {
            pm[warp * GMAX + g] = m[g];
            pl[warp * GMAX + g] = lsum[g];
          }
        }
      }
      named_bar_sync(BAR_C, NCT);
      finish<D, GMAX, true>(a, I, pm, pl, pacc, NCW, flag, d);
    } else {
      // int8 compute. q8 in registers (16 int8 a lane), the block's scores
      // and the item's state in shared memory.
      const float sc = *a.score_scale;
      int q8[GMAX][4];
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        const uint4 w = g < I.gc && dok ? *reinterpret_cast<const uint4*>(
                                              a.q8 + ((long long)I.b * a.Hq + I.head0 + g) * d + ds * 16)
                                        : zero4;
        q8[g][0] = w.x;
        q8[g][1] = w.y;
        q8[g][2] = w.z;
        q8[g][3] = w.w;
      }
      float* sblk = reinterpret_cast<float*>(smem + lay.i8c);  // [GMAX][block]
      float* vsblk = sblk + GMAX * a.block;                    // [block]
      int* pvi = reinterpret_cast<int*>(vsblk + a.block);      // [GMAX][D]
      float* accs = reinterpret_cast<float*>(pvi + GMAX * D);  // [GMAX][D]
      float* m_s = accs + GMAX * D;
      float* l_s = m_s + GMAX;
      float* al_s = l_s + GMAX;
      float* ps_s = al_s + GMAX;
      for (int i = tid; i < GMAX * D; i += NCT) {
        pvi[i] = 0;
        accs[i] = 0.f;
      }
      if (tid < GMAX) {
        m_s[tid] = -INFINITY;
        l_s[tid] = 0.f;
      }
      named_bar_sync(BAR_C, NCT);
      for (int blk0 = I.s0; blk0 < I.s_end; blk0 += BLK) {
        const int blk1 = min(blk0 + BLK, I.s_end);
        // Pass 1: the block's scores, fp32 (dot x score scale x K scale).
        for (int t0 = blk0; t0 < blk1; t0 += a.tile, ++n) {
          const int rows = min(t0 + a.tile, blk1) - t0;
          const int st = n % NST;
          mbar_wait(full0 + 8 * st, (n / NST) & 1);
          const int8_t* krows = reinterpret_cast<const int8_t*>(ring + st * lay.stage);
          const float* kss = reinterpret_cast<const float*>(krows + 2 * a.tile * d);
          const float* vss = kss + a.tile;
          for (int base = warp * TPW; base < rows; base += NCW * TPW) {
            const int i = base + ts;
            const bool valid = i < rows;
            const int ii = valid ? i : 0;
            const uint4 w = *reinterpret_cast<const uint4*>(krows + ii * d + dsx * 16);
#pragma unroll
            for (int g = 0; g < GMAX; ++g) {
              if (g >= I.gc) break;
              int dot = __dp4a(q8[g][0], static_cast<int>(w.x), 0);
              dot = __dp4a(q8[g][1], static_cast<int>(w.y), dot);
              dot = __dp4a(q8[g][2], static_cast<int>(w.z), dot);
              dot = __dp4a(q8[g][3], static_cast<int>(w.w), dot);
#pragma unroll
              for (int o = LPT / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
              if (valid && ds == 0)
                sblk[g * a.block + t0 + i - blk0] =
                    __fmul_rn(__fmul_rn(static_cast<float>(dot), sc), kss[ii]);
            }
            if (valid && ds == 0) vsblk[t0 + i - blk0] = vss[ii];
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(empty0 + 8 * st);
        }
        named_bar_sync(BAR_C, NCT);
        // The block's max, sum and P requant, a warp a head.
        const int nb = blk1 - blk0;
        for (int g = warp; g < I.gc; g += NCW) {
          float* sg = sblk + g * a.block;
          float mx = -INFINITY;
          for (int i = lane; i < nb; i += 32) mx = fmaxf(mx, sg[i]);
          const float m_next = fmaxf(m_s[g], warp_max(mx));
          const float alpha = expf(m_s[g] - m_next);
          float sum = 0.f, pmax = 0.f;
          for (int i = lane; i < nb; i += 32) {
            const float e = expf(sg[i] - m_next);
            sum += e;
            sg[i] = e * vsblk[i];  // V scale folded into P
            pmax = fmaxf(pmax, sg[i]);
          }
          sum = warp_sum(sum);
          pmax = warp_max(pmax);
          const float pinv = pmax == 0.f ? 0.f : 127.f / pmax;
          for (int i = lane; i < nb; i += 32)
            sg[i] = truncf(__fadd_rn(__fmul_rn(sg[i], pinv), 0.5f));
          if (lane == 0) {
            l_s[g] = __fadd_rn(__fmul_rn(l_s[g], alpha), sum);
            m_s[g] = m_next;
            al_s[g] = alpha;
            ps_s[g] = pmax == 0.f ? 0.f : pmax / 127.f;
          }
        }
        named_bar_sync(BAR_C, NCT);
        // Pass 2: P8 . V8 in int32 (exact in any order).
        int pacc[GMAX][16];
#pragma unroll
        for (int g = 0; g < GMAX; ++g)
#pragma unroll
          for (int e = 0; e < 16; ++e) pacc[g][e] = 0;
        for (int t0 = blk0; t0 < blk1; t0 += a.tile, ++n) {
          const int rows = min(t0 + a.tile, blk1) - t0;
          const int st = n % NST;
          mbar_wait(full0 + 8 * st, (n / NST) & 1);
          const int8_t* vrows = reinterpret_cast<const int8_t*>(ring + st * lay.stage) + a.tile * d;
          for (int base = warp * TPW; base < rows; base += NCW * TPW) {
            const int i = base + ts;
            if (i < rows) {
              const uint4 w = *reinterpret_cast<const uint4*>(vrows + i * d + dsx * 16);
              const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
              for (int g = 0; g < GMAX; ++g) {
                if (g >= I.gc) break;
                const int p8 = static_cast<int>(sblk[g * a.block + t0 + i - blk0]);
#pragma unroll
                for (int e = 0; e < 16; ++e)
                  pacc[g][e] +=
                      p8 * static_cast<int>(static_cast<int8_t>(u[e / 4] >> (8 * (e % 4))));
              }
            }
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(empty0 + 8 * st);
        }
#pragma unroll
        for (int g = 0; g < GMAX; ++g) {
          if (g >= I.gc) break;
#pragma unroll
          for (int e = 0; e < 16; ++e) {
            int v = pacc[g][e];
#pragma unroll
            for (int o = LPT; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
            if (ts == 0) atomicAdd(pvi + g * D + ds * 16 + e, v);
          }
        }
        named_bar_sync(BAR_C, NCT);
        for (int idx = tid; idx < I.gc * D; idx += NCT) {
          const int g = idx / D;
          accs[idx] = __fadd_rn(__fmul_rn(accs[idx], al_s[g]),
                                __fmul_rn(static_cast<float>(pvi[idx]), ps_s[g]));
          pvi[idx] = 0;
        }
        named_bar_sync(BAR_C, NCT);
      }
      finish<D, GMAX, false>(a, I, m_s, l_s, accs, 1, flag, d);
    }
  }
}

template <typename T, int D, int GMAX, bool I8C, bool FULL>
cudaError_t launch(K3Args a, int smem, cudaStream_t st) {
  auto kernel = k3_kernel<T, D, GMAX, I8C, FULL>;
  // The opt-in to > 48 KB and the CTAs a SM at the last shared-memory size,
  // once a device.
  static bool opted[64] = {false};
  static int occ_smem[64] = {0}, occ[64] = {0};
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!opted[dev]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return e;
    opted[dev] = true;
  }
  if (occ_smem[dev] != smem) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ[dev], kernel, NTHREADS, smem);
    if (e != cudaSuccess) return e;
    if (occ[dev] < 1) return cudaErrorInvalidConfiguration;
    occ_smem[dev] = smem;
  }
  e = sm_count(&sms);
  if (e != cudaSuccess) return e;
  const int grid = min(a.n_items, sms * occ[dev]);
  kernel<<<grid, NTHREADS, smem, st>>>(a);
  return cudaGetLastError();
}

// The instantiation of the call's head dim: the width D itself, or narrower.
template <typename T, int D, int GMAX, bool I8C>
cudaError_t launch_width(const K3Args& a, int smem, cudaStream_t st) {
  return a.d == D ? launch<T, D, GMAX, I8C, true>(a, smem, st)
                  : launch<T, D, GMAX, I8C, false>(a, smem, st);
}

template <typename T, int D>
cudaError_t dispatch(const K3Args& a, bool i8c, int smem, cudaStream_t st) {
  // Heads a CTA takes when G > 1: at most 32 registers of q and of acc a
  // lane (16 with fp32 pools, which spill at 32 under 3 CTAs a SM).
  constexpr int GC = sizeof(T) == 4 ? 4 : 2 * sizeof(T);
  if constexpr (std::is_same<T, int8_t>::value) {
    if (i8c) return a.gcmax == 1 ? launch_width<T, D, 1, true>(a, smem, st)
                                 : launch_width<T, D, GC, true>(a, smem, st);
  }
  return a.gcmax == 1 ? launch_width<T, D, 1, false>(a, smem, st)
                      : launch_width<T, D, GC, false>(a, smem, st);
}

// The compiled width of head dim d: 64, 128 or 256.
int k3_width(int d) { return d <= 64 ? 64 : d <= 128 ? 128 : 256; }

// The instantiations of the call's width; D 256 for 1- and 2-byte pools
// only (an fp32 row would need 64 lanes).
template <typename T>
cudaError_t dispatch_width(const K3Args& a, int dc, bool i8c, int smem, cudaStream_t st) {
  if (dc == 64) return dispatch<T, 64>(a, i8c, smem, st);
  if (dc == 128) return dispatch<T, 128>(a, i8c, smem, st);
  if constexpr (sizeof(T) < 4) return dispatch<T, 256>(a, i8c, smem, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// The one entry of K3 (see ops/paged.py::_k3_launch). q (float mode) or q8
// and score_scale (int8 compute); k_new, v_new and slots for the fused
// decode, else null; tbias (B, Hkv, bias_len) or null; ws, counters as in
// the note above (ws may be null when n_split is 1). The split, tile,
// requant block and head chunk come from ops/paged.py::k3_plan.
extern "C" int pfa_paged_k3(const void* q, const void* q8, const void* score_scale,
                            void* k_pool, void* v_pool, void* k_scales, void* v_scales,
                            const void* lengths, const void* tables, const void* tbias,
                            const void* k_new, const void* v_new, const void* slots, void* o,
                            void* ws, void* counters, int layer, int B, int Hq, int Hkv, int D,
                            int num_pages, int page, int pps, int bias_len, int pool_dtype,
                            int in_dtype, int i8c, int split_pages, int n_split, int tile,
                            int block, int gcmax, float sm_scale, void* stream) {
  const int elt = pool_dtype == PFA_INT8 ? 1 : pool_dtype == PFA_BF16 ? 2 : 4;
  const bool quant = pool_dtype == PFA_INT8;
  const bool fused = slots != nullptr;
  // D: the real head dim, up to 256 (128 over fp32 pools), in rows of whole
  // 16-byte units (the bulk copies' granule; ops/paged.py pads other pools);
  // dc: the width.
  const int dc = k3_width(D);
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || D < 1 || D > (elt == 4 ? 128 : 256) ||
      (D * elt) % 16 != 0 ||
      page <= 0 || pps <= 0 ||
      tile <= 0 || split_pages <= 0 || n_split != (pps + split_pages - 1) / split_pages ||
      (page % tile != 0 && tile % page != 0) || counters == nullptr)
    return cudaErrorInvalidValue;
  if (pool_dtype != PFA_INT8 && pool_dtype != PFA_BF16 && pool_dtype != PFA_F32)
    return cudaErrorInvalidValue;
  const int G = Hq / Hkv;
  if (gcmax != (G == 1 ? 1 : elt == 4 ? 4 : 2 * elt)) return cudaErrorInvalidValue;
  if (quant && (page % 4 != 0 || tile % 4 != 0 || !aligned16(k_scales) || !aligned16(v_scales)))
    return cudaErrorInvalidValue;
  if (!aligned16(k_pool) || !aligned16(v_pool)) return cudaErrorInvalidValue;
  if (i8c && (!quant || fused || q8 == nullptr || score_scale == nullptr || block <= 0 ||
              block % page != 0 || (split_pages * page) % block != 0))
    return cudaErrorInvalidValue;
  if (!i8c && q == nullptr) return cudaErrorInvalidValue;
  if (fused && (k_new == nullptr || v_new == nullptr ||
                (in_dtype != PFA_BF16 && in_dtype != PFA_F32)))
    return cudaErrorInvalidValue;
  if (tbias != nullptr && (i8c || bias_len < pps * page)) return cudaErrorInvalidValue;
  if (n_split > 1 && ws == nullptr) return cudaErrorInvalidValue;
  const Layout lay = k3_layout(B, dc, D, elt, gcmax, i8c, tile, split_pages, i8c ? block : 0);
  if (lay.total > SMEM_MAX) return cudaErrorInvalidValue;
  const int n_gchunk = (G + gcmax - 1) / gcmax;
  const long long n_items = (long long)B * Hkv * n_gchunk * n_split;
  if (n_items > INT_MAX) return cudaErrorInvalidValue;

  K3Args a;
  a.q = static_cast<const float*>(q);
  a.q8 = static_cast<const int8_t*>(q8);
  a.score_scale = static_cast<const float*>(score_scale);
  a.k_pool = k_pool;
  a.v_pool = v_pool;
  a.k_scales = static_cast<float*>(k_scales);
  a.v_scales = static_cast<float*>(v_scales);
  a.lengths = static_cast<const int*>(lengths);
  a.tables = static_cast<const int*>(tables);
  a.tbias = static_cast<const float*>(tbias);
  a.k_new = k_new;
  a.v_new = v_new;
  a.slots = static_cast<const int*>(slots);
  a.o = static_cast<float*>(o);
  a.ws = static_cast<float*>(ws);
  a.counters = static_cast<int*>(counters);
  a.head_stride = (long long)num_pages * page;
  a.layer_base = (long long)layer * Hkv * a.head_stride;
  a.B = B;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.G = G;
  a.gcmax = gcmax;
  a.n_gchunk = n_gchunk;
  a.page = page;
  a.pps = pps;
  a.bias_len = bias_len;
  a.split_pages = split_pages;
  a.n_split = n_split;
  a.tile = tile;
  a.block = i8c ? block : 0;
  a.n_items = static_cast<int>(n_items);
  a.d = D;
  a.in_bf16 = in_dtype == PFA_BF16;
  a.sm_scale = sm_scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pool_dtype == PFA_INT8) return dispatch_width<int8_t>(a, dc, i8c, lay.total, st);
  if (pool_dtype == PFA_BF16) return dispatch_width<__nv_bfloat16>(a, dc, i8c, lay.total, st);
  return dispatch_width<float>(a, dc, i8c, lay.total, st);
}

// K3's shared-memory bytes for a plan at head dim D (ops/paged.py::k3_smem
// counts the same; a card test holds the two equal).
extern "C" int pfa_paged_k3_smem(int B, int D, int elt, int gcmax, int i8c, int tile,
                                 int split_pages, int block) {
  return k3_layout(B, k3_width(D), D, elt, gcmax, i8c != 0, tile, split_pages, i8c ? block : 0)
      .total;
}
