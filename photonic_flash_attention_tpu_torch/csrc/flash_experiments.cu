// K16-K19: the forward design-space experiments on mma.sync (sm_90a).
//
// Replace the TPU kernels of benchmarks/ (B15d-h):
// * K16 pfa_flash_pipelined: flash_pipeline_experiment.py::_kernel (the KV
//   loop software-pipelined so QK(j+1) overlaps softmax(j)), fp32 inputs
//   here, bf16 on the Hopper body of flash_experiments_sm90.cu;
// * K17 pfa_flash_chunked: flash_pipeline_experiment.py::_kernel_chunked
//   (K/V staged in chunks of `unroll` tiles, one copy and one barrier a
//   chunk, the chunk's tiles unrolled at compile time), fp32 inputs here,
//   bf16 on the Hopper body of flash_experiments_sm90.cu;
// * K18 pfa_flash_tri: _kernel_tri and _kernel_tri_i8 (one launch per q
//   row-block; its int8 mode runs Q.K in s8), fp32 inputs and the int8
//   mode with an fp32 V here; bf16 inputs on flash_experiments_sm90.cu,
//   the int8 mode with a bf16 V on the quantized body of
//   flash_quant_sm90.cu (flash_quant_sm90<D, INT8QK, true>);
// * K19 pfa_flash_fulltri: _kernel_fulltri (one CTA walks a head's whole
//   causal triangle, the next row's first tiles fetched during the last
//   tile of the current one), fp32 inputs here, bf16 on
//   flash_experiments_sm90.cu.
// K13 (fixed max), K14 (augmented V) and K15 (paired chains) run only on
// the Hopper body of flash_experiments_sm90.cu (bf16). Callers:
// experiments/flash_*_experiment.py in the port package.
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
// FADD.
//
// The causal mask of all of them is the experiments' `col <= row` (top-left),
// not K1's end-aligned diagonal; the two agree for square shapes. Every
// row sees key 0, so after the first tile every running max is finite and
// masked keys can be -inf where JAX uses a finite mask value: they
// contribute exactly 0 either way.

#include "common.cuh"

namespace {

constexpr int XBQ = 64;       // query rows of one chain: 4 warps x 16
constexpr int XBKV = 64;      // keys per K/V tile
constexpr int XTHREADS = 128;
constexpr int NT = XBKV / 8;  // 8-wide score tiles per K/V tile

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
// the running sum l is rescaled by alpha. A row with no key yet (only in a
// masked tile) keeps base 0.
template <bool MASKED>
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
    l[i] *= alpha[i];
  }
}

// p = exp2(s * sc - base) for the tile's scores, one FFMA and one exp
// each; each p is added into l.
__device__ __forceinline__ void exp_tiles(float s[NT][4], float l[2], const float base[2],
                                          float sc) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[n][e] = exp2f(fmaf(s[n][e], sc, -base[e >> 1]));
      l[e >> 1] += s[n][e];
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

// `rows` rows of bf16 or fp32 (converted) into bf16 shared memory: by
// cp.async for bf16 (the caller commits and waits), synchronously for fp32.
template <int D, int LD>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long stride, int rows, int valid) {
  load_tile_bf16_async<D, LD, XTHREADS>(dst, src, stride, rows, valid);
}
template <int D, int LD>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const float* src, long long stride,
                                          int rows, int valid) {
  load_tile_cvt<D, LD, XTHREADS>(dst, src, stride, rows, valid);
}

template <int D, int LD, typename T>
__device__ __forceinline__ void load_kv(__nv_bfloat16* dst, const T* src, long long stride,
                                        int valid) {
  load_rows<D, LD>(dst, src, stride, XBKV, valid);
}

template <int D, bool MASKED>
__device__ __forceinline__ void pipelined_softmax_pv(float s[NT][4], float acc[D / 8][4],
                                                     float m[2], float l[2], float sc, int kv0,
                                                     const int rows[2], int S, bool causal,
                                                     const __nv_bfloat16* Vs, int g, int t4) {
  float alpha[2], base[2];
  if (MASKED) mask_tile(s, kv0, rows, S, causal, t4);
  softmax_stats<MASKED>(s, m, l, alpha, base, sc);
  exp_tiles(s, l, base, sc);
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

// --- K17: chunked K/V staging ---------------------------------------------
//
// fp32 inputs (converted to bf16 on load) only: bf16 runs on the TMA +
// wgmma body of flash_experiments_sm90.cu.
//
// _kernel_chunked's TPU grid is (b, h, q block, kv chunk): one chunk of
// `unroll` kv tiles a grid step, m/l/acc carried in VMEM scratch between
// steps, dead chunks skipped whole when causal. Here a CTA of 64 query rows
// loops over chunks of U 64-key tiles (U the call's unroll, a template
// parameter): a chunk's K and V are copied by one cp.async group and read
// after one barrier (K16 waits once a tile), and its U tiles run in a loop
// unrolled at compile time, the state in registers (a loop inside the block
// takes the place of the grid's scratch carry). The causal skip stays
// chunk-granular as on the TPU: a chunk runs whole when any of its keys is
// live for the CTA's rows, and its tiles past a warp's diagonal are masked
// to -inf (each adds p = 0 with alpha = 1): that waste is part of what the
// experiment measures. The chunk buffer is doubled (the next chunk's copy
// in flight during this chunk's tiles) where two fit in 227 KB: D 64 at U 2
// and 4 (83 and 157 KB), D 128 at U 2 (157 KB). D 128 at U 4 holds one
// (157 KB, one CTA a SM) and copies the next chunk after the last tile.
// Bound as K1 (at D 64 the softmax stream, ~41 us against the tensor
// cores' ~26 at B4 S2048 H12 causal): a tile's per-score work is K16's
// fp32 body's; the chunk only thins the copies and
// barriers around it, and its shared memory sets how many CTAs share a SM.
constexpr int SMEM_LIMIT = 232448;

__host__ __device__ constexpr int chunk_smem(int d, int u, int bufs) {
  return (XBQ + 2 * bufs * u * XBKV) * (d + 8) * 2;
}
__host__ __device__ constexpr int chunk_bufs(int d, int u) {
  return chunk_smem(d, u, 2) <= SMEM_LIMIT ? 2 : 1;
}

template <int D, int U, typename T>
__global__ void __launch_bounds__(XTHREADS)
flash_chunked_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ o, int S, int Hq, int Hkv, float scale, int causal) {
  constexpr int LD = D + 8, SPAN = U * XBKV, CHUNK = SPAN * LD, NBUF = chunk_bufs(D, U);
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Kb = Qs + XBQ * LD;      // NBUF K chunks
  __nv_bfloat16* Vb = Kb + NBUF * CHUNK;  // NBUF V chunks

  const int q0 = blockIdx.x * XBQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3, wr = warp * 16;
  const long long qstr = (long long)Hq * D, kvstr = (long long)Hkv * D;
  const long long qbase = (long long)b * S * qstr + (long long)h * D;
  const T* kb = k + (long long)b * S * kvstr + (long long)hk * D;
  const T* vb = v + (long long)b * S * kvstr + (long long)hk * D;
  const int kv_end = causal ? min(S, q0 + XBQ) : S;  // chunk c runs while c * SPAN < kv_end
  const int nc = (kv_end + SPAN - 1) / SPAN;

  load_rows<D, LD>(Qs, q + qbase + q0 * qstr, qstr, XBQ, S - q0);
  load_rows<D, LD>(Kb, kb, kvstr, SPAN, S);
  load_rows<D, LD>(Vb, vb, kvstr, SPAN, S);
  cp_async_commit();

  uint32_t qf[D / 16][4];
  const int rows[2] = {q0 + wr + g, q0 + wr + g + 8};
  const float sc = scale * LOG2E;
  float acc[D / 8][4] = {};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int c = 0; c < nc; ++c) {
    const int c0 = c * SPAN;
    int buf = 0;
    if (NBUF == 2) {
      cp_async_wait<0>();  // chunk c
      __syncthreads();     // and every warp is past chunk c-1, whose buffer is refilled now
      buf = c & 1;
      if (c + 1 < nc) {
        const int n0 = c0 + SPAN;
        load_rows<D, LD>(Kb + (buf ^ 1) * CHUNK, kb + n0 * kvstr, kvstr, SPAN, S - n0);
        load_rows<D, LD>(Vb + (buf ^ 1) * CHUNK, vb + n0 * kvstr, kvstr, SPAN, S - n0);
        cp_async_commit();
      }
    } else {
      if (c > 0) {
        __syncthreads();  // every warp is past chunk c-1
        load_rows<D, LD>(Kb, kb + c0 * kvstr, kvstr, SPAN, S - c0);
        load_rows<D, LD>(Vb, vb + c0 * kvstr, kvstr, SPAN, S - c0);
        cp_async_commit();
      }
      cp_async_wait<0>();
      __syncthreads();
    }
    if (c == 0) q_frags<D, LD>(qf, Qs, wr, g, t4);
    const __nv_bfloat16* Ks = Kb + buf * CHUNK;
    const __nv_bfloat16* Vs = Vb + buf * CHUNK;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int kv0 = c0 + u * XBKV;
      float s[NT][4];
      qk_tile<D, LD>(s, qf, Ks + u * XBKV * LD, g, t4);
      if (kv0 + XBKV > S || (causal && kv0 + XBKV - 1 > q0 + wr))
        pipelined_softmax_pv<D, true>(s, acc, m, l, sc, kv0, rows, S, causal,
                                      Vs + u * XBKV * LD, g, t4);
      else
        pipelined_softmax_pv<D, false>(s, acc, m, l, sc, kv0, rows, S, causal,
                                       Vs + u * XBKV * LD, g, t4);
    }
  }
  quad_sum(l);
  store_rows<D>(o, acc, l, rows, S, qstr, qbase, t4);
}

// --- K18: one launch per q row-block ---------------------------------------
//
// _kernel_tri's host loop makes one pallas_call per q row-block i over a
// static kv extent of whole block_kv tiles (min(ceil((i+1) bq / bkv), S /
// bkv)), masking only the tiles that reach past the row-block's first row;
// _kernel_tri_i8 is the same with Q and K int8 per tensor, causal or not
// (not: every row-block the full extent). The port keeps the host loop:
// each launch gets the row-block's first row and its row count, runs
// ceil(rows / 64) CTAs a (b, h) and writes its rows of the one output in
// place. The static extent has no counterpart: a CTA walks its 64-key tiles
// up to its own diagonal when causal (the extent's tiles past it are wholly
// masked and add nothing), else to S, K/V double-buffered by cp.async with
// one barrier a tile, the mask only on a warp's diagonal tile and the
// ragged end.
// The int8 mode (I8) with an fp32 V (a bf16 V runs on the Hopper quantized
// body of flash_quant_sm90.cu): q and k are int8 payloads (rows of D + 16
// bytes in shared memory, conflict-free fragment loads), Q.K runs on
// mma.sync m16n8k32 s8 x s8 -> s32, and the raw integer scores are scaled
// by the (1,) fp32 device scalar score_scale (qs * ks * sm_scale, read
// here, never on the host) folded with log2 e; V converted to bf16 on
// load, P rounded to bf16 for P.V, the output fp32. Bound as K1, and the
// int8 mode's Q.K at twice the bf16 tensor rate still leaves the softmax
// stream the limit at D 64; a tile's per-score work is the control's, and
// what the launch structure adds is load balance: each launch ends with
// its longest CTA, the one at the row-block's diagonal.

// rows x D int8 from global (row stride `stride` bytes) into shared memory
// with byte pitch LDB by cp.async; rows at or past `valid` are zero-filled.
template <int D, int LDB>
__device__ __forceinline__ void load_tile_u8_async(uint8_t* dst, const uint8_t* src,
                                                   long long stride, int rows, int valid) {
  constexpr int CH = D / 16;
  for (int i = threadIdx.x; i < rows * CH; i += XTHREADS) {
    const int r = i / CH, c = (i % CH) * 16;
    cp_async16(dst + r * LDB + c, r < valid ? src + r * stride + c : src, r < valid);
  }
}

// One 64-row Q or K tile: int8 payload rows (I8), or bf16/fp32 rows in bf16.
template <int D, bool I8, typename T>
__device__ __forceinline__ void load_qk_tile(uint8_t* dst, const void* src, long long off,
                                             long long stride, int valid) {
  if constexpr (I8)
    load_tile_u8_async<D, D + 16>(dst, static_cast<const uint8_t*>(src) + off, stride, XBKV,
                                  valid);
  else
    load_rows<D, D + 8>(reinterpret_cast<__nv_bfloat16*>(dst), static_cast<const T*>(src) + off,
                        stride, XBKV, valid);
}

// s = Q K^T over one 64-key tile of int8 payloads: exact int32 sums as fp32.
template <int D>
__device__ __forceinline__ void qk_tile_s8(float s[NT][4], uint32_t qf[D / 32][4],
                                           const uint8_t* Ks, int g, int t4) {
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    int ci[4] = {0, 0, 0, 0};
#pragma unroll
    for (int kc = 0; kc < D / 32; ++kc) {
      uint32_t b0, b1;
      b_frag8_t<D + 16>(b0, b1, Ks, n * 8, kc * 32, g, t4);
      mma_s8_16832(ci, qf[kc], b0, b1);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = static_cast<float>(ci[e]);
  }
}

template <int D, bool I8>
__host__ __device__ constexpr int qk_tile_bytes() {
  return I8 ? XBKV * (D + 16) : XBKV * (D + 8) * 2;
}

template <int D, typename T, bool I8>
__global__ void __launch_bounds__(XTHREADS)
flash_tri_kernel(const void* __restrict__ q, const void* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, const float* __restrict__ score_scale, int S, int Hq,
                 int Hkv, int q_row0, int nrows, float scale, int causal) {
  constexpr int LD = D + 8, QKT = qk_tile_bytes<D, I8>(), VT = XBKV * LD;
  extern __shared__ __align__(16) unsigned char smem[];
  uint8_t* Qs = smem;
  uint8_t* Kb = Qs + QKT;  // two K tiles
  __nv_bfloat16* Vb = reinterpret_cast<__nv_bfloat16*>(Kb + 2 * QKT);  // two V tiles

  const int q0 = q_row0 + blockIdx.x * XBQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int row_end = min(S, q_row0 + nrows);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3, wr = warp * 16;
  const long long qstr = (long long)Hq * D, kvstr = (long long)Hkv * D;
  const long long qbase = (long long)b * S * qstr + (long long)h * D;
  const long long kvbase = (long long)b * S * kvstr + (long long)hk * D;
  const T* vb = v + kvbase;
  const int kv_end = causal ? min(S, q0 + XBQ) : S;
  const int n = (kv_end + XBKV - 1) / XBKV;

  load_qk_tile<D, I8, T>(Qs, q, qbase + q0 * qstr, qstr, row_end - q0);
  load_qk_tile<D, I8, T>(Kb, k, kvbase, kvstr, S);
  load_kv<D, LD>(Vb, vb, kvstr, S);
  cp_async_commit();

  uint32_t qf[I8 ? D / 32 : D / 16][4];
  const int rows[2] = {q0 + wr + g, q0 + wr + g + 8};
  const float sc = (I8 ? *score_scale : scale) * LOG2E;
  float acc[D / 8][4] = {};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int j = 0; j < n; ++j) {
    cp_async_wait<0>();  // tile j
    __syncthreads();     // and every warp is past tile j-1, whose buffers are refilled now
    const int kv0 = j * XBKV, buf = j & 1;
    if (j + 1 < n) {
      const int n0 = kv0 + XBKV;
      load_qk_tile<D, I8, T>(Kb + (buf ^ 1) * QKT, k, kvbase + n0 * kvstr, kvstr, S - n0);
      load_kv<D, LD>(Vb + (buf ^ 1) * VT, vb + n0 * kvstr, kvstr, S - n0);
      cp_async_commit();
    }
    float s[NT][4];
    if constexpr (I8) {
      if (j == 0) {
#pragma unroll
        for (int kc = 0; kc < D / 32; ++kc) load_a_frag8<D + 16>(qf[kc], Qs, wr, kc * 32, g, t4);
      }
      qk_tile_s8<D>(s, qf, Kb + buf * QKT, g, t4);
    } else {
      if (j == 0) q_frags<D, LD>(qf, reinterpret_cast<const __nv_bfloat16*>(Qs), wr, g, t4);
      qk_tile<D, LD>(s, qf, reinterpret_cast<const __nv_bfloat16*>(Kb + buf * QKT), g, t4);
    }
    if (kv0 + XBKV > S || (causal && kv0 + XBKV - 1 > q0 + wr))
      pipelined_softmax_pv<D, true>(s, acc, m, l, sc, kv0, rows, S, causal, Vb + buf * VT, g, t4);
    else
      pipelined_softmax_pv<D, false>(s, acc, m, l, sc, kv0, rows, S, causal, Vb + buf * VT, g,
                                     t4);
  }
  quad_sum(l);
  store_rows<D>(o, acc, l, rows, row_end, qstr, qbase, t4);
}

// --- K19: one CTA walks a head's whole triangle -----------------------------
//
// fp32 inputs (converted to bf16 on load) only: bf16 runs on the TMA +
// wgmma body of flash_experiments_sm90.cu.
//
// _kernel_fulltri's grid is (b, h): every q row-block of a head and its
// causal kv tiles in one straight-line body, so the scheduler can overlap
// one row's epilogue with the next row's products. Here one CTA per (b, h)
// walks the head's 64-row q tiles, heaviest (last) first, as one stream of
// (row tile, kv tile) steps: each step has the next step's K/V tile in
// flight by cp.async, and a row's last step also the next row's Q (Q
// double-buffered), so the epilogue (row sums, normalise, store) overlaps
// the next row's copies. A head's K/V (512 KB at S 2048, D 64) does not fit
// 227 KB: tiles are streamed, each row re-reading its keys (from L2). One
// CTA a head is the function measured, 48 CTAs at B4 H12 for 132 SMs, so a
// loss to K1 is expected; the head is not split and no cluster is used.
// Bound as K1 (the softmax stream at D 64) over the whole card, but one
// CTA holds a SM here: four warps must hide the latency of each tile's
// chain of products and exps, which several CTAs a SM hide together in K1.
template <int D, typename T>
__global__ void __launch_bounds__(XTHREADS)
flash_fulltri_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ o, int S, int Hq, int Hkv, float scale) {
  constexpr int LD = D + 8, TILE = XBKV * LD;  // XBQ == XBKV: a Q tile is a K/V tile
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qb = reinterpret_cast<__nv_bfloat16*>(smem);  // two Q tiles
  __nv_bfloat16* Kb = Qb + 2 * TILE;                            // two K tiles
  __nv_bfloat16* Vb = Kb + 2 * TILE;                            // two V tiles

  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3, wr = warp * 16;
  const long long qstr = (long long)Hq * D, kvstr = (long long)Hkv * D;
  const long long qbase = (long long)b * S * qstr + (long long)h * D;
  const T* kb = k + (long long)b * S * kvstr + (long long)hk * D;
  const T* vb = v + (long long)b * S * kvstr + (long long)hk * D;
  // the causal kv tiles of row tile rt: up to its last row
  auto tiles_of = [S](int rt) { return (min(S, rt * XBQ + XBQ) + XBKV - 1) / XBKV; };

  int rt = (S + XBQ - 1) / XBQ - 1, j = 0, n = tiles_of(rt), buf = 0, qbuf = 0;
  load_rows<D, LD>(Qb, q + qbase + (long long)rt * XBQ * qstr, qstr, XBQ, S - rt * XBQ);
  load_kv<D, LD>(Kb, kb, kvstr, S);
  load_kv<D, LD>(Vb, vb, kvstr, S);
  cp_async_commit();

  uint32_t qf[D / 16][4];
  int rows[2] = {0, 0};
  const float sc = scale * LOG2E;
  float acc[D / 8][4] = {};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  while (true) {
    cp_async_wait<0>();  // this step's tiles
    __syncthreads();     // and every warp is past the step before, whose buffers are refilled now
    int next_rt = rt, next_j = j + 1;
    if (next_j == n) {
      next_rt = rt - 1;
      next_j = 0;
    }
    if (next_rt >= 0) {
      if (next_j == 0)
        load_rows<D, LD>(Qb + (qbuf ^ 1) * TILE, q + qbase + (long long)next_rt * XBQ * qstr,
                         qstr, XBQ, S - next_rt * XBQ);
      const long long n0 = (long long)next_j * XBKV;
      load_kv<D, LD>(Kb + (buf ^ 1) * TILE, kb + n0 * kvstr, kvstr, S - (int)n0);
      load_kv<D, LD>(Vb + (buf ^ 1) * TILE, vb + n0 * kvstr, kvstr, S - (int)n0);
      cp_async_commit();
    }
    const int q0 = rt * XBQ, kv0 = j * XBKV;
    if (j == 0) {  // a new row tile
      q_frags<D, LD>(qf, Qb + qbuf * TILE, wr, g, t4);
      rows[0] = q0 + wr + g;
      rows[1] = rows[0] + 8;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
      m[0] = m[1] = -INFINITY;
      l[0] = l[1] = 0.f;
    }
    float s[NT][4];
    qk_tile<D, LD>(s, qf, Kb + buf * TILE, g, t4);
    if (kv0 + XBKV > S || kv0 + XBKV - 1 > q0 + wr)
      pipelined_softmax_pv<D, true>(s, acc, m, l, sc, kv0, rows, S, true, Vb + buf * TILE, g, t4);
    else
      pipelined_softmax_pv<D, false>(s, acc, m, l, sc, kv0, rows, S, true, Vb + buf * TILE, g, t4);
    if (j == n - 1) {  // the row's epilogue, the next row's copies in flight
      quad_sum(l);
      store_rows<D>(o, acc, l, rows, S, qstr, qbase, t4);
    }
    if (next_rt < 0) break;
    if (next_j == 0) {
      qbuf ^= 1;
      n = tiles_of(next_rt);
    }
    rt = next_rt;
    j = next_j;
    buf ^= 1;
  }
}

template <typename Kern, typename... Args>
cudaError_t launch_k(Kern kern, dim3 grid, int smem, cudaStream_t st, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kern<<<grid, XTHREADS, smem, st>>>(args...);
  return cudaGetLastError();
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

template <int D, int U, typename T>
cudaError_t run_chunked(const void* q, const void* k, const void* v, void* o, int B, int S,
                        int Hq, int Hkv, float scale, int causal, cudaStream_t st) {
  const dim3 grid((S + XBQ - 1) / XBQ, Hq, B);
  return launch_k(flash_chunked_kernel<D, U, T>, grid, chunk_smem(D, U, chunk_bufs(D, U)), st,
                  static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
                  static_cast<T*>(o), S, Hq, Hkv, scale, causal);
}

// fp32 inputs only: bf16 runs on flash_experiments_sm90.cu.
template <int D, int U>
cudaError_t chunked_dtype(int dtype, const void* q, const void* k, const void* v, void* o, int B,
                          int S, int Hq, int Hkv, float scale, int causal, cudaStream_t st) {
  if (dtype == PFA_F32) return run_chunked<D, U, float>(q, k, v, o, B, S, Hq, Hkv, scale, causal, st);
  return cudaErrorInvalidValue;
}

template <int D, typename T, bool I8>
cudaError_t run_tri(const void* q, const void* k, const void* v, void* o, const float* sc, int B,
                    int S, int Hq, int Hkv, int q_row0, int rows, float scale, int causal,
                    cudaStream_t st) {
  const dim3 grid((rows + XBQ - 1) / XBQ, Hq, B);
  const int smem = 3 * qk_tile_bytes<D, I8>() + 2 * XBKV * (D + 8) * (int)sizeof(__nv_bfloat16);
  return launch_k(flash_tri_kernel<D, T, I8>, grid, smem, st, q, k, static_cast<const T*>(v),
                  static_cast<T*>(o), sc, S, Hq, Hkv, q_row0, rows, scale, causal);
}

// fp32 only: the plain mode's bf16 inputs run on flash_experiments_sm90.cu,
// the int8 mode's bf16 V on flash_quant_sm90.cu.
template <int D, bool I8>
cudaError_t tri_dtype(int dtype, const void* q, const void* k, const void* v, void* o,
                      const float* sc, int B, int S, int Hq, int Hkv, int q_row0, int rows,
                      float scale, int causal, cudaStream_t st) {
  if (dtype == PFA_F32)
    return run_tri<D, float, I8>(q, k, v, o, sc, B, S, Hq, Hkv, q_row0, rows, scale, causal, st);
  return cudaErrorInvalidValue;
}

template <int D, typename T>
cudaError_t run_fulltri(const void* q, const void* k, const void* v, void* o, int B, int S,
                        int Hq, int Hkv, float scale, cudaStream_t st) {
  const dim3 grid(Hq, B);
  const int smem = 6 * XBKV * (D + 8) * (int)sizeof(__nv_bfloat16);
  return launch_k(flash_fulltri_kernel<D, T>, grid, smem, st, static_cast<const T*>(q),
                  static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(o), S, Hq,
                  Hkv, scale);
}

}  // namespace

// K16 in fp32 (the bf16 body: pfa_flash_pipelined_sm90). q (B, S, Hq, D),
// k/v (B, S, Hkv, D), o like q; fp32 (dtype), D in {64, 128}, Hq % Hkv == 0.
extern "C" int pfa_flash_pipelined(const void* q, const void* k, const void* v, void* o, int B,
                                   int S, int Hq, int Hkv, int D, float sm_scale, int causal,
                                   int dtype, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == PFA_F32 && D == 64)
    return run_pipelined<64, float>(q, k, v, o, B, S, Hq, Hkv, sm_scale, causal, st);
  if (dtype == PFA_F32 && D == 128)
    return run_pipelined<128, float>(q, k, v, o, B, S, Hq, Hkv, sm_scale, causal, st);
  return cudaErrorInvalidValue;
}

// K17 in fp32 (the bf16 body: pfa_flash_chunked_sm90). q (B, S, Hq, D),
// k/v (B, S, Hkv, D), o like q; fp32 (dtype), D in {64, 128}, Hq % Hkv ==
// 0; unroll (64-key tiles a chunk) in {2, 4}.
extern "C" int pfa_flash_chunked(const void* q, const void* k, const void* v, void* o, int B,
                                 int S, int Hq, int Hkv, int D, float sm_scale, int causal,
                                 int unroll, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64 && unroll == 2)
    return chunked_dtype<64, 2>(dtype, q, k, v, o, B, S, Hq, Hkv, sm_scale, causal, st);
  if (D == 64 && unroll == 4)
    return chunked_dtype<64, 4>(dtype, q, k, v, o, B, S, Hq, Hkv, sm_scale, causal, st);
  if (D == 128 && unroll == 2)
    return chunked_dtype<128, 2>(dtype, q, k, v, o, B, S, Hq, Hkv, sm_scale, causal, st);
  if (D == 128 && unroll == 4)
    return chunked_dtype<128, 4>(dtype, q, k, v, o, B, S, Hq, Hkv, sm_scale, causal, st);
  return cudaErrorInvalidValue;
}

// K18 in fp32 and its int8 mode with an fp32 V (bf16: pfa_flash_tri_sm90;
// the int8 mode's bf16 V: pfa_flash_tri_i8_sm90). Query rows [q_row0,
// q_row0 + rows) of q (B, S, Hq, D) against k/v (B, S, Hkv, D), causal
// (col <= row) or not, written into o (B, S, Hq, D) in place; D in {64,
// 128}, Hq % Hkv == 0. q, k, v and o fp32 (dtype), or with qk_int8 q and k
// int8 payloads, score_scale a (1,) fp32 device scalar, v and o fp32.
extern "C" int pfa_flash_tri(const void* q, const void* k, const void* v, void* o,
                             const void* score_scale, int B, int S, int Hq, int Hkv, int D,
                             int q_row0, int rows, float sm_scale, int causal, int qk_int8,
                             int dtype, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0 || rows <= 0 || q_row0 < 0 ||
      q_row0 >= S || (qk_int8 && score_scale == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(score_scale);
  if (D == 64 && qk_int8)
    return tri_dtype<64, true>(dtype, q, k, v, o, sc, B, S, Hq, Hkv, q_row0, rows, sm_scale,
                               causal, st);
  if (D == 64)
    return tri_dtype<64, false>(dtype, q, k, v, o, sc, B, S, Hq, Hkv, q_row0, rows, sm_scale,
                                causal, st);
  if (D == 128 && qk_int8)
    return tri_dtype<128, true>(dtype, q, k, v, o, sc, B, S, Hq, Hkv, q_row0, rows, sm_scale,
                                causal, st);
  if (D == 128)
    return tri_dtype<128, false>(dtype, q, k, v, o, sc, B, S, Hq, Hkv, q_row0, rows, sm_scale,
                                 causal, st);
  return cudaErrorInvalidValue;
}

// K19 in fp32 (the bf16 body: pfa_flash_fulltri_sm90). q (B, S, Hq, D),
// k/v (B, S, Hkv, D), o like q, causal; fp32 (dtype), D in {64, 128},
// Hq % Hkv == 0.
extern "C" int pfa_flash_fulltri(const void* q, const void* k, const void* v, void* o, int B,
                                 int S, int Hq, int Hkv, int D, float sm_scale, int dtype,
                                 void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == PFA_F32 && D == 64)
    return run_fulltri<64, float>(q, k, v, o, B, S, Hq, Hkv, sm_scale, st);
  if (dtype == PFA_F32 && D == 128)
    return run_fulltri<128, float>(q, k, v, o, B, S, Hq, Hkv, sm_scale, st);
  return cudaErrorInvalidValue;
}
