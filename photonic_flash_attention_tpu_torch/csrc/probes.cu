// K9-K12: the card's own rates, measured by four probes for Hopper (sm_90a).
//
// The roofline (hardware/roofline.py) divides work by the rates these
// kernels measure: HBM read and copy bandwidth, the exp rate, and the rate
// of the online-softmax stream that bounds K1 at head dim 64.
//
// K9 (pfa_hbm_read) replaces photonic_flash_attention_tpu/ops/hbm_bw.py::
// _read_kernel (hbm_read_probe): read every byte of x once, return 8 rows of
// it. Bound: bytes / 3.35 TB/s (H100 SXM data sheet at its 700 W limit),
// 0.0801 ms for bench.py's (262144, 512) bf16. The TPU kernel streams 4 MB
// chunks through two VMEM slots by DMA; here every thread streams 16-byte
// loads, neighbouring threads on neighbouring addresses, in a grid-stride
// loop over one full wave of blocks (the occupancy API sizes the grid), with
// STREAM_UNROLL loads in flight per thread: 256 threads x 8 x 16 B = 32 KB
// per block, several MB over a wave of blocks, above the ~2 MB the card
// needs in flight at 3.35 TB/s and ~0.6 us of latency.
// K10 (pfa_hbm_copy) replaces ::_copy_kernel (hbm_copy): y = x. Bound:
// 2 x bytes / 3.35 TB/s. The TPU kernel streams 2 MB tiles HBM -> VMEM ->
// HBM by DMA; here the TMA's 1-D bulk copy does the same through shared
// memory: the array in 32 KB chunks, one thread of a CTA loading its
// chunks into a ring of stages (cp.async.bulk onto the stage's mbarrier),
// storing each back once it is full (cp.async.bulk.global.shared::cta) and
// reloading a stage once that store has read it
// (cp.async.bulk.wait_group.read). No register holds data, so loads and
// stores do not wait on each other. The host picks the grid
// (ops/hbm_bw.py::k10_plan): a CTA a chunk, three resident a SM and handed
// out in the array's order by the block scheduler, ran as fast as
// y.copy_(x) on the H100; a persistent CTA a SM walking the chunks
// grid-strided (or each over a span of its own), at any depth of ring, ran
// 4-8 % slower, and an L2 evict_first hint on the stores moved nothing
// (PERF.md). The chunk and the stages are the plan's too.
// K11 (pfa_exp_probe) replaces photonic_flash_attention_tpu/ops/
// device_probes.py::_exp_kernel (exp_probe): `iters` chained x <- exp(-x),
// returning rows 0-7. Bound: exps over the MUFU rate, 16 a clock per SM
// (CUDA C++ Programming Guide, exp2f at compute capability 9.0) x 132 SMs x
// the SM clock. Each thread holds one float4 (four independent chains) and
// computes exp as K1 does, exp2f(x * log2 e) (csrc/flash_fwd.cu:153).
// K12 (pfa_softmax_probe) replaces ::_softmax_kernel (softmax_block_probe):
// `iters` chained online-softmax block updates over (rows, cols) fp32,
// returning rows 0-7 (and their running sums l). Bound: the larger of
// (elements + rows) x iters exps over the MUFU rate and the instructions
// the function needs per element over 128 issue lanes a clock per SM: 5.5
// unmasked (FFMA, FMNMX, FADD, half an F2FP, the bf16 unpack, MUFU.EX2),
// 7.5 masked (+ compare and select), both below the MUFU term's 8 (128 /
// 16), so MUFU binds. The TPU probe mirrors the TPU flash kernel's
// lane-replicated statistics; this one mirrors K1's Hopper softmax step
// (csrc/flash_sm90_step.cuh): every exp one FFMA and one
// ex2.approx.ftz.f32 (sm90.cuh::ex2), p = ex2(s log2 e - m log2 e) and
// alpha = ex2(m_prev log2 e - m log2 e); its update loop holds 7.9 (masked)
// and 5.7 (unmasked) instructions a value besides MUFU.EX2 at 512 columns
// (chip_smoke.py::k12_sass_counts). A row's values live in the registers
// of SOFTMAX_GROUP = 8 threads, cols / 8 a thread (64 at 512 columns), the
// max and the sum taken by three __shfl_xor_sync (K1 reduces across a
// quad by two): a quad a row (128 values a thread at 512 columns, three
// blocks a SM) ran both modes 6-7 % slower than eight threads a row (six
// blocks a SM; PERF.md), and every width takes the one layout, so the
// stream's linear fit (128 and 512 columns) compares one code.
// A thread's max and sum run in CHAINS independent partial chains
// (values j % CHAINS, pairs p % CHAINS), folded by a tree, so no one chain
// is VPT links long. Each update: the optional mask select
// col <= it + mask_bound on every value, the row max, p, alpha, l = alpha
// l + sum p, s <- f32(bf16(p)), the cast by pairs as K1 packs P. Both
// modes run this one step, so the masked mode's extra time is the mask's
// and its outputs equal the unmasked mode's bit for bit.
//
// Nothing may be dead code: the TPU kernels were kept alive by
// has_side_effects and VMEM writes, while nvcc drops any load or arithmetic
// whose value reaches no store, and may sink a thread's whole chain under
// the branch that stores the returned rows. So every thread folds its final
// values (and K12's m, and l, which only rows 0-7 return) into one
// register and stores it to a sink only where it equals `sentinel`, a
// kernel argument: the compare needs every value, so every load and every
// link of every chain runs. K12's mask bound is a kernel argument too, so nvcc cannot prove the
// select always true (it always is: col < cols <= mask_bound); masked and
// unmasked are compile-time modes, as K1's modes are.

#include "sm90.cuh"

namespace {

constexpr int STREAM_THREADS = 256;
constexpr int STREAM_UNROLL = 8;  // 16-byte loads in flight per thread
constexpr int EXP_THREADS = 256;  // K11: one float4 per thread and step
constexpr int SOFTMAX_THREADS = 128;
constexpr int SOFTMAX_GROUP = 8;  // K12: threads a row
constexpr int CHAINS = 4;  // K12: independent partial max and sum chains a thread
constexpr float PROBE_MASK = -1e30f;  // the TPU probe's mask value and m_0

__device__ __forceinline__ uint32_t fold(uint4 v) { return v.x ^ v.y ^ v.z ^ v.w; }

__device__ __forceinline__ uint32_t fold(float4 v) {
  return __float_as_uint(v.x) ^ __float_as_uint(v.y) ^ __float_as_uint(v.z) ^
         __float_as_uint(v.w);
}

// K9. Every 16-byte vector of x once (grid-stride, STREAM_UNROLL in
// flight); block 0 then copies the returned slice (8 rows) to out.
__global__ void __launch_bounds__(STREAM_THREADS)
hbm_read(const uint4* __restrict__ x, long long n_vec, const uint4* __restrict__ slice,
         uint4* __restrict__ out, int slice_vec, uint32_t sentinel, uint32_t* __restrict__ sink) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t acc = 0;
  for (; i + (STREAM_UNROLL - 1) * stride < n_vec; i += STREAM_UNROLL * stride) {
    uint4 v[STREAM_UNROLL];
#pragma unroll
    for (int u = 0; u < STREAM_UNROLL; ++u) v[u] = x[i + u * stride];
#pragma unroll
    for (int u = 0; u < STREAM_UNROLL; ++u) acc ^= fold(v[u]);
  }
  for (; i < n_vec; i += stride) acc ^= fold(x[i]);
  if (acc == sentinel) sink[0] = acc;
  if (blockIdx.x == 0)
    for (int j = threadIdx.x; j < slice_vec; j += blockDim.x) out[j] = slice[j];
}

// K10. y = x in chunks of `chunk` bytes (the last one the rest of n_bytes,
// a multiple of 16): CTA b copies chunks b, b + grid, ... of the n_chunks
// through a ring of `stages` stages of `chunk` bytes and their mbarriers.
// One thread issues every copy: the ring filled, then for each chunk in
// turn: wait for it, store it back, and reload the stage the chunk before
// it held, once that chunk's store has read it (one store's group left
// pending). Everything done before the CTA exits.
__global__ void __launch_bounds__(32)
hbm_copy_ring(const unsigned char* __restrict__ x, unsigned char* __restrict__ y,
              long long n_bytes, long long n_chunks, int chunk, int stages) {
  extern __shared__ __align__(128) unsigned char ring[];
  if (threadIdx.x != 0) return;
  const uint32_t buf = smem_u32(ring), bar = buf + stages * chunk;
  for (int s = 0; s < stages; ++s) mbar_init(bar + 8 * s, 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  const long long g = gridDim.x, b = blockIdx.x, n = (n_chunks - b + g - 1) / g;
  auto at = [&](long long j) { return (b + j * g) * chunk; };  // the j-th chunk's offset
  auto bytes_of = [&](long long j) {
    const long long left = n_bytes - at(j);
    return static_cast<uint32_t>(left < chunk ? left : chunk);
  };
  auto load = [&](long long j) {  // the j-th chunk into stage j % stages
    const uint32_t s = j % stages, nb = bytes_of(j);
    mbar_expect_tx(bar + 8 * s, nb);
    bulk_load(buf + s * chunk, x + at(j), nb, bar + 8 * s);
  };
  for (long long j = 0; j < n && j < stages; ++j) load(j);
  for (long long j = 0; j < n; ++j) {
    const uint32_t s = j % stages;
    mbar_wait(bar + 8 * s, (j / stages) & 1);
    fence_proxy_async();
    bulk_store(y + at(j), buf + s * chunk, bytes_of(j));
    bulk_commit();
    if (j >= 1 && j - 1 + stages < n) {
      bulk_wait<1, true>();  // chunk j - 1's store has read its stage
      load(j - 1 + stages);
    }
  }
  bulk_wait<0, false>();
}

// exp(-x) as K1 computes exp: exp2f of the argument times log2 e.
__device__ __forceinline__ float exp_neg(float x) { return exp2f((0.f - x) * LOG2E); }

// K11. Each thread: one float4 of x per grid-stride step, `iters` chained
// exp(-x) on each of its four values; the first out4 float4s (rows 0-7) are
// returned.
__global__ void __launch_bounds__(EXP_THREADS)
exp_chain(const float4* __restrict__ x, float4* __restrict__ out, long long n4, int out4,
          int iters, uint32_t sentinel, uint32_t* __restrict__ sink) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  uint32_t acc = 0;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4; i += stride) {
    float4 v = x[i];
#pragma unroll 4
    for (int it = 0; it < iters; ++it) {
      v.x = exp_neg(v.x);
      v.y = exp_neg(v.y);
      v.z = exp_neg(v.z);
      v.w = exp_neg(v.w);
    }
    if (i < out4) out[i] = v;
    acc ^= fold(v);
  }
  if (acc == sentinel) sink[0] = acc;
}

// K12. Block: SOFTMAX_THREADS threads, groups of G per row. Thread t of a
// group holds the VPT values of its row at columns p * 2G + 2t + {0, 1}
// (pair p), K1's quad layout widened to G threads.
template <int G, int VPT, bool MASKED>
__global__ void __launch_bounds__(SOFTMAX_THREADS)
softmax_stream(const float* __restrict__ x, float* __restrict__ out, float* __restrict__ l_out,
               int rows, int cols, int iters, int mask_bound, uint32_t sentinel,
               uint32_t* __restrict__ sink) {
  const int row = blockIdx.x * (SOFTMAX_THREADS / G) + threadIdx.x / G;
  const int t = threadIdx.x % G;
  const bool live = row < rows;  // a dead row's group computes on zeros
  float v[VPT];
#pragma unroll
  for (int p = 0; p < VPT / 2; ++p) {
    float2 a = make_float2(0.f, 0.f);
    if (live) a = *reinterpret_cast<const float2*>(x + (long long)row * cols + p * 2 * G + 2 * t);
    v[2 * p] = a.x;
    v[2 * p + 1] = a.y;
  }
  static_assert(CHAINS == 4 && VPT % (2 * CHAINS) == 0, "four chains of whole pairs");
  float m = PROBE_MASK, l = 0.f;
  for (int it = 0; it < iters; ++it) {
    // col <= it + mask_bound, col = c_j + 2t with c_j a compile-time
    // constant: one compare of c_j with lim per value.
    const int lim = it + mask_bound - 2 * t;
    float mc[CHAINS];
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) mc[c] = -INFINITY;
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      if (MASKED) v[j] = (j >> 1) * 2 * G + (j & 1) <= lim ? v[j] : PROBE_MASK;
      mc[j % CHAINS] = fmaxf(mc[j % CHAINS], v[j]);
    }
    float mx = fmaxf(fmaxf(mc[0], mc[1]), fmaxf(mc[2], mc[3]));
#pragma unroll
    for (int o = 1; o < G; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float m_next = fmaxf(m, mx);
    const float nb = -m_next * LOG2E;  // p = ex2(s log2 e + nb): one FFMA a value
    const float alpha = ex2(fmaf(m, LOG2E, nb));
    float sc[CHAINS];
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) sc[c] = 0.f;
#pragma unroll
    for (int j = 0; j < VPT; j += 2) {
      const float p0 = ex2(fmaf(v[j], LOG2E, nb));
      const float p1 = ex2(fmaf(v[j + 1], LOG2E, nb));
      float& part = sc[(j / 2) % CHAINS];
      part += p0;
      part += p1;
      // P -> bf16 by pairs, as K1 packs P for P.V (common.cuh::pack_bf16).
      const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
      v[j] = __low2float(h);
      v[j + 1] = __high2float(h);
    }
    float sum = (sc[0] + sc[1]) + (sc[2] + sc[3]);
#pragma unroll
    for (int o = 1; o < G; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    l = alpha * l + sum;
    m = m_next;
  }
  uint32_t acc = __float_as_uint(m) ^ __float_as_uint(l);
#pragma unroll
  for (int j = 0; j < VPT; ++j) acc ^= __float_as_uint(v[j]);
  if (acc == sentinel) sink[0] = acc;
  if (live && row < 8) {
#pragma unroll
    for (int p = 0; p < VPT / 2; ++p)
      *reinterpret_cast<float2*>(out + (long long)row * cols + p * 2 * G + 2 * t) =
          make_float2(v[2 * p], v[2 * p + 1]);
    if (t == 0) l_out[row] = l;
  }
}

// Blocks of `kernel` at `threads` a block that fill every SM once.
template <typename K>
cudaError_t wave_blocks(K kernel, int threads, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  if (e == cudaSuccess && per_sm * sms <= 0) e = cudaErrorInvalidConfiguration;
  *blocks = per_sm * sms;
  return e;
}

template <typename K>
cudaError_t grid_for(K kernel, int threads, long long work_items, int* grid) {
  int wave = 0;
  const cudaError_t e = wave_blocks(kernel, threads, &wave);
  const long long need = (work_items + threads - 1) / threads;
  *grid = static_cast<int>(need < wave ? (need > 0 ? need : 1) : wave);
  return e;
}

// K12's instantiation for `cols` (cols % 128 == 0, up to 1024): (G, VPT) =
// (SOFTMAX_GROUP, cols / SOFTMAX_GROUP).
template <bool MASKED>
using SoftmaxKernel = void (*)(const float*, float*, float*, int, int, int, int, uint32_t,
                               uint32_t*);

template <bool MASKED>
SoftmaxKernel<MASKED> softmax_kernel_for(int cols) {
  constexpr int G = SOFTMAX_GROUP;
  switch (cols) {
    case 128: return softmax_stream<G, 128 / G, MASKED>;
    case 256: return softmax_stream<G, 256 / G, MASKED>;
    case 384: return softmax_stream<G, 384 / G, MASKED>;
    case 512: return softmax_stream<G, 512 / G, MASKED>;
    case 640: return softmax_stream<G, 640 / G, MASKED>;
    case 768: return softmax_stream<G, 768 / G, MASKED>;
    case 896: return softmax_stream<G, 896 / G, MASKED>;
    case 1024: return softmax_stream<G, 1024 / G, MASKED>;
    default: return nullptr;
  }
}

template <bool MASKED>
cudaError_t run_softmax(const float* x, float* out, float* l_out, int rows, int cols, int iters,
                        int mask_bound, uint32_t sentinel, uint32_t* sink, cudaStream_t st) {
  const SoftmaxKernel<MASKED> kernel = softmax_kernel_for<MASKED>(cols);
  if (kernel == nullptr) return cudaErrorInvalidValue;
  const int rows_per_block = SOFTMAX_THREADS / SOFTMAX_GROUP;
  kernel<<<(rows + rows_per_block - 1) / rows_per_block, SOFTMAX_THREADS, 0, st>>>(
      x, out, l_out, rows, cols, iters, mask_bound, sentinel, sink);
  return cudaGetLastError();
}

}  // namespace

// K9: read the n_bytes of x; out = the slice_bytes at `slice` (x's returned
// rows). n_bytes and slice_bytes multiples of 16, pointers 16-byte aligned.
extern "C" int pfa_hbm_read(const void* x, const void* slice, void* out, uint32_t* sink,
                            long long n_bytes, int slice_bytes, uint32_t sentinel, void* stream) {
  if (n_bytes <= 0 || n_bytes % 16 || slice_bytes <= 0 || slice_bytes % 16 || !aligned16(x) ||
      !aligned16(slice) || !aligned16(out))
    return cudaErrorInvalidValue;
  int grid = 0;
  const cudaError_t e = grid_for(hbm_read, STREAM_THREADS, n_bytes / 16, &grid);
  if (e != cudaSuccess) return e;
  hbm_read<<<grid, STREAM_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), n_bytes / 16, static_cast<const uint4*>(slice),
      static_cast<uint4*>(out), slice_bytes / 16, sentinel, sink);
  return cudaGetLastError();
}

// K10: y = x, n_bytes a multiple of 16, both 16-byte aligned, on the plan
// of ops/hbm_bw.py::k10_plan: `chunk` bytes a chunk (a multiple of 16, at
// most 2^20 - 16: an mbarrier's byte count), `stages` ring stages (2 to
// 8) in at most SMEM_MAX bytes with their mbarriers, `grid` CTAs (1 to
// ceil(n_bytes / chunk)).
extern "C" int pfa_hbm_copy(const void* x, void* y, long long n_bytes, int chunk, int stages,
                            int grid, void* stream) {
  if (n_bytes <= 0 || n_bytes % 16 || !aligned16(x) || !aligned16(y) || chunk <= 0 ||
      chunk % 16 || chunk > (1 << 20) - 16 || stages < 2 || stages > 8 ||
      (long long)stages * (chunk + 8) > SMEM_MAX)
    return cudaErrorInvalidValue;
  const long long n_chunks = (n_bytes + chunk - 1) / chunk;
  if (grid < 1 || grid > n_chunks) return cudaErrorInvalidValue;
  const int smem = stages * (chunk + 8);
  const cudaError_t e =
      cudaFuncSetAttribute(hbm_copy_ring, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  hbm_copy_ring<<<grid, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(x), static_cast<unsigned char*>(y), n_bytes, n_chunks,
      chunk, stages);
  return cudaGetLastError();
}

// K11: `iters` chained exp(-x) over the n fp32 values of x (n % 4 == 0);
// out = the first out_n (8 rows; out_n % 4 == 0).
extern "C" int pfa_exp_probe(const float* x, float* out, uint32_t* sink, long long n, int out_n,
                             int iters, uint32_t sentinel, void* stream) {
  if (n <= 0 || n % 4 || out_n <= 0 || out_n % 4 || out_n > n || iters < 0 || !aligned16(x) ||
      !aligned16(out))
    return cudaErrorInvalidValue;
  int grid = 0;
  const cudaError_t e = grid_for(exp_chain, EXP_THREADS, n / 4, &grid);
  if (e != cudaSuccess) return e;
  exp_chain<<<grid, EXP_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(out), n / 4, out_n / 4, iters,
      sentinel, sink);
  return cudaGetLastError();
}

// K12: `iters` chained online-softmax block updates over (rows, cols) fp32
// (rows >= 8, cols in 128..1024, cols % 128 == 0); out = rows 0-7, l_out
// their running sums (8 values); masked selects col <= it + mask_bound
// before each update.
extern "C" int pfa_softmax_probe(const float* x, float* out, float* l_out, uint32_t* sink,
                                 int rows, int cols, int iters, int mask_bound, int masked,
                                 uint32_t sentinel, void* stream) {
  if (rows < 8 || iters < 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (masked)
    return run_softmax<true>(x, out, l_out, rows, cols, iters, mask_bound, sentinel, sink, st);
  return run_softmax<false>(x, out, l_out, rows, cols, iters, mask_bound, sentinel, sink, st);
}

// The work one full wave of a probe holds on this card: kernel 0 (K11)
// fp32 values; kernel 1 (K12) rows at `cols`, masked or not.
extern "C" int pfa_probe_wave(int kernel, int cols, int masked, int* out) {
  int blocks = 0;
  cudaError_t e;
  if (kernel == 0) {
    e = wave_blocks(exp_chain, EXP_THREADS, &blocks);
    *out = blocks * EXP_THREADS * 4;
    return e;
  }
  if (kernel != 1) return cudaErrorInvalidValue;
  if (masked) {
    const SoftmaxKernel<true> k = softmax_kernel_for<true>(cols);
    if (k == nullptr) return cudaErrorInvalidValue;
    e = wave_blocks(k, SOFTMAX_THREADS, &blocks);
  } else {
    const SoftmaxKernel<false> k = softmax_kernel_for<false>(cols);
    if (k == nullptr) return cudaErrorInvalidValue;
    e = wave_blocks(k, SOFTMAX_THREADS, &blocks);
  }
  *out = blocks * (SOFTMAX_THREADS / SOFTMAX_GROUP);
  return e;
}
