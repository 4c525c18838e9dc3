// SVGD's all-to-all for Hopper (sm_90a): pairwise squared distances of the
// stacked particle matrix and the SVGD driving force. Plain C interface.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/svgd_rbf.py:
//   pairwise_sqdist (_sqdist_kernel, pl.pallas_call at :66)
//   svgd_force      (_force_kernel,  pl.pallas_call at :96)
// and adds the store's (n,) row mask the reference's masked jnp form takes
// (src/repro/bdl/svgd.py:82-102): a dead row (mask <= 0) is read as zeros by
// select, never loaded, so NaN in a padding slot cannot leak.
//
//   theta, grads (n, D) fp32, row-major contiguous; mask (n,) fp32 or null.
//
// Shapes on the training path: n = 2..256 particles, D = 1e6..1e9 parameters
// (19,775,360 for the ViT of configs/vit_mnist.py). Both kernels stream D
// once and do O(n) flops per byte at the shapes used (n = 8): they are bound
// by bytes. At (8, 19,775,360) on an H100 SXM (3.35 TB/s): sqdist reads
// 632.8 MB (0.189 ms); force reads 2 x 632.8 MB and writes 632.8 MB
// (0.567 ms).
//
// sqdist design. The TPU grid carries the (n, n) sum across D tiles in
// order; Hopper blocks run unordered, so the sum is split over D instead.
// Rows go in tiles of 8; the work is the tile pairs ti <= tj (a diagonal
// tile of one row has no pair and is left out), each cut into nchunks
// near-equal contiguous column ranges. The wrapper's plan
// (kernels/svgd_rbf.py sqdist_plan) sizes the grid to one wave of the SMs
// and the blocks per SM the ring's shared memory allows; each block walks
// the (pair, chunk) items blockIdx.x, + gridDim.x, ... (one each at n = 8).
//
// Stage 1 streams an item's columns through a ring of 1-4 stages in shared
// memory. One thread copies the live rows of the tile pair over a column
// tile into a stage with cp.async.bulk (the TMA's 1-D bulk copy), completed
// on the stage's mbarrier with expect_tx bytes, and refills a stage once
// every warp has read it, so the next stages stay in flight while the warps
// compute. The plan's default, 2 stages of 16 KB and 2 blocks an SM, keeps
// up to 64 KB an SM in flight (a grid of scalar loads held ~24 KB); more
// in flight was slower on an H100. Dead rows are not copied and read as 0 by select. Each
// thread sums (theta_i - theta_j)^2 over its columns in registers for the
// pairs i < j only (28 at n = 8; no Gram form, so no cancellation and never
// negative), the block reduces them in a fixed order and writes its partial
// to scratch (n, n, nchunks). Rows whose byte stride is not a multiple of
// 16 (D % 4 != 0) cannot be bulk-copied: the same kernel then reads them
// with plain loads (the plan's "plain" path).
//
// Stage 2 is one warp per pair i < j: lane l sums the chunks l, l + 32, ...
// in order, then a fixed xor-shuffle tree; it writes (i, j) and (j, i) from
// the one sum and an exact 0 on the diagonal. No atomics: the result is
// deterministic and exactly symmetric.
//
// force design. phi_i = sum_j ktn[i,j] g_j - (ksum_i theta_i - sum_j
// ktn[i,j] theta_j) * inv_ell2, with ktn = K^T / n_eff and ksum = K.sum(0) /
// n_eff computed by the caller (the (n, n) glue stays plain torch, as it is
// plain jnp in the reference). One thread per column d; a block owns 8
// receiving rows i and holds their ktn rows in shared memory (8 n floats,
// 8 KB at n = 256, where the whole K^T/n would exceed the 227 KB a block may
// use); each thread streams theta[:, d] and g[:, d] once per row tile and
// keeps 16 accumulators in registers. Dead rows are written as exact zeros.
// Simple and correct first: no TMA, no wgmma, fp32 CUDA-core FMAs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 8;  // rows per pair tile (sqdist) and per row tile (force)
constexpr int kMaxStages = 4;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ bool row_live(const float* mask, int r, int n) {
  return r < n && (mask == nullptr || mask[r] > 0.f);
}

// -- Hopper's asynchronous bulk copies and transaction barriers -------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// The one arrival of a stage's phase, expecting `bytes` of bulk copies.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Spin until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

// Global -> shared, `bytes` a multiple of 16, both addresses 16-byte aligned.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
               " [%0], [%1], %2, [%3];\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
               : "memory");
}

// -- pairwise_sqdist ---------------------------------------------------------

// acc[a][b] += (x_a - y_b)^2 over one column: the pairs a < b of a diagonal
// tile (y = x), all 64 of an off-diagonal one.
__device__ __forceinline__ void add_column(float (&acc)[kTile][kTile],
                                           const float (&x)[kTile],
                                           const float (&y)[kTile], bool diag) {
  if (diag) {
#pragma unroll
    for (int a = 0; a < kTile; ++a)
#pragma unroll
      for (int b = a + 1; b < kTile; ++b) {
        const float t = x[a] - x[b];
        acc[a][b] = fmaf(t, t, acc[a][b]);
      }
  } else {
#pragma unroll
    for (int a = 0; a < kTile; ++a)
#pragma unroll
      for (int b = 0; b < kTile; ++b) {
        const float t = x[a] - y[b];
        acc[a][b] = fmaf(t, t, acc[a][b]);
      }
  }
}

// Stage 1. kRows = 8: one row tile (n <= 8), every item on the diagonal;
// kRows = 16: two tiles' rows a stage, diagonal and off-diagonal items.
// kBulk: the ring of bulk copies; else plain loads from device memory.
// Stage s of the ring holds stage_rows rows of tile_cols floats; the row of
// slot a < 8 is i0 + a, of slot 8 + b is j0 + b.
template <int kRows, bool kBulk>
__global__ void __launch_bounds__(kThreads, 2)
sqdist_stream_kernel(const float* __restrict__ theta, const float* __restrict__ mask,
                     float* __restrict__ partial, int n, long long D, int npairs,
                     int nchunks, int stages, int tile_cols, int stage_rows) {
  extern __shared__ __align__(128) float ring[];
  __shared__ uint64_t bar[kMaxStages];
  __shared__ float red[kWarps][kTile * kTile];
  if (kBulk) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < stages; ++s) mbar_init(&bar[s], 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  const int tiles = (n + kTile - 1) / kTile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long unit = kBulk ? 4 : 1;  // columns: 16 bytes on the bulk path
  const long long units = D / unit;
  const int T = tile_cols;
  const int stage_floats = stage_rows * T;
  const int items = npairs * nchunks;
  uint32_t it = 0;  // column tiles this block has streamed: ring slot and parity

  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int p = item / nchunks;
    const int c = item - p * nchunks;
    int ti = 0, rem = p;  // pair p of the pairs ti <= tj in row-major order
    while (rem >= tiles - ti) {
      rem -= tiles - ti;
      ++ti;
    }
    const int tj = ti + rem;
    const bool diag = kRows == kTile || ti == tj;
    const int i0 = ti * kTile;
    const int j0 = tj * kTile;
    unsigned live = 0;
#pragma unroll
    for (int a = 0; a < kTile; ++a) {
      if (row_live(mask, i0 + a, n)) live |= 1u << a;
      if (!diag && row_live(mask, j0 + a, n)) live |= 1u << (kTile + a);
    }
    const long long d0 = c * units / nchunks * unit;
    const long long d1 = (c + 1) * units / nchunks * unit;

    float acc[kTile][kTile];
#pragma unroll
    for (int a = 0; a < kTile; ++a)
#pragma unroll
      for (int b = 0; b < kTile; ++b) acc[a][b] = 0.f;

    if (kBulk) {
      const long long len = d1 - d0;
      const int ntiles = static_cast<int>((len + T - 1) / T);
      // one thread fills ring slot (it + k) % stages with column tile k
      auto fill = [&](int k) {
        const int s = static_cast<int>((it + k) % stages);
        const long long col0 = d0 + static_cast<long long>(k) * T;
        const long long w = len - static_cast<long long>(k) * T < T
                                ? len - static_cast<long long>(k) * T : T;
        const uint32_t bytes = static_cast<uint32_t>(w) * 4u;
        float* st = ring + s * stage_floats;
        // the warps' reads of this slot (ordered by __syncthreads) before
        // the async proxy's writes
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_expect_tx(&bar[s], bytes * __popc(live));
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          if ((live >> r) & 1u) {
            const int row = r < kTile ? i0 + r : j0 + r - kTile;
            bulk_copy(st + r * T, theta + static_cast<long long>(row) * D + col0, bytes,
                      &bar[s]);
          }
      };
      if (threadIdx.x == 0)
        for (int k = 0; k < stages && k < ntiles; ++k) fill(k);
      for (int k = 0; k < ntiles; ++k) {
        const int s = static_cast<int>((it + k) % stages);
        mbar_wait(&bar[s], ((it + k) / stages) & 1u);
        const long long left = len - static_cast<long long>(k) * T;
        const int w = left < T ? static_cast<int>(left) : T;
        const float* st = ring + s * stage_floats;
        for (int col = threadIdx.x; col < w; col += kThreads) {
          float x[kTile], y[kTile];
#pragma unroll
          for (int a = 0; a < kTile; ++a) {
            // a slot past stage_rows holds no row (never live): read slot 0
            const int slot = (kRows == 2 * kTile || a < stage_rows) ? a : 0;
            x[a] = ((live >> a) & 1u) ? st[slot * T + col] : 0.f;
            y[a] = (!diag && ((live >> (kTile + a)) & 1u))
                       ? st[(kTile + a) * T + col] : 0.f;
          }
          add_column(acc, x, y, diag);
        }
        __syncthreads();
        if (threadIdx.x == 0 && k + stages < ntiles) fill(k + stages);
      }
      it += static_cast<uint32_t>(ntiles);
    } else {
      for (long long d = d0 + threadIdx.x; d < d1; d += kThreads) {
        float x[kTile], y[kTile];
#pragma unroll
        for (int a = 0; a < kTile; ++a) {
          x[a] = ((live >> a) & 1u) ? theta[static_cast<long long>(i0 + a) * D + d] : 0.f;
          y[a] = (!diag && ((live >> (kTile + a)) & 1u))
                     ? theta[static_cast<long long>(j0 + a) * D + d] : 0.f;
        }
        add_column(acc, x, y, diag);
      }
    }

    // the block's sum of each pair in a fixed order: warp tree, then warps
#pragma unroll
    for (int a = 0; a < kTile; ++a)
#pragma unroll
      for (int b = 0; b < kTile; ++b)
        if (!diag || a < b) {
          const float v = warp_sum(acc[a][b]);
          if (lane == 0) red[warp][a * kTile + b] = v;
        }
    __syncthreads();
    if (threadIdx.x < kTile * kTile) {
      const int a = threadIdx.x / kTile;
      const int b = threadIdx.x - a * kTile;
      if ((!diag || a < b) && i0 + a < n && j0 + b < n) {
        float s = 0.f;
        for (int w = 0; w < kWarps; ++w) s += red[w][threadIdx.x];
        partial[(static_cast<long long>(i0 + a) * n + j0 + b) * nchunks + c] = s;
      }
    }
    __syncthreads();
  }
}

// Stage 2: warp q sums pair q of the pairs i < j in row-major order over the
// chunks; thread t < n writes the diagonal's exact 0.
__global__ void __launch_bounds__(kThreads)
sqdist_sum_kernel(const float* __restrict__ partial, float* __restrict__ out, int n,
                  int nchunks) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t < n) out[static_cast<long long>(t) * n + t] = 0.f;
  const int q = t >> 5;
  const int lane = threadIdx.x & 31;
  if (q >= n * (n - 1) / 2) return;
  int i = 0, rem = q;
  while (rem >= n - 1 - i) {
    rem -= n - 1 - i;
    ++i;
  }
  const int j = i + 1 + rem;
  const float* src = partial + (static_cast<long long>(i) * n + j) * nchunks;
  float s = 0.f;
  for (int c = lane; c < nchunks; c += 32) s += src[c];
  s = warp_sum(s);
  if (lane == 0) {
    out[static_cast<long long>(i) * n + j] = s;
    out[static_cast<long long>(j) * n + i] = s;
  }
}

__global__ void __launch_bounds__(kThreads)
svgd_force_kernel(const float* __restrict__ theta, const float* __restrict__ grads,
                  const float* __restrict__ ktn, const float* __restrict__ ksum,
                  const float* __restrict__ inv_ell2, const float* __restrict__ mask,
                  float* __restrict__ out, int n, int n_pad, long long D) {
  extern __shared__ float smem[];
  float* k_s = smem;                 // kTile x n_pad rows of ktn, zero-padded
  float* live_s = k_s + kTile * n_pad;  // n_pad, 1 = live row, 0 = dead or padding
  const int i0 = blockIdx.y * kTile;
  for (int e = threadIdx.x; e < kTile * n_pad; e += kThreads) {
    const int a = e / n_pad;
    const int j = e - a * n_pad;
    k_s[e] = (i0 + a < n && j < n) ? ktn[static_cast<long long>(i0 + a) * n + j] : 0.f;
  }
  for (int j = threadIdx.x; j < n_pad; j += kThreads)
    live_s[j] = row_live(mask, j, n) ? 1.f : 0.f;
  __syncthreads();

  const long long d = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (d >= D) return;
  const float inv = *inv_ell2;
  float acc_g[kTile], acc_t[kTile], own[kTile];
#pragma unroll
  for (int a = 0; a < kTile; ++a) acc_g[a] = acc_t[a] = own[a] = 0.f;

  for (int j0 = 0; j0 < n_pad; j0 += kTile) {
    float t[kTile], g[kTile];
#pragma unroll
    for (int b = 0; b < kTile; ++b) {
      const bool live = live_s[j0 + b] > 0.f;
      const long long off = static_cast<long long>(j0 + b) * D + d;
      t[b] = live ? theta[off] : 0.f;
      g[b] = live ? grads[off] : 0.f;
    }
    if (j0 == i0) {
#pragma unroll
      for (int b = 0; b < kTile; ++b) own[b] = t[b];
    }
#pragma unroll
    for (int a = 0; a < kTile; ++a)
#pragma unroll
      for (int b = 0; b < kTile; ++b) {
        const float k = k_s[a * n_pad + j0 + b];
        acc_g[a] = fmaf(k, g[b], acc_g[a]);
        acc_t[a] = fmaf(k, t[b], acc_t[a]);
      }
  }
#pragma unroll
  for (int a = 0; a < kTile; ++a) {
    const int i = i0 + a;
    if (i < n) {
      const float phi = acc_g[a] - (ksum[i] * own[a] - acc_t[a]) * inv;
      out[static_cast<long long>(i) * D + d] = live_s[i] > 0.f ? phi : 0.f;
    }
  }
}

}  // namespace

// Returns the cudaError_t of the launches (0 = success). The caller checks
// shapes, dtypes, devices, contiguity and (bulk) 16-byte alignment, plans
// the launch (kernels/svgd_rbf.py sqdist_plan: npairs tile pairs, nchunks,
// grid, the ring's stages x stage_rows x tile_cols floats) and allocates
// partial (n, n, nchunks) and out (n, n). grid 0 launches no stage 1 (no
// pair i < j); reduce 0 launches stage 1 alone (a probe of its time).
extern "C" int svgd_pairwise_sqdist(const void* theta, const void* mask, void* partial,
                                    void* out, int n, long long D, int npairs, int nchunks,
                                    int grid, int stages, int tile_cols, int stage_rows,
                                    int bulk, int reduce, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stages < 1 || stages > kMaxStages || nchunks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (grid > 0) {
    const bool one_tile = n <= kTile;
    void (*kernel)(const float*, const float*, float*, int, long long, int, int, int, int,
                   int) =
        one_tile ? (bulk ? &sqdist_stream_kernel<kTile, true>
                         : &sqdist_stream_kernel<kTile, false>)
                 : (bulk ? &sqdist_stream_kernel<2 * kTile, true>
                         : &sqdist_stream_kernel<2 * kTile, false>);
    const size_t smem =
        bulk ? sizeof(float) * static_cast<size_t>(stages) * stage_rows * tile_cols : 0;
    if (smem > 0) {
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    kernel<<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(theta), static_cast<const float*>(mask),
        static_cast<float*>(partial), n, D, npairs, nchunks, stages, tile_cols, stage_rows);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (reduce) {
    const int warps = n * (n - 1) / 2;
    int blocks = (warps + kWarps - 1) / kWarps;
    const int diag_blocks = (n + kThreads - 1) / kThreads;
    if (blocks < diag_blocks) blocks = diag_blocks;
    sqdist_sum_kernel<<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(partial), static_cast<float*>(out), n, nchunks);
  }
  return static_cast<int>(cudaGetLastError());
}

// phi (n, D) from theta, grads (n, D), ktn (n, n), ksum (n,), inv_ell2 (a
// device scalar) and mask (n,) or null. Returns the cudaError_t (0 = success).
extern "C" int svgd_force(const void* theta, const void* grads, const void* ktn,
                          const void* ksum, const void* inv_ell2, const void* mask,
                          void* out, int n, long long D, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_pad = (n + kTile - 1) / kTile * kTile;
  const size_t smem = sizeof(float) * static_cast<size_t>(kTile + 1) * n_pad;
  dim3 grid(static_cast<unsigned>((D + kThreads - 1) / kThreads), n_pad / kTile);
  svgd_force_kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(theta), static_cast<const float*>(grads),
      static_cast<const float*>(ktn), static_cast<const float*>(ksum),
      static_cast<const float*>(inv_ell2), static_cast<const float*>(mask),
      static_cast<float*>(out), n, n_pad, D);
  return static_cast<int>(cudaGetLastError());
}
