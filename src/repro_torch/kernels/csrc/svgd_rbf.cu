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
// force. phi_i = sum_j ktn[i,j] g_j - (ksum_i theta_i - sum_j ktn[i,j]
// theta_j) * inv_ell2, with ktn = K^T / n_eff and ksum = K.sum(0) / n_eff
// computed by the caller (the (n, n) glue stays plain torch, as it is plain
// jnp in the reference). Dead rows are written as exact zeros.
//
// What bounds it: each column moves 3n floats (theta and g read, phi
// written) for 4 n^2 FLOPs, n / 3 FLOPs a byte, so below n ~ 60 the force
// is bound by bytes (fp32 CUDA-core FMAs: 67 TFLOP/s over 3.35 TB/s is 20
// FLOPs a byte) and above it by fp32 operations, where only a tensor-core
// form (later work) would help.
//
// The column kernel (svgd_force_kernel, the first design, kept as the probe
// entry svgd_force_columns) gives one thread one column: a grid of D / 256 blocks,
// each staging its 8 receiving rows' ktn into shared memory and
// synchronising to stream 256 columns, both row loops fixed at 8 (at n = 2,
// 128 FMAs a column for 8 live ones), 2n scalar 4-byte loads in flight a
// thread. It reaches 27% of its bound at n = 2, 49% at 4, 76% at 8.
//
// The streaming design (force_stream_kernel), launched on the wrapper's
// plan (kernels/svgd_rbf.py force_plan). A block stages its receiving rows'
// ktn, ksum and the live flags once, then walks column tiles with a grid
// stride. For n <= 8 (template kN = n) every row is both receiving and
// source, the row loops run to n exactly at compile time, and a thread
// loads all n rows of theta and g over its kCols columns before any FMA.
// Where every row is 16-byte aligned (D % 4 == 0, aligned bases: the ViT's,
// the LM's and the zoo's shapes) the loads are 128-bit with the streaming
// hints (__ldcs / __stcs: nothing is reused), kCols is 8 at n <= 2 (two
// float4 groups: 128 B of loads in flight a thread at n = 2) and 4 above,
// and the grid is one persistent wave; there it reads 84-86% of the byte
// bound at n = 2, 4 and 8 on an H100 (PERF.md). Elsewhere (the UNet's D is
// odd) the loads are scalar, kCols is 4 at n <= 4 and 2 above, and each
// block takes one column tile: on the UNet's small D the block scheduler
// balances the tiles better than a fixed stride. For n > 8 (kN = 0) a
// block owns 8 receiving rows, as the column kernel's do, and re-streams theta and g
// once per row tile; the plan gives the blocks of one column tile's row
// tiles neighbouring indices, so the re-reads meet in L2. Past n ~ 60 that
// path is bound by fp32 operations (above): a tensor-core form is later
// work.
//
// Arithmetic: per column the same FMAs as the column kernel, in the same
// order, acc = fmaf(ktn[i,j], g_j, acc) and fmaf(ktn[i,j], theta_j, acc)
// over ascending j, and the same epilogue (force_phi, shared by the two
// kernels), so the result is the column kernel's bit for bit. Its padding rows
// (j >= n in the last tile of 8) add fmaf(0, 0, acc) == acc (acc starts at
// +0 and is never -0), so leaving them out changes no bit; dead rows j < n
// are still added as zeros, as there.

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

// -- svgd_force ----------------------------------------------------------------

// The force's epilogue for one (row, column), shared by both kernels so that
// they compile it alike: phi = acc_g - (ksum_i theta_i - acc_t) / ell^2.
__device__ __forceinline__ float force_phi(float acc_g, float ksum_i, float own,
                                           float acc_t, float inv) {
  return acc_g - (ksum_i * own - acc_t) * inv;
}

// The column kernel: the probe entry svgd_force_columns (note above).
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
      const float phi = force_phi(acc_g[a], ksum[i], own[a], acc_t[a], inv);
      out[static_cast<long long>(i) * D + d] = live_s[i] > 0.f ? phi : 0.f;
    }
  }
}


// The streaming kernel's launch constants by n (n > 8 as 9) and path
// (kernels/svgd_rbf.py mirrors them in force_plan): columns a thread a
// tile, blocks an SM.
__host__ __device__ constexpr int force_cols(int n, bool vec) {
  return vec ? (n <= 2 ? 8 : 4) : (n <= 4 ? 4 : 2);
}
__host__ __device__ constexpr int force_blocks(int n, bool vec) {
  return vec && n > 4 ? 2 : 4;
}

// kCols columns of one row over a tile starting at column c0: as float4
// groups (kVec: the thread's group q holds columns c0 + (q * kThreads + tid) * 4
// + 0..3) or as scalars (column c0 + q * kThreads + tid). A dead row or a
// column past D reads as 0.
template <int kCols, bool kVec, bool kStream>
__device__ __forceinline__ void load_cols(const float* __restrict__ row, long long c0,
                                          long long D, bool live, float (&v)[kCols]) {
  if constexpr (kVec) {
#pragma unroll
    for (int q = 0; q < kCols / 4; ++q) {
      const long long c = c0 + (static_cast<long long>(q) * kThreads + threadIdx.x) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (live && c < D) {
        const float4* src = reinterpret_cast<const float4*>(row + c);
        x = kStream ? __ldcs(src) : __ldg(src);
      }
      v[4 * q] = x.x;
      v[4 * q + 1] = x.y;
      v[4 * q + 2] = x.z;
      v[4 * q + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      const long long c = c0 + static_cast<long long>(q) * kThreads + threadIdx.x;
      v[q] = (live && c < D) ? (kStream ? __ldcs(row + c) : __ldg(row + c)) : 0.f;
    }
  }
}

template <int kCols, bool kVec>
__device__ __forceinline__ void store_cols(float* __restrict__ row, long long c0, long long D,
                                           const float (&v)[kCols]) {
  if constexpr (kVec) {
#pragma unroll
    for (int q = 0; q < kCols / 4; ++q) {
      const long long c = c0 + (static_cast<long long>(q) * kThreads + threadIdx.x) * 4;
      if (c < D)
        __stcs(reinterpret_cast<float4*>(row + c),
               make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]));
    }
  } else {
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      const long long c = c0 + static_cast<long long>(q) * kThreads + threadIdx.x;
      if (c < D) __stcs(row + c, v[q]);
    }
  }
}

// kN = n in [1, 8]: one row tile of all n rows. kN = 0: n > 8, block b owns
// the receiving rows of tile b % row_tiles and walks the column tiles
// b / row_tiles, + gridDim.x / row_tiles, ... (the grid is a multiple of
// row_tiles). Shared memory: ktn's receiving rows, their ksum, the live flags.
template <int kN, bool kVec>
__global__ void __launch_bounds__(kThreads, force_blocks(kN == 0 ? kTile + 1 : kN, kVec))
force_stream_kernel(const float* __restrict__ theta, const float* __restrict__ grads,
                    const float* __restrict__ ktn, const float* __restrict__ ksum,
                    const float* __restrict__ inv_ell2, const float* __restrict__ mask,
                    float* __restrict__ out, int n, long long D, long long tiles,
                    int row_tiles) {
  constexpr int kR = kN == 0 ? kTile : kN;            // receiving rows a block
  constexpr int kCols = force_cols(kN == 0 ? kTile + 1 : kN, kVec);
  constexpr long long kTileCols = static_cast<long long>(kThreads) * kCols;
  extern __shared__ float smem[];
  float* k_s = smem;                    // kR rows of n: ktn[i0 + a, j]
  float* ksum_s = k_s + kR * n;         // kR
  float* live_s = ksum_s + kR;          // n: 1 live, 0 dead
  const int rt = kN == 0 ? static_cast<int>(blockIdx.x % row_tiles) : 0;
  const int i0 = rt * kTile;
  const float inv = *inv_ell2;          // issued beside the staging loads
  for (int e = threadIdx.x; e < kR * n; e += kThreads) {
    const int a = e / n;
    k_s[e] = i0 + a < n ? ktn[static_cast<long long>(i0) * n + e] : 0.f;
  }
  for (int a = threadIdx.x; a < kR; a += kThreads)
    ksum_s[a] = i0 + a < n ? ksum[i0 + a] : 0.f;
  for (int j = threadIdx.x; j < n; j += kThreads) live_s[j] = row_live(mask, j, n) ? 1.f : 0.f;
  __syncthreads();
  const long long first = kN == 0 ? blockIdx.x / row_tiles : blockIdx.x;
  const long long step = kN == 0 ? gridDim.x / row_tiles : gridDim.x;

  for (long long tile = first; tile < tiles; tile += step) {
    const long long c0 = tile * kTileCols;
    if constexpr (kN > 0) {
      // every row's columns in registers first: 2 n kCols floats in flight
      float t[kR][kCols], g[kR][kCols];
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        const bool live = live_s[j] > 0.f;
        load_cols<kCols, kVec, true>(theta + j * D, c0, D, live, t[j]);
        load_cols<kCols, kVec, true>(grads + j * D, c0, D, live, g[j]);
      }
#pragma unroll
      for (int a = 0; a < kR; ++a) {
        float ag[kCols], at[kCols];
#pragma unroll
        for (int c = 0; c < kCols; ++c) ag[c] = at[c] = 0.f;
#pragma unroll
        for (int j = 0; j < kR; ++j) {
          const float k = k_s[a * kR + j];
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            ag[c] = fmaf(k, g[j][c], ag[c]);
            at[c] = fmaf(k, t[j][c], at[c]);
          }
        }
        const bool live = live_s[a] > 0.f;
        float phi[kCols];
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          phi[c] = live ? force_phi(ag[c], ksum_s[a], t[a][c], at[c], inv) : 0.f;
        store_cols<kCols, kVec>(out + a * D, c0, D, phi);
      }
    } else {
      // 8 receiving rows; the sources one at a time, loaded through L2
      // (the other row tiles' blocks read the same columns)
      float ag[kR][kCols], at[kR][kCols];
#pragma unroll
      for (int a = 0; a < kR; ++a)
#pragma unroll
        for (int c = 0; c < kCols; ++c) ag[a][c] = at[a][c] = 0.f;
#pragma unroll 2
      for (int j = 0; j < n; ++j) {
        float t[kCols], g[kCols];
        const bool live = live_s[j] > 0.f;
        load_cols<kCols, kVec, false>(theta + j * D, c0, D, live, t);
        load_cols<kCols, kVec, false>(grads + j * D, c0, D, live, g);
#pragma unroll
        for (int a = 0; a < kR; ++a) {
          const float k = k_s[a * n + j];
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            ag[a][c] = fmaf(k, g[c], ag[a][c]);
            at[a][c] = fmaf(k, t[c], at[a][c]);
          }
        }
      }
#pragma unroll
      for (int a = 0; a < kR; ++a) {
        const int i = i0 + a;
        if (i >= n) break;
        const bool live = live_s[i] > 0.f;
        float own[kCols], phi[kCols];
        // the receiving row's theta once more (0 if dead, as the column kernel keeps it)
        load_cols<kCols, kVec, false>(theta + i * D, c0, D, live, own);
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          phi[c] = live ? force_phi(ag[a][c], ksum_s[a], own[c], at[a][c], inv) : 0.f;
        store_cols<kCols, kVec>(out + i * D, c0, D, phi);
      }
    }
  }
}

template <int kN>
int launch_force(bool vec, int grid, size_t smem, cudaStream_t s, const float* theta,
                 const float* grads, const float* ktn, const float* ksum,
                 const float* inv_ell2, const float* mask, float* out, int n, long long D,
                 long long tiles, int row_tiles) {
  void (*kernel)(const float*, const float*, const float*, const float*, const float*,
                 const float*, float*, int, long long, long long, int) =
      vec ? &force_stream_kernel<kN, true> : &force_stream_kernel<kN, false>;
  kernel<<<grid, kThreads, smem, s>>>(theta, grads, ktn, ksum, inv_ell2, mask, out, n, D,
                                      tiles, row_tiles);
  return static_cast<int>(cudaGetLastError());
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
// device scalar) and mask (n,) or null, by the streaming kernel on the
// wrapper's plan (kernels/svgd_rbf.py force_plan): a grid that is a
// multiple of the row tiles, cols columns a thread a tile (checked against
// force_cols), vec 1 for 128-bit loads (every row 16-byte aligned). Returns
// the cudaError_t (0 = success).
extern "C" int svgd_force(const void* theta, const void* grads, const void* ktn,
                          const void* ksum, const void* inv_ell2, const void* mask,
                          void* out, int n, long long D, int grid, int cols, int vec,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int row_tiles = n <= kTile ? 1 : (n + kTile - 1) / kTile;
  if (n < 1 || D < 1 || grid < 1 || grid % row_tiles != 0 ||
      cols != force_cols(n <= kTile ? n : kTile + 1, vec != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tile_cols = static_cast<long long>(kThreads) * cols;
  const long long tiles = (D + tile_cols - 1) / tile_cols;
  const int rows = n <= kTile ? n : kTile;
  const size_t smem = sizeof(float) * (static_cast<size_t>(rows) * n + rows + n);
  const float* t = static_cast<const float*>(theta);
  const float* g = static_cast<const float*>(grads);
  const float* k = static_cast<const float*>(ktn);
  const float* ks = static_cast<const float*>(ksum);
  const float* inv = static_cast<const float*>(inv_ell2);
  const float* m = static_cast<const float*>(mask);
  float* o = static_cast<float*>(out);
  const bool v = vec != 0;
  switch (n) {
    case 1: return launch_force<1>(v, grid, smem, s, t, g, k, ks, inv, m, o, n, D, tiles, 1);
    case 2: return launch_force<2>(v, grid, smem, s, t, g, k, ks, inv, m, o, n, D, tiles, 1);
    case 3: return launch_force<3>(v, grid, smem, s, t, g, k, ks, inv, m, o, n, D, tiles, 1);
    case 4: return launch_force<4>(v, grid, smem, s, t, g, k, ks, inv, m, o, n, D, tiles, 1);
    case 5: return launch_force<5>(v, grid, smem, s, t, g, k, ks, inv, m, o, n, D, tiles, 1);
    case 6: return launch_force<6>(v, grid, smem, s, t, g, k, ks, inv, m, o, n, D, tiles, 1);
    case 7: return launch_force<7>(v, grid, smem, s, t, g, k, ks, inv, m, o, n, D, tiles, 1);
    case 8: return launch_force<8>(v, grid, smem, s, t, g, k, ks, inv, m, o, n, D, tiles, 1);
    default:
      return launch_force<0>(v, grid, smem, s, t, g, k, ks, inv, m, o, n, D, tiles,
                             row_tiles);
  }
}

// The column kernel, a probe only (never on a path): the same arguments as
// svgd_force without the plan. Returns the cudaError_t (0 = success).
extern "C" int svgd_force_columns(const void* theta, const void* grads, const void* ktn,
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
