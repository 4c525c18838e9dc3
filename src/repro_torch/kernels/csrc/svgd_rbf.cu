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
// order; Hopper blocks run unordered, so the sum is split over D instead:
// stage 1 gives each block a chunk of columns and one 8 x 8 tile of (i, j)
// pairs; each thread accumulates sum (theta_i - theta_j)^2 over its columns
// for all 64 pairs in registers (no Gram, so no cancellation and never
// negative), the block reduces them in a fixed order and writes its (8, 8)
// partial to scratch. Stage 2 sums the partials over chunks in chunk order.
// No atomics: the result is deterministic. At n = 8 there is one tile, so
// theta is read from device memory exactly once.
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

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 8;  // rows per pair tile (sqdist) and per row tile (force)

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ bool row_live(const float* mask, int r, int n) {
  return r < n && (mask == nullptr || mask[r] > 0.f);
}

__global__ void __launch_bounds__(kThreads)
sqdist_partial_kernel(const float* __restrict__ theta, const float* __restrict__ mask,
                      float* __restrict__ partial, int n, long long D,
                      long long chunk, int tiles) {
  const int ti = blockIdx.y / tiles;
  const int tj = blockIdx.y - ti * tiles;
  const int i0 = ti * kTile;
  const int j0 = tj * kTile;
  const bool same = ti == tj;
  const long long d0 = static_cast<long long>(blockIdx.x) * chunk;
  long long d1 = d0 + chunk;
  if (d1 > D) d1 = D;

  bool li[kTile], lj[kTile];
#pragma unroll
  for (int a = 0; a < kTile; ++a) {
    li[a] = row_live(mask, i0 + a, n);
    lj[a] = row_live(mask, j0 + a, n);
  }
  float acc[kTile][kTile];
#pragma unroll
  for (int a = 0; a < kTile; ++a)
#pragma unroll
    for (int b = 0; b < kTile; ++b) acc[a][b] = 0.f;

  for (long long d = d0 + threadIdx.x; d < d1; d += kThreads) {
    float x[kTile], y[kTile];
#pragma unroll
    for (int a = 0; a < kTile; ++a)
      x[a] = li[a] ? theta[static_cast<long long>(i0 + a) * D + d] : 0.f;
#pragma unroll
    for (int b = 0; b < kTile; ++b)
      y[b] = same ? x[b] : (lj[b] ? theta[static_cast<long long>(j0 + b) * D + d] : 0.f);
#pragma unroll
    for (int a = 0; a < kTile; ++a)
#pragma unroll
      for (int b = 0; b < kTile; ++b) {
        const float t = x[a] - y[b];
        acc[a][b] = fmaf(t, t, acc[a][b]);
      }
  }

  __shared__ float red[kWarps][kTile * kTile];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int a = 0; a < kTile; ++a)
#pragma unroll
    for (int b = 0; b < kTile; ++b) {
      const float v = warp_sum(acc[a][b]);
      if (lane == 0) red[warp][a * kTile + b] = v;
    }
  __syncthreads();
  if (threadIdx.x < kTile * kTile) {
    const int a = threadIdx.x / kTile;
    const int b = threadIdx.x - a * kTile;
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[w][threadIdx.x];
    if (i0 + a < n && j0 + b < n)
      partial[(static_cast<long long>(blockIdx.x) * n + i0 + a) * n + j0 + b] = s;
  }
}

__global__ void sqdist_reduce_kernel(const float* __restrict__ partial,
                                     float* __restrict__ out, int n, int nchunks) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int nn = n * n;
  if (e >= nn) return;
  float s = 0.f;
  for (int c = 0; c < nchunks; ++c) s += partial[static_cast<long long>(c) * nn + e];
  out[e] = s;
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
// shapes, dtypes, devices and contiguity and allocates partial
// (nchunks, n, n) and out (n, n).
extern "C" int svgd_pairwise_sqdist(const void* theta, const void* mask, void* partial,
                                    void* out, int n, long long D, long long chunk,
                                    int nchunks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (n + kTile - 1) / kTile;
  dim3 grid(nchunks, tiles * tiles);
  sqdist_partial_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(theta), static_cast<const float*>(mask),
      static_cast<float*>(partial), n, D, chunk, tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nn = n * n;
  sqdist_reduce_kernel<<<(nn + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), n, nchunks);
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
