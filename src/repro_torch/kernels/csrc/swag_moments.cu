// SWAG moment passes for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/swag_moments.py:
//   moments_flat  (_moments_kernel,  pl.pallas_call at :50)
//   diag_std_flat (_diag_std_kernel, pl.pallas_call at :86)
//
// moments: over the store's stacked rows, one leaf at a time (no flatten
// copy), mean, sq, theta (P, L) fp32 contiguous, n (P,) fp32 per row:
//   mean' = (mean * n + theta) / (n + 1),  sq' = (sq * n + theta^2) / (n + 1)
// A dead row (mask[p] <= 0) is copied through bit for bit and its theta is
// never read. The pass also writes the SWAG deviation of each live row into
// its ring slot, dev[p, slot[p], :] = theta - mean' (src/repro/bdl/swag.py:
// 61-66), in place: the ring is max_rank times the parameters (12.7 GB at
// 8 ViT-MNIST particles and rank 20), too large to copy per collection. The
// slot differs by row (rank % max_rank per row), so it is read per row.
//
// diag_std: sqrt(max(sq - mean^2, 1e-30)) elementwise over the (P, L) rows
// of one leaf: the SWAG diagonal scale, read once per particle row at
// serve-time sampling (not once per drawn sample).
//
// The moments may be updated in place: out_mean may be mean and out_sq
// may be sq (the collection passes the store's own leaves). Each element
// is read and then written by one thread, and by no other, so the alias is
// safe; those four pointers carry no __restrict__, which would promise the
// compiler they do not alias. A dead row updated in place is left as it
// is, unread.
//
// Both are elementwise streams, bound by bytes on an H100 SXM (3.35 TB/s):
// at 8 x 19,775,360 parameters, moments reads 3 x 632.8 MB and writes
// 3 x 632.8 MB (two moments and the deviation row): 1.13 ms; diag_std reads
// 2 x 632.8 MB and writes 632.8 MB: 0.567 ms. The design is a grid-stride
// loop with one fp32 element per thread per step, neighbouring threads on
// neighbouring addresses, grid.y over particle rows; nothing is staged in
// shared memory because nothing is reused.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocksX = 8192;

__global__ void __launch_bounds__(kThreads)
moments_kernel(const float* mean, const float* sq,
               const float* __restrict__ theta, const float* __restrict__ n,
               const float* __restrict__ mask, float* __restrict__ dev,
               const int* __restrict__ slot, int R, float* out_mean,
               float* out_sq, long long L) {
  const int p = blockIdx.y;
  const long long base = static_cast<long long>(p) * L;
  const bool live = mask == nullptr || mask[p] > 0.f;
  if (!live && out_mean == mean && out_sq == sq) return;
  const float np = n[p];
  const float np1 = np + 1.f;
  float* drow = (dev != nullptr && live)
                    ? dev + (static_cast<long long>(p) * R + slot[p]) * L
                    : nullptr;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long d = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       d < L; d += stride) {
    const float m = mean[base + d];
    const float s = sq[base + d];
    if (live) {
      const float t = theta[base + d];
      // round every product as the plain version does (no FMA
      // contraction), so the two agree bit for bit
      const float m2 = __fadd_rn(__fmul_rn(m, np), t) / np1;
      out_mean[base + d] = m2;
      out_sq[base + d] = __fadd_rn(__fmul_rn(s, np), __fmul_rn(t, t)) / np1;
      if (drow != nullptr) drow[d] = t - m2;
    } else {
      out_mean[base + d] = m;
      out_sq[base + d] = s;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
diag_std_kernel(const float* __restrict__ mean, const float* __restrict__ sq,
                float* __restrict__ out, long long numel) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       i < numel; i += stride) {
    const float m = mean[i];
    // m*m rounded before the subtraction, as in the plain version: where
    // sq ~ m^2 the difference is rounding noise, and an FMA would change
    // its square root by far more than an ulp
    out[i] = sqrtf(fmaxf(__fsub_rn(sq[i], __fmul_rn(m, m)), 1e-30f));
  }
}

unsigned blocks_for(long long count) {
  long long b = (count + kThreads - 1) / kThreads;
  if (b > kMaxBlocksX) b = kMaxBlocksX;
  if (b < 1) b = 1;
  return static_cast<unsigned>(b);
}

}  // namespace

// mean, sq, theta, out_mean, out_sq: (P, L) fp32 (out_mean may be mean and
// out_sq may be sq; no other overlap); n: (P,) fp32; mask: (P,) fp32 or
// null; dev: (P, R, L) fp32 or null, with slot (P,) int32 in [0, R).
// Returns the cudaError_t of the launch (0 = success).
extern "C" int swag_moments(const void* mean, const void* sq, const void* theta,
                            const void* n, const void* mask, void* dev,
                            const void* slot, int R, void* out_mean, void* out_sq,
                            int P, long long L, void* stream) {
  dim3 grid(blocks_for(L), P);
  moments_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(mean), static_cast<const float*>(sq),
      static_cast<const float*>(theta), static_cast<const float*>(n),
      static_cast<const float*>(mask), static_cast<float*>(dev),
      static_cast<const int*>(slot), R, static_cast<float*>(out_mean),
      static_cast<float*>(out_sq), L);
  return static_cast<int>(cudaGetLastError());
}

// mean, sq, out: numel fp32 contiguous. Returns the cudaError_t (0 = success).
extern "C" int swag_diag_std(const void* mean, const void* sq, void* out,
                             long long numel, void* stream) {
  diag_std_kernel<<<blocks_for(numel), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(mean), static_cast<const float*>(sq),
      static_cast<float*>(out), numel);
  return static_cast<int>(cudaGetLastError());
}
