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
// diag_std: sqrt(max(sq - mean^2, 1e-30)) elementwise: the SWAG diagonal
// scale, computed once per particle at serve-time sampling (not once per
// drawn sample), over every leaf of the tree in one launch
// (swag_diag_std_leaves, below).
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
// 2 x 632.8 MB and writes 632.8 MB: 0.567 ms. The first design, kept for
// the per-leaf entries (swag_moments and swag_diag_std: probes and the
// one-launch kernels' peers, off the sampling and collection paths): a
// grid-stride loop with one fp32 element per thread per step, neighbouring
// threads on neighbouring addresses, grid.y over particle rows; nothing is
// staged in shared memory because nothing is reused.
//
// moments over every leaf (swag_moments_leaves, the collection's path).
// The reference ravels the whole tree and makes one pallas_call; the
// per-leaf entry makes one launch per leaf (34 for the UNet, 18 for the ViT, P times
// that on the NEL), and a small tree's collection was bound by those
// launches and the host between them (the UNet's: 0.84-1.82 ms eager for a
// 0.071 ms bound). This entry updates up to kMaxLeaves leaves in one launch
// without the ravel copy: the leaves' pointers and lengths travel by value
// in the kernel's parameters (LeafSet, __grid_constant__; 3,112 bytes of
// the 4 KB a launch takes), so no device table and no host-to-device copy
// are needed and a stream being captured takes it as it is. A tree of more
// leaves takes one launch per kMaxLeaves. The work items are (leaf, row,
// chunk of kChunk elements), numbered leaf by leaf (LeafSet::start, a
// prefix sum the wrapper computes and this entry checks); one persistent
// wave of blocks walks them with a grid stride. A chunk goes as 128-bit
// loads (four float4 of mean, sq and theta a thread, 192 B in flight) where
// the leaf's rows are 16-byte aligned (L % 4 == 0 and aligned bases), else
// as scalar loads (the UNet's 1-element biases). The update is in place
// (the collection's own leaves): a dead row is skipped, neither read nor
// written. The element arithmetic is moments_kernel's (moments_elem), so
// the two and the plain version agree bit for bit.
//
// diag_std over every leaf (swag_diag_std_leaves, the sampling path). The
// per-leaf entry made one launch per leaf, and sampling made them once
// per draw: 272 launches for 8 UNet particles in sample_predict, each 1 to
// 393,216 elements, host-bound (0.39-0.92 ms for a 0.004-0.036 ms bound).
// This entry computes up to kMaxLeaves leaves' scales in one launch, the
// pointers (mean, sq, out) and lengths by value in a __grid_constant__
// parameter struct as for moments (DiagSet: 2,576 bytes), once per
// particle. The scale is elementwise over a leaf's contiguous (P, ...)
// block, so a leaf is its numel elements and a work item is (leaf, chunk
// of kChunk elements): the moments plan at one row. A chunk goes as
// 128-bit streaming loads and stores (__ldcs / __stcs: nothing is read
// twice) where the leaf's three bases are 16-byte aligned and its length
// is a multiple of 4 (the UNet's 1-element biases qualify in an (8, 1)
// stack), else as scalar accesses. The element arithmetic is
// diag_std_kernel's (diag_std_elem), so the two agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocksX = 8192;

// One element of a live row: mean', sq' rounded as the plain version
// rounds them (no FMA contraction), and the deviation theta - mean'.
__device__ __forceinline__ void moments_elem(float m, float s, float t, float np, float np1,
                                             float& m2, float& s2, float& d) {
  m2 = __fadd_rn(__fmul_rn(m, np), t) / np1;
  s2 = __fadd_rn(__fmul_rn(s, np), __fmul_rn(t, t)) / np1;
  d = t - m2;
}

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
      float m2, s2, dv;
      moments_elem(m, s, theta[base + d], np, np1, m2, s2, dv);
      out_mean[base + d] = m2;
      out_sq[base + d] = s2;
      if (drow != nullptr) drow[d] = dv;
    } else {
      out_mean[base + d] = m;
      out_sq[base + d] = s;
    }
  }
}

// One scale: m*m rounded before the subtraction, as in the plain version:
// where sq ~ m^2 the difference is rounding noise, and an FMA would change
// its square root by far more than an ulp.
__device__ __forceinline__ float diag_std_elem(float m, float s) {
  return sqrtf(fmaxf(__fsub_rn(s, __fmul_rn(m, m)), 1e-30f));
}

__global__ void __launch_bounds__(kThreads)
diag_std_kernel(const float* __restrict__ mean, const float* __restrict__ sq,
                float* __restrict__ out, long long numel) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       i < numel; i += stride) {
    out[i] = diag_std_elem(mean[i], sq[i]);
  }
}

constexpr int kMaxLeaves = 64;
constexpr int kGroups = 4;                       // float4 groups a thread an item
constexpr int kLeafBlocks = 2;                   // blocks an SM
constexpr int kChunk = kThreads * 4 * kGroups;   // elements an item

struct Leaf {
  float* mean;           // (P, L), updated in place
  float* sq;             // (P, L), updated in place
  const float* theta;    // (P, L)
  float* dev;            // (P, R, L) or null
  long long L;
  long long start;       // the leaf's first work item
};

struct LeafSet {
  Leaf leaf[kMaxLeaves];
  const float* n;        // (P,)
  const float* mask;     // (P,) or null
  const int* slot;       // (P,) or null
  long long items;
  int count;
  int R;
};

__global__ void __launch_bounds__(kThreads, kLeafBlocks)
moments_leaves_kernel(const __grid_constant__ LeafSet set) {
  int l = 0;  // a block's items only grow, so its leaf index only moves on
  for (long long item = blockIdx.x; item < set.items; item += gridDim.x) {
    while (l + 1 < set.count && item >= set.leaf[l + 1].start) ++l;
    const Leaf& f = set.leaf[l];
    const long long chunks = (f.L + kChunk - 1) / kChunk;
    const long long r = item - f.start;
    const int p = static_cast<int>(r / chunks);
    const long long e0 = (r - p * chunks) * kChunk;
    if (set.mask != nullptr && !(set.mask[p] > 0.f)) continue;  // dead: untouched
    const float np = set.n[p];
    const float np1 = np + 1.f;
    const long long base = static_cast<long long>(p) * f.L;
    float* mrow = f.mean + base;
    float* srow = f.sq + base;
    const float* trow = f.theta + base;
    float* drow = f.dev != nullptr
                      ? f.dev + (static_cast<long long>(p) * set.R + set.slot[p]) * f.L
                      : nullptr;
    const bool vec = f.L % 4 == 0 &&
        ((reinterpret_cast<uintptr_t>(f.mean) | reinterpret_cast<uintptr_t>(f.sq) |
          reinterpret_cast<uintptr_t>(f.theta) | reinterpret_cast<uintptr_t>(f.dev)) & 15) == 0;
    if (vec) {
      float4 m[kGroups], s[kGroups], t[kGroups];
#pragma unroll
      for (int q = 0; q < kGroups; ++q) {
        const long long e = e0 + (static_cast<long long>(q) * kThreads + threadIdx.x) * 4;
        if (e < f.L) {
          m[q] = *reinterpret_cast<const float4*>(mrow + e);
          s[q] = *reinterpret_cast<const float4*>(srow + e);
          t[q] = __ldcs(reinterpret_cast<const float4*>(trow + e));
        }
      }
#pragma unroll
      for (int q = 0; q < kGroups; ++q) {
        const long long e = e0 + (static_cast<long long>(q) * kThreads + threadIdx.x) * 4;
        if (e < f.L) {
          float4 m2, s2, d;
          moments_elem(m[q].x, s[q].x, t[q].x, np, np1, m2.x, s2.x, d.x);
          moments_elem(m[q].y, s[q].y, t[q].y, np, np1, m2.y, s2.y, d.y);
          moments_elem(m[q].z, s[q].z, t[q].z, np, np1, m2.z, s2.z, d.z);
          moments_elem(m[q].w, s[q].w, t[q].w, np, np1, m2.w, s2.w, d.w);
          __stcs(reinterpret_cast<float4*>(mrow + e), m2);
          __stcs(reinterpret_cast<float4*>(srow + e), s2);
          if (drow != nullptr) __stcs(reinterpret_cast<float4*>(drow + e), d);
        }
      }
    } else {
      for (long long e = e0 + threadIdx.x; e < f.L && e < e0 + kChunk; e += kThreads) {
        float m2, s2, d;
        moments_elem(mrow[e], srow[e], trow[e], np, np1, m2, s2, d);
        mrow[e] = m2;
        srow[e] = s2;
        if (drow != nullptr) drow[e] = d;
      }
    }
  }
}

struct DiagLeaf {
  const float* mean;     // numel L, contiguous
  const float* sq;
  float* out;
  long long L;
  long long start;       // the leaf's first work item
};

struct DiagSet {
  DiagLeaf leaf[kMaxLeaves];
  long long items;
  int count;
};
static_assert(sizeof(DiagSet) <= 4096,
              "DiagSet must fit the 4 KB of a kernel's parameters");

__global__ void __launch_bounds__(kThreads, kLeafBlocks)
diag_std_leaves_kernel(const __grid_constant__ DiagSet set) {
  int l = 0;  // a block's items only grow, so its leaf index only moves on
  for (long long item = blockIdx.x; item < set.items; item += gridDim.x) {
    while (l + 1 < set.count && item >= set.leaf[l + 1].start) ++l;
    const DiagLeaf& f = set.leaf[l];
    const long long e0 = (item - f.start) * kChunk;
    const bool vec = f.L % 4 == 0 &&
        ((reinterpret_cast<uintptr_t>(f.mean) | reinterpret_cast<uintptr_t>(f.sq) |
          reinterpret_cast<uintptr_t>(f.out)) & 15) == 0;
    if (vec) {
      float4 m[kGroups], s[kGroups];
#pragma unroll
      for (int q = 0; q < kGroups; ++q) {
        const long long e = e0 + (static_cast<long long>(q) * kThreads + threadIdx.x) * 4;
        if (e < f.L) {
          m[q] = __ldcs(reinterpret_cast<const float4*>(f.mean + e));
          s[q] = __ldcs(reinterpret_cast<const float4*>(f.sq + e));
        }
      }
#pragma unroll
      for (int q = 0; q < kGroups; ++q) {
        const long long e = e0 + (static_cast<long long>(q) * kThreads + threadIdx.x) * 4;
        if (e < f.L) {
          float4 o;
          o.x = diag_std_elem(m[q].x, s[q].x);
          o.y = diag_std_elem(m[q].y, s[q].y);
          o.z = diag_std_elem(m[q].z, s[q].z);
          o.w = diag_std_elem(m[q].w, s[q].w);
          __stcs(reinterpret_cast<float4*>(f.out + e), o);
        }
      }
    } else {
      for (long long e = e0 + threadIdx.x; e < f.L && e < e0 + kChunk; e += kThreads)
        f.out[e] = diag_std_elem(f.mean[e], f.sq[e]);
    }
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

// One collection over `count` <= kMaxLeaves leaves in one launch, in place.
// ptrs: 4 per leaf (mean, sq, theta, dev or 0), lens: L per leaf, starts:
// each leaf's first work item (P * ceil(L / kChunk) items a leaf, in leaf
// order; checked here), items their total; n (P,), mask (P,) or null, slot
// (P,) int32 or null (with the devs), R the ring's depth; grid the blocks
// (one wave). Returns the cudaError_t of the launch (0 = success).
extern "C" int swag_moments_leaves(const long long* ptrs, const long long* lens,
                                   const long long* starts, int count, long long items,
                                   const void* n, const void* mask, const void* slot, int R,
                                   int P, int grid, void* stream) {
  if (count < 1 || count > kMaxLeaves || grid < 1 || P < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  LeafSet set{};
  long long at = 0;
  for (int i = 0; i < count; ++i) {
    Leaf& f = set.leaf[i];
    f.mean = reinterpret_cast<float*>(ptrs[4 * i]);
    f.sq = reinterpret_cast<float*>(ptrs[4 * i + 1]);
    f.theta = reinterpret_cast<const float*>(ptrs[4 * i + 2]);
    f.dev = reinterpret_cast<float*>(ptrs[4 * i + 3]);
    f.L = lens[i];
    f.start = starts[i];
    if (f.L < 1 || f.start != at) return static_cast<int>(cudaErrorInvalidValue);
    at += P * ((f.L + kChunk - 1) / kChunk);
  }
  if (at != items) return static_cast<int>(cudaErrorInvalidValue);
  set.n = static_cast<const float*>(n);
  set.mask = static_cast<const float*>(mask);
  set.slot = static_cast<const int*>(slot);
  set.items = items;
  set.count = count;
  set.R = R;
  moments_leaves_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(set);
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

// The scales of `count` <= kMaxLeaves leaves in one launch. ptrs: 3 per
// leaf (mean, sq, out; out overlaps no input), lens: numel per leaf,
// starts: each leaf's first work item (ceil(numel / kChunk) items a leaf,
// in leaf order; checked here), items their total; grid the blocks (one
// wave). Returns the cudaError_t of the launch (0 = success).
extern "C" int swag_diag_std_leaves(const long long* ptrs, const long long* lens,
                                    const long long* starts, int count, long long items,
                                    int grid, void* stream) {
  if (count < 1 || count > kMaxLeaves || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  DiagSet set{};
  long long at = 0;
  for (int i = 0; i < count; ++i) {
    DiagLeaf& f = set.leaf[i];
    f.mean = reinterpret_cast<const float*>(ptrs[3 * i]);
    f.sq = reinterpret_cast<const float*>(ptrs[3 * i + 1]);
    f.out = reinterpret_cast<float*>(ptrs[3 * i + 2]);
    f.L = lens[i];
    f.start = starts[i];
    if (f.L < 1 || f.start != at) return static_cast<int>(cudaErrorInvalidValue);
    at += (f.L + kChunk - 1) / kChunk;
  }
  if (at != items) return static_cast<int>(cudaErrorInvalidValue);
  set.items = items;
  set.count = count;
  diag_std_leaves_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(set);
  return static_cast<int>(cudaGetLastError());
}
