// Blocked online-softmax attention forward (prefill) for Hopper (sm_90a),
// plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/attention.py
// ::flash_attention (_flash_kernel, pl.pallas_call at :108), which the
// reference vmaps over the particle axis. Here the particle axis is folded
// into the batch:
//
//   q      (N, S, H, hd)     fp32 or bf16, contiguous (N = particles x rows)
//   k, v   (N, S, KVH, hd)   the dtype of q, contiguous
//   out    (N, S, H, hd)     the dtype of q
//
// Semantics kept from the TPU kernel: GQA (query head h reads kv head
// h / G, G = H / KVH); causal (key j visible to query i iff j <= i) or
// bidirectional; keys past S are masked by a bounds check instead of the
// reference's padding copies; the online softmax keeps m, l in fp32 with
// the -1e30 convention, and a masked score contributes an exact 0 weight,
// so a tile a row cannot see leaves m, l and the accumulator unchanged;
// scale 1/sqrt(hd); the output is divided by max(l, 1e-30).
//
// Bound on an H100 SXM: q, k and v are read once and out written once,
// (2 H + 2 KVH) * N * S * hd * itemsize bytes at 3.35 TB/s, against
// 4 * N * H * hd * S^2 flops (halved, S (S + 1) / 2 pairs, when causal) at
// the 67 TFLOP/s fp32 rate outside the tensor cores (the kernel keeps fp32
// products, as the reference does). A 128-token prompt is bound by bytes;
// a long one (S = 4096) by operations.
//
// Design: one block of 128 threads per (q tile, kv head, batch). A q tile
// holds kRows query rows: BQ = kRows / G positions times the G query heads
// that share the kv head (row r = t * G + g), so K and V are read once per
// tile for all G heads. K and V stream through shared memory in tiles of
// kCols keys (rows padded by one float against bank conflicts); k tiles
// strictly above the diagonal are never visited. Each thread keeps a 4 x 8
// tile of the scores and a 4 x (hd / 8) tile of the output accumulator in
// registers, so a shared-memory load feeds 2-4 FMAs. fp32 FMAs on the CUDA
// cores: simple and right first; wgmma, TMA and warp specialisation are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 64;   // query rows per block: 16 thread rows x 4
constexpr int kCols = 64;   // keys per tile: 8 thread columns x 8
constexpr int kSP = kCols + 1;
static_assert(kThreads == (kRows / 4) * 8, "one 4-row x 8-col tile per thread");
static_assert(kCols == 64, "the softmax gives each lane two keys");

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// NJ = columns of hd each thread accumulates: dims tc + 8 j, j < NJ
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int S, int H,
             int KVH, int hd, int BQ, int causal, float scale) {
  const int qt = blockIdx.x;
  const int kvh = blockIdx.y;
  const long long n = blockIdx.z;
  const int G = H / KVH;
  const int R = BQ * G;        // live rows of this block (<= kRows)
  const int q0 = qt * BQ;
  const int tid = threadIdx.x;
  const int tr = tid >> 3;     // thread row: rows tr * 4 + i
  const int tc = tid & 7;      // thread column: keys / dims tc + 8 j
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int hdp = hd + 1;

  extern __shared__ float smem[];
  float* q_s = smem;                  // kRows * hdp, pre-scaled queries
  float* k_s = q_s + kRows * hdp;     // kCols * hdp
  float* v_s = k_s + kCols * hdp;     // kCols * hd
  float* s_s = v_s + kCols * hd;      // kRows * kSP, scores then weights
  float* m_s = s_s + kRows * kSP;     // kRows
  float* l_s = m_s + kRows;           // kRows
  float* c_s = l_s + kRows;           // kRows, this tile's rescale factor

  for (int i = tid; i < kRows * hd; i += kThreads) {
    const int r = i / hd;
    const int d = i - r * hd;
    const int t = r / G;
    const int g = r - t * G;
    float x = 0.f;
    if (r < R && q0 + t < S)
      x = to_f32(q[((n * S + q0 + t) * H + static_cast<long long>(kvh) * G + g) * hd + d]) * scale;
    q_s[r * hdp + d] = x;
  }
  for (int r = tid; r < kRows; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  int q_hi = q0 + BQ;  // one past the tile's last position
  if (q_hi > S) q_hi = S;
  const int n_kt = causal ? (q_hi - 1) / kCols + 1 : (S + kCols - 1) / kCols;
  const long long kv_stride = static_cast<long long>(KVH) * hd;
  const T* kb = k + n * S * kv_stride + static_cast<long long>(kvh) * hd;
  const T* vb = v + n * S * kv_stride + static_cast<long long>(kvh) * hd;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kCols;
    __syncthreads();  // the previous tile is no longer read
    for (int i = tid; i < kCols * hd; i += kThreads) {
      const int c = i / hd;
      const int d = i - c * hd;
      float kx = 0.f, vx = 0.f;
      if (k0 + c < S) {
        const long long off = (k0 + c) * kv_stride + d;
        kx = to_f32(kb[off]);
        vx = to_f32(vb[off]);
      }
      k_s[c * hdp + d] = kx;
      v_s[c * hd + d] = vx;
    }
    __syncthreads();
    // scores of rows tr*4+i, keys tc+8j
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float qa[4], ka[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = q_s[(tr * 4 + i) * hdp + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) ka[j] = k_s[(tc + 8 * j) * hdp + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] += qa[i] * ka[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tr * 4 + i;
      const int qpos = q0 + r / G;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kpos = k0 + tc + 8 * j;
        const bool valid = r < R && kpos < S && (!causal || kpos <= qpos);
        s_s[r * kSP + tc + 8 * j] = valid ? s[i][j] : kNegInf;
      }
    }
    __syncthreads();
    // online-softmax statistics: one warp per row, two keys per lane
    for (int r = warp; r < kRows; r += kWarps) {
      const int qpos = q0 + r / G;
      float e[2], mx = kNegInf;
#pragma unroll
      for (int h = 0; h < 2; ++h) mx = fmaxf(mx, s_s[r * kSP + lane + 32 * h]);
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kpos = k0 + lane + 32 * h;
        const bool valid = r < R && kpos < S && (!causal || kpos <= qpos);
        e[h] = valid ? expf(s_s[r * kSP + lane + 32 * h] - m_new) : 0.f;
        s_s[r * kSP + lane + 32 * h] = e[h];
        sum += e[h];
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
    // acc = acc * corr + p @ v for rows tr*4+i, dims tc+8j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[tr * 4 + i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }
    for (int c = 0; c < kCols; ++c) {
      float pa[4], va[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = s_s[(tr * 4 + i) * kSP + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = tc + 8 * j;
        va[j] = d < hd ? v_s[c * hd + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] += pa[i] * va[j];
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr * 4 + i;
    const int t = r / G;
    const int g = r - t * G;
    if (r >= R || q0 + t >= S) continue;
    const float inv_l = 1.f / fmaxf(l_s[r], 1e-30f);
    T* o = out + ((n * S + q0 + t) * H + static_cast<long long>(kvh) * G + g) * hd;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tc + 8 * j;
      if (d < hd) o[d] = from_f32<T>(acc[i][j] * inv_l);
    }
  }
}

template <typename T, int NJ>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int N, int S, int H, int KVH, int hd, int causal,
                   float scale, cudaStream_t stream) {
  const int G = H / KVH;
  const int BQ = kRows / G;
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(kRows + kCols) * (hd + 1) + static_cast<size_t>(kCols) * hd +
       static_cast<size_t>(kRows) * kSP + 3 * kRows);
  auto kernel = flash_kernel<T, NJ>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  dim3 grid((S + BQ - 1) / BQ, KVH, N);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), S, H, KVH, hd, BQ, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out,
                     int N, int S, int H, int KVH, int hd, int causal,
                     float scale, cudaStream_t s) {
  if (hd <= 8) return launch<T, 1>(q, k, v, out, N, S, H, KVH, hd, causal, scale, s);
  if (hd <= 16) return launch<T, 2>(q, k, v, out, N, S, H, KVH, hd, causal, scale, s);
  if (hd <= 32) return launch<T, 4>(q, k, v, out, N, S, H, KVH, hd, causal, scale, s);
  if (hd <= 64) return launch<T, 8>(q, k, v, out, N, S, H, KVH, hd, causal, scale, s);
  if (hd <= 128) return launch<T, 16>(q, k, v, out, N, S, H, KVH, hd, causal, scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success). dtype code: 0 fp32,
// 1 bf16 (q, k, v and out alike). The caller checks shapes, dtypes,
// devices and contiguity, hd <= 128 and G = H / KVH <= 64.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int N, int S, int H, int KVH, int hd,
                               int causal, int dtype, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H % KVH != 0 || H / KVH > kRows) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kF32)
    return static_cast<int>(dispatch<float>(q, k, v, out, N, S, H, KVH, hd, causal, scale, s));
  if (dtype == kBF16)
    return static_cast<int>(dispatch<__nv_bfloat16>(q, k, v, out, N, S, H, KVH, hd, causal,
                                                    scale, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
