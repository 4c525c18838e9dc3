// Single-token decode attention over a dense KV cache for Hopper (sm_90a),
// plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py
// ::decode_attention (_decode_kernel, pl.pallas_call at :85), which the
// reference vmaps over the particle axis. Here the particle axis is
// explicit:
//
//   q        (P, B, H, hd)          fp32 or bf16, contiguous
//   k/v      particle p at p * kv_p_stride, then (B, C, KVH, hd)
//            contiguous             fp32 or bf16 (a unit's view of a cache
//            stacked on (P, n_units, ...) is strided on the particle axis)
//   k_pos    (B, C) int32, absolute position of each cache slot (-1 =
//            empty), shared by all particles
//   out      (P, B, H, hd), dtype of q
//
// Semantics kept from the TPU kernel: slot c is valid iff k_pos[b, c] >= 0
// (and c < C: the ragged last tile is masked by index, never padded in
// memory); both the softmax weight and the value row are zeroed on invalid
// slots, so an empty slot's contents (possibly NaN) never enter the
// arithmetic; scale 1/sqrt(hd); the output is divided by max(l, 1e-30), so
// a row with no valid slot returns zeros.
//
// Bound on an H100 SXM: the kernel reads each valid K/V row once, so it
// moves P * sum_b(valid_b) * KVH * hd * 2 * itemsize bytes of cache (plus
// q, k_pos and out) at 3.35 TB/s; its 4 * P * sum_b(valid_b) * H * hd flops
// are far below the fp32 rate. It is bound by bytes.
//
// Design: the layout of csrc/paged_decode_attention.cu with a contiguous
// cache in place of the page walk. One block per (kv head, row, particle)
// streams C in tiles of kTile slots, staged in shared memory as fp32 with
// invalid slots written as 0; the G = H / KVH query heads of the kv head
// reuse each tile, so the cache is read from HBM once per particle and row.
// A tile whose slots are all empty is skipped without reading K or V.
// m, l and the accumulator stay in fp32 in shared memory. Simple and right
// first: split-KV, TMA and wgmma are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;
static_assert(kTile == 32, "the softmax gives each lane of a warp one slot");

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

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k_cache,
              const TKV* __restrict__ v_cache, const int* __restrict__ k_pos,
              TQ* __restrict__ out, int B, int H, int KVH, int hd, int C,
              long long kv_p_stride, float scale) {
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int p = blockIdx.z;
  const int G = H / KVH;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ float smem[];
  float* q_s = smem;              // G * hd, pre-scaled queries
  float* acc_s = q_s + G * hd;    // G * hd
  float* k_s = acc_s + G * hd;    // kTile * hd
  float* v_s = k_s + kTile * hd;  // kTile * hd
  float* s_s = v_s + kTile * hd;  // G * kTile, scores then weights
  float* m_s = s_s + G * kTile;   // G
  float* l_s = m_s + G;           // G
  float* c_s = l_s + G;           // G, this tile's rescale factor
  __shared__ int valid_s[kTile];
  __shared__ int any_s;

  const long long q_base =
      ((static_cast<long long>(p) * B + b) * H + static_cast<long long>(kvh) * G) * hd;
  for (int i = tid; i < G * hd; i += kThreads) {
    q_s[i] = to_f32(q[q_base + i]) * scale;
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }

  const int* pos = k_pos + static_cast<long long>(b) * C;
  const long long slot_stride = static_cast<long long>(KVH) * hd;
  const long long row_off = static_cast<long long>(p) * kv_p_stride +
                            static_cast<long long>(b) * C * slot_stride +
                            static_cast<long long>(kvh) * hd;
  const TKV* kr = k_cache + row_off;
  const TKV* vr = v_cache + row_off;

  for (int col0 = 0; col0 < C; col0 += kTile) {
    __syncthreads();  // the previous tile is no longer read
    if (tid == 0) any_s = 0;
    __syncthreads();
    if (tid < kTile) {
      const int c = col0 + tid;
      const int ok = c < C && pos[c] >= 0;
      valid_s[tid] = ok;
      if (ok) any_s = 1;
    }
    __syncthreads();
    if (!any_s) continue;  // an all-empty tile adds nothing
    for (int i = tid; i < kTile * hd; i += kThreads) {
      const int c = i / hd;
      const int d = i - c * hd;
      float kv = 0.f, vv = 0.f;
      if (valid_s[c]) {
        const long long off = (col0 + c) * slot_stride + d;
        kv = to_f32(kr[off]);
        vv = to_f32(vr[off]);
      }
      k_s[i] = kv;
      v_s[i] = vv;
    }
    __syncthreads();
    // scores: one warp per (head, slot), lanes split hd
    for (int pr = warp; pr < G * kTile; pr += kWarps) {
      const int g = pr / kTile;
      const int c = pr - g * kTile;
      float part = 0.f;
      for (int d = lane; d < hd; d += 32) part += q_s[g * hd + d] * k_s[c * hd + d];
      part = warp_sum(part);
      if (lane == 0) s_s[pr] = valid_s[c] ? part : kNegInf;
    }
    __syncthreads();
    // online-softmax statistics: one warp per head, one lane per slot
    for (int g = warp; g < G; g += kWarps) {
      const float s = s_s[g * kTile + lane];
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float e = valid_s[lane] ? expf(s - m_new) : 0.f;
      s_s[g * kTile + lane] = e;
      const float sum = warp_sum(e);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        c_s[g] = corr;
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    // acc = acc * corr + p @ v; each thread owns fixed (head, dim) entries
    for (int i = tid; i < G * hd; i += kThreads) {
      const int g = i / hd;
      const int d = i - g * hd;
      float a = acc_s[i] * c_s[g];
      for (int c = 0; c < kTile; ++c) a += s_s[g * kTile + c] * v_s[c * hd + d];
      acc_s[i] = a;
    }
  }
  __syncthreads();
  for (int i = tid; i < G * hd; i += kThreads) {
    const int g = i / hd;
    out[q_base + i] = from_f32<TQ>(acc_s[i] / fmaxf(l_s[g], 1e-30f));
  }
}

template <typename TQ, typename TKV>
cudaError_t launch(const void* q, const void* k_cache, const void* v_cache,
                   const int* k_pos, void* out, int P, int B, int H, int KVH,
                   int hd, int C, long long kv_p_stride, float scale,
                   cudaStream_t stream) {
  const size_t G = static_cast<size_t>(H / KVH);
  const size_t smem = sizeof(float) * (2 * G * hd + 2 * static_cast<size_t>(kTile) * hd +
                                       G * kTile + 3 * G);
  auto kernel = decode_kernel<TQ, TKV>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  dim3 grid(KVH, B, P);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k_cache),
      static_cast<const TKV*>(v_cache), k_pos, static_cast<TQ*>(out), B, H, KVH,
      hd, C, kv_p_stride, scale);
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success). dtype codes: 0 fp32,
// 1 bf16. The caller checks shapes, dtypes, devices and contiguity.
extern "C" int decode_attention(const void* q, const void* k_cache,
                                const void* v_cache, const void* k_pos,
                                void* out, int P, int B, int H, int KVH, int hd,
                                int C, long long kv_p_stride, int q_dtype,
                                int kv_dtype, float scale, void* stream) {
  const int* pos = static_cast<const int*>(k_pos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == kF32 && kv_dtype == kF32)
    return launch<float, float>(q, k_cache, v_cache, pos, out, P, B, H, KVH, hd,
                                C, kv_p_stride, scale, s);
  if (q_dtype == kF32 && kv_dtype == kBF16)
    return launch<float, __nv_bfloat16>(q, k_cache, v_cache, pos, out, P, B, H,
                                        KVH, hd, C, kv_p_stride, scale, s);
  if (q_dtype == kBF16 && kv_dtype == kF32)
    return launch<__nv_bfloat16, float>(q, k_cache, v_cache, pos, out, P, B, H,
                                        KVH, hd, C, kv_p_stride, scale, s);
  if (q_dtype == kBF16 && kv_dtype == kBF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(q, k_cache, v_cache, pos, out, P,
                                                B, H, KVH, hd, C, kv_p_stride,
                                                scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
