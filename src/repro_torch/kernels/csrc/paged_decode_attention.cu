// Paged single-token decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_decode_attention.py
// ::paged_decode_attention (pl.pallas_call at :219), which the reference
// vmaps over the particle axis. Here the particle axis is explicit:
//
//   q            (P, B, H, hd)                    fp32 or bf16, contiguous
//   k/v pages    particle p at p * kv_p_stride, then (NP, ps, KVH, hd)
//                contiguous                       fp32 or bf16
//   block_tables (B, n_pmax) int32, shared by all particles
//   seq_lens     (B,) int32, last valid position; -1 marks an inactive row
//   out          (P, B, H, hd), dtype of q
//
// Semantics kept from the TPU kernel: column c of logical page pi is valid
// iff pi*ps + c <= seq_len and seq_len >= 0; both the softmax weight and the
// value row are zeroed on invalid columns (slots past the tail hold stale
// writes of a previous owner, possibly NaN); an inactive row returns exact
// zeros; scale 1/sqrt(hd); the output is divided by max(l, 1e-30).
//
// Bound on an H100 SXM: the kernel reads each live K/V row once, so it moves
// P * sum_b(seq_len_b + 1) * KVH * hd * 2 * itemsize bytes of pages (plus q
// and out), read at 3.35 TB/s; its 4 * P * sum_b(seq_len_b + 1) * H * hd
// flops are far below the fp32 rate. It is bound by bytes.
//
// Design: one block per (kv head, row, particle). The block loads its row's
// block-table entries itself and loops over the row's live pages only,
// ceil((seq_len + 1) / ps) of them, never over all n_pmax. Each page's K and
// V tiles are staged in shared memory as fp32 (invalid slots written as 0
// there, so stale NaN never enters arithmetic); the G = H / KVH query heads
// that share the kv head reuse the tile, so a page is read from HBM once per
// particle and row. m, l and the accumulator stay in fp32 in shared memory.
// This is the simple correct form: one block per (p, b, kv head) leaves the
// card under-filled at small B * KVH and serialises a long row's pages;
// split-KV (flash-decoding), TMA and wgmma are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

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
paged_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k_pages,
                    const TKV* __restrict__ v_pages,
                    const int* __restrict__ block_tables,
                    const int* __restrict__ seq_lens, TQ* __restrict__ out,
                    int B, int H, int KVH, int hd, int NP, int ps, int n_pmax,
                    long long kv_p_stride, float scale) {
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int p = blockIdx.z;
  const int G = H / KVH;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ float smem[];
  float* q_s = smem;             // G * hd, pre-scaled queries
  float* acc_s = q_s + G * hd;   // G * hd
  float* k_s = acc_s + G * hd;   // ps * hd
  float* v_s = k_s + ps * hd;    // ps * hd
  float* s_s = v_s + ps * hd;    // G * ps, scores then weights
  float* m_s = s_s + G * ps;     // G
  float* l_s = m_s + G;          // G
  float* c_s = l_s + G;          // G, this page's rescale factor

  const long long q_base =
      ((static_cast<long long>(p) * B + b) * H + static_cast<long long>(kvh) * G) * hd;
  const int sl = seq_lens[b];
  if (sl < 0) {
    for (int i = tid; i < G * hd; i += kThreads) out[q_base + i] = from_f32<TQ>(0.f);
    return;
  }
  for (int i = tid; i < G * hd; i += kThreads) {
    q_s[i] = to_f32(q[q_base + i]) * scale;
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }

  const int* bt = block_tables + static_cast<long long>(b) * n_pmax;
  const TKV* kp = k_pages + static_cast<long long>(p) * kv_p_stride;
  const TKV* vp = v_pages + static_cast<long long>(p) * kv_p_stride;
  const long long slot_stride = static_cast<long long>(KVH) * hd;
  const long long page_stride = ps * slot_stride;
  int n_live = sl / ps + 1;  // pages holding positions 0..sl
  if (n_live > n_pmax) n_live = n_pmax;

  for (int pi = 0; pi < n_live; ++pi) {
    const int page = bt[pi];
    // a block-table entry outside the pool is never dereferenced: its
    // columns count as invalid (the host allocator never hands one out)
    const bool page_ok = page >= 0 && page < NP;
    const int col0 = pi * ps;
    __syncthreads();  // the previous page's tiles are no longer read
    for (int i = tid; i < ps * hd; i += kThreads) {
      const int c = i / hd;
      const int d = i - c * hd;
      float kv = 0.f, vv = 0.f;
      if (page_ok && col0 + c <= sl) {
        const long long off = page * page_stride + c * slot_stride +
                              static_cast<long long>(kvh) * hd + d;
        kv = to_f32(kp[off]);
        vv = to_f32(vp[off]);
      }
      k_s[i] = kv;
      v_s[i] = vv;
    }
    __syncthreads();
    // scores: one warp per (head, column), lanes split hd
    for (int pr = warp; pr < G * ps; pr += kWarps) {
      const int g = pr / ps;
      const int c = pr - g * ps;
      float part = 0.f;
      for (int d = lane; d < hd; d += 32) part += q_s[g * hd + d] * k_s[c * hd + d];
      part = warp_sum(part);
      if (lane == 0) s_s[pr] = (page_ok && col0 + c <= sl) ? part : kNegInf;
    }
    __syncthreads();
    // online-softmax statistics: one warp per head
    for (int g = warp; g < G; g += kWarps) {
      float mx = kNegInf;
      for (int c = lane; c < ps; c += 32) mx = fmaxf(mx, s_s[g * ps + c]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = lane; c < ps; c += 32) {
        const bool valid = page_ok && col0 + c <= sl;
        const float w = valid ? expf(s_s[g * ps + c] - m_new) : 0.f;
        s_s[g * ps + c] = w;
        sum += w;
      }
      sum = warp_sum(sum);
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
      for (int c = 0; c < ps; ++c) a += s_s[g * ps + c] * v_s[c * hd + d];
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
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const int* block_tables, const int* seq_lens, void* out,
                   int P, int B, int H, int KVH, int hd, int NP, int ps,
                   int n_pmax, long long kv_p_stride, float scale,
                   cudaStream_t stream) {
  const int G = H / KVH;
  const size_t smem =
      sizeof(float) * (2 * static_cast<size_t>(G) * hd + 2 * static_cast<size_t>(ps) * hd +
                       static_cast<size_t>(G) * ps + 3 * static_cast<size_t>(G));
  auto kernel = paged_decode_kernel<TQ, TKV>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  dim3 grid(KVH, B, P);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k_pages),
      static_cast<const TKV*>(v_pages), block_tables, seq_lens,
      static_cast<TQ*>(out), B, H, KVH, hd, NP, ps, n_pmax, kv_p_stride, scale);
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success). dtype codes: 0 fp32,
// 1 bf16. The caller checks shapes, dtypes, devices and contiguity.
extern "C" int paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* seq_lens, void* out, int P, int B,
    int H, int KVH, int hd, int NP, int ps, int n_pmax, long long kv_p_stride,
    int q_dtype, int kv_dtype, float scale, void* stream) {
  const int* bt = static_cast<const int*>(block_tables);
  const int* sl = static_cast<const int*>(seq_lens);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == kF32 && kv_dtype == kF32)
    return launch<float, float>(q, k_pages, v_pages, bt, sl, out, P, B, H, KVH,
                                hd, NP, ps, n_pmax, kv_p_stride, scale, s);
  if (q_dtype == kF32 && kv_dtype == kBF16)
    return launch<float, __nv_bfloat16>(q, k_pages, v_pages, bt, sl, out, P, B,
                                        H, KVH, hd, NP, ps, n_pmax, kv_p_stride,
                                        scale, s);
  if (q_dtype == kBF16 && kv_dtype == kF32)
    return launch<__nv_bfloat16, float>(q, k_pages, v_pages, bt, sl, out, P, B,
                                        H, KVH, hd, NP, ps, n_pmax, kv_p_stride,
                                        scale, s);
  if (q_dtype == kBF16 && kv_dtype == kBF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(q, k_pages, v_pages, bt, sl, out,
                                                P, B, H, KVH, hd, NP, ps, n_pmax,
                                                kv_p_stride, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
