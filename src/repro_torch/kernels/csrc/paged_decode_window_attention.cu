// Paged drafted-window attention (speculative verify) for Hopper (sm_90a),
// plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_decode_attention.py
// ::paged_decode_window_attention (_paged_window_kernel, pl.pallas_call at
// :175), which the reference vmaps over the particle axis. Here the
// particle axis is explicit:
//
//   q            (P, B, W, H, hd)                 fp32 or bf16, contiguous
//   k/v pages    particle p at p * kv_p_stride, then (NP, ps, KVH, hd)
//                contiguous                       fp32 or bf16
//   block_tables (B, n_pmax) int32, shared by all particles
//   seq_lens     (B,) int32, absolute position of window query 0; -1 marks
//                an inactive row
//   out          (P, B, W, H, hd), dtype of q
//
// Semantics: query w of row b sits at position seq_len + w and sees the
// columns c <= seq_len + w (the committed prefix plus drafts 0..w); an
// inactive row returns exact zeros; scale 1/sqrt(hd); the output is divided
// by max(l, 1e-30). A column a query may not see contributes neither its
// weight nor its value row: the value sum of query w stops at its own last
// column, so stale slots (possibly NaN) never enter its arithmetic. The TPU
// kernel zeroes only the weights there, and so lets 0 * NaN through.
// With W = 1 this is, operation for operation, csrc/paged_decode_attention.cu.
//
// Bound on an H100 SXM: each live K/V row is read once per window, so the
// kernel moves P * sum_b(seq_len_b + W) * KVH * hd * 2 * itemsize bytes of
// pages (plus q and out) at 3.35 TB/s; its 4 * P * W * sum_b(seq_len_b + W)
// * H * hd flops are far below the fp32 rate at W <= 8. It is bound by bytes.
//
// Design: PR 11's paged decode kernel with the window folded into the rows
// of a block, as the TPU kernel folds it into its q tile. One block per (kv
// head, row, particle) walks pages 0 .. min((seq_len + W - 1) / ps,
// n_pmax - 1) of its row (never all n_pmax); each page's K and V tiles are
// staged once in shared memory as fp32 and serve all W * G query rows
// (r = w * G + g), so a page is read from HBM once per window, not once per
// drafted token. m, l and the accumulator stay in fp32 in shared memory.
// Simple and right first: split-KV, TMA and wgmma are later work.

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
paged_window_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k_pages,
                    const TKV* __restrict__ v_pages,
                    const int* __restrict__ block_tables,
                    const int* __restrict__ seq_lens, TQ* __restrict__ out,
                    int B, int W, int H, int KVH, int hd, int NP, int ps,
                    int n_pmax, long long kv_p_stride, float scale) {
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int p = blockIdx.z;
  const int G = H / KVH;
  const int R = W * G;  // query rows of this block, r = w * G + g
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ float smem[];
  float* q_s = smem;             // R * hd, pre-scaled queries
  float* acc_s = q_s + R * hd;   // R * hd
  float* k_s = acc_s + R * hd;   // ps * hd
  float* v_s = k_s + ps * hd;    // ps * hd
  float* s_s = v_s + ps * hd;    // R * ps, scores then weights
  float* m_s = s_s + R * ps;     // R
  float* l_s = m_s + R;          // R
  float* c_s = l_s + R;          // R, this page's rescale factor

  // element (w, g, d) of this block sits at ((p*B + b)*W + w)*H*hd
  // + (kvh*G + g)*hd + d
  const long long row_base = (static_cast<long long>(p) * B + b) * W;
  const int sl = seq_lens[b];
  for (int i = tid; i < R * hd; i += kThreads) {
    const int r = i / hd;
    const int w = r / G;
    const int g = r - w * G;
    const int d = i - r * hd;
    const long long off =
        ((row_base + w) * H + static_cast<long long>(kvh) * G + g) * hd + d;
    if (sl < 0) {
      out[off] = from_f32<TQ>(0.f);
    } else {
      q_s[i] = to_f32(q[off]) * scale;
      acc_s[i] = 0.f;
    }
  }
  if (sl < 0) return;
  for (int r = tid; r < R; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  const int* bt = block_tables + static_cast<long long>(b) * n_pmax;
  const TKV* kp = k_pages + static_cast<long long>(p) * kv_p_stride;
  const TKV* vp = v_pages + static_cast<long long>(p) * kv_p_stride;
  const long long slot_stride = static_cast<long long>(KVH) * hd;
  const long long page_stride = ps * slot_stride;
  const int last = sl + W - 1;  // the last column any query of the row sees
  int n_live = last / ps + 1;
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
      if (page_ok && col0 + c <= last) {
        const long long off = page * page_stride + c * slot_stride +
                              static_cast<long long>(kvh) * hd + d;
        kv = to_f32(kp[off]);
        vv = to_f32(vp[off]);
      }
      k_s[i] = kv;
      v_s[i] = vv;
    }
    __syncthreads();
    // scores: one warp per (query row, column), lanes split hd
    for (int pr = warp; pr < R * ps; pr += kWarps) {
      const int r = pr / ps;
      const int c = pr - r * ps;
      const int w = r / G;
      float part = 0.f;
      for (int d = lane; d < hd; d += 32) part += q_s[r * hd + d] * k_s[c * hd + d];
      part = warp_sum(part);
      if (lane == 0) s_s[pr] = (page_ok && col0 + c <= sl + w) ? part : kNegInf;
    }
    __syncthreads();
    // online-softmax statistics: one warp per query row
    for (int r = warp; r < R; r += kWarps) {
      const int w = r / G;
      float mx = kNegInf;
      for (int c = lane; c < ps; c += 32) mx = fmaxf(mx, s_s[r * ps + c]);
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = lane; c < ps; c += 32) {
        const bool valid = page_ok && col0 + c <= sl + w;
        const float e = valid ? expf(s_s[r * ps + c] - m_new) : 0.f;
        s_s[r * ps + c] = e;
        sum += e;
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
    // acc = acc * corr + p @ v over the columns query w may see; each thread
    // owns fixed (row, dim) entries
    for (int i = tid; i < R * hd; i += kThreads) {
      const int r = i / hd;
      const int d = i - r * hd;
      int c_end = sl + r / G - col0 + 1;
      if (!page_ok || c_end < 0) c_end = 0;
      if (c_end > ps) c_end = ps;
      float a = acc_s[i] * c_s[r];
      for (int c = 0; c < c_end; ++c) a += s_s[r * ps + c] * v_s[c * hd + d];
      acc_s[i] = a;
    }
  }
  __syncthreads();
  for (int i = tid; i < R * hd; i += kThreads) {
    const int r = i / hd;
    const int w = r / G;
    const int g = r - w * G;
    const int d = i - r * hd;
    const long long off =
        ((row_base + w) * H + static_cast<long long>(kvh) * G + g) * hd + d;
    out[off] = from_f32<TQ>(acc_s[i] / fmaxf(l_s[r], 1e-30f));
  }
}

template <typename TQ, typename TKV>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const int* block_tables, const int* seq_lens, void* out,
                   int P, int B, int W, int H, int KVH, int hd, int NP, int ps,
                   int n_pmax, long long kv_p_stride, float scale,
                   cudaStream_t stream) {
  const size_t R = static_cast<size_t>(W) * (H / KVH);
  const size_t smem = sizeof(float) * (2 * R * hd + 2 * static_cast<size_t>(ps) * hd +
                                       R * ps + 3 * R);
  auto kernel = paged_window_kernel<TQ, TKV>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  dim3 grid(KVH, B, P);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k_pages),
      static_cast<const TKV*>(v_pages), block_tables, seq_lens,
      static_cast<TQ*>(out), B, W, H, KVH, hd, NP, ps, n_pmax, kv_p_stride, scale);
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success). dtype codes: 0 fp32,
// 1 bf16. The caller checks shapes, dtypes, devices and contiguity.
extern "C" int paged_decode_window_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* seq_lens, void* out, int P, int B,
    int W, int H, int KVH, int hd, int NP, int ps, int n_pmax,
    long long kv_p_stride, int q_dtype, int kv_dtype, float scale, void* stream) {
  const int* bt = static_cast<const int*>(block_tables);
  const int* sl = static_cast<const int*>(seq_lens);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == kF32 && kv_dtype == kF32)
    return launch<float, float>(q, k_pages, v_pages, bt, sl, out, P, B, W, H,
                                KVH, hd, NP, ps, n_pmax, kv_p_stride, scale, s);
  if (q_dtype == kF32 && kv_dtype == kBF16)
    return launch<float, __nv_bfloat16>(q, k_pages, v_pages, bt, sl, out, P, B,
                                        W, H, KVH, hd, NP, ps, n_pmax,
                                        kv_p_stride, scale, s);
  if (q_dtype == kBF16 && kv_dtype == kF32)
    return launch<__nv_bfloat16, float>(q, k_pages, v_pages, bt, sl, out, P, B,
                                        W, H, KVH, hd, NP, ps, n_pmax,
                                        kv_p_stride, scale, s);
  if (q_dtype == kBF16 && kv_dtype == kBF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(q, k_pages, v_pages, bt, sl, out,
                                                P, B, W, H, KVH, hd, NP, ps,
                                                n_pmax, kv_p_stride, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
