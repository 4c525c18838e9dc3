// Paged drafted-window attention (speculative verify) for Hopper (sm_90a),
// with the page walk split across blocks; plain C interface.
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
//   scratch      fp32, P * B * KVH * n_splits * W * G * (hd + 2), from the
//                wrapper (torch.empty); the kernels allocate nothing
//
// Semantics: query w of row b sits at position seq_len + w and sees the
// columns c <= seq_len + w (the committed prefix plus drafts 0..w); an
// inactive row returns exact zeros; scale 1/sqrt(hd); the output is divided
// by max(l, 1e-30). A column a query may not see contributes neither its
// weight nor its value row: the value sum of query w stops at its own last
// column, and slots past the window or in a page id outside the pool are
// zero-filled on the way in, so stale slots (possibly NaN) never enter its
// arithmetic. The TPU kernel zeroes only the weights there, and so lets
// 0 * NaN through. Only live pages, 0 .. (seq_len + W - 1) / ps, are read.
//
// Bound on an H100 SXM: each live K/V row is read once per window, so the
// kernels move P * sum_b(seq_len_b + W) * KVH * hd * 2 * itemsize bytes of
// pages (plus q and out) at 3.35 TB/s; the 4 * P * W * sum_b(seq_len_b + W)
// * H * hd flops are far below the fp32 rate at W <= 8. It is bound by
// bytes; at the serving shape (P=4, 8 rows of ~100 tokens, W=5, qwen
// heads) that is ~10 us, and the work is 512 (kv head, row, particle)
// walks of ~7 pages each, too few and too serial for 132 SMs.
//
// Design (flash-decoding):
// - The split plan comes from the wrapper (kernels/
//   paged_decode_window_attention.py::split_plan, computed from n_pmax,
//   ps and W, never from seq_lens): n_splits, and a floor of pages per
//   split. On the card a row with n_live pages gives each split
//   pps = max(floor, ceil(n_live / n_splits)) pages; split s owns pages
//   [s * pps, min((s + 1) * pps, n_live)), and a split past the row's live
//   pages exits at once. The grid is (kv head, row, particle x split).
// - Inside a split the block walks its pages in stages of about 32
//   columns; K and V rows of the next stage arrive by 16-byte cp.async
//   while the current one is computed (a two-stage ring), and each
//   column's page id is read once per stage into shared memory. A warp
//   takes a query row and a lane a column: the lane computes the column's
//   full hd-length score from q broadcast out of shared memory with
//   16-byte loads, so no score needs a shuffle reduction (K rows are padded
//   4 words past a multiple of 32, so 8 lanes' 16-byte loads of 8 columns
//   hit all 32 banks once); the row's max and sum then take one shuffle
//   reduction each, with no barrier between scores and weights. Each
//   thread keeps its (row, 4 dims) quads of the accumulator in registers
//   and reads V rows as 16-byte loads. Three barriers per stage.
// - A row with one live split writes its output directly. Otherwise each
//   split writes fp32 partials (m, l, acc[W * G, hd]) to the scratch, and a
//   second kernel, window_combine_kernel, launched from the same entry
//   point, merges a row's splits in split order: deterministic, no float
//   atomics. The wrapper counts one launch per call for the pair.
// With W = 1 the function is csrc/paged_decode_attention.cu's; the two sum
// in different orders (splits, stages), so they agree to rounding (1e-6).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  return make_float4(__low2float(a), __high2float(a), __low2float(b), __high2float(b));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__host__ __device__ __forceinline__ int round_up(int x, int m) { return (x + m - 1) / m * m; }

// K/V row stride in elements: 4 words past a multiple of 32 (fp32), the
// same in words for bf16; rows stay 16-byte aligned for cp.async
template <typename T>
__host__ __device__ int kv_stride_smem(int hd) {
  return sizeof(T) == 4 ? round_up(hd, 32) + 4 : round_up(hd, 64) + 8;
}

// pages of row b: live count and this row's pages per split
struct RowPlan {
  int n_live, pps, n_used;
};

__device__ __forceinline__ RowPlan row_plan(int sl, int W, int ps, int n_pmax,
                                            int min_pps, int n_splits) {
  RowPlan rp;
  rp.n_live = (sl + W - 1) / ps + 1;
  if (rp.n_live > n_pmax) rp.n_live = n_pmax;
  rp.pps = (rp.n_live + n_splits - 1) / n_splits;
  if (rp.pps < min_pps) rp.pps = min_pps;
  rp.n_used = (rp.n_live + rp.pps - 1) / rp.pps;
  return rp;
}

template <typename TQ, typename TKV, int NE>
__global__ void __launch_bounds__(kThreads)
window_split_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k_pages,
                    const TKV* __restrict__ v_pages, const int* __restrict__ block_tables,
                    const int* __restrict__ seq_lens, TQ* __restrict__ out,
                    float* __restrict__ scratch, int B, int W, int H, int KVH, int hd,
                    int NP, int ps, int n_pmax, long long kv_p_stride, float scale,
                    int stage_pages, int min_pps, int n_splits, int vec) {
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int p = blockIdx.z / n_splits;
  const int split = blockIdx.z - p * n_splits;
  const int G = H / KVH;
  const int R = W * G;  // query rows of this block, r = w * G + g
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int sl = seq_lens[b];
  const long long row_base = (static_cast<long long>(p) * B + b) * W;
  // element (w, g, d) of this block sits at ((p*B + b)*W + w)*H*hd + (kvh*G + g)*hd + d
  auto q_off = [&](int r, int d) {
    const int w = r / G;
    return ((row_base + w) * H + static_cast<long long>(kvh) * G + (r - w * G)) * hd + d;
  };

  if (sl < 0) {
    if (split == 0)
      for (int i = tid; i < R * hd; i += kThreads) out[q_off(i / hd, i % hd)] = from_f32<TQ>(0.f);
    return;
  }
  const RowPlan rp = row_plan(sl, W, ps, n_pmax, min_pps, n_splits);
  const int pg0 = split * rp.pps;
  if (pg0 >= rp.n_live) return;
  const int pg1 = pg0 + rp.pps < rp.n_live ? pg0 + rp.pps : rp.n_live;
  const int last = sl + W - 1;  // the last column any query of the row sees

  const int SC = stage_pages * ps;  // columns per stage
  const int KS = kv_stride_smem<TKV>(hd);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TKV* k_s = reinterpret_cast<TKV*>(smem_raw);   // 2 stages x SC x KS
  TKV* v_s = k_s + 2 * SC * KS;                  // 2 stages x SC x KS
  float* q_s = reinterpret_cast<float*>(v_s + 2 * SC * KS);  // R x hd, pre-scaled
  float* p_s = q_s + R * hd;                     // R x SC, scores then weights
  float* m_s = p_s + R * SC;                     // R
  float* l_s = m_s + R;                          // R
  float* c_s = l_s + R;                          // R, this stage's rescale factor
  int* pg_s = reinterpret_cast<int*>(c_s + R);   // 2 stages x SC: page of a column, or -1

  const int* bt = block_tables + static_cast<long long>(b) * n_pmax;
  const TKV* kp = k_pages + static_cast<long long>(p) * kv_p_stride;
  const TKV* vp = v_pages + static_cast<long long>(p) * kv_p_stride;
  const long long slot_stride = static_cast<long long>(KVH) * hd;
  const long long page_stride = ps * slot_stride;
  // page of stage column c (or -1: outside the split, the window or the pool)
  auto col_page = [&](int pp, int c) {
    const int pi = pp + c / ps;
    if (pi >= pg1 || pi * ps + c % ps > last) return -1;
    const int page = bt[pi];
    return page >= 0 && page < NP ? page : -1;
  };
  auto load_stage = [&](int st, int pp) {
    TKV* ks = k_s + st * SC * KS;
    TKV* vs = v_s + st * SC * KS;
    for (int c = tid; c < SC; c += kThreads) pg_s[st * SC + c] = col_page(pp, c);
    if (vec) {
      constexpr int kChunk = 16 / sizeof(TKV);
      const int cpr = hd / kChunk;
      for (int i = tid; i < SC * cpr; i += kThreads) {
        const int c = i / cpr;
        const int d = (i - c * cpr) * kChunk;
        const int page = col_page(pp, c);
        const long long off = page < 0 ? 0
            : page * page_stride + (c % ps) * slot_stride + static_cast<long long>(kvh) * hd + d;
        cp_async16(ks + c * KS + d, kp + off, page >= 0);
        cp_async16(vs + c * KS + d, vp + off, page >= 0);
      }
    } else {
      for (int i = tid; i < SC * hd; i += kThreads) {
        const int c = i / hd;
        const int d = i - c * hd;
        const int page = col_page(pp, c);
        TKV kx = from_f32<TKV>(0.f), vx = from_f32<TKV>(0.f);
        if (page >= 0) {
          const long long off = page * page_stride + (c % ps) * slot_stride +
                                static_cast<long long>(kvh) * hd + d;
          kx = kp[off];
          vx = vp[off];
        }
        ks[c * KS + d] = kx;
        vs[c * KS + d] = vx;
      }
    }
    cp_async_commit();
  };

  const int n_st = (pg1 - pg0 + stage_pages - 1) / stage_pages;
  load_stage(0, pg0);
  for (int i = tid; i < R * hd; i += kThreads) q_s[i] = to_f32(q[q_off(i / hd, i % hd)]) * scale;
  for (int r = tid; r < R; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  // accumulator: with hd % 4 == 0 a thread owns (row, 4 dims) quads, else
  // single (row, dim) entries; NE floats either way
  const int vw = (hd & 3) == 0 ? 4 : 1;
  const int units = R * hd / vw;
  float acc[NE];
#pragma unroll
  for (int i = 0; i < NE; ++i) acc[i] = 0.f;

  for (int st = 0; st < n_st; ++st) {
    const int pp = pg0 + st * stage_pages;
    const int col0 = pp * ps;
    if (st + 1 < n_st) {
      load_stage((st + 1) & 1, pp + stage_pages);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const TKV* ks = k_s + (st & 1) * SC * KS;
    const TKV* vs = v_s + (st & 1) * SC * KS;
    const int* pg = pg_s + (st & 1) * SC;
    // a warp per query row; a lane per column computes the full hd-length
    // score, then the row's max and sum by shuffles
    for (int r = warp; r < R; r += kWarps) {
      const int lim = sl + r / G;
      const float* qr = q_s + r * hd;
      float mx = kNegInf;
      for (int c = lane; c < SC; c += 32) {
        const TKV* kr = ks + c * KS;
        float dot = 0.f;
        if (vw == 4) {
          for (int d = 0; d < hd; d += 4) {
            const float4 kk = load4(kr + d);
            const float4 qq = *reinterpret_cast<const float4*>(qr + d);
            dot += qq.x * kk.x;
            dot += qq.y * kk.y;
            dot += qq.z * kk.z;
            dot += qq.w * kk.w;
          }
        } else {
          for (int d = 0; d < hd; ++d) dot += qr[d] * to_f32(kr[d]);
        }
        const float x = pg[c] >= 0 && col0 + c <= lim ? dot : kNegInf;
        p_s[r * SC + c] = x;
        mx = fmaxf(mx, x);
      }
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = lane; c < SC; c += 32) {  // the lane's own scores
        const bool ok = pg[c] >= 0 && col0 + c <= lim;
        const float e = ok ? expf(p_s[r * SC + c] - m_new) : 0.f;
        p_s[r * SC + c] = e;
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
    // acc = acc * corr + p @ v over the columns query w may see
    auto c_end_of = [&](int r) {
      const int c_end = sl + r / G - col0 + 1;
      return c_end < 0 ? 0 : (c_end > SC ? SC : c_end);
    };
    if (vw == 4) {
#pragma unroll
      for (int i = 0; i < NE; i += 4) {
        const int u = tid + (i / 4) * kThreads;
        if (u < units) {
          const int r = (4 * u) / hd;
          const int d = 4 * u - r * hd;
          const int c_end = c_end_of(r);
          const float corr = c_s[r];
          const float* pr = p_s + r * SC;
          float a0 = acc[i] * corr, a1 = acc[i + 1] * corr, a2 = acc[i + 2] * corr,
                a3 = acc[i + 3] * corr;
          for (int c = 0; c < c_end; ++c) {
            const float4 vv = load4(vs + c * KS + d);
            const float w = pr[c];
            a0 += w * vv.x;
            a1 += w * vv.y;
            a2 += w * vv.z;
            a3 += w * vv.w;
          }
          acc[i] = a0;
          acc[i + 1] = a1;
          acc[i + 2] = a2;
          acc[i + 3] = a3;
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < NE; ++i) {
        const int e = tid + i * kThreads;
        if (e < units) {
          const int r = e / hd;
          const int d = e - r * hd;
          const int c_end = c_end_of(r);
          const float* pr = p_s + r * SC;
          float a = acc[i] * c_s[r];
          for (int c = 0; c < c_end; ++c) a += pr[c] * to_f32(vs[c * KS + d]);
          acc[i] = a;
        }
      }
    }
    __syncthreads();  // the stage is free for the stage after next
  }

  // entry x of accumulator slot i: (row, dim) = e / hd, e % hd
  auto entry_of = [&](int i) {
    return vw == 4 ? (tid + (i / 4) * kThreads) * 4 + i % 4 : tid + i * kThreads;
  };
  if (rp.n_used == 1) {
#pragma unroll
    for (int i = 0; i < NE; ++i) {
      const int e = entry_of(i);
      if (e < R * hd)
        out[q_off(e / hd, e % hd)] = from_f32<TQ>(acc[i] / fmaxf(l_s[e / hd], 1e-30f));
    }
    return;
  }
  // partials of this split: (m, l) rows, then acc rows
  const long long unit = ((static_cast<long long>(p) * B + b) * KVH + kvh) * n_splits + split;
  const long long n_units = static_cast<long long>(gridDim.z) * B * KVH;
  float* ml = scratch + unit * R * 2;
  float* pa = scratch + n_units * R * 2 + unit * R * hd;
  for (int r = tid; r < R; r += kThreads) {
    ml[2 * r] = m_s[r];
    ml[2 * r + 1] = l_s[r];
  }
#pragma unroll
  for (int i = 0; i < NE; ++i) {
    const int e = entry_of(i);
    if (e < R * hd) pa[e] = acc[i];
  }
}

// merge the splits of each (kv head, row, particle) in split order
template <typename TQ>
__global__ void __launch_bounds__(kThreads)
window_combine_kernel(const int* __restrict__ seq_lens, const float* __restrict__ scratch,
                      TQ* __restrict__ out, int P, int B, int W, int H, int KVH, int hd,
                      int ps, int n_pmax, int min_pps, int n_splits) {
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int p = blockIdx.z;
  const int sl = seq_lens[b];
  if (sl < 0) return;
  const RowPlan rp = row_plan(sl, W, ps, n_pmax, min_pps, n_splits);
  if (rp.n_used <= 1) return;
  const int G = H / KVH;
  const int R = W * G;
  const long long unit0 = ((static_cast<long long>(p) * B + b) * KVH + kvh) * n_splits;
  const long long units = static_cast<long long>(P) * n_splits * B * KVH;
  const float* ml = scratch + unit0 * R * 2;
  const float* pa = scratch + units * R * 2 + unit0 * R * hd;
  const long long row_base = (static_cast<long long>(p) * B + b) * W;
  for (int e = threadIdx.x; e < R * hd; e += kThreads) {
    const int r = e / hd;
    const int d = e - r * hd;
    float m = kNegInf;
    for (int s = 0; s < rp.n_used; ++s) m = fmaxf(m, ml[s * R * 2 + 2 * r]);
    float l = 0.f, o = 0.f;
    for (int s = 0; s < rp.n_used; ++s) {
      const float f = expf(ml[s * R * 2 + 2 * r] - m);
      l += ml[s * R * 2 + 2 * r + 1] * f;
      o += pa[static_cast<long long>(s) * R * hd + e] * f;
    }
    const int w = r / G;
    out[((row_base + w) * H + static_cast<long long>(kvh) * G + (r - w * G)) * hd + d] =
        from_f32<TQ>(o / fmaxf(l, 1e-30f));
  }
}

template <typename TQ, typename TKV, int NE>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const int* block_tables, const int* seq_lens, void* out, float* scratch,
                   int P, int B, int W, int H, int KVH, int hd, int NP, int ps, int n_pmax,
                   long long kv_p_stride, float scale, int stage_pages, int min_pps,
                   int n_splits, int vec, cudaStream_t stream) {
  const size_t R = static_cast<size_t>(W) * (H / KVH);
  const size_t SC = static_cast<size_t>(stage_pages) * ps;
  const size_t smem = sizeof(TKV) * 4 * SC * kv_stride_smem<TKV>(hd) +
                      sizeof(float) * (R * hd + R * SC + 3 * R) + sizeof(int) * 2 * SC;
  auto kernel = window_split_kernel<TQ, TKV, NE>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(KVH, B, P * n_splits), kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k_pages),
      static_cast<const TKV*>(v_pages), block_tables, seq_lens, static_cast<TQ*>(out),
      scratch, B, W, H, KVH, hd, NP, ps, n_pmax, kv_p_stride, scale, stage_pages, min_pps,
      n_splits, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return err;
  window_combine_kernel<TQ><<<dim3(KVH, B, P), kThreads, 0, stream>>>(
      seq_lens, scratch, static_cast<TQ*>(out), P, B, W, H, KVH, hd, ps, n_pmax, min_pps,
      n_splits);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t dispatch(const void* q, const void* k_pages, const void* v_pages,
                     const int* bt, const int* sl, void* out, float* scratch, int P, int B,
                     int W, int H, int KVH, int hd, int NP, int ps, int n_pmax,
                     long long kv_p_stride, float scale, int stage_pages, int min_pps,
                     int n_splits, int vec, cudaStream_t s) {
  const int entries = W * (H / KVH) * hd;  // accumulator entries of a block
  if (entries <= 4 * kThreads)
    return launch<TQ, TKV, 4>(q, k_pages, v_pages, bt, sl, out, scratch, P, B, W, H, KVH,
                              hd, NP, ps, n_pmax, kv_p_stride, scale, stage_pages, min_pps,
                              n_splits, vec, s);
  if (entries <= 8 * kThreads)
    return launch<TQ, TKV, 8>(q, k_pages, v_pages, bt, sl, out, scratch, P, B, W, H, KVH,
                              hd, NP, ps, n_pmax, kv_p_stride, scale, stage_pages, min_pps,
                              n_splits, vec, s);
  if (entries <= 32 * kThreads)
    return launch<TQ, TKV, 32>(q, k_pages, v_pages, bt, sl, out, scratch, P, B, W, H, KVH,
                               hd, NP, ps, n_pmax, kv_p_stride, scale, stage_pages, min_pps,
                               n_splits, vec, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// Returns the cudaError_t of the launches (0 = success). dtype codes: 0 fp32,
// 1 bf16. The caller checks shapes, dtypes, devices and contiguity, W * G *
// hd <= 4096, and passes the split plan (stage_pages, min_pps, n_splits)
// and the scratch it sized. K/V rows go through 16-byte cp.async when a row
// of hd elements is a whole number of 16-byte chunks and the pages and the
// particle stride are 16-byte aligned; else through plain loads.
extern "C" int paged_decode_window_attention(
    const void* q, const void* k_pages, const void* v_pages, const void* block_tables,
    const void* seq_lens, void* out, void* scratch, int P, int B, int W, int H, int KVH,
    int hd, int NP, int ps, int n_pmax, long long kv_p_stride, int q_dtype, int kv_dtype,
    float scale, int stage_pages, int min_pps, int n_splits, void* stream) {
  const int* bt = static_cast<const int*>(block_tables);
  const int* sl = static_cast<const int*>(seq_lens);
  float* sc = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (KVH <= 0 || H % KVH != 0 || stage_pages < 1 || min_pps < 1 || n_splits < 1 ||
      P * n_splits > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long item = kv_dtype == kBF16 ? 2 : 4;
  const int vec = (hd * item) % 16 == 0 && (kv_p_stride * item) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(k_pages) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(v_pages) % 16 == 0;
  if (q_dtype == kF32 && kv_dtype == kF32)
    return dispatch<float, float>(q, k_pages, v_pages, bt, sl, out, sc, P, B, W, H, KVH, hd,
                                  NP, ps, n_pmax, kv_p_stride, scale, stage_pages, min_pps,
                                  n_splits, vec, s);
  if (q_dtype == kF32 && kv_dtype == kBF16)
    return dispatch<float, __nv_bfloat16>(q, k_pages, v_pages, bt, sl, out, sc, P, B, W, H,
                                          KVH, hd, NP, ps, n_pmax, kv_p_stride, scale,
                                          stage_pages, min_pps, n_splits, vec, s);
  if (q_dtype == kBF16 && kv_dtype == kF32)
    return dispatch<__nv_bfloat16, float>(q, k_pages, v_pages, bt, sl, out, sc, P, B, W, H,
                                          KVH, hd, NP, ps, n_pmax, kv_p_stride, scale,
                                          stage_pages, min_pps, n_splits, vec, s);
  if (q_dtype == kBF16 && kv_dtype == kBF16)
    return dispatch<__nv_bfloat16, __nv_bfloat16>(q, k_pages, v_pages, bt, sl, out, sc, P,
                                                  B, W, H, KVH, hd, NP, ps, n_pmax,
                                                  kv_p_stride, scale, stage_pages, min_pps,
                                                  n_splits, vec, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
