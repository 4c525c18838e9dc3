// The split KV walk of the decode-attention kernels for Hopper (sm_90a):
// device code shared by csrc/paged_decode_attention.cu (one query token a
// row; also the speculative draft), csrc/paged_decode_window_attention.cu
// (W drafted tokens a row: the speculative verify) and
// csrc/decode_attention.cu (one token over a dense cache). The three
// differ only in how a column's address is found (a block table, or a
// contiguous row with k_pos), in which columns a query may see, and in W.
//
// A row of keys is n_pmax units of ps columns: pages, or for a dense cache
// single slots (ps = 1, n_pmax = C). Row b's query w sits at position
// seq_len(b) + w and sees the columns c <= seq_len(b) + w whose slot is
// valid; a row with seq_len < 0 is inactive and returns exact zeros. The
// scale is 1/sqrt(hd) and the output is divided by max(l, 1e-30), so a
// row with no valid column returns zeros. A column a query may not see
// adds neither its weight nor its value row; invalid slots (past the
// window, a page id outside the pool, k_pos < 0, past C) are zero-filled
// on the way in, so a stale slot (possibly NaN) never enters the
// arithmetic.
//
// Bound on an H100 SXM: every live K/V row is read once, P * sum_b(live_b)
// * KVH * hd * 2 * itemsize bytes at 3.35 TB/s; the 4 * P * W *
// sum_b(live_b) * H * hd flops are far below the fp32 rate at W <= 8. It
// is bound by bytes, and at decode shapes by latency: a few pages a row,
// too few and too serial for 132 SMs if one block walked a whole row.
//
// Design (flash-decoding):
// - The split plan comes from the wrapper (kernels/split_walk.py::
//   split_plan, from n_pmax, ps, W and the grid's size, never from
//   seq_lens or k_pos, which would cost a device sync a call): units per
//   stage, a floor of units per split, and n_splits, which is 1 when the
//   unsplit grid has a block per SM or more (then the splits and their
//   merge cost more than they win). A row with n_live units gives each split
//   max(floor, ceil(n_live / n_splits)) of them; split s owns units
//   [s * per_split, min((s + 1) * per_split, n_live)), and a split past
//   the row's live units exits at once. The grid is (kv head group, row,
//   particle x split); a block takes `heads` kv heads of one (row,
//   particle, split) (kernels/split_walk.py::heads_per_block: at one
//   query row per kv head, two with fp32 K/V and four with bf16, which
//   beat one on the card), and a stage reads each slot's heads as one
//   contiguous run. A kv head whose W * G query rows' accumulators do not
//   fit a block (more than 4096 entries: qwen3-moe's verify window, W 5 x
//   G 16 x hd 128) has its rows split over row_blocks blocks of one kv
//   head (kernels/split_walk.py::block_rows); each walks the same columns
//   for its own rows, and writes its rows' outputs or partials.
// - Inside a split the block walks its units in stages of about 32
//   columns. K and V rows of the next stage arrive by 16-byte cp.async
//   while the current one is computed (a two-stage ring). A few threads
//   share a column: they find its slot once a stage (one block-table or
//   k_pos read) and split its copies; a stage with no valid column is
//   skipped. Each thread's accumulator rows, visible ends and offsets are
//   found once, before the walk: the stages do no integer division.
//   A warp takes a query row and a lane a column: the lane computes the
//   column's full hd-length score from q broadcast out of shared memory
//   with 16-byte loads, so no score needs a shuffle reduction (K rows are
//   padded 4 words past a multiple of 32, so 8 lanes' 16-byte loads of 8
//   columns hit all 32 banks once); the row's max and sum then take one
//   shuffle reduction each. Each thread keeps its (row, 4 dims) quads of
//   the accumulator in registers and reads V rows as 16-byte loads. Three
//   barriers per stage.
// - A row with one live split writes its output directly. Otherwise each
//   split writes fp32 partials (m, l, acc) to the wrapper's scratch and
//   combine_kernel, launched right after by the same entry point, merges a
//   row's splits in split order: deterministic, no float atomics. The
//   wrapper counts the pair as one launch.
// Every query row's arithmetic (its columns, stages, score order, the
// lanes of its reductions, its accumulator order and its merge) depends
// only on the plan, the row and the column rule, never on W, on the other
// rows or on `heads`. So the window kernel at W = 1 returns exactly what
// the single-token kernel returns.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace split_walk {
namespace {  // internal linkage: each kernel library has its own copy

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src, or 16 zero bytes (src not read) when !ok
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

// K/V row stride in shared memory, in elements: 4 words past a multiple of
// 32 (fp32), the same in words for bf16; rows stay 16-byte aligned
template <typename T>
__host__ __device__ int kv_stride_smem(int hd) {
  return sizeof(T) == 4 ? round_up(hd, 32) + 4 : round_up(hd, 64) + 8;
}

// The walk's shape and plan (all from the host).
struct Walk {
  int P, B, W, H, KVH, hd;
  int heads;              // kv heads per block; divides KVH
  int row_blocks;         // blocks a kv head group's query rows split over
  int ps, n_pmax;         // a row is n_pmax units of ps columns
  long long kv_p_stride;  // elements from one particle's K/V to the next
  float scale;
  int stage_units, min_units, n_splits;
  int vec;                // K/V rows go by 16-byte cp.async (set by run)
};

// The block-table column rule: column c of row b is slot c % ps of page
// block_tables[b, c / ps]; a page id outside the pool is never read.
struct PagedCols {
  const int* block_tables;  // (B, n_pmax)
  const int* seq_lens;      // (B,): position of query 0, -1 inactive
  int NP, ps, n_pmax;
  long long slot_stride;    // KVH * hd

  __device__ __forceinline__ int seq_len(int b) const { return seq_lens[b]; }
  // element offset of the column's slot (kv head 0) past the particle's
  // base, or -1 if the slot may not be read
  __device__ __forceinline__ long long offset(int b, int c) const {
    const int page = block_tables[static_cast<long long>(b) * n_pmax + c / ps];
    if (page < 0 || page >= NP) return -1;
    return (static_cast<long long>(page) * ps + c % ps) * slot_stride;
  }
};

struct RowPlan {
  int n_live, per_split, n_used;
};

__device__ __forceinline__ RowPlan row_plan(int sl, const Walk& wk) {
  RowPlan rp;
  rp.n_live = (sl + wk.W - 1) / wk.ps + 1;
  if (rp.n_live > wk.n_pmax) rp.n_live = wk.n_pmax;
  rp.per_split = (rp.n_live + wk.n_splits - 1) / wk.n_splits;
  if (rp.per_split < wk.min_units) rp.per_split = wk.min_units;
  rp.n_used = (rp.n_live + rp.per_split - 1) / rp.per_split;
  return rp;
}

template <typename TQ, typename TKV, int NE, class Cols>
__global__ void __launch_bounds__(kThreads)
split_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k, const TKV* __restrict__ v,
             TQ* __restrict__ out, float* __restrict__ scratch, const Walk wk,
             const Cols cols) {
  const int kvh0 = static_cast<int>(blockIdx.x) / wk.row_blocks * wk.heads;
  const int b = blockIdx.y;
  const int p = blockIdx.z / wk.n_splits;
  const int split = blockIdx.z - p * wk.n_splits;
  const int W = wk.W, H = wk.H, hd = wk.hd, ps = wk.ps;
  const int G = H / wk.KVH;
  const int R1 = W * G;          // query rows of a kv head, w * G + g
  // the group's query rows h * R1 + w * G + g, split over row_blocks
  // blocks: this block takes R of them from row0 on; r below is a row of
  // the block, r + row0 its row in the group
  const int RB = (wk.heads * R1 + wk.row_blocks - 1) / wk.row_blocks;
  const int row0 = static_cast<int>(blockIdx.x) % wk.row_blocks * RB;
  const int R = RB < wk.heads * R1 - row0 ? RB : wk.heads * R1 - row0;
  if (R <= 0) return;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long row_base = (static_cast<long long>(p) * wk.B + b) * W;
  auto q_off = [&](int r, int d) {
    const int rr = r + row0;
    const int h = rr / R1;
    const int w = (rr - h * R1) / G;
    const int g = rr - h * R1 - w * G;
    return ((row_base + w) * H + static_cast<long long>(kvh0 + h) * G + g) * hd + d;
  };

  const int sl = cols.seq_len(b);
  if (sl < 0) {
    if (split == 0)
      for (int i = tid; i < R * hd; i += kThreads) out[q_off(i / hd, i % hd)] = from_f32<TQ>(0.f);
    return;
  }
  const RowPlan rp = row_plan(sl, wk);
  const int pg0 = split * rp.per_split;
  if (pg0 >= rp.n_live) return;
  const int pg1 = pg0 + rp.per_split < rp.n_live ? pg0 + rp.per_split : rp.n_live;
  // this split's columns: [pg0 * ps, col_end), none past the last query's
  const int col_end = pg1 * ps < sl + W ? pg1 * ps : sl + W;

  const int SC = wk.stage_units * ps;  // columns per stage
  const int KS = kv_stride_smem<TKV>(hd);
  const int HS = SC * KS;              // one kv head's K (or V) rows of a stage
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TKV* k_s = reinterpret_cast<TKV*>(smem_raw);         // 2 stages x heads x SC x KS
  TKV* v_s = k_s + 2 * wk.heads * HS;                  // 2 stages x heads x SC x KS
  float* q_s = reinterpret_cast<float*>(v_s + 2 * wk.heads * HS);  // R x hd, pre-scaled
  float* p_s = q_s + R * hd;                           // R x SC, scores then weights
  float* m_s = p_s + R * SC;                           // R
  float* l_s = m_s + R;                                // R
  float* c_s = l_s + R;                                // R, this stage's rescale factor
  int* ok_s = reinterpret_cast<int*>(c_s + R);         // 2 stages x SC: column valid

  const TKV* kp = k + static_cast<long long>(p) * wk.kv_p_stride + static_cast<long long>(kvh0) * hd;
  const TKV* vp = v + static_cast<long long>(p) * wk.kv_p_stride + static_cast<long long>(kvh0) * hd;
  auto col_offset = [&](int col) { return col < col_end ? cols.offset(b, col) : -1LL; };
  // tpc threads share a column: each finds the column's slot once a stage
  // and copies its share of the column's heads, with no division per copy
  const int tpc = SC >= kThreads ? 1 : kThreads / SC;
  const int c_first = tid / tpc;
  const int j0 = tid - c_first * tpc;
  // issues stage st's copies; returns whether any of this thread's columns
  // is valid (the thread with j0 == 0 records each column's flag)
  auto load_stage = [&](int st, int col0) {
    TKV* ks = k_s + st * wk.heads * HS;
    TKV* vs = v_s + st * wk.heads * HS;
    int any = 0;
    for (int c = c_first; c < SC; c += kThreads / tpc) {
      const long long off = col_offset(col0 + c);
      any |= off >= 0;
      if (j0 == 0) ok_s[st * SC + c] = off >= 0;
      const TKV* kc = kp + (off < 0 ? 0 : off);
      const TKV* vc = vp + (off < 0 ? 0 : off);
      for (int h = 0; h < wk.heads; ++h) {
        TKV* kd = ks + h * HS + c * KS;
        TKV* vd = vs + h * HS + c * KS;
        if (wk.vec) {
          constexpr int kChunk = 16 / sizeof(TKV);
          for (int d = j0 * kChunk; d < hd; d += tpc * kChunk) {
            cp_async16(kd + d, kc + h * hd + d, off >= 0);
            cp_async16(vd + d, vc + h * hd + d, off >= 0);
          }
        } else {
          for (int d = j0; d < hd; d += tpc) {
            kd[d] = off < 0 ? from_f32<TKV>(0.f) : kc[h * hd + d];
            vd[d] = off < 0 ? from_f32<TKV>(0.f) : vc[h * hd + d];
          }
        }
      }
    }
    cp_async_commit();
    return any;
  };

  const int n_st = (pg1 - pg0 + wk.stage_units - 1) / wk.stage_units;
  int any_next = load_stage(0, pg0 * ps);
  // accumulator: with hd % 4 == 0 a thread owns (row, 4 dims) quads, quad
  // j being unit tid + j * kThreads, else single (row, dim) entries; NE
  // floats either way. A quad's row, last visible column, V offset and q /
  // out offset are found once here, not in every stage (integer division
  // is slow); the quads also load q.
  constexpr int NQ = NE / 4;
  const int vw = (hd & 3) == 0 ? 4 : 1;
  const int units = R * hd / vw;
  int quad_row[NQ], quad_lim[NQ], quad_v[NQ];
  long long quad_q[NQ];
#pragma unroll
  for (int j = 0; j < NQ; ++j) {
    const int u = tid + j * kThreads;
    const int r = vw == 4 && u < units ? 4 * u / hd : 0;
    const int h = (r + row0) / R1;
    const int d = 4 * u - r * hd;
    quad_row[j] = r;
    quad_lim[j] = sl + (r + row0 - h * R1) / G;
    quad_v[j] = h * HS + d;
    quad_q[j] = q_off(r, d);
    if (vw == 4 && u < units)
      for (int x = 0; x < 4; ++x) q_s[r * hd + d + x] = to_f32(q[quad_q[j] + x]) * wk.scale;
  }
  if (vw != 4)
    for (int i = tid; i < R * hd; i += kThreads) q_s[i] = to_f32(q[q_off(i / hd, i % hd)]) * wk.scale;
  for (int r = tid; r < R; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  float acc[NE];
#pragma unroll
  for (int i = 0; i < NE; ++i) acc[i] = 0.f;

  for (int st = 0; st < n_st; ++st) {
    const int col0 = (pg0 + st * wk.stage_units) * ps;
    const int any = any_next;
    if (st + 1 < n_st) {
      any_next = load_stage((st + 1) & 1, col0 + SC);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    const int* ok = ok_s + (st & 1) * SC;
    if (__syncthreads_or(any)) {
      const TKV* ks = k_s + (st & 1) * wk.heads * HS;
      const TKV* vs = v_s + (st & 1) * wk.heads * HS;
      // a warp per query row; a lane per column computes the full
      // hd-length score, then the row's max and sum by shuffles
      for (int r = warp; r < R; r += kWarps) {
        const int h = (r + row0) / R1;
        const int lim = sl + (r + row0 - h * R1) / G;  // the row's last visible column
        const float* qr = q_s + r * hd;
        const TKV* kh = ks + h * HS;
        float mx = kNegInf;
        for (int c = lane; c < SC; c += 32) {
          const TKV* kr = kh + c * KS;
          float dot = 0.f;
          if (vw == 4) {
#pragma unroll 4
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
          const float x = ok[c] && col0 + c <= lim ? dot : kNegInf;
          p_s[r * SC + c] = x;
          mx = fmaxf(mx, x);
        }
        mx = warp_max(mx);
        const float m_prev = m_s[r];
        const float m_new = fmaxf(m_prev, mx);
        float sum = 0.f;
        for (int c = lane; c < SC; c += 32) {  // the lane's own scores
          const float e = ok[c] && col0 + c <= lim ? expf(p_s[r * SC + c] - m_new) : 0.f;
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
      // acc = acc * corr + p @ v over the columns the row may see
      auto clamp_end = [&](int lim) {
        const int c_end = lim - col0 + 1;
        return c_end < 0 ? 0 : (c_end > SC ? SC : c_end);
      };
      if (vw == 4) {
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
          if (tid + j * kThreads < units) {
            const int i = 4 * j;
            const int c_end = clamp_end(quad_lim[j]);
            const float corr = c_s[quad_row[j]];
            const float* pr = p_s + quad_row[j] * SC;
            const TKV* vh = vs + quad_v[j];
            float a0 = acc[i] * corr, a1 = acc[i + 1] * corr, a2 = acc[i + 2] * corr,
                  a3 = acc[i + 3] * corr;
#pragma unroll 4
            for (int c = 0; c < c_end; ++c) {
              const float4 vv = load4(vh + c * KS);
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
            const int c_end = clamp_end(sl + ((r + row0) % R1) / G);
            const float* pr = p_s + r * SC;
            const TKV* vh = vs + ((r + row0) / R1) * HS + d;
            float a = acc[i] * c_s[r];
            for (int c = 0; c < c_end; ++c) a += pr[c] * to_f32(vh[c * KS]);
            acc[i] = a;
          }
        }
      }
    }
    __syncthreads();  // the stage is free for the stage after next
  }

  // the output, or this split's partials per kv head: (m, l) rows, then
  // acc rows; a run of vw accumulator entries is one (row, dims d..) run
  const int one = rp.n_used == 1;
  const long long n_units = static_cast<long long>(gridDim.z) * wk.B * wk.KVH;
  const long long unit0 =
      ((static_cast<long long>(p) * wk.B + b) * wk.KVH + kvh0) * wk.n_splits + split;
  if (!one) {
    for (int r = tid; r < R; r += kThreads) {
      const int h = (r + row0) / R1;
      float* ml = scratch + (unit0 + static_cast<long long>(h) * wk.n_splits) * R1 * 2 +
                  2 * (r + row0 - h * R1);
      ml[0] = m_s[r];
      ml[1] = l_s[r];
    }
  }
  // entries (r, d .. d + n - 1) of the accumulator, n = 1 or 4, whose
  // element (r, d) lies at qo in q and out
  auto put = [&](int r, int d, long long qo, int n, float a0, float a1, float a2, float a3) {
    const int h = (r + row0) / R1;
    if (one) {
      const float l = fmaxf(l_s[r], 1e-30f);
      TQ* o = out + qo;
      o[0] = from_f32<TQ>(a0 / l);
      if (n == 4) {
        o[1] = from_f32<TQ>(a1 / l);
        o[2] = from_f32<TQ>(a2 / l);
        o[3] = from_f32<TQ>(a3 / l);
      }
    } else {
      float* pa = scratch + n_units * R1 * 2 +
                  (unit0 + static_cast<long long>(h) * wk.n_splits) * R1 * hd +
                  (r + row0 - h * R1) * hd + d;
      pa[0] = a0;
      if (n == 4) {
        pa[1] = a1;
        pa[2] = a2;
        pa[3] = a3;
      }
    }
  };
  if (vw == 4) {
#pragma unroll
    for (int j = 0; j < NQ; ++j)
      if (tid + j * kThreads < units)
        put(quad_row[j], 4 * (tid + j * kThreads) - quad_row[j] * hd, quad_q[j], 4,
            acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < NE; ++i) {
      const int e = tid + i * kThreads;
      if (e < units) put(e / hd, e % hd, q_off(e / hd, e % hd), 1, acc[i], 0.f, 0.f, 0.f);
    }
  }
}

// merge the splits of each (kv head, row, particle) in split order
template <typename TQ, class Cols>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const float* __restrict__ scratch, TQ* __restrict__ out, const Walk wk,
               const Cols cols) {
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int p = blockIdx.z;
  const int sl = cols.seq_len(b);
  if (sl < 0) return;
  const RowPlan rp = row_plan(sl, wk);
  if (rp.n_used <= 1) return;
  const int hd = wk.hd;
  const int G = wk.H / wk.KVH;
  const int R1 = wk.W * G;
  const long long unit0 = ((static_cast<long long>(p) * wk.B + b) * wk.KVH + kvh) * wk.n_splits;
  const long long n_units = static_cast<long long>(wk.P) * wk.n_splits * wk.B * wk.KVH;
  const float* ml = scratch + unit0 * R1 * 2;
  const float* pa = scratch + n_units * R1 * 2 + unit0 * R1 * hd;
  const long long row_base = (static_cast<long long>(p) * wk.B + b) * wk.W;
  for (int e = threadIdx.x; e < R1 * hd; e += kThreads) {
    const int r = e / hd;
    const int d = e - r * hd;
    float m = kNegInf;
    for (int s = 0; s < rp.n_used; ++s) m = fmaxf(m, ml[s * R1 * 2 + 2 * r]);
    float l = 0.f, o = 0.f;
    for (int s = 0; s < rp.n_used; ++s) {
      const float f = expf(ml[s * R1 * 2 + 2 * r] - m);
      l += ml[s * R1 * 2 + 2 * r + 1] * f;
      o += pa[static_cast<long long>(s) * R1 * hd + e] * f;
    }
    const int w = r / G;
    out[((row_base + w) * wk.H + static_cast<long long>(kvh) * G + (r - w * G)) * hd + d] =
        from_f32<TQ>(o / fmaxf(l, 1e-30f));
  }
}

template <typename TQ, typename TKV, int NE, class Cols>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* scratch,
                   const Walk& wk, const Cols& cols, cudaStream_t stream) {
  // rows of a block
  const size_t R = (static_cast<size_t>(wk.heads) * wk.W * (wk.H / wk.KVH) + wk.row_blocks - 1) /
                   wk.row_blocks;
  const size_t SC = static_cast<size_t>(wk.stage_units) * wk.ps;
  const size_t smem = sizeof(TKV) * 4 * wk.heads * SC * kv_stride_smem<TKV>(wk.hd) +
                      sizeof(float) * (R * wk.hd + R * SC + 3 * R) + sizeof(int) * 2 * SC;
  auto kernel = split_kernel<TQ, TKV, NE, Cols>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(wk.KVH / wk.heads * wk.row_blocks, wk.B, wk.P * wk.n_splits), kThreads, smem,
           stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v),
      static_cast<TQ*>(out), scratch, wk, cols);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || wk.n_splits == 1) return err;
  combine_kernel<TQ, Cols><<<dim3(wk.KVH, wk.B, wk.P), kThreads, 0, stream>>>(
      scratch, static_cast<TQ*>(out), wk, cols);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, class Cols>
cudaError_t dispatch_ne(const void* q, const void* k, const void* v, void* out, float* scratch,
                        const Walk& wk, const Cols& cols, cudaStream_t s) {
  // accumulator entries of a block: its rows x hd
  const int rows = (wk.heads * wk.W * (wk.H / wk.KVH) + wk.row_blocks - 1) / wk.row_blocks;
  const int entries = rows * wk.hd;
  if (entries <= 4 * kThreads) return launch<TQ, TKV, 4>(q, k, v, out, scratch, wk, cols, s);
  if (entries <= 8 * kThreads) return launch<TQ, TKV, 8>(q, k, v, out, scratch, wk, cols, s);
  if (entries <= 32 * kThreads) return launch<TQ, TKV, 32>(q, k, v, out, scratch, wk, cols, s);
  return cudaErrorInvalidValue;
}

// Checks the plan, picks the K/V load path and the dtypes' instance, and
// launches; returns the cudaError_t of the launches (0 = success). K/V
// rows go through 16-byte cp.async when a kv head's row of hd elements is
// a whole number of 16-byte chunks and the K/V base and the particle
// stride are 16-byte aligned; else through plain loads.
template <class Cols>
int run(const void* q, const void* k, const void* v, void* out, void* scratch, Walk wk,
        const Cols& cols, int q_dtype, int kv_dtype, cudaStream_t s) {
  if (wk.KVH <= 0 || wk.H % wk.KVH != 0 || wk.heads < 1 || wk.KVH % wk.heads != 0 ||
      wk.row_blocks < 1 || (wk.row_blocks > 1 && wk.heads != 1) ||
      wk.W < 1 || wk.ps < 1 || wk.stage_units < 1 || wk.min_units < 1 || wk.n_splits < 1 ||
      static_cast<long long>(wk.P) * wk.n_splits > 65535 || wk.B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long item = kv_dtype == kBF16 ? 2 : 4;
  wk.vec = (wk.hd * item) % 16 == 0 && (wk.kv_p_stride * item) % 16 == 0 &&
           reinterpret_cast<uintptr_t>(k) % 16 == 0 && reinterpret_cast<uintptr_t>(v) % 16 == 0;
  float* sc = static_cast<float*>(scratch);
  if (q_dtype == kF32 && kv_dtype == kF32)
    return dispatch_ne<float, float>(q, k, v, out, sc, wk, cols, s);
  if (q_dtype == kF32 && kv_dtype == kBF16)
    return dispatch_ne<float, __nv_bfloat16>(q, k, v, out, sc, wk, cols, s);
  if (q_dtype == kBF16 && kv_dtype == kF32)
    return dispatch_ne<__nv_bfloat16, float>(q, k, v, out, sc, wk, cols, s);
  if (q_dtype == kBF16 && kv_dtype == kBF16)
    return dispatch_ne<__nv_bfloat16, __nv_bfloat16>(q, k, v, out, sc, wk, cols, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace split_walk
