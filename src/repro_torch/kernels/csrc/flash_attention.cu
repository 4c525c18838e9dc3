// Blocked online-softmax attention forward (prefill) for Hopper (sm_90a) on
// the tensor cores, plain C interface.
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
// bidirectional; the prefix-LM mask of the reference's jnp attention
// (causal with prefix > 0: key j visible to query i iff j <= i or
// j < prefix, paligemma's bidirectional image prefix); keys past S are
// masked by a bounds check instead of the reference's padding copies; the online softmax keeps m, l in fp32 with
// the -1e30 convention, and a masked score contributes an exact 0 weight,
// so a tile a row cannot see leaves m, l and the accumulator unchanged;
// scale 1/sqrt(hd) (applied to the fp32 scores); the output is divided by
// max(l, 1e-30).
//
// Bounds on an H100 SXM. Bytes: q, k and v read once and out written once,
// (2 H + 2 KVH) * N * S * hd * itemsize at 3.35 TB/s. Operations:
// 4 * N * H * hd * S^2 flops (halved, S (S + 1) / 2 pairs, when causal);
// at the 67 TFLOP/s fp32 rate of the CUDA cores that is 2.05 ms for P=4 x
// 4096 tokens of qwen1.5-0.5b (H = KVH = 16, hd 64). This kernel runs its
// products on the tensor cores instead, as three TF32 products per fp32
// product (below) at 495 TFLOP/s: 3 * 137.5 GFLOP = ~0.83 ms at 4096
// tokens, which is the bound the design aims at. A 128-token prompt is
// bound by bytes (~2.5 us) and in practice by latency.
//
// Design (FlashAttention-2 on mma.sync):
// - One block per (q tile, kv head, batch), NW warps; each warp owns 16
//   consecutive rows of the flattened (position, head-in-group) row list
//   r = t * G + g of its kv head, so K and V are read once per tile for all
//   G heads and any G fits. Scores and the output accumulator stay in
//   registers as mma fragments; m and l per row too (each lane keeps a
//   partial l over its own columns, summed over the row's 4 lanes at the
//   end). Scores are taken in log2 units, so each weight is one exp2, and
//   a tile wholly inside S and a warp's causal limit skips the mask.
// - fp32: 3xTF32. Each fp32 operand x splits into big = tf32(x) and
//   small = tf32(x - big), where tf32 rounds to nearest with ties away from
//   zero (the bits of cvt.rna.tf32.f32, done as an integer add and mask,
//   which run at full rate where the conversion does not); a product is
//   small*big + big*small + big*big, accumulated in fp32 by
//   mma.sync.m16n8k8 (the small*small term, ~2^-22 relative, is dropped).
//   One TF32 product alone keeps ~3 decimal digits and would miss the
//   reference's 2e-5. bf16: one mma.sync.m16n8k16 bf16 product with fp32
//   accumulators, P rounded to bf16 (held at 2e-2).
// - P reaches the p @ v product without a shuffle or a shared-memory
//   round trip: the TF32 accumulator layout (lane (g, t) holds columns
//   2t, 2t+1 of rows g, g+8) is not the A-operand layout (columns t, t+4),
//   so the p @ v k-index is permuted instead: k-column t stands for key 2t
//   and k-column t + 4 for key 2t + 1, and V's B fragment reads the same
//   key rows. The q k^T k-index is permuted the same way (d 2t, 2t+1), so
//   each Q and K fragment is one 8-byte shared-memory load. bf16's m16n8k16
//   accumulator pairs already are its A-operand pairs.
// - K/V tiles of BN keys stream through a two-stage shared-memory ring
//   filled by 16-byte cp.async (zero-filled past S; the block's queries
//   ride in the first tile's group), so tile k+1 loads
//   while tile k is computed: two barriers per tile. Row strides are padded
//   so every fragment load is free of bank conflicts (fp32 K and Q rows
//   8 words past a multiple of 32, V rows 4 past a multiple of 32). An hd
//   that is not a multiple of 16 bytes takes synchronous loads instead.
// - mma.sync is issued in groups of four independent accumulators, one
//   product kind at a time, so four chains are in flight per warp instead
//   of one dependent chain of three.
// - Long prompts: 8 warps (128 rows) share each 64-key K/V tile; at
//   hd <= 64 the kernel is held to 128 registers a thread so that two
//   blocks (16 warps) fit an SM. Short prompts: when 128-row tiles would
//   give fewer than two blocks per SM, the kernel runs 32-row tiles of two
//   warps with 32-key tiles (the 128-token bucket at P=4: 256 blocks
//   instead of 64). Causal: the heaviest (last) q tiles are scheduled
//   first, each warp skips the key tiles above its own rows, and no block
//   visits a tile above its last row. A prefix opens the tiles below it to
//   every row: a block visits at least the prefix's tiles, no warp skips
//   a tile that starts inside the prefix, and a tile wholly inside the
//   prefix needs no mask.
// - Wide heads (128 < hd <= 256: gemma3's 256): the 128-row, 64-key
//   tiles would need 403 KB of fp32 shared memory, past Hopper's 227 KB a
//   block, so these take 64-row tiles of four warps with 32-key tiles
//   (202 KB fp32, 101 KB bf16), or 32-row tiles of two warps when 64-row
//   tiles give fewer than two blocks per SM; each warp keeps 32 dim tiles
//   of the output (128 fp32 registers of accumulator).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

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

// round to TF32, to nearest with ties away from zero: the bits of
// cvt.rna.tf32.f32 for finite x, in two full-rate integer ops
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small, both TF32
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d[j] += a * b[j] for kGroup accumulators with a = ah + al, b = bh + bl
// (three TF32 products each). The products are issued one kind at a time
// across the group, so kGroup independent mma chains are in flight; each
// accumulator still adds small*big, big*small, big*big in that order.
constexpr int kGroup = 4;

__device__ __forceinline__ void mma_3xtf32(float (*d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (&bh)[kGroup][2],
                                           const uint32_t (&bl)[kGroup][2]) {
#pragma unroll
  for (int j = 0; j < kGroup; ++j) mma_tf32(d[j], al, bh[j][0], bh[j][1]);
#pragma unroll
  for (int j = 0; j < kGroup; ++j) mma_tf32(d[j], ah, bl[j][0], bl[j][1]);
#pragma unroll
  for (int j = 0; j < kGroup; ++j) mma_tf32(d[j], ah, bh[j][0], bh[j][1]);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}


template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__host__ __device__ __forceinline__ int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Row strides in elements (see the design note), and the padded hd that the
// q k^T k-steps (8 fp32, 16 bf16) and the p @ v n-tiles (8) read.
template <typename T> struct Layout;
template <> struct Layout<float> {
  static constexpr int kStep = 8;
  __host__ __device__ static int ks(int hd) { return round_up(hd, 32) + 8; }
  // 4 past a multiple of 16, and whole groups of four 8-wide dim tiles
  __host__ __device__ static int vs(int hd) { return round_up(hd, 32) + 4; }
};
template <> struct Layout<__nv_bfloat16> {
  static constexpr int kStep = 16;
  __host__ __device__ static int ks(int hd) { return round_up(hd, 64) + 8; }
  __host__ __device__ static int vs(int hd) { return round_up(hd, 64) + 8; }
};

template <typename T, int NW, int BN>
__host__ __device__ size_t smem_elems(int hd) {
  return static_cast<size_t>(16 * NW + 2 * BN) * Layout<T>::ks(hd) +
         static_cast<size_t>(2 * BN) * Layout<T>::vs(hd);
}

// s[j] (keys 8j..8j+7 of the tile) += q_rows . k^T over hd
template <int NT>
__device__ __forceinline__ void scores(float (&s)[NT][4], const float* q_w,
                                       const float* k_t, int KS, int hdk, int g, int t) {
  static_assert(NT % kGroup == 0, "key tiles come in groups");
  for (int kk = 0; kk < hdk; kk += 8) {
    const float2 qa = *reinterpret_cast<const float2*>(q_w + g * KS + kk + 2 * t);
    const float2 qb = *reinterpret_cast<const float2*>(q_w + (g + 8) * KS + kk + 2 * t);
    uint32_t ah[4], al[4];
    split(qa.x, ah[0], al[0]);
    split(qb.x, ah[1], al[1]);
    split(qa.y, ah[2], al[2]);
    split(qb.y, ah[3], al[3]);
#pragma unroll
    for (int j0 = 0; j0 < NT; j0 += kGroup) {
      uint32_t bh[kGroup][2], bl[kGroup][2];
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        const float2 kf =
            *reinterpret_cast<const float2*>(k_t + (8 * (j0 + j) + g) * KS + kk + 2 * t);
        split(kf.x, bh[j][0], bl[j][0]);
        split(kf.y, bh[j][1], bl[j][1]);
      }
      mma_3xtf32(s + j0, ah, al, bh, bl);
    }
  }
}

template <int NT>
__device__ __forceinline__ void scores(float (&s)[NT][4], const __nv_bfloat16* q_w,
                                       const __nv_bfloat16* k_t, int KS, int hdk, int g,
                                       int t) {
  for (int kk = 0; kk < hdk; kk += 16) {
    uint32_t a[4];
    a[0] = *reinterpret_cast<const uint32_t*>(q_w + g * KS + kk + 2 * t);
    a[1] = *reinterpret_cast<const uint32_t*>(q_w + (g + 8) * KS + kk + 2 * t);
    a[2] = *reinterpret_cast<const uint32_t*>(q_w + g * KS + kk + 2 * t + 8);
    a[3] = *reinterpret_cast<const uint32_t*>(q_w + (g + 8) * KS + kk + 2 * t + 8);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const __nv_bfloat16* kr = k_t + (8 * j + g) * KS + kk + 2 * t;
      mma_bf16(s[j], a, *reinterpret_cast<const uint32_t*>(kr),
               *reinterpret_cast<const uint32_t*>(kr + 8));
    }
  }
}

// o[jo] (dims 8jo..8jo+7) += p . v over the tile's keys
template <int NT, int NO>
__device__ __forceinline__ void pv(float (&o)[NO][4], const float (&p)[NT][4],
                                   const float* v_t, int VS, int n_dt, int g, int t) {
#pragma unroll
  for (int m = 0; m < NT; ++m) {
    // k-column t is key 8m + 2t, k-column t + 4 is key 8m + 2t + 1
    uint32_t ah[4], al[4];
    split(p[m][0], ah[0], al[0]);
    split(p[m][2], ah[1], al[1]);
    split(p[m][1], ah[2], al[2]);
    split(p[m][3], ah[3], al[3]);
    const float* v0 = v_t + (8 * m + 2 * t) * VS + g;
    if (NO < kGroup) {  // hd <= 16: one or two dim tiles
#pragma unroll
      for (int jo = 0; jo < NO; ++jo) {
        if (jo < n_dt) {
          uint32_t bh0, bl0, bh1, bl1;
          split(v0[8 * jo], bh0, bl0);
          split(v0[VS + 8 * jo], bh1, bl1);
          mma_tf32(o[jo], al, bh0, bh1);
          mma_tf32(o[jo], ah, bl0, bl1);
          mma_tf32(o[jo], ah, bh0, bh1);
        }
      }
    } else {
#pragma unroll
      for (int j0 = 0; j0 < NO; j0 += kGroup) {
        if (j0 < n_dt) {  // dim tiles past hd read zeroed pad columns or stay unused
          uint32_t bh[kGroup][2], bl[kGroup][2];
#pragma unroll
          for (int j = 0; j < kGroup; ++j) {
            split(v0[8 * (j0 + j)], bh[j][0], bl[j][0]);
            split(v0[VS + 8 * (j0 + j)], bh[j][1], bl[j][1]);
          }
          mma_3xtf32(o + j0, ah, al, bh, bl);
        }
      }
    }
  }
}

template <int NT, int NO>
__device__ __forceinline__ void pv(float (&o)[NO][4], const float (&p)[NT][4],
                                   const __nv_bfloat16* v_t, int VS, int n_dt, int g,
                                   int t) {
#pragma unroll
  for (int m = 0; m < NT / 2; ++m) {
    uint32_t a[4];
    a[0] = pack_bf16(p[2 * m][0], p[2 * m][1]);
    a[1] = pack_bf16(p[2 * m][2], p[2 * m][3]);
    a[2] = pack_bf16(p[2 * m + 1][0], p[2 * m + 1][1]);
    a[3] = pack_bf16(p[2 * m + 1][2], p[2 * m + 1][3]);
    const __nv_bfloat16* v0 = v_t + (16 * m + 2 * t) * VS + g;
#pragma unroll
    for (int jo = 0; jo < NO; ++jo) {
      if (jo < n_dt) {
        const __nv_bfloat16* c = v0 + 8 * jo;
        mma_bf16(o[jo], a, pack_raw(c[0], c[VS]), pack_raw(c[8 * VS], c[9 * VS]));
      }
    }
  }
}

// One tile's online-softmax update on the score fragments (in place: the
// scores become the weights p) and the rescale of m, l and the output.
// Scores are taken in log2 units (scale * log2 e), so p = exp2(s - m) is
// exp(s_e - m_e) with one MUFU op. MASK: apply the row, S, causal and
// prefix limits (key visible iff key <= pos or key < prefix).
template <int NT, int NO, bool MASK>
__device__ __forceinline__ void online_softmax(float (&s)[NT][4], float (&o)[NO][4],
                                               float (&m_run)[2], float (&l_run)[2],
                                               float scale_log2, int k0, const int (&row)[2],
                                               const int (&pos)[2], int rows, int S,
                                               int causal, int prefix, int t) {
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      float x = s[j][e] * scale_log2;
      if (MASK) {
        const int key = k0 + 8 * j + 2 * t + (e & 1);
        if (!(row[h] < rows && key < S && (!causal || key <= pos[h] || key < prefix)))
          x = kNegInf;
      }
      s[j][e] = x;
      mx[h] = fmaxf(mx[h], x);
    }
  float corr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m_run[h], mx[h]);
    corr[h] = exp2f(m_run[h] - m_new);
    m_run[h] = m_new;
    l_run[h] *= corr[h];
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      // a masked score gives an exact 0 weight
      const float p = (!MASK || s[j][e] != kNegInf) ? exp2f(s[j][e] - m_run[h]) : 0.f;
      s[j][e] = p;
      l_run[h] += p;
    }
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    o[j][0] *= corr[0];
    o[j][1] *= corr[0];
    o[j][2] *= corr[1];
    o[j][3] *= corr[1];
  }
}

// NW warps of 16 rows; BN keys per tile; NO = 8-wide dim tiles of the output
template <typename T, int NW, int BN, int NO>
__global__ void __launch_bounds__(NW * 32, NW == 8 && NO <= 8 ? 2 : 1)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ out, int N, int S, int H, int KVH, int hd, int causal,
             int prefix, float scale, int vec, int n_qt) {
  constexpr int BM = 16 * NW;
  const float scale_log2 = scale * 1.4426950408889634f;  // exp(x) = exp2(x log2 e)
  constexpr int NT = BN / 8;
  constexpr int kThreads = NW * 32;
  constexpr int kStep = Layout<T>::kStep;
  const int per = KVH * N;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x / per);  // heavy tiles first
  const int rem = static_cast<int>(blockIdx.x % per);
  const int kvh = rem % KVH;
  const long long n = rem / KVH;
  const int G = H / KVH;
  const int rows = S * G;
  const int r0 = qt * BM;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int KS = Layout<T>::ks(hd);
  const int VS = Layout<T>::vs(hd);
  const int hdk = round_up(hd, kStep);
  const int hdv = round_up(hd, 8);
  const int n_dt = hdv / 8;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);   // BM x KS
  T* k_s = q_s + BM * KS;                    // 2 stages x BN x KS
  T* v_s = k_s + 2 * BN * KS;                // 2 stages x BN x VS

  // queries (zero past the rows and in the padded dims): by cp.async in the
  // first tile's group when the rows allow it. The K/V pad dims are zeroed
  // once (cp.async writes only dims < hd).
  auto q_row = [&](int rg) {
    const int tq = rg / G;
    return q + ((n * S + tq) * H + static_cast<long long>(kvh) * G + (rg - tq * G)) * hd;
  };
  if (vec) {
    constexpr int kChunk = 16 / sizeof(T);
    const int cpr = hd / kChunk;
    for (int i = tid; i < BM * cpr; i += kThreads) {
      const int r = i / cpr;
      const int d = (i - r * cpr) * kChunk;
      const bool ok = r0 + r < rows;
      cp_async16(q_s + r * KS + d, q_row(ok ? r0 + r : 0) + d, ok);
    }
  } else {
    for (int i = tid; i < BM * hd; i += kThreads) {
      const int r = i / hd;
      const int d = i - r * hd;
      q_s[r * KS + d] = r0 + r < rows ? q_row(r0 + r)[d] : from_f32<T>(0.f);
    }
  }
  const int kpad = hdk - hd, vpad = hdv - hd;
  for (int i = tid; i < BM * kpad; i += kThreads)
    q_s[(i / kpad) * KS + hd + i % kpad] = from_f32<T>(0.f);
  for (int i = tid; i < 2 * BN * (kpad + vpad); i += kThreads) {
    const int c = i / (kpad + vpad);
    const int d = i - c * (kpad + vpad);
    if (d < kpad)
      k_s[c * KS + hd + d] = from_f32<T>(0.f);
    else
      v_s[c * VS + hd + d - kpad] = from_f32<T>(0.f);
  }

  const int last_row = (r0 + BM < rows ? r0 + BM : rows) - 1;
  // causal: up to the block's last row, and at least the prefix's tiles
  const int all_kt = (S + BN - 1) / BN;
  const int pre_kt = (prefix < S ? prefix : S) + BN - 1;
  const int n_kt = causal ? max((last_row / G) / BN + 1, pre_kt / BN) : all_kt;
  const long long kv_stride = static_cast<long long>(KVH) * hd;
  const T* kb = k + n * S * kv_stride + static_cast<long long>(kvh) * hd;
  const T* vb = v + n * S * kv_stride + static_cast<long long>(kvh) * hd;

  auto load_tile = [&](int st, int k0) {
    T* ks = k_s + st * BN * KS;
    T* vs = v_s + st * BN * VS;
    if (vec) {
      constexpr int kChunk = 16 / sizeof(T);
      const int cpr = hd / kChunk;
      for (int i = tid; i < BN * cpr; i += kThreads) {
        const int c = i / cpr;
        const int d = (i - c * cpr) * kChunk;
        const bool ok = k0 + c < S;
        const long long off = (ok ? k0 + c : 0) * kv_stride + d;
        cp_async16(ks + c * KS + d, kb + off, ok);
        cp_async16(vs + c * VS + d, vb + off, ok);
      }
    } else {
      for (int i = tid; i < BN * hd; i += kThreads) {
        const int c = i / hd;
        const int d = i - c * hd;
        const bool ok = k0 + c < S;
        const long long off = (k0 + c) * kv_stride + d;
        ks[c * KS + d] = ok ? kb[off] : from_f32<T>(0.f);
        vs[c * VS + d] = ok ? vb[off] : from_f32<T>(0.f);
      }
    }
    cp_async_commit();
  };

  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};
  const int wr0 = r0 + warp * 16;                 // the warp's first row
  const int row[2] = {wr0 + g, wr0 + g + 8};      // this lane's two rows
  const int pos[2] = {row[0] / G, row[1] / G};
  const bool warp_live = wr0 < rows;
  const int warp_last = warp_live ? ((wr0 + 16 < rows ? wr0 + 16 : rows) - 1) / G : -1;
  const T* q_w = q_s + warp * 16 * KS;

  load_tile(0, 0);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BN;
    if (kt + 1 < n_kt) {
      load_tile((kt + 1) & 1, k0 + BN);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (warp_live && (!causal || k0 <= warp_last || k0 < prefix)) {
      const T* k_t = k_s + (kt & 1) * BN * KS;
      const T* v_t = v_s + (kt & 1) * BN * VS;
      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      scores<NT>(s, q_w, k_t, KS, hdk, g, t);
      // scores in log2 units; a tile wholly inside the rows, S and either
      // the causal limit of the warp's first row or the prefix needs no mask
      const bool full = k0 + BN <= S && wr0 + 16 <= rows &&
                        (!causal || k0 + BN - 1 <= wr0 / G || k0 + BN <= prefix);
      if (full)
        online_softmax<NT, NO, false>(s, o, m_run, l_run, scale_log2, k0, row, pos, rows, S,
                                      causal, prefix, t);
      else
        online_softmax<NT, NO, true>(s, o, m_run, l_run, scale_log2, k0, row, pos, rows, S,
                                     causal, prefix, t);
      pv<NT, NO>(o, s, v_t, VS, n_dt, g, t);
    }
    __syncthreads();  // the stage is free for the tile after next
  }

  if (!warp_live) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 1);
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= rows) continue;
    const int gq = row[h] - pos[h] * G;
    T* orow = out + ((n * S + pos[h]) * H + static_cast<long long>(kvh) * G + gq) * hd;
    const float inv_l = 1.f / fmaxf(l_run[h], 1e-30f);
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int d = 8 * j + 2 * t;
      if (d < hd) orow[d] = from_f32<T>(o[j][2 * h] * inv_l);
      if (d + 1 < hd) orow[d + 1] = from_f32<T>(o[j][2 * h + 1] * inv_l);
    }
  }
}

template <typename T, int NW, int BN, int NO>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int N, int S,
                   int H, int KVH, int hd, int causal, int prefix, float scale, int vec,
                   cudaStream_t stream) {
  const int rows = S * (H / KVH);
  const int n_qt = (rows + 16 * NW - 1) / (16 * NW);
  const size_t smem = sizeof(T) * smem_elems<T, NW, BN>(hd);
  auto kernel = flash_kernel<T, NW, BN, NO>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const long long blocks = static_cast<long long>(n_qt) * KVH * N;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(blocks), NW * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), N, S, H, KVH, hd, causal, prefix, scale, vec, n_qt);
  return cudaGetLastError();
}

// The big tile (BW warps of 16 query rows, BK keys) when its grid gives at
// least two blocks per SM, else 2 warps and 32 keys.
template <typename T, int NO, int BW, int BK>
cudaError_t pick_tiles(const void* q, const void* k, const void* v, void* out, int N,
                       int S, int H, int KVH, int hd, int causal, int prefix, float scale,
                       int vec, cudaStream_t s) {
  const long long rows = static_cast<long long>(S) * (H / KVH);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long big_blocks = (rows + 16 * BW - 1) / (16 * BW) * KVH * N;
  if (big_blocks >= 2LL * sms)
    return launch<T, BW, BK, NO>(q, k, v, out, N, S, H, KVH, hd, causal, prefix, scale, vec,
                                 s);
  return launch<T, 2, 32, NO>(q, k, v, out, N, S, H, KVH, hd, causal, prefix, scale, vec, s);
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out, int N,
                     int S, int H, int KVH, int hd, int causal, int prefix, float scale,
                     int vec, cudaStream_t s) {
  if (hd <= 8)
    return pick_tiles<T, 1, 8, 64>(q, k, v, out, N, S, H, KVH, hd, causal, prefix, scale,
                                         vec, s);
  if (hd <= 16)
    return pick_tiles<T, 2, 8, 64>(q, k, v, out, N, S, H, KVH, hd, causal, prefix, scale,
                                         vec, s);
  if (hd <= 32)
    return pick_tiles<T, 4, 8, 64>(q, k, v, out, N, S, H, KVH, hd, causal, prefix, scale,
                                         vec, s);
  if (hd <= 64)
    return pick_tiles<T, 8, 8, 64>(q, k, v, out, N, S, H, KVH, hd, causal, prefix, scale,
                                         vec, s);
  if (hd <= 128)
    return pick_tiles<T, 16, 8, 64>(q, k, v, out, N, S, H, KVH, hd, causal, prefix, scale,
                                         vec, s);
  if (hd <= 256)  // 8 warps of 64 keys would not fit shared memory here
    return pick_tiles<T, 32, 4, 32>(q, k, v, out, N, S, H, KVH, hd, causal, prefix, scale,
                                         vec, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success). dtype code: 0 fp32,
// 1 bf16 (q, k, v and out alike). prefix: the prefix-LM's bidirectional
// prefix length (0: plain causal; read only when causal). The caller
// checks shapes, dtypes, devices and contiguity, hd <= 256 and
// G = H / KVH <= 64. Q, K and V
// rows go through 16-byte cp.async when a row of hd elements is a whole
// number of 16-byte chunks and q, k and v start on 16 bytes; else through
// plain loads.
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* out,
                               int N, int S, int H, int KVH, int hd, int causal, int prefix,
                               int dtype, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (KVH <= 0 || H % KVH != 0 || H / KVH > 64 || hd <= 0 || prefix < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t item = dtype == kBF16 ? 2 : 4;
  const int vec = (hd * item) % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(v) % 16 == 0;
  if (dtype == kF32)
    return static_cast<int>(
        dispatch<float>(q, k, v, out, N, S, H, KVH, hd, causal, prefix, scale, vec, s));
  if (dtype == kBF16)
    return static_cast<int>(
        dispatch<__nv_bfloat16>(q, k, v, out, N, S, H, KVH, hd, causal, prefix, scale, vec, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
