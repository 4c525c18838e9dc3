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
// The bound and the design (a split page walk, cp.async stages, a lane per
// column, a fixed-order combine) are csrc/split_walk.cuh's. At W = 1 this
// is csrc/paged_decode_attention.cu, bit for bit.

#include "split_walk.cuh"

// Returns the cudaError_t of the launches (0 = success). dtype codes: 0
// fp32, 1 bf16. The caller checks shapes, dtypes, devices and contiguity,
// and passes kv heads per block and the blocks a kv head's W * G query
// rows split over (a block's rows x hd <= 4096), the split plan
// (stage_pages, min_pps, n_splits) and the scratch it sized.
extern "C" int paged_decode_window_attention(
    const void* q, const void* k_pages, const void* v_pages, const void* block_tables,
    const void* seq_lens, void* out, void* scratch, int P, int B, int W, int H, int KVH,
    int hd, int NP, int ps, int n_pmax, long long kv_p_stride, int q_dtype, int kv_dtype,
    float scale, int heads, int row_blocks, int stage_pages, int min_pps, int n_splits,
    void* stream) {
  using namespace split_walk;
  const Walk wk{P, B, W, H, KVH, hd, heads, row_blocks, ps, n_pmax, kv_p_stride, scale,
                stage_pages, min_pps, n_splits, 0};
  const PagedCols cols{static_cast<const int*>(block_tables),
                       static_cast<const int*>(seq_lens), NP, ps, n_pmax,
                       static_cast<long long>(KVH) * hd};
  return run(q, k_pages, v_pages, out, scratch, wk, cols, q_dtype, kv_dtype,
             static_cast<cudaStream_t>(stream));
}
