// Paged single-token decode attention for Hopper (sm_90a), plain C
// interface; also the speculative draft, over a one-particle view.
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
//   scratch      fp32, P * B * KVH * n_splits * G * (hd + 2), from the
//                wrapper (torch.empty); the kernels allocate nothing
//
// Semantics kept from the TPU kernel: column c of row b is valid iff
// c <= seq_len and seq_len >= 0; both the weight and the value row of an
// invalid column are zeroed (slots past the tail hold stale writes of a
// previous owner, possibly NaN); an inactive row returns exact zeros;
// scale 1/sqrt(hd); the output is divided by max(l, 1e-30).
//
// This is the drafted-window kernel (csrc/paged_decode_window_attention.cu)
// at W = 1: one query row per (kv head group, row, particle), the same
// block-table column rule, the split page walk of csrc/split_walk.cuh
// (which states the bound and the design), and the wrapper's split plan at
// W = 1. The two return the same bits for a one-token window.

#include "split_walk.cuh"

// Returns the cudaError_t of the launches (0 = success). dtype codes: 0
// fp32, 1 bf16. The caller checks shapes, dtypes, devices and contiguity,
// and passes kv heads per block, the blocks a kv head's query rows split
// over, the split plan (stage_pages, min_pps, n_splits) and the scratch
// it sized.
extern "C" int paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages, const void* block_tables,
    const void* seq_lens, void* out, void* scratch, int P, int B, int H, int KVH, int hd,
    int NP, int ps, int n_pmax, long long kv_p_stride, int q_dtype, int kv_dtype,
    float scale, int heads, int row_blocks, int stage_pages, int min_pps, int n_splits,
    void* stream) {
  using namespace split_walk;
  const Walk wk{P, B, 1, H, KVH, hd, heads, row_blocks, ps, n_pmax, kv_p_stride, scale,
                stage_pages, min_pps, n_splits, 0};
  const PagedCols cols{static_cast<const int*>(block_tables),
                       static_cast<const int*>(seq_lens), NP, ps, n_pmax,
                       static_cast<long long>(KVH) * hd};
  return run(q, k_pages, v_pages, out, scratch, wk, cols, q_dtype, kv_dtype,
             static_cast<cudaStream_t>(stream));
}
