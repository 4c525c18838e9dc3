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
//   scratch  fp32, P * B * KVH * n_splits * G * (hd + 2), from the wrapper
//
// Semantics kept from the TPU kernel: slot c is valid iff k_pos[b, c] >= 0
// (and c < C: the ragged last stage is masked by index, never padded in
// memory); both the softmax weight and the value row are zeroed on invalid
// slots, so an empty slot's contents (possibly NaN) never enter the
// arithmetic; scale 1/sqrt(hd); the output is divided by max(l, 1e-30), so
// a row with no valid slot returns zeros.
//
// The walk is csrc/split_walk.cuh's (which states the bound and the
// design) over a row of C one-slot units: the split plan comes from C and
// the grid's size (kernels/split_walk.py::launch_plan), every row spans
// all C slots, and a column's address is its slot in the row, read only
// where k_pos says it is filled. A stage whose slots are all empty reads
// no K or V and is skipped.

#include "split_walk.cuh"

namespace {

// Column c of row b is slot c of the row, valid iff k_pos[b, c] >= 0.
struct DenseCols {
  const int* k_pos;        // (B, C)
  int C;
  long long slot_stride;   // KVH * hd

  // every row spans all C slots: query 0 at position C - 1
  __device__ __forceinline__ int seq_len(int) const { return C - 1; }
  __device__ __forceinline__ long long offset(int b, int c) const {
    const long long slot = static_cast<long long>(b) * C + c;
    return k_pos[slot] < 0 ? -1 : slot * slot_stride;
  }
};

}  // namespace

// Returns the cudaError_t of the launches (0 = success). dtype codes: 0
// fp32, 1 bf16. The caller checks shapes, dtypes, devices and contiguity,
// and passes kv heads per block, the blocks a kv head's query rows split
// over, the split plan over C (stage_slots, min_slots, n_splits) and the
// scratch it sized.
extern "C" int decode_attention(const void* q, const void* k_cache, const void* v_cache,
                                const void* k_pos, void* out, void* scratch, int P, int B,
                                int H, int KVH, int hd, int C, long long kv_p_stride,
                                int q_dtype, int kv_dtype, float scale, int heads,
                                int row_blocks, int stage_slots, int min_slots, int n_splits,
                                void* stream) {
  using namespace split_walk;
  const Walk wk{P, B, 1, H, KVH, hd, heads, row_blocks, 1, C, kv_p_stride, scale,
                stage_slots, min_slots, n_splits, 0};
  const DenseCols cols{static_cast<const int*>(k_pos), C, static_cast<long long>(KVH) * hd};
  return run(q, k_cache, v_cache, out, scratch, wk, cols, q_dtype, kv_dtype,
             static_cast<cudaStream_t>(stream));
}
