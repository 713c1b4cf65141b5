// Column gather of the fp speculative LM head, the first of the two stages
// of spec_head_logits: cols[c, :] = W[:, ids[c]] for c < C, from the
// (D, V) row-major head into a contiguous (C, D) buffer of the head's
// dtype (an exact copy), ids clamped to [0, V). The tile, its bound and
// its design: spec_gather.cuh (shared with spec_head_gather_q.cu).
//
// With spec_head.cu (the dot over the gathered buffer) it replaces the
// Pallas kernel spec_head_logits (_kernel) in
// src/repro/kernels/spec_head/spec_head.py, whose (B, k, D/Dt) grid
// streams column spec_ids[b, j] block by block through a scalar-prefetched
// index map. Why two stages: the tree step (core/engine.py) asks the spec
// head, at every exit point that runs its gate, for the k children's
// columns of each of its B*N nodes. Every such id is one of the row's N
// node tokens, and the node tokens do not change within a step. So the
// step gathers the B*N node tokens' columns once, at the first exit point
// that runs the gate, and each exit point then reads only the contiguous
// buffer (spec_head.cu). spec_head_logits alone gathers its R*k ids.
#include "spec_gather.cuh"

extern "C" {

const char* spec_head_gather_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// w (D, V) f32 or bf16; ids (C,) int32, C >= 1; cols (C, D) of w's dtype.
int spec_head_gather_launch(const void* w, const void* ids, void* cols,
                            int C, int D, int V, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rt::DT_BF16)
    return rt::spec_gather_run<__nv_bfloat16, false>(w, nullptr, ids, cols,
                                                     nullptr, C, D, V, st);
  return rt::spec_gather_run<float, false>(w, nullptr, ids, cols, nullptr,
                                           C, D, V, st);
}

}  // extern "C"
