// Column gather of a quantized speculative LM head, the first of the two
// stages of spec_head_logits_q: for c < C,
//   codes[c, :] = q[:, ids[c]]    (int8, an exact copy of the stored bytes)
//   scales[c]   = scale[ids[c]]   (fp32)
// from int8 codes (D, V) or plane-packed int4 bytes (D/2, V)
// (repro_torch.quant's layout: one byte at stored row d holds the codes of
// hidden rows d and d + D/2) into a contiguous (C, Dp) buffer, Dp the
// stored row count, ids clamped to [0, V). No dequantized buffer: the dot
// (spec_head_q.cu) multiplies a column's fp32 sum by its scale, as the
// Pallas kernel folds the scale after its tile dot. The tile, its bound
// and its design: spec_gather.cuh, on a 1-byte element (16 codes a
// 16-byte store), the scales copied in the same launch.
//
// With spec_head_q.cu it replaces the Pallas kernel spec_head_logits_q
// (_kernel_q8 / _kernel_q4) in src/repro/kernels/spec_head/spec_head.py,
// whose (B, k, D/Dt) grid gathers integer column blocks and scale scalars
// through scalar-prefetched index maps. The tree step (core/engine.py)
// gathers its B*N node tokens' code columns once per step and dots with
// them at every exit point that runs the gate, as the fp tree gate does
// (spec_head_gather.cu).
//
// Bound on the H100: C * Dp 32-byte sectors (160 columns at D = 4096:
// 655k sectors, 21 MB, ~6.3 us in int8; int4 half of that), for C * Dp
// useful bytes and C scales.
#include "spec_gather.cuh"

extern "C" {

const char* spec_head_gather_q_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q int8 (Dp, V), Dp = D for int8 codes or D/2 for packed int4; scale (V,)
// f32; ids (C,) int32, C >= 1; codes (C, Dp) int8; scales (C,) f32.
int spec_head_gather_q_launch(const void* q, const void* scale,
                              const void* ids, void* codes, void* scales,
                              int C, int Dp, int V, void* stream) {
  return rt::spec_gather_run<int8_t, true>(q, scale, ids, codes, scales, C,
                                           Dp, V,
                                           static_cast<cudaStream_t>(stream));
}

}  // extern "C"
