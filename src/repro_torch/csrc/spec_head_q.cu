// Speculative LM head over a quantized head: logits[r, j] =
// (hn[r] . codes[:, ids[r, j]]) * scale[ids[r, j]], fp32, one CTA per row
// r, any row count R; int8 codes (D, V) or plane-packed int4 bytes
// (D/2, V) (repro_torch.quant's layout). The softmax stays in the caller
// (kernels/spec_head/ops.py).
//
// Replaces the Pallas kernel spec_head_logits_q (_kernel_q8 / _kernel_q4)
// in src/repro/kernels/spec_head/spec_head.py, whose (B, k, D/Dt) grid
// gathers integer column blocks and scale scalars through scalar-prefetched
// index maps and folds the scale into each tile's partial dot. Here one
// CTA does a row's whole reduction for its k columns (spec_head.cuh on an
// Int8Cols or Int4Cols reader: one int4 byte at stored row d feeds hidden
// entries d and d + D/2) and multiplies each column's sum by its scale
// once. Ids are clamped as in the fp kernel.
//
// Bound on the H100: bytes — the k gathered code columns (k * D bytes in
// int8, k * D/2 in int4), k scales and the D hidden entries per row; the
// strided gather pays one 32-byte sector per code, as the fp kernel does
// per element.
#include "spec_head.cuh"

extern "C" {

int spec_head_q_max_k() { return rt::SH_MAXK; }
const char* spec_head_q_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// hn (R, D) f32 or bf16; q int8 (D, V) for bits 8 or packed (D/2, V) for
// bits 4; scale (V,) f32; ids (R, k) int32; logits (R, k) f32.
int spec_head_q_launch(const void* hn, const void* q, const void* scale,
                       const void* ids, void* logits, int R, int D, int V,
                       int k, int bits, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* c = static_cast<const int8_t*>(q);
  const float* s = static_cast<const float*>(scale);
  if (dtype == rt::DT_BF16) {
    using T = __nv_bfloat16;
    if (bits == 4)
      return rt::spec_head_run<T>(hn, rt::Int4Cols{c, s}, ids, logits, R, D,
                                  V, k, st);
    return rt::spec_head_run<T>(hn, rt::Int8Cols{c, s}, ids, logits, R, D, V,
                                k, st);
  }
  if (bits == 4)
    return rt::spec_head_run<float>(hn, rt::Int4Cols{c, s}, ids, logits, R,
                                    D, V, k, st);
  return rt::spec_head_run<float>(hn, rt::Int8Cols{c, s}, ids, logits, R, D,
                                  V, k, st);
}

}  // extern "C"
