// Speculative LM head: logits[r, j] = hn[r] . W[:, ids[r, j]], fp32, one CTA
// per row r, any row count R. The softmax over the k logits stays in the
// Python wrapper's caller (kernels/spec_head/ops.py), as in the JAX package.
//
// Replaces the Pallas kernel spec_head_logits (_kernel) in
// src/repro/kernels/spec_head/spec_head.py, whose (B, k, D/Dt) grid streams
// column spec_ids[b, j] block by block through a scalar-prefetched index
// map and accumulates the partial dots in its output block. Here one CTA
// does a row's whole D reduction for all k columns (spec_head.cuh, the body
// the fused exit gate also runs).
//
// Bound on the H100: bytes — the k * D gathered head elements and the D
// hidden entries per row (R = 160 node rows of the default tree at B=4:
// 160 * 4 * 4096 * 2 B = 5.2 MB of useful bf16, ~2 us at 3.35 TB/s); the
// 2 * R * k * D operations are tiny. What the kernel pays is the 32-byte
// sector per strided element (spec_head.cuh); R CTAs spread over the SMs.
// The kernel body is in spec_head.cuh, shared with spec_head_q.cu.
#include "spec_head.cuh"

extern "C" {

int spec_head_max_k() { return rt::SH_MAXK; }
const char* spec_head_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// hn (R, D) and w (D, V) of one dtype; ids (R, k) int32; logits (R, k) f32.
int spec_head_launch(const void* hn, const void* w, const void* ids,
                     void* logits, int R, int D, int V, int k, int dtype,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rt::DT_BF16) {
    using T = __nv_bfloat16;
    return rt::spec_head_run<T>(hn, rt::FpCols<T>{static_cast<const T*>(w)},
                                ids, logits, R, D, V, k, st);
  }
  return rt::spec_head_run<float>(
      hn, rt::FpCols<float>{static_cast<const float*>(w)}, ids, logits, R, D,
      V, k, st);
}

}  // extern "C"
