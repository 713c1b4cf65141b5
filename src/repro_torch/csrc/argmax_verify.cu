// Streaming LM-head argmax: token[b] = argmax_v (hn[b] . W[:, v]), fp32.
//
// Replaces the Pallas kernel argmax_verify_fused (_verify_kernel) in
// src/repro/kernels/exit_gate/exit_gate.py, whose grid is (rows, vocabulary
// tiles): the tiles run one after another on one core with a running
// (max, argmax) in SMEM. Here the tiles run in parallel: pass 1 gives each
// CTA a 128-column strip and a group of up to 8 rows (any row count R, see
// lm_head_stream.cuh) and writes one (max, argmax) partial per (row, strip);
// pass 2 merges the partials of a row in one CTA. Both passes use
// rt::before, so equal maxima resolve to the lowest id, and columns >= V
// never win. The (R, V) logits are never written.
//
// Bound on the H100: at decode batch (R <= 8) bytes, one pass over the head,
// D*V*sizeof(T) (4096 * 32000 * 2 B = 262 MB for Llama-2-7B in bf16, ~78 us
// at 3.35 TB/s). The tree acceptance walk verifies B*N node rows (160 at
// B=4 with the default 40-node tree): there the 2*R*D*V fp32 operations
// bound it (42 GFLOP, ~0.63 ms at 67 TFLOP/s). The design keeps the read
// coalesced (one column per thread), keeps LH_UNROLL loads in flight per
// thread, spreads V/128 = 250 strips over the 132 SMs, and orders the grid
// so that the row groups of one strip share it through L2. Tensor cores
// (the head as a bf16 GEMM operand) are later work. The passes are in
// argmax_verify.cuh, shared with the quantized sibling argmax_verify_q.cu.
#include "argmax_verify.cuh"

extern "C" {

int argmax_verify_block_cols() { return rt::LH_THREADS; }
const char* argmax_verify_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// hn (R, D), w (D, V) of one dtype, any R >= 1; pval/pidx (R, nblk)
// scratch with nblk = ceil(V / argmax_verify_block_cols()); tok (R,) int32,
// mx (R,) f32.
int argmax_verify_launch(const void* hn, const void* w, void* pval,
                         void* pidx, void* tok, void* mx, int R, int D, int V,
                         int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rt::DT_BF16) {
    using T = __nv_bfloat16;
    return rt::argmax_verify_run<T>(hn, rt::FpCols<T>{static_cast<const T*>(
        w)}, pval, pidx, tok, mx, R, D, V, st);
  }
  return rt::argmax_verify_run<float>(
      hn, rt::FpCols<float>{static_cast<const float*>(w)}, pval, pidx, tok,
      mx, R, D, V, st);
}

}  // extern "C"
