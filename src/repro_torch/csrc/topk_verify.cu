// Streaming LM-head top-k: ids[b, :k] sorted by logit descending, then by
// id ascending (exactly lax.top_k on the materialized logits), fp32.
//
// Replaces the Pallas kernel topk_verify_fused (_topk_kernel) in
// src/repro/kernels/exit_gate/exit_gate.py, which folds vocabulary tiles in
// order into a running sorted top-k list. Here pass 1 gives each CTA a
// 128-column strip and a group of up to 8 rows (any row count R; the
// streaming layout of argmax_verify.cu, lm_head_stream.cuh) and extracts
// the strip's own top-k per row by k rounds of a block-wide best under
// rt::before, excluding the ids already taken; pass 2 runs the same k
// rounds over the (nblk * k) candidates of a row. A global top-k entry is
// always inside its strip's top-k, and rt::before is a total order, so the
// merge keeps value-descending, id-ascending order across CTAs.
//
// Bound on the H100: bytes at decode batch, one pass over the (D, V) head
// (262 MB in bf16 for Llama-2-7B, ~78 us at 3.35 TB/s); with many rows the
// 2*R*D*V fp32 operations. The k extraction rounds touch only registers and
// 128 B of shared memory per round. The passes are in topk_verify.cuh,
// shared with the quantized sibling topk_verify_q.cu.
#include "topk_verify.cuh"

extern "C" {

int topk_verify_block_cols() { return rt::LH_THREADS; }
int topk_verify_max_k() { return rt::TK_MAXK; }
const char* topk_verify_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// hn (R, D), w (D, V) of one dtype, any R >= 1; pval/pidx (R, nblk, k)
// scratch with nblk = ceil(V / topk_verify_block_cols()); ids (R, k) int32,
// vals (R, k) f32.
int topk_verify_launch(const void* hn, const void* w, void* pval, void* pidx,
                       void* ids, void* vals, int R, int D, int V, int k,
                       int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rt::DT_BF16) {
    using T = __nv_bfloat16;
    return rt::topk_verify_run<T>(hn, rt::FpCols<T>{static_cast<const T*>(
        w)}, pval, pidx, ids, vals, R, D, V, k, st);
  }
  return rt::topk_verify_run<float>(
      hn, rt::FpCols<float>{static_cast<const float*>(w)}, pval, pidx, ids,
      vals, R, D, V, k, st);
}

}  // extern "C"
