// LM-head top-k: ids[b, :k] sorted by logit descending, then by id
// ascending (exactly lax.top_k on the materialized logits), fp32 sums.
//
// Replaces the Pallas kernel topk_verify_fused (_topk_kernel) in
// src/repro/kernels/exit_gate/exit_gate.py, which folds vocabulary tiles in
// order into a running sorted top-k list. Here pass 1 gives each CTA a
// 128-column strip and a tile of rows (any row count R) and writes the
// strip's own top-k per row under rt::before; pass 2 (topk_merge) runs k
// rounds of a block-wide best over the (nblk * k) candidates of a row,
// excluding the ids already taken. A global top-k entry is always inside
// its strip's top-k, and rt::before is a total order, so the merge keeps
// value-descending, id-ascending order across CTAs.
//
// Which instance runs which body:
//   bf16 — topk_partial_mma (lm_head_mma.cuh) on the tensor cores: the
//          main loop of the bf16 argmax (cp.async ring, mma.sync m16n8k16
//          bf16 x bf16 -> fp32, one instruction shape and one k-order for
//          every R) with a top-k epilogue: each thread sorts its 8 columns
//          per row (bitonic network), quad shuffles merge them into the
//          warp's top k of 32 columns, and one thread per row merges the
//          four warps' sorted lists in shared memory;
//   fp32 — topk_partial (topk_verify.cuh over lm_head_stream.cuh): one
//          column per thread on the fp32 CUDA cores, groups of 8 rows, k
//          rounds of a block-wide best, so its sums stay those of the
//          plain fp32 version.
//
// Bound on the H100: bytes at decode batch, one pass over the (D, V) head
// (262 MB in bf16 for Llama-2-7B, ~78 us at 3.35 TB/s); at the tree's
// 160-320 rows the 2*R*D*V operations at the bf16 rate (0.079-0.085 ms).
// The streaming body took 0.27 ms at B=4 and 2.15 / 4.11 ms at 160 / 320
// rows, floored by load latency and then by the fp32 peak; the bf16 tile
// reads the head once per tile of up to 256 rows. Numbers: PERF.md, from
// chip_smoke.py and scripts/ab_argmax_verify.py. Both bodies' passes are
// launched from topk_verify.cuh, shared with the quantized sibling
// topk_verify_q.cu (+ topk_verify_q4.cu).
#include "topk_verify.cuh"

extern "C" {

int topk_verify_block_cols() {
  static_assert(rt::LM_BN == rt::LH_THREADS, "one strip width for both");
  return rt::LM_BN;
}
int topk_verify_max_k() { return rt::TK_MAXK; }
const char* topk_verify_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// hn (R, D), w (D, V) of one dtype, any R >= 1 (bf16: D % 8 == 0 and hn
// 16-byte aligned), 1 <= k <= topk_verify_max_k(); pval/pidx (R, nblk, k)
// scratch with nblk = ceil(V / topk_verify_block_cols()); ids (R, k) int32,
// vals (R, k) f32.
int topk_verify_launch(const void* hn, const void* w, void* pval, void* pidx,
                       void* ids, void* vals, int R, int D, int V, int k,
                       int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rt::DT_BF16) {
    if (D % 8 || reinterpret_cast<uintptr_t>(hn) % 16 || k < 1 ||
        k > rt::TK_MAXK)
      return static_cast<int>(cudaErrorInvalidValue);
    const int vec = V % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
    return rt::topk_mma_run(hn,
                            rt::Bf16Tile{static_cast<const __nv_bfloat16*>(w)},
                            pval, pidx, ids, vals, R, D, V, k, vec, st);
  }
  return rt::topk_verify_run<float>(
      hn, rt::FpCols<float>{static_cast<const float*>(w)}, pval, pidx, ids,
      vals, R, D, V, k, st);
}

}  // extern "C"
