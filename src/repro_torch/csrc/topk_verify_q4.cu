// The int4 half of topk_verify_q.cu's tensor-core tile: the two passes of
// the top-k over plane-packed int4 codes (D/2, V) with bf16 hidden rows,
// rt::topk_mma_run on an Int4Tile reader. It is its own source only so
// that nvcc compiles its 24 tile instances beside the int8 ones; the C
// interface, the checks and the fp32 rows are in topk_verify_q.cu.
#include "topk_verify.cuh"

// hn (R, D) bf16, D % 16 == 0, 16-byte aligned (checked by the caller);
// the rest as topk_verify_q_launch's.
int topk_verify_q4_mma(const void* hn, const int8_t* q, const float* s,
                       void* pval, void* pidx, void* ids, void* vals, int R,
                       int D, int V, int k, cudaStream_t st) {
  const rt::Int4Tile head{{q, s}};
  return rt::topk_mma_run(hn, head, pval, pidx, ids, vals, R, D, V, k,
                          head.copy_width(V), st);
}
