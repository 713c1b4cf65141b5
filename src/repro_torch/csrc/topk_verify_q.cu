// Streaming top-k over a quantized LM head: ids[b, :k] of
// (hn[b] . codes) * scale sorted by logit descending, then by id ascending
// (exactly lax.top_k on the materialized logits), fp32, for int8 codes
// (D, V) or plane-packed int4 bytes (D/2, V) (repro_torch.quant's layout).
//
// Replaces the Pallas kernel topk_verify_fused_q (_topk_kernel_q8 /
// _topk_kernel_q4) in src/repro/kernels/exit_gate/exit_gate.py, which the
// draft proposal runs under weight-only quantization. The passes, the grid
// and the tie order are topk_verify.cu's (topk_verify.cuh) on an Int8Cols
// or Int4Cols reader (see argmax_verify_q.cu for the int4 stage and the
// scale).
//
// Bound on the H100: bytes at decode batch — int8 codes + scales 131 MB
// (~39 us at 3.35 TB/s), int4 65.7 MB (~20 us); with many rows the 2*R*D*V
// operations at the bf16 rate (see argmax_verify_q.cu). Like argmax_verify_q.cu it is bound by one-byte loads and
// FMAs per column, not by bytes.
#include "topk_verify.cuh"

namespace {

template <typename T>
int run(const void* hn, const void* q, const void* scale, void* pval,
        void* pidx, void* ids, void* vals, int R, int D, int V, int k,
        int bits, cudaStream_t st) {
  const int8_t* codes = static_cast<const int8_t*>(q);
  const float* s = static_cast<const float*>(scale);
  if (bits == 4)
    return rt::topk_verify_run<T>(hn, rt::Int4Cols{codes, s}, pval, pidx,
                                  ids, vals, R, D, V, k, st);
  return rt::topk_verify_run<T>(hn, rt::Int8Cols{codes, s}, pval, pidx, ids,
                                vals, R, D, V, k, st);
}

}  // namespace

extern "C" {

int topk_verify_q_block_cols() { return rt::LH_THREADS; }
int topk_verify_q_max_k() { return rt::TK_MAXK; }
const char* topk_verify_q_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// hn (R, D) f32 or bf16, any R >= 1; q int8 (D, V) for bits 8 or packed
// (D/2, V) for bits 4; scale (V,) f32; pval/pidx (R, nblk, k) scratch with
// nblk = ceil(V / topk_verify_q_block_cols()); ids (R, k) int32, vals
// (R, k) f32.
int topk_verify_q_launch(const void* hn, const void* q, const void* scale,
                         void* pval, void* pidx, void* ids, void* vals, int R,
                         int D, int V, int k, int bits, int dtype,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rt::DT_BF16)
    return run<__nv_bfloat16>(hn, q, scale, pval, pidx, ids, vals, R, D, V,
                              k, bits, st);
  return run<float>(hn, q, scale, pval, pidx, ids, vals, R, D, V, k, bits,
                    st);
}

}  // extern "C"
