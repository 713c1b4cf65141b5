// Top-k over a quantized LM head: ids[b, :k] of (hn[b] . codes) * scale
// sorted by logit descending, then by id ascending (exactly lax.top_k on
// the materialized logits), fp32, for int8 codes (D, V) or plane-packed
// int4 bytes (D/2, V) (repro_torch.quant's layout).
//
// Replaces the Pallas kernel topk_verify_fused_q (_topk_kernel_q8 /
// _topk_kernel_q4) in src/repro/kernels/exit_gate/exit_gate.py, which the
// draft proposal runs under weight-only quantization. The two passes and
// the tie order are topk_verify.cu's: per-strip top-k partials, then
// topk_merge.
//
// Which instance runs which body:
//   bf16 hidden rows — topk_partial_mma (lm_head_mma.cuh) on an Int8Tile
//          or Int4Tile reader: argmax_verify_q.cu's main loop (the raw
//          codes through the cp.async ring, made bf16 B fragments in
//          registers, mma.sync m16n8k16 -> fp32, each column's sum times
//          its scale once) with topk_verify.cu's top-k epilogue. So
//          vals[:, 0] is bit-equal to argmax_verify_q's max on the same
//          inputs, and ids[:, 0] equal to its token;
//   fp32 hidden rows — topk_partial (topk_verify.cuh over
//          lm_head_stream.cuh) on an Int8Cols or Int4Cols reader, one
//          column of one-byte loads per thread on the fp32 CUDA cores.
//
// Bound on the H100: bytes at decode batch — int8 codes + scales 131 MB
// (~39 us at 3.35 TB/s), int4 65.7 MB (~20 us); with many rows the
// 2*R*D*V operations at the bf16 rate (42 GFLOP at R=160, ~42 us at 989
// TFLOP/s). The streaming body was bound by one-byte loads and FMAs per
// column (0.27 / 0.21 ms at B=4, ~2 ms at 160 rows); the tile moves 16
// bytes per copy and reads the codes once per tile of up to 256 rows.
// Numbers: PERF.md, from chip_smoke.py and scripts/ab_argmax_verify.py.
//
// The int4 tile's instances are in topk_verify_q4.cu, compiled beside this
// file and linked into one library (kernels/build.py's PARTS): the int8
// and int4 tiles are 24 instances each (lm_mma_dispatch's 12 row tiles x
// KP 4 and 8), which one nvcc process took ~110 s to compile.
#include "topk_verify.cuh"

// topk_verify_q4.cu: the int4 tile's two passes (rt::topk_mma_run).
int topk_verify_q4_mma(const void* hn, const int8_t* q, const float* s,
                       void* pval, void* pidx, void* ids, void* vals, int R,
                       int D, int V, int k, cudaStream_t st);

extern "C" {

int topk_verify_q_block_cols() {
  static_assert(rt::LM_BN == rt::LH_THREADS, "one strip width for both");
  return rt::LM_BN;
}
int topk_verify_q_max_k() { return rt::TK_MAXK; }
const char* topk_verify_q_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// hn (R, D) f32 or bf16 (bf16: D % 8 == 0, int4 D % 16 == 0, and hn
// 16-byte aligned), any R >= 1; q int8 (D, V) for bits 8 or packed
// (D/2, V) for bits 4; scale (V,) f32; 1 <= k <= topk_verify_q_max_k();
// pval/pidx (R, nblk, k) scratch with nblk = ceil(V /
// topk_verify_q_block_cols()); ids (R, k) int32, vals (R, k) f32.
int topk_verify_q_launch(const void* hn, const void* q, const void* scale,
                         void* pval, void* pidx, void* ids, void* vals, int R,
                         int D, int V, int k, int bits, int dtype,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* codes = static_cast<const int8_t*>(q);
  const float* s = static_cast<const float*>(scale);
  if (k < 1 || k > rt::TK_MAXK)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == rt::DT_BF16) {
    if (D % (bits == 4 ? 16 : 8) || reinterpret_cast<uintptr_t>(hn) % 16)
      return static_cast<int>(cudaErrorInvalidValue);
    if (bits == 4)
      return topk_verify_q4_mma(hn, codes, s, pval, pidx, ids, vals, R, D, V,
                                k, st);
    const rt::Int8Tile head{{codes, s}};
    return rt::topk_mma_run(hn, head, pval, pidx, ids, vals, R, D, V, k,
                            head.copy_width(V), st);
  }
  if (bits == 4)
    return rt::topk_verify_run<float>(hn, rt::Int4Cols{codes, s}, pval, pidx,
                                      ids, vals, R, D, V, k, st);
  return rt::topk_verify_run<float>(hn, rt::Int8Cols{codes, s}, pval, pidx,
                                    ids, vals, R, D, V, k, st);
}

}  // extern "C"
