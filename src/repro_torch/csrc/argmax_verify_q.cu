// Streaming argmax over a quantized LM head: token[b] = argmax_v
// (hn[b] . codes[:, v]) * scale[v], fp32, for int8 codes (D, V) or
// plane-packed int4 bytes (D/2, V) (repro_torch.quant's layout).
//
// Replaces the Pallas kernel argmax_verify_fused_q (_verify_kernel_q8 /
// _verify_kernel_q4) in src/repro/kernels/exit_gate/exit_gate.py. The
// Pallas int4 kernel passes hn twice, with index maps for the halves
// [0, D/2) and [D/2, D), and sums two half-plane dots per tile; here the
// stage of lm_head_stream.cuh holds both halves of each hidden chunk and one
// packed byte feeds both. The passes, the grid and the tie order are
// argmax_verify.cu's (argmax_verify.cuh), on an Int8Cols or Int4Cols reader
// that widens each code to fp32 in registers; a column's sum is multiplied
// by its scale once, before the per-CTA partial.
//
// Bound on the H100: bytes at decode batch — the codes once and the V fp32
// scales: int8 D*V + 4V = 131 MB for Llama-2-7B (~39 us at 3.35 TB/s),
// int4 65.7 MB (~20 us); with many rows the 2*R*D*V operations at the
// bf16 rate, since bf16 hidden rows and every code are exact bf16 operands
// (42 GFLOP at R=160, ~42 us at 989 TFLOP/s). The design
// is the fp kernel's, one column of one-byte loads per thread, so it is
// bound by load and FMA instructions per column rather than by bytes;
// reading 4 or 8 codes per thread is later work.
#include "argmax_verify.cuh"

namespace {

template <typename T>
int run(const void* hn, const void* q, const void* scale, void* pval,
        void* pidx, void* tok, void* mx, int R, int D, int V, int bits,
        cudaStream_t st) {
  const int8_t* codes = static_cast<const int8_t*>(q);
  const float* s = static_cast<const float*>(scale);
  if (bits == 4)
    return rt::argmax_verify_run<T>(hn, rt::Int4Cols{codes, s}, pval, pidx,
                                    tok, mx, R, D, V, st);
  return rt::argmax_verify_run<T>(hn, rt::Int8Cols{codes, s}, pval, pidx,
                                  tok, mx, R, D, V, st);
}

}  // namespace

extern "C" {

int argmax_verify_q_block_cols() { return rt::LH_THREADS; }
const char* argmax_verify_q_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// hn (R, D) f32 or bf16, any R >= 1; q int8 (D, V) for bits 8 or packed
// (D/2, V) for bits 4; scale (V,) f32; pval/pidx (R, nblk) scratch with
// nblk = ceil(V / argmax_verify_q_block_cols()); tok (R,) int32, mx (R,)
// f32.
int argmax_verify_q_launch(const void* hn, const void* q, const void* scale,
                           void* pval, void* pidx, void* tok, void* mx, int R,
                           int D, int V, int bits, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rt::DT_BF16)
    return run<__nv_bfloat16>(hn, q, scale, pval, pidx, tok, mx, R, D, V,
                              bits, st);
  return run<float>(hn, q, scale, pval, pidx, tok, mx, R, D, V, bits, st);
}

}  // extern "C"
