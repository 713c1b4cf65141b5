// LM-head argmax over a quantized head: token[b] = argmax_v
// (hn[b] . codes[:, v]) * scale[v], fp32 sums, for int8 codes (D, V) or
// plane-packed int4 bytes (D/2, V) (repro_torch.quant's layout).
//
// Replaces the Pallas kernel argmax_verify_fused_q (_verify_kernel_q8 /
// _verify_kernel_q4) in src/repro/kernels/exit_gate/exit_gate.py. The
// Pallas int4 kernel passes hn twice, with index maps for the halves
// [0, D/2) and [D/2, D), and sums two half-plane dots per tile; here the
// hidden stage holds both halves of each chunk and one packed byte feeds
// both. The passes and the tie order are argmax_verify.cu's; a column's
// sum is multiplied by its scale once, before the per-CTA partial.
//
// Which instance runs which body:
//   bf16 hidden rows — argmax_partial_mma (lm_head_mma.cuh) on an Int8Tile
//          or Int4Tile reader: the raw codes stream through the bf16
//          argmax's cp.async ring (16-byte copies; 4-byte or element copies
//          for rows off 16 bytes, e.g. V = 50280), one ldmatrix.trans of
//          bytes gives a lane 4 int8 codes (8 int4), which become bf16 B
//          fragments in registers (byte_perm into an fp32 magic number for
//          int8, nibbles into the mantissa of bf16 128 for int4: every code
//          is exact in bf16), multiplied by mma.sync m16n8k16 -> fp32;
//   fp32 hidden rows — argmax_partial (argmax_verify.cuh over
//          lm_head_stream.cuh) on an Int8Cols or Int4Cols reader, one
//          column of one-byte loads per thread on the fp32 CUDA cores.
//
// Bound on the H100: bytes at decode batch — the codes once and the V fp32
// scales: int8 D*V + 4V = 131 MB for Llama-2-7B (~39 us at 3.35 TB/s),
// int4 65.7 MB (~20 us); with many rows the 2*R*D*V operations at the
// bf16 rate (42 GFLOP at R=160, ~42 us at 989 TFLOP/s). The streaming body
// was bound by one-byte loads and FMAs per column (0.27 / 0.21 ms at B=4,
// ~2 ms at 160 rows); the tile moves 16 bytes per copy and reads the codes
// once per tile of up to 256 rows. Numbers: PERF.md, from chip_smoke.py
// and scripts/ab_argmax_verify.py.
#include "argmax_verify.cuh"
#include "lm_head_mma.cuh"

namespace {

template <typename H>
int run_mma(const void* hn, H head, void* pval, void* pidx, void* tok,
            void* mx, int R, int D, int V, cudaStream_t st) {
  const int vec = head.copy_width(V);
  const int err = rt::lm_mma_dispatch(R, [&](auto mt, auto wm) {
    return rt::argmax_partial_mma_launch<H, decltype(mt)::value,
                                         decltype(wm)::value>(
        hn, head, pval, pidx, R, D, V, vec, st);
  });
  if (err != 0) return err;
  rt::argmax_merge<H><<<R, 256, 0, st>>>(
      static_cast<const float*>(pval), static_cast<const int*>(pidx),
      (V + rt::LM_BN - 1) / rt::LM_BN, static_cast<int*>(tok),
      static_cast<float*>(mx));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int argmax_verify_q_block_cols() {
  static_assert(rt::LM_BN == rt::LH_THREADS, "one strip width for both");
  return rt::LM_BN;
}
const char* argmax_verify_q_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// hn (R, D) f32 or bf16 (bf16: D % 8 == 0, int4 D % 16 == 0, and hn
// 16-byte aligned), any R >= 1; q int8 (D, V) for bits 8 or packed
// (D/2, V) for bits 4; scale (V,) f32; pval/pidx (R, nblk) scratch with
// nblk = ceil(V / argmax_verify_q_block_cols()); tok (R,) int32, mx (R,)
// f32.
int argmax_verify_q_launch(const void* hn, const void* q, const void* scale,
                           void* pval, void* pidx, void* tok, void* mx, int R,
                           int D, int V, int bits, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* codes = static_cast<const int8_t*>(q);
  const float* s = static_cast<const float*>(scale);
  if (dtype == rt::DT_BF16) {
    if (D % (bits == 4 ? 16 : 8) || reinterpret_cast<uintptr_t>(hn) % 16)
      return static_cast<int>(cudaErrorInvalidValue);
    if (bits == 4)
      return run_mma(hn, rt::Int4Tile{{codes, s}}, pval, pidx, tok, mx, R, D,
                     V, st);
    return run_mma(hn, rt::Int8Tile{{codes, s}}, pval, pidx, tok, mx, R, D,
                   V, st);
  }
  if (bits == 4)
    return rt::argmax_verify_run<float>(hn, rt::Int4Cols{codes, s}, pval,
                                        pidx, tok, mx, R, D, V, st);
  return rt::argmax_verify_run<float>(hn, rt::Int8Cols{codes, s}, pval,
                                      pidx, tok, mx, R, D, V, st);
}

}  // extern "C"
