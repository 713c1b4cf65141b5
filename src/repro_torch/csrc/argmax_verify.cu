// Streaming LM-head argmax: token[b] = argmax_v (hn[b] . W[:, v]), fp32.
//
// Replaces the Pallas kernel argmax_verify_fused (_verify_kernel) in
// src/repro/kernels/exit_gate/exit_gate.py, whose grid is (rows, vocabulary
// tiles): the tiles run one after another on one core with a running
// (max, argmax) in SMEM. Here the tiles run in parallel: pass 1 gives each
// CTA a 128-column strip and a tile of rows (any row count R) and writes
// one (max, argmax) partial per (row, strip); pass 2 (argmax_merge) merges
// the partials of a row in one CTA. Both passes use rt::before, so equal
// maxima resolve to the lowest id, and columns >= V never win. The (R, V)
// logits are never written.
//
// Which instance runs which body:
//   bf16 — argmax_partial_mma (lm_head_mma.cuh) on the tensor cores: the
//          head and the hidden rows stream through a cp.async ring into
//          shared memory and are multiplied with mma.sync m16n8k16 (bf16 x
//          bf16 -> fp32), one instruction shape and one k-order for every
//          R, so a row's logits do not depend on the rows verified with it;
//   fp32 — argmax_partial (argmax_verify.cuh over lm_head_stream.cuh): one
//          column per thread on the fp32 CUDA cores, groups of 8 rows, so
//          its sums stay those of the plain fp32 version (TF32 would not).
//
// Bound on the H100 (700 W): at decode batch (R <= 16) bytes, one pass over
// the head, D*V*2 B in bf16 (4096 * 32000 * 2 B = 262 MB for Llama-2-7B,
// 0.078 ms at 3.35 TB/s). The first (streaming) body kept ~4 KB in flight
// per CTA and reached 3.4x that bound (0.263 ms at B=4); the bf16 body keeps
// two 16 KB chunks of head in flight per CTA, about two CTAs per SM at
// V = 32000, in 16-byte copies (0.093 ms, 1.2x the bound). The tree
// acceptance walk verifies B*N node rows (160-320): the bound stays
// 0.079-0.085 ms (the bytes at 160 rows, the 84 GFLOP at the bf16 peak at
// 320), where the fp32 CUDA-core peak floored the first body at 0.63-1.25
// ms (it took 2.09 / 4.01 ms); the bf16 body reads the head once per tile
// of up to 256 rows (two warp rows, 8 warps) and takes 0.17 / 0.32 ms
// (cuBLAS bf16 matmul + argmax: 0.11 / 0.14 ms). Numbers: PERF.md, from
// chip_smoke.py and scripts/ab_argmax_verify.py.
#include "argmax_verify.cuh"
#include "lm_head_mma.cuh"

extern "C" {

int argmax_verify_block_cols() {
  static_assert(rt::LM_BN == rt::LH_THREADS, "one strip width for both");
  return rt::LM_BN;
}
const char* argmax_verify_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// hn (R, D), w (D, V) of one dtype, any R >= 1 (bf16: D % 8 == 0 and hn
// 16-byte aligned); pval/pidx (R, nblk) scratch with nblk = ceil(V /
// argmax_verify_block_cols()); tok (R,) int32, mx (R,) f32.
int argmax_verify_launch(const void* hn, const void* w, void* pval,
                         void* pidx, void* tok, void* mx, int R, int D, int V,
                         int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rt::DT_BF16) {
    if (D % 8 || reinterpret_cast<uintptr_t>(hn) % 16)
      return static_cast<int>(cudaErrorInvalidValue);
    const int vec = V % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
    const rt::Bf16Tile head{static_cast<const __nv_bfloat16*>(w)};
    const int err = rt::lm_mma_dispatch(R, [&](auto mt, auto wm) {
      return rt::argmax_partial_mma_launch<rt::Bf16Tile, decltype(mt)::value,
                                           decltype(wm)::value>(
          hn, head, pval, pidx, R, D, V, vec, st);
    });
    if (err != 0) return err;
    using T = __nv_bfloat16;
    rt::argmax_merge<rt::FpCols<T>><<<R, 256, 0, st>>>(
        static_cast<const float*>(pval), static_cast<const int*>(pidx),
        (V + rt::LM_BN - 1) / rt::LM_BN, static_cast<int*>(tok),
        static_cast<float*>(mx));
    return static_cast<int>(cudaGetLastError());
  }
  return rt::argmax_verify_run<float>(
      hn, rt::FpCols<float>{static_cast<const float*>(w)}, pval, pidx, tok,
      mx, R, D, V, st);
}

}  // extern "C"
