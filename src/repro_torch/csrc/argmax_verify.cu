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
// (the head as a bf16 GEMM operand) are later work.
#include "lm_head_stream.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(rt::LH_THREADS)
argmax_partial(const T* __restrict__ hn, const T* __restrict__ w,
               float* __restrict__ pval, int* __restrict__ pidx, int R,
               int D, int V) {
  __shared__ __align__(16) float sh[rt::LH_ROWS * rt::LH_DC];
  __shared__ float sv[32];
  __shared__ int si[32];
  const int col = blockIdx.y * rt::LH_THREADS + threadIdx.x;
  const int row0 = blockIdx.x * rt::LH_ROWS;
  const int nb = min(rt::LH_ROWS, R - row0);
  float acc[rt::LH_ROWS];
  rt::lm_head_column(hn, w, row0, nb, D, V, col, sh, acc);
  const bool in = col < V;
#pragma unroll
  for (int b = 0; b < rt::LH_ROWS; ++b) {
    if (b < nb) {                            // uniform across the block
      float v = in ? acc[b] : -CUDART_INF_F;
      int i = in ? col : INT_MAX;
      rt::block_best(v, i, sv, si);
      if (threadIdx.x == 0) {
        const size_t o = (size_t)(row0 + b) * gridDim.y + blockIdx.y;
        pval[o] = v;
        pidx[o] = i;
      }
    }
  }
}

__global__ void argmax_merge(const float* __restrict__ pval,
                             const int* __restrict__ pidx, int nblk,
                             int* __restrict__ tok, float* __restrict__ mx) {
  __shared__ float sv[32];
  __shared__ int si[32];
  const int b = blockIdx.x;
  float v = -CUDART_INF_F;
  int i = INT_MAX;
  for (int t = threadIdx.x; t < nblk; t += blockDim.x) {
    const float ov = pval[(size_t)b * nblk + t];
    const int oi = pidx[(size_t)b * nblk + t];
    if (rt::before(ov, oi, v, i)) { v = ov; i = oi; }
  }
  rt::block_best(v, i, sv, si);
  if (threadIdx.x == 0) { tok[b] = i; mx[b] = v; }
}

}  // namespace

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
  const int nblk = (V + rt::LH_THREADS - 1) / rt::LH_THREADS;
  const dim3 grid((R + rt::LH_ROWS - 1) / rt::LH_ROWS, nblk);
  if (dtype == rt::DT_BF16) {
    argmax_partial<__nv_bfloat16><<<grid, rt::LH_THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(hn),
        static_cast<const __nv_bfloat16*>(w), static_cast<float*>(pval),
        static_cast<int*>(pidx), R, D, V);
  } else {
    argmax_partial<float><<<grid, rt::LH_THREADS, 0, st>>>(
        static_cast<const float*>(hn), static_cast<const float*>(w),
        static_cast<float*>(pval), static_cast<int*>(pidx), R, D, V);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  argmax_merge<<<R, 256, 0, st>>>(static_cast<const float*>(pval),
                                  static_cast<const int*>(pidx), nblk,
                                  static_cast<int*>(tok),
                                  static_cast<float*>(mx));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
