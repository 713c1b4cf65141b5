// Streaming LM-head argmax, the two passes and their launch, over any
// column reader (common.cuh); argmax_verify.cu and argmax_verify_q.cu
// instantiate it for fp32 hidden rows (fp heads, int8 and int4 codes), and
// argmax_merge for every instance. See argmax_verify.cu.
#pragma once

#include "lm_head_stream.cuh"

namespace rt {

template <typename T, typename W>
__global__ void __launch_bounds__(LH_THREADS)
argmax_partial(const T* __restrict__ hn, W w, float* __restrict__ pval,
               int* __restrict__ pidx, int R, int D, int V) {
  __shared__ __align__(16) float sh[W::P * LH_ROWS * LH_DC];
  __shared__ float sv[32];
  __shared__ int si[32];
  const int col = blockIdx.y * LH_THREADS + threadIdx.x;
  const int row0 = blockIdx.x * LH_ROWS;
  const int nb = min(LH_ROWS, R - row0);
  float acc[LH_ROWS];
  lm_head_column(hn, w, row0, nb, D, V, col, sh, acc);
  const bool in = col < V;
#pragma unroll
  for (int b = 0; b < LH_ROWS; ++b) {
    if (b < nb) {                            // uniform across the block
      float v = in ? acc[b] : -CUDART_INF_F;
      int i = in ? col : INT_MAX;
      block_best(v, i, sv, si);
      if (threadIdx.x == 0) {
        const size_t o = (size_t)(row0 + b) * gridDim.y + blockIdx.y;
        pval[o] = v;
        pidx[o] = i;
      }
    }
  }
}

// W only names the instance (a profiler tells the fp and quantized merges
// apart); the merge reads the partials alone.
template <typename W>
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
    if (before(ov, oi, v, i)) { v = ov; i = oi; }
  }
  block_best(v, i, sv, si);
  if (threadIdx.x == 0) { tok[b] = i; mx[b] = v; }
}

// Both passes on `stream`; returns the first launch error (0 if none).
// pval/pidx: (R, ceil(V / LH_THREADS)) scratch.
template <typename T, typename W>
int argmax_verify_run(const void* hn, W w, void* pval, void* pidx, void* tok,
                      void* mx, int R, int D, int V, cudaStream_t st) {
  const int nblk = (V + LH_THREADS - 1) / LH_THREADS;
  const dim3 grid((R + LH_ROWS - 1) / LH_ROWS, nblk);
  argmax_partial<T, W><<<grid, LH_THREADS, 0, st>>>(
      static_cast<const T*>(hn), w, static_cast<float*>(pval),
      static_cast<int*>(pidx), R, D, V);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  argmax_merge<W><<<R, 256, 0, st>>>(static_cast<const float*>(pval),
                                     static_cast<const int*>(pidx), nblk,
                                     static_cast<int*>(tok),
                                     static_cast<float*>(mx));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rt
