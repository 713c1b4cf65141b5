// LM-head top-k: the streaming passes and their launch, over any column
// reader (common.cuh), and the launch of the tensor-core tile's passes
// over any tile reader (lm_head_mma.cuh). topk_verify.cu instantiates them
// for fp32 and bf16 hidden rows, topk_verify_q.cu and topk_verify_q4.cu
// for int8 and int4 codes. See topk_verify.cu.
#pragma once

#include "lm_head_mma.cuh"
#include "lm_head_stream.cuh"

namespace rt {

constexpr int TK_MAXK = 8;

// Whether `id` was selected in one of the rounds [0, j).
__device__ __forceinline__ bool taken(int id, const int (&sel)[TK_MAXK],
                                      int j) {
  bool t = false;
#pragma unroll
  for (int q = 0; q < TK_MAXK; ++q) t |= (q < j) && (sel[q] == id);
  return t;
}

template <typename T, typename W>
__global__ void __launch_bounds__(LH_THREADS)
topk_partial(const T* __restrict__ hn, W w, float* __restrict__ pval,
             int* __restrict__ pidx, int R, int D, int V, int k) {
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
      float cand = in ? acc[b] : -CUDART_INF_F;
      int cid = in ? col : INT_MAX;
      for (int j = 0; j < k; ++j) {
        float v = cand;
        int i = cid;
        block_best(v, i, sv, si);
        if (threadIdx.x == 0) {
          const size_t o =
              ((size_t)(row0 + b) * gridDim.y + blockIdx.y) * k + j;
          pval[o] = v;
          pidx[o] = i;
        }
        if (cid == i) { cand = -CUDART_INF_F; cid = INT_MAX; }
      }
    }
  }
}

// W only names the instance (see argmax_merge).
template <typename W>
__global__ void topk_merge(const float* __restrict__ pval,
                           const int* __restrict__ pidx, int ncand, int k,
                           int* __restrict__ ids, float* __restrict__ vals) {
  __shared__ float sv[32];
  __shared__ int si[32];
  const int b = blockIdx.x;
  const float* rv = pval + (size_t)b * ncand;
  const int* ri = pidx + (size_t)b * ncand;
  int sel[TK_MAXK];
#pragma unroll
  for (int q = 0; q < TK_MAXK; ++q) sel[q] = -1;
#pragma unroll
  for (int j = 0; j < TK_MAXK; ++j) {
    if (j < k) {                             // uniform across the block
      float v = -CUDART_INF_F;
      int i = INT_MAX;
      for (int t = threadIdx.x; t < ncand; t += blockDim.x) {
        const float ov = rv[t];
        const int oi = ri[t];
        if (!taken(oi, sel, j) && before(ov, oi, v, i)) {
          v = ov;
          i = oi;
        }
      }
      block_best(v, i, sv, si);
      sel[j] = i;
      if (threadIdx.x == 0) {
        ids[(size_t)b * k + j] = i;
        vals[(size_t)b * k + j] = v;
      }
    }
  }
}

// Both passes on `stream`; returns the first launch error (0 if none).
// pval/pidx: (R, ceil(V / LH_THREADS), k) scratch; 1 <= k <= TK_MAXK.
template <typename T, typename W>
int topk_verify_run(const void* hn, W w, void* pval, void* pidx, void* ids,
                    void* vals, int R, int D, int V, int k, cudaStream_t st) {
  const int nblk = (V + LH_THREADS - 1) / LH_THREADS;
  const dim3 grid((R + LH_ROWS - 1) / LH_ROWS, nblk);
  topk_partial<T, W><<<grid, LH_THREADS, 0, st>>>(
      static_cast<const T*>(hn), w, static_cast<float*>(pval),
      static_cast<int*>(pidx), R, D, V, k);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  topk_merge<W><<<R, 256, 0, st>>>(static_cast<const float*>(pval),
                                   static_cast<const int*>(pidx), nblk * k, k,
                                   static_cast<int*>(ids),
                                   static_cast<float*>(vals));
  return static_cast<int>(cudaGetLastError());
}

// The bf16 tile's two passes on `stream`: topk_partial_mma over head
// reader H in the row tile lm_mma_dispatch picks for R (lists of KP = 4
// for k <= 4, else 8), then topk_merge; returns the first launch error.
// vec is H's copy flag (Bf16Tile: 0 or 1; ByteTile: copy_width's bytes);
// pval/pidx: (R, ceil(V / LM_BN), k) scratch; 1 <= k <= TK_MAXK.
template <typename H>
static int topk_mma_run(const void* hn, H head, void* pval, void* pidx,
                        void* ids, void* vals, int R, int D, int V, int k,
                        int vec, cudaStream_t st) {
  const int err = lm_mma_dispatch(R, [&](auto mt, auto wm) {
    constexpr int MT = decltype(mt)::value, WM = decltype(wm)::value;
    return k <= 4 ? topk_partial_mma_launch<H, 4, MT, WM>(
                        hn, head, pval, pidx, R, D, V, k, vec, st)
                  : topk_partial_mma_launch<H, 8, MT, WM>(
                        hn, head, pval, pidx, R, D, V, k, vec, st);
  });
  if (err != 0) return err;
  const int nblk = (V + LM_BN - 1) / LM_BN;
  topk_merge<H><<<R, 256, 0, st>>>(static_cast<const float*>(pval),
                                   static_cast<const int*>(pidx), nblk * k, k,
                                   static_cast<int*>(ids),
                                   static_cast<float*>(vals));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rt
