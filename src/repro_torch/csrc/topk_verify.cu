// Streaming LM-head top-k: ids[b, :k] sorted by logit descending, then by
// id ascending (exactly lax.top_k on the materialized logits), fp32.
//
// Replaces the Pallas kernel topk_verify_fused (_topk_kernel) in
// src/repro/kernels/exit_gate/exit_gate.py, which folds vocabulary tiles in
// order into a running sorted top-k list. Here pass 1 gives each CTA a
// 128-column strip and a group of up to 8 rows (any row count R; the
// streaming layout of argmax_verify.cu, lm_head_stream.cuh) and extracts
// the strip's own top-k per row by k rounds of a block-wide best under
// rt::before, excluding the ids already taken; pass 2 runs the same k
// rounds over the (nblk * k) candidates of a row. A global top-k entry is
// always inside its strip's top-k, and rt::before is a total order, so the
// merge keeps value-descending, id-ascending order across CTAs.
//
// Bound on the H100: bytes at decode batch, one pass over the (D, V) head
// (262 MB in bf16 for Llama-2-7B, ~78 us at 3.35 TB/s); with many rows the
// 2*R*D*V fp32 operations. The k extraction rounds touch only registers and
// 128 B of shared memory per round.
#include "lm_head_stream.cuh"

namespace {

constexpr int TK_MAXK = 8;

// Whether `id` was selected in one of the rounds [0, j).
__device__ __forceinline__ bool taken(int id, const int (&sel)[TK_MAXK],
                                      int j) {
  bool t = false;
#pragma unroll
  for (int q = 0; q < TK_MAXK; ++q) t |= (q < j) && (sel[q] == id);
  return t;
}

template <typename T>
__global__ void __launch_bounds__(rt::LH_THREADS)
topk_partial(const T* __restrict__ hn, const T* __restrict__ w,
             float* __restrict__ pval, int* __restrict__ pidx, int R, int D,
             int V, int k) {
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
      float cand = in ? acc[b] : -CUDART_INF_F;
      int cid = in ? col : INT_MAX;
      for (int j = 0; j < k; ++j) {
        float v = cand;
        int i = cid;
        rt::block_best(v, i, sv, si);
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
        if (!taken(oi, sel, j) && rt::before(ov, oi, v, i)) {
          v = ov;
          i = oi;
        }
      }
      rt::block_best(v, i, sv, si);
      sel[j] = i;
      if (threadIdx.x == 0) {
        ids[(size_t)b * k + j] = i;
        vals[(size_t)b * k + j] = v;
      }
    }
  }
}

}  // namespace

extern "C" {

int topk_verify_block_cols() { return rt::LH_THREADS; }
int topk_verify_max_k() { return TK_MAXK; }
const char* topk_verify_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// hn (R, D), w (D, V) of one dtype, any R >= 1; pval/pidx (R, nblk, k)
// scratch with nblk = ceil(V / topk_verify_block_cols()); ids (R, k) int32,
// vals (R, k) f32.
int topk_verify_launch(const void* hn, const void* w, void* pval, void* pidx,
                       void* ids, void* vals, int R, int D, int V, int k,
                       int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nblk = (V + rt::LH_THREADS - 1) / rt::LH_THREADS;
  const dim3 grid((R + rt::LH_ROWS - 1) / rt::LH_ROWS, nblk);
  if (dtype == rt::DT_BF16) {
    topk_partial<__nv_bfloat16><<<grid, rt::LH_THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(hn),
        static_cast<const __nv_bfloat16*>(w), static_cast<float*>(pval),
        static_cast<int*>(pidx), R, D, V, k);
  } else {
    topk_partial<float><<<grid, rt::LH_THREADS, 0, st>>>(
        static_cast<const float*>(hn), static_cast<const float*>(w),
        static_cast<float*>(pval), static_cast<int*>(pidx), R, D, V, k);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  topk_merge<<<R, 256, 0, st>>>(static_cast<const float*>(pval),
                                static_cast<const int*>(pidx), nblk * k, k,
                                static_cast<int*>(ids),
                                static_cast<float*>(vals));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
