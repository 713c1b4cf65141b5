// Streaming LM-head argmax: token[b] = argmax_v (hn[b] . W[:, v]), fp32.
//
// Replaces the Pallas kernel argmax_verify_fused (_verify_kernel) in
// src/repro/kernels/exit_gate/exit_gate.py. On the TPU the vocabulary tiles
// run one after another on one core with a running (max, argmax) in SMEM.
// Here the tiles run in parallel: pass 1 gives each CTA a 128-column strip
// and writes one (max, argmax) partial per (row, CTA); pass 2 merges the
// partials of a row in one CTA. Both passes use rt::before, so equal maxima
// resolve to the lowest id, and columns >= V never win. The (B, V) logits
// are never written.
//
// Bound on the H100: bytes. One pass over the head, D*V*sizeof(T)
// (4096 * 32000 * 2 B = 262 MB for Llama-2-7B in bf16, ~78 us at
// 3.35 TB/s); the B*D*V multiply-adds are far below the fp32 rate at B <= 8.
// The design keeps the read coalesced (one column per thread), keeps
// LH_UNROLL loads in flight per thread, and spreads V/128 = 250 CTAs over
// the 132 SMs. A split over D, or TMA tiles, is later work.
#include "lm_head_stream.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(rt::LH_THREADS)
argmax_partial(const T* __restrict__ hn, const T* __restrict__ w,
               float* __restrict__ pval, int* __restrict__ pidx, int B,
               int D, int V) {
  __shared__ float sh[rt::LH_MAXB * rt::LH_DC];
  __shared__ float sv[32];
  __shared__ int si[32];
  const int col = blockIdx.x * rt::LH_THREADS + threadIdx.x;
  float acc[rt::LH_MAXB];
  rt::lm_head_column(hn, w, B, D, V, col, sh, acc);
  const bool in = col < V;
#pragma unroll
  for (int b = 0; b < rt::LH_MAXB; ++b) {
    if (b < B) {                             // uniform across the block
      float v = in ? acc[b] : -CUDART_INF_F;
      int i = in ? col : INT_MAX;
      rt::block_best(v, i, sv, si);
      if (threadIdx.x == 0) {
        pval[(size_t)b * gridDim.x + blockIdx.x] = v;
        pidx[(size_t)b * gridDim.x + blockIdx.x] = i;
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
int argmax_verify_max_rows() { return rt::LH_MAXB; }
const char* argmax_verify_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// hn (B, D), w (D, V) of one dtype; pval/pidx (B, nblk) scratch with
// nblk = ceil(V / argmax_verify_block_cols()); tok (B,) int32, mx (B,) f32.
int argmax_verify_launch(const void* hn, const void* w, void* pval,
                         void* pidx, void* tok, void* mx, int B, int D, int V,
                         int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nblk = (V + rt::LH_THREADS - 1) / rt::LH_THREADS;
  if (dtype == rt::DT_BF16) {
    argmax_partial<__nv_bfloat16><<<nblk, rt::LH_THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(hn),
        static_cast<const __nv_bfloat16*>(w), static_cast<float*>(pval),
        static_cast<int*>(pidx), B, D, V);
  } else {
    argmax_partial<float><<<nblk, rt::LH_THREADS, 0, st>>>(
        static_cast<const float*>(hn), static_cast<const float*>(w),
        static_cast<float*>(pval), static_cast<int*>(pidx), B, D, V);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  argmax_merge<<<B, 256, 0, st>>>(static_cast<const float*>(pval),
                                  static_cast<const int*>(pidx), nblk,
                                  static_cast<int*>(tok),
                                  static_cast<float*>(mx));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
