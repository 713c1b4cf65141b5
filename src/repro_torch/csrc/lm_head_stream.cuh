// Streaming LM-head product shared by argmax_verify.cu and topk_verify.cu.
//
// Each CTA owns LH_THREADS consecutive vocabulary columns, one per thread:
// for every row d of the (D, V) row-major head, neighbouring threads read
// neighbouring columns, so each warp load is one coalesced segment. The
// (B, D) hidden rows are staged in shared memory LH_DC entries at a time and
// read as broadcasts. Each thread sums its column for all B rows in fp32,
// sequentially over d, so identical columns give bit-identical logits.
#pragma once

#include "common.cuh"

namespace rt {

constexpr int LH_THREADS = 128;   // vocabulary columns per CTA
constexpr int LH_DC = 256;        // hidden entries staged per chunk
constexpr int LH_MAXB = 8;        // rows per call (decode batch)
constexpr int LH_UNROLL = 16;     // head loads in flight per thread

template <typename T>
__device__ __forceinline__ void lm_head_column(
    const T* __restrict__ hn, const T* __restrict__ w, int B, int D, int V,
    int col, float* sh, float (&acc)[LH_MAXB]) {
#pragma unroll
  for (int b = 0; b < LH_MAXB; ++b) acc[b] = 0.f;
  const bool in = col < V;
  for (int d0 = 0; d0 < D; d0 += LH_DC) {
    const int dc = min(LH_DC, D - d0);
    __syncthreads();
    for (int t = threadIdx.x; t < B * LH_DC; t += blockDim.x) {
      const int b = t / LH_DC, dd = t - b * LH_DC;
      sh[t] = dd < dc ? to_f(hn[(size_t)b * D + d0 + dd]) : 0.f;
    }
    __syncthreads();
    if (!in) continue;
    const T* wp = w + (size_t)d0 * V + col;
    int dd = 0;
    for (; dd + LH_UNROLL <= dc; dd += LH_UNROLL) {
      float x[LH_UNROLL];
#pragma unroll
      for (int u = 0; u < LH_UNROLL; ++u)
        x[u] = to_f(wp[(size_t)(dd + u) * V]);
#pragma unroll
      for (int u = 0; u < LH_UNROLL; ++u) {
#pragma unroll
        for (int b = 0; b < LH_MAXB; ++b)
          if (b < B) acc[b] = fmaf(sh[b * LH_DC + dd + u], x[u], acc[b]);
      }
    }
    for (; dd < dc; ++dd) {
      const float x = to_f(wp[(size_t)dd * V]);
#pragma unroll
      for (int b = 0; b < LH_MAXB; ++b)
        if (b < B) acc[b] = fmaf(sh[b * LH_DC + dd], x, acc[b]);
    }
  }
}

}  // namespace rt
