// Streaming LM-head product shared by argmax_verify.cu and topk_verify.cu.
//
// Grid: (row groups, vocabulary strips). A CTA owns LH_THREADS consecutive
// vocabulary columns, one per thread, and a group of at most LH_ROWS rows
// of the (R, D) hidden input; any R is taken, in ceil(R / LH_ROWS) groups.
// For every row d of the (D, V) row-major head, neighbouring threads read
// neighbouring columns, so each warp load is one coalesced segment. The
// group's hidden rows are staged in shared memory LH_DC entries at a time
// and read as 16-byte broadcasts (one shared load per four multiply-adds).
// Each thread sums its column for its rows in fp32, sequentially over d, so
// identical columns give bit-identical logits whatever the row count.
//
// The row group is blockIdx.x, the fastest-varying grid index, so the CTAs
// that read one vocabulary strip are launched next to each other: with many
// rows (the tree acceptance walk verifies B*N node rows) the strip is read
// from device memory about once and from L2 by the other groups.
#pragma once

#include "common.cuh"

namespace rt {

constexpr int LH_THREADS = 128;   // vocabulary columns per CTA
constexpr int LH_DC = 256;        // hidden entries staged per chunk
constexpr int LH_ROWS = 8;        // rows per CTA (one row group)
constexpr int LH_UNROLL = 16;     // head loads in flight per thread

// Rows [row0, row0 + nb) of hn against column `col`; acc[b] for b < nb.
template <typename T>
__device__ __forceinline__ void lm_head_column(
    const T* __restrict__ hn, const T* __restrict__ w, int row0, int nb,
    int D, int V, int col, float* sh, float (&acc)[LH_ROWS]) {
  static_assert(LH_UNROLL % 4 == 0 && LH_DC % LH_UNROLL == 0, "tiling");
#pragma unroll
  for (int b = 0; b < LH_ROWS; ++b) acc[b] = 0.f;
  const bool in = col < V;
  const T* hg = hn + (size_t)row0 * D;
  for (int d0 = 0; d0 < D; d0 += LH_DC) {
    const int dc = min(LH_DC, D - d0);
    __syncthreads();
    for (int t = threadIdx.x; t < nb * LH_DC; t += blockDim.x) {
      const int b = t / LH_DC, dd = t - b * LH_DC;
      sh[t] = dd < dc ? to_f(hg[(size_t)b * D + d0 + dd]) : 0.f;
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
      for (int b = 0; b < LH_ROWS; ++b) {
        if (b < nb) {
          const float4* s4 =
              reinterpret_cast<const float4*>(sh + b * LH_DC + dd);
          float a = acc[b];
#pragma unroll
          for (int q = 0; q < LH_UNROLL / 4; ++q) {
            const float4 s = s4[q];
            a = fmaf(s.x, x[4 * q], a);
            a = fmaf(s.y, x[4 * q + 1], a);
            a = fmaf(s.z, x[4 * q + 2], a);
            a = fmaf(s.w, x[4 * q + 3], a);
          }
          acc[b] = a;
        }
      }
    }
    for (; dd < dc; ++dd) {
      const float x = to_f(wp[(size_t)dd * V]);
#pragma unroll
      for (int b = 0; b < LH_ROWS; ++b)
        if (b < nb) acc[b] = fmaf(sh[b * LH_DC + dd], x, acc[b]);
    }
  }
}

}  // namespace rt
