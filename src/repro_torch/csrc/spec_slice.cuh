// Speculative LM-head gather-dot over a slice of the hidden dimension, the
// first stage of the cluster-split exit gate (exit_gate.cu): one CTA of
// THREADS threads computes, for one row and the stored head rows
// [d_lo, d_hi),
//   out[j] = sum_{d_lo <= d < d_hi} hn_row[d] * W[d, ids_row[j]]   (j < k)
// in fp32, through a column reader of common.cuh (P hidden entries per
// stored element, as in spec_head.cuh). The CTAs of a cluster take
// disjoint slices and sum their partials in rank order; a SCALED reader's
// column scale is left to that caller, after the sum.
//
// The same strided layout as spec_head.cuh (W[d, ids[j]] for every d: one
// 32-byte sector per element), but a row's sectors are spread over the
// cluster's SMs: at D = 4096 and a cluster of 8 each thread takes two head
// rows, each with its k loads issued at once, and no SM streams more than
// 1/8 of the row's k * D sectors.
//
// Thread t sums d = d_lo + t, d_lo + t + THREADS, ... in order (a row's k
// loads issued before its k multiply-adds); each warp reduces with
// shuffles; thread j < k then adds the THREADS / 32 warp sums in warp order
// and returns out[j] (the other threads return 0).
#pragma once

#include "spec_head.cuh"

namespace rt {

template <int THREADS, typename T, typename W>
__device__ __forceinline__ float spec_slice(
    const T* __restrict__ hn_row, W w, const int* __restrict__ ids_row,
    int d_lo, int d_hi, int D, int V, int k, float (*red)[THREADS / 32]) {
  constexpr int P = W::P;
  constexpr int NW = THREADS / 32;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int Dp = D / P;                      // stored rows of the head
  int col[SH_MAXK];
  float acc[SH_MAXK];
#pragma unroll
  for (int j = 0; j < SH_MAXK; ++j) {
    col[j] = j < k ? spec_col(ids_row, j, V) : 0;
    acc[j] = 0.f;
  }
  for (int d = d_lo + threadIdx.x; d < d_hi; d += THREADS) {
    float x[P];
#pragma unroll
    for (int p = 0; p < P; ++p) x[p] = to_f(hn_row[p * Dp + d]);
    const size_t row = (size_t)d * V;
    float c[SH_MAXK][P];
#pragma unroll
    for (int j = 0; j < SH_MAXK; ++j)
      if (j < k) w.load(row + col[j], c[j]);
#pragma unroll
    for (int j = 0; j < SH_MAXK; ++j)
      if (j < k) {
#pragma unroll
        for (int p = 0; p < P; ++p) acc[j] = fmaf(x[p], c[j][p], acc[j]);
      }
  }
#pragma unroll
  for (int j = 0; j < SH_MAXK; ++j)
    if (j < k) {                             // k is the same for the CTA
      const float s = warp_sum(acc[j]);
      if (lane == 0) red[j][wid] = s;
    }
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x < k)
    for (int q = 0; q < NW; ++q) s += red[threadIdx.x][q];
  return s;
}

}  // namespace rt
