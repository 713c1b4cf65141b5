// Speculative LM-head gather-dot shared by spec_head.cu and exit_gate.cu:
// one CTA of SH_THREADS threads computes, for one row,
//   logits[j] = hn_row . W[:, ids_row[j]]     (j < k, fp32)
// over the (D, V) row-major head. Both kernels take this one body, so the
// spec-head features and the fused gate's cannot drift.
//
// Layout choice: the head stays (D, V) row-major, shared with the verify
// kernels, and the gather reads W[d, ids[j]] for every d — a strided read
// with a stride of V elements. Each of those reads costs one 32-byte
// sector, so a row moves k * D * 32 B (4 * 4096 * 32 B = 512 KB) from memory
// or L2 for k * D * sizeof(T) useful bytes (32 KB in bf16). A V-major copy
// of the head would make the gather contiguous but costs another 262 MB of
// card memory for Llama-2-7B. At decode batch (B <= 8 rows: <= 4 MB per exit
// point) and for the tree gate (B*N = 160-320 node rows: 80-160 MB of
// sectors per exit point, much of it L2 hits because sibling nodes share
// parents' candidate columns) the strided gather is the cheaper side.
//
// Thread t sums d = t, t + SH_THREADS, ... in order; each warp reduces with
// shuffles; thread j < k then adds the SH_THREADS / 32 warp sums in warp
// order. The D loop gives every thread k strided loads in flight.
#pragma once

#include "common.cuh"

namespace rt {

constexpr int SH_THREADS = 256;
constexpr int SH_MAXK = 8;

// red: (SH_MAXK, 32) shared scratch; out: SH_MAXK shared floats, holding
// the k logits for every thread of the CTA when the call returns. Ids are
// clamped to [0, V) so a bad id cannot read outside the head.
template <typename T>
__device__ __forceinline__ void spec_head_row(
    const T* __restrict__ hn_row, const T* __restrict__ w,
    const int* __restrict__ ids_row, int D, int V, int k,
    float (*red)[32], float* out) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  constexpr int nw = SH_THREADS / 32;
  int col[SH_MAXK];
  float acc[SH_MAXK];
#pragma unroll
  for (int j = 0; j < SH_MAXK; ++j) {
    col[j] = j < k ? min(max(ids_row[j], 0), V - 1) : 0;
    acc[j] = 0.f;
  }
  for (int d = threadIdx.x; d < D; d += SH_THREADS) {
    const float x = to_f(hn_row[d]);
    const T* wr = w + (size_t)d * V;
#pragma unroll
    for (int j = 0; j < SH_MAXK; ++j)
      if (j < k) acc[j] = fmaf(x, to_f(wr[col[j]]), acc[j]);
  }
#pragma unroll
  for (int j = 0; j < SH_MAXK; ++j) {
    const float s = warp_sum(acc[j]);
    if (lane == 0) red[j][wid] = s;
  }
  __syncthreads();
  if (threadIdx.x < k) {
    float s = 0.f;
    for (int q = 0; q < nw; ++q) s += red[threadIdx.x][q];
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

}  // namespace rt
