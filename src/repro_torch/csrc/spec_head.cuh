// Speculative LM-head gather-dot of spec_head_q.cu (the quantized tree
// gate): one CTA of SH_THREADS threads computes, for one row,
//   logits[j] = hn_row . W[:, ids_row[j]]     (j < k, fp32)
// over the (D, V) row-major head, read through a column reader
// (common.cuh): int8 codes, or plane-packed int4 bytes, where one byte at
// stored row d < D/2 feeds hidden entries d and d + D/2 and a column's sum
// is multiplied by its scale after the block reduction. The fused exit
// gates (exit_gate.cu, exit_gate_q.cu) spread a row over a cluster of
// CTAs instead (spec_slice.cuh): the same products, summed in another
// order. The fp spec head no longer runs this body: spec_head_gather.cu
// and spec_head.cu split it into a gather and a dot.
//
// Layout choice: the head stays (D, V) row-major, shared with the verify
// kernels, and the gather reads W[d, ids[j]] for every d — a strided read
// with a stride of V elements. Each of those reads costs one 32-byte
// sector, so a row moves k * D * 32 B (4 * 4096 * 32 B = 512 KB) from memory
// or L2 for k * D * sizeof(T) useful bytes (32 KB in bf16). Three ways to
// pay less: a V-major copy of the head (contiguous columns, but another
// copy of the head in card memory: 262 MB in bf16 for Llama-2-7B); a
// gather of each distinct column once, into a contiguous buffer that the
// dots then read (what the fp tree gate does since its ids are the step's
// B*N node tokens: one gather per step instead of one per exit point,
// spec_head_gather.cu); or fewer sectors per column (int4 halves them).
// At decode batch (B <= 8 rows) the AR gates take the cluster body.
//
// Thread t sums d = t, t + SH_THREADS, ... in order; each warp reduces with
// shuffles; thread j < k then adds the SH_THREADS / 32 warp sums in warp
// order. The D loop gives every thread k strided loads in flight.
#pragma once

#include "common.cuh"

namespace rt {

constexpr int SH_THREADS = 256;
constexpr int SH_MAXK = 8;

// Ids are clamped to [0, V) so a bad id cannot read outside the head.
__device__ __forceinline__ int spec_col(const int* ids_row, int j, int V) {
  return min(max(ids_row[j], 0), V - 1);
}

// red: (SH_MAXK, 32) shared scratch; out: SH_MAXK shared floats, holding
// the k logits for every thread of the CTA when the call returns.
// Each of a row's k gathered loads is followed by its multiply-adds. Issuing
// all k loads first (as the cluster gate's spec_slice.cuh does) was slower
// at the AR path's B=4 rows (32 launches per step) and faster at the tree's
// 160 rows (2-3 launches per step), in a one-off A/B of the two orders on
// an H100; choosing the order by row count is open.
template <typename T, typename W>
__device__ __forceinline__ void spec_head_row(
    const T* __restrict__ hn_row, W w,
    const int* __restrict__ ids_row, int D, int V, int k,
    float (*red)[32], float* out) {
  constexpr int P = W::P;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  constexpr int nw = SH_THREADS / 32;
  const int Dp = D / P;                      // stored rows of the head
  int col[SH_MAXK];
  float acc[SH_MAXK];
#pragma unroll
  for (int j = 0; j < SH_MAXK; ++j) {
    col[j] = j < k ? spec_col(ids_row, j, V) : 0;
    acc[j] = 0.f;
  }
  for (int d = threadIdx.x; d < Dp; d += SH_THREADS) {
    float x[P];
#pragma unroll
    for (int p = 0; p < P; ++p) x[p] = to_f(hn_row[p * Dp + d]);
    const size_t row = (size_t)d * V;
#pragma unroll
    for (int j = 0; j < SH_MAXK; ++j)
      if (j < k) {
        float c[P];
        w.load(row + col[j], c);
#pragma unroll
        for (int p = 0; p < P; ++p) acc[j] = fmaf(x[p], c[p], acc[j]);
      }
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
    if constexpr (W::SCALED) s *= w.scale(spec_col(ids_row, threadIdx.x, V));
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

// One CTA per row r: logits[r, j] for j < k (spec_head_q.cu).
template <typename T, typename W>
__global__ void __launch_bounds__(SH_THREADS)
spec_head_kernel(const T* __restrict__ hn, W w, const int* __restrict__ ids,
                 float* __restrict__ logits, int D, int V, int k) {
  __shared__ float red[SH_MAXK][32];
  __shared__ float s_out[SH_MAXK];
  const size_t r = blockIdx.x;
  spec_head_row(hn + r * D, w, ids + r * k, D, V, k, red, s_out);
  if (threadIdx.x < k) logits[r * k + threadIdx.x] = s_out[threadIdx.x];
}

template <typename T, typename W>
int spec_head_run(const void* hn, W w, const void* ids, void* logits, int R,
                  int D, int V, int k, cudaStream_t st) {
  spec_head_kernel<T, W><<<R, SH_THREADS, 0, st>>>(
      static_cast<const T*>(hn), w, static_cast<const int*>(ids),
      static_cast<float*>(logits), D, V, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rt
