// Streaming LM-head product on the fp32 CUDA cores, shared by the fp32
// instances of argmax_verify.cu, topk_verify.cu, argmax_verify_q.cu and
// topk_verify_q.cu. Their bf16 instances run the tensor-core tile of
// lm_head_mma.cuh instead.
//
// Bound on the H100: one column per thread and a 2-byte load per bf16
// element keep ~4 KB in flight per 128-thread CTA (LH_UNROLL loads a
// thread), far too little to hide device-memory latency, so these kernels
// are bound by load latency, not bytes (3.4x the byte bound at B=4 in
// bf16); at 160-320 rows the fp32 multiply-adds bound them (0.63-1.25 ms at
// the 67 TFLOP/s fp32 peak).
//
// Grid: (row groups, vocabulary strips). A CTA owns LH_THREADS consecutive
// vocabulary columns, one per thread, and a group of at most LH_ROWS rows
// of the (R, D) hidden input; any R is taken, in ceil(R / LH_ROWS) groups.
// For every stored row d of the head, neighbouring threads read
// neighbouring columns, so each warp load is one coalesced segment. The
// group's hidden rows are staged in shared memory LH_DC entries at a time
// and read as 16-byte broadcasts (one shared load per four multiply-adds).
// Each thread sums its column for its rows in fp32, sequentially over d, so
// identical columns give bit-identical logits whatever the row count (the
// tensor-core tile keeps the same property with one MMA shape and one
// k-order for every R).
//
// The head is read through a column reader (common.cuh): fp weights, int8
// codes, or plane-packed int4 bytes, whose one byte at stored row d < D/2
// holds the codes of logical rows d and d + D/2 — the stage then holds both
// halves of each hidden chunk. A scaled reader's column sum is multiplied
// by its column scale once, before the caller takes its per-CTA partial.
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
// sh: W::P * LH_ROWS * LH_DC floats of 16-byte aligned shared memory.
template <typename T, typename W>
__device__ __forceinline__ void lm_head_column(
    const T* __restrict__ hn, W w, int row0, int nb, int D, int V,
    int col, float* sh, float (&acc)[LH_ROWS]) {
  static_assert(LH_UNROLL % 4 == 0 && LH_DC % LH_UNROLL == 0, "tiling");
  constexpr int P = W::P;
#pragma unroll
  for (int b = 0; b < LH_ROWS; ++b) acc[b] = 0.f;
  const bool in = col < V;
  const T* hg = hn + (size_t)row0 * D;
  const int Dp = D / P;                      // stored rows of the head
  for (int d0 = 0; d0 < Dp; d0 += LH_DC) {
    const int dc = min(LH_DC, Dp - d0);
    __syncthreads();
    for (int t = threadIdx.x; t < P * nb * LH_DC; t += blockDim.x) {
      const int pb = t / LH_DC, dd = t - pb * LH_DC;
      int p = 0, b = pb;                     // pb = p * nb + b
      if constexpr (P > 1) { p = pb / nb; b = pb - p * nb; }
      sh[(p * LH_ROWS + b) * LH_DC + dd] =
          dd < dc ? to_f(hg[(size_t)b * D + p * Dp + d0 + dd]) : 0.f;
    }
    __syncthreads();
    if (!in) continue;
    const size_t wp = (size_t)d0 * V + col;
    int dd = 0;
    for (; dd + LH_UNROLL <= dc; dd += LH_UNROLL) {
      float x[LH_UNROLL][P];
#pragma unroll
      for (int u = 0; u < LH_UNROLL; ++u)
        w.load(wp + (size_t)(dd + u) * V, x[u]);
#pragma unroll
      for (int b = 0; b < LH_ROWS; ++b) {
        if (b < nb) {
          float a = acc[b];
#pragma unroll
          for (int p = 0; p < P; ++p) {
            const float4* s4 = reinterpret_cast<const float4*>(
                sh + (p * LH_ROWS + b) * LH_DC + dd);
#pragma unroll
            for (int q = 0; q < LH_UNROLL / 4; ++q) {
              const float4 s = s4[q];
              a = fmaf(s.x, x[4 * q][p], a);
              a = fmaf(s.y, x[4 * q + 1][p], a);
              a = fmaf(s.z, x[4 * q + 2][p], a);
              a = fmaf(s.w, x[4 * q + 3][p], a);
            }
          }
          acc[b] = a;
        }
      }
    }
    for (; dd < dc; ++dd) {
      float x[P];
      w.load(wp + (size_t)dd * V, x);
#pragma unroll
      for (int b = 0; b < LH_ROWS; ++b)
        if (b < nb) {
#pragma unroll
          for (int p = 0; p < P; ++p)
            acc[b] = fmaf(sh[(p * LH_ROWS + b) * LH_DC + dd], x[p], acc[b]);
        }
    }
  }
  if constexpr (W::SCALED) {
    if (in) {
      const float s = w.scale(col);
#pragma unroll
      for (int b = 0; b < LH_ROWS; ++b) acc[b] *= s;
    }
  }
}

}  // namespace rt
