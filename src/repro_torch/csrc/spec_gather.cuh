// Column gather of a speculative LM head, the first of the two stages of
// the spec head (spec_head_gather.cu for an fp head, spec_head_gather_q.cu
// for int8 or plane-packed int4 codes): for c < C,
//   cols[c, :] = w[:, ids[c]]        (an exact copy, rows stored rows)
//   scales[c]  = scale[ids[c]]       (SCALED only: a quantized head)
// from the (rows, V) row-major head into a contiguous (C, rows) buffer of
// the head's element type. Ids are clamped to [0, V) as every spec-head
// kernel clamps them (spec_col in spec_head.cuh). Codes stay codes: the
// dot applies a column's scale after its fp32 sum.
//
// Bound on the H100: a strided read of the head pays one 32-byte sector
// per element, C * rows sectors (the tree's B*N = 160 columns at D = 4096:
// 655k sectors, 21 MB, ~6.3 us at 3.35 TB/s, in bf16 or int8; half of that
// for int4's D/2 stored rows); the (C, rows) write is contiguous. Design:
// a CTA takes a tile of GC = 16 columns by GD = 128 stored rows; each of
// its 256 threads takes one column and issues its GL = 8 loads (rows tdg,
// tdg + 16, ...) before it stores any, so the card keeps the whole
// gather's sector reads in flight at once. The tile is transposed through
// shared memory (rows padded by 16 bytes) and written as 16-byte stores,
// consecutive threads on consecutive 16 bytes of one row of cols; a row
// count that is not a multiple of 16 bytes, or an unaligned cols, is
// written element by element. The CTAs of the first row tile also copy
// their columns' scales.
// Numbers: PERF.md, from chip_smoke.py and scripts/ab_spec_head.py.
#pragma once

#include "common.cuh"

namespace rt {

constexpr int GC = 16;                 // columns per CTA
constexpr int GD = 128;                // stored rows per CTA
constexpr int GT = 256;                // threads per CTA
constexpr int GL = GC * GD / GT;       // loads in flight per thread

template <typename T, bool SCALED>
__global__ void __launch_bounds__(GT)
spec_gather_kernel(const T* __restrict__ w, const float* __restrict__ scale,
                   const int* __restrict__ ids, T* __restrict__ cols,
                   float* __restrict__ scales, int C, int rows, int V,
                   int vec) {
  constexpr int E = 16 / sizeof(T);    // elements per 16-byte store
  constexpr int TS = GD + E;           // padded tile row, elements
  __shared__ __align__(16) unsigned char tile_b[GC * TS * sizeof(T)];
  T* tile = reinterpret_cast<T*>(tile_b);
  const int c0 = blockIdx.x * GC, d0 = blockIdx.y * GD;
  const int tc = threadIdx.x % GC, tdg = threadIdx.x / GC;
  // a column or row past the edge reads a valid element; it is never
  // written out
  const int c = min(c0 + tc, C - 1);
  const int col = min(max(__ldg(ids + c), 0), V - 1);
  T x[GL];
#pragma unroll
  for (int i = 0; i < GL; ++i) {
    const int d = min(d0 + tdg + i * (GT / GC), rows - 1);
    x[i] = __ldg(w + (size_t)d * V + col);
  }
  if constexpr (SCALED) {
    if (blockIdx.y == 0 && tdg == 0 && c0 + tc < C)
      scales[c0 + tc] = __ldg(scale + col);
  }
#pragma unroll
  for (int i = 0; i < GL; ++i) tile[tc * TS + tdg + i * (GT / GC)] = x[i];
  __syncthreads();
  if (vec) {
    for (int q = threadIdx.x; q < GC * GD / E; q += GT) {
      const int r = q / (GD / E), e = (q % (GD / E)) * E;
      if (c0 + r < C && d0 + e < rows)   // rows % E == 0: inside
        *reinterpret_cast<uint4*>(cols + (size_t)(c0 + r) * rows + d0 + e) =
            *reinterpret_cast<const uint4*>(tile + r * TS + e);
    }
  } else {
    for (int q = threadIdx.x; q < GC * GD; q += GT) {
      const int r = q / GD, e = q % GD;
      if (c0 + r < C && d0 + e < rows)
        cols[(size_t)(c0 + r) * rows + d0 + e] = tile[r * TS + e];
    }
  }
}

// One launch; scale and scales are read only when SCALED
template <typename T, bool SCALED>
int spec_gather_run(const void* w, const void* scale, const void* ids,
                    void* cols, void* scales, int C, int rows, int V,
                    cudaStream_t st) {
  if (C < 1 || rows < 1 || V < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = rows % (16 / static_cast<int>(sizeof(T))) == 0 &&
                  reinterpret_cast<uintptr_t>(cols) % 16 == 0;
  const dim3 grid((C + GC - 1) / GC, (rows + GD - 1) / GD);
  spec_gather_kernel<T, SCALED><<<grid, GT, 0, st>>>(
      static_cast<const T*>(w), static_cast<const float*>(scale),
      static_cast<const int*>(ids), static_cast<T*>(cols),
      static_cast<float*>(scales), C, rows, V, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rt
