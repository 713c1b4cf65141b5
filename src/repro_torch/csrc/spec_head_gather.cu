// Column gather of the speculative LM head, the first of the two stages of
// spec_head_logits: cols[c, :] = W[:, ids[c]] for c < C, from the (D, V)
// row-major head into a contiguous (C, D) buffer of the head's dtype (an
// exact copy). Ids are clamped to [0, V), as every spec-head kernel
// clamps them (spec_col in spec_head.cuh).
//
// With spec_head.cu (the dot over the gathered buffer) it replaces the
// Pallas kernel spec_head_logits (_kernel) in
// src/repro/kernels/spec_head/spec_head.py, whose (B, k, D/Dt) grid
// streams column spec_ids[b, j] block by block through a scalar-prefetched
// index map. Why two stages: the tree step (core/engine.py) asks the spec
// head, at every exit point that runs its gate, for the k children's
// columns of each of its B*N nodes. Every such id is one of the row's N
// node tokens, and the node tokens do not change within a step. So the
// step gathers the B*N node tokens' columns once, at the first exit point
// that runs the gate, and each exit point then reads only the contiguous
// buffer (spec_head.cu). spec_head_logits alone gathers its R*k ids.
//
// Bound on the H100: a strided read of the head pays one 32-byte sector
// per element, C * D sectors (the tree's B*N = 160 columns at D = 4096:
// 655k sectors, 21 MB, ~6.3 us at 3.35 TB/s, for 1.3 MB of useful bf16);
// the (C, D) write is contiguous. Design: a CTA takes a tile of GC = 16
// columns by GD = 128 head rows; each of its 256 threads takes one column
// and issues its GL = 8 loads (rows tdg, tdg + 16, ...) before it stores
// any, so the card keeps the whole gather's sector reads in flight at
// once. The tile is transposed through shared memory (rows padded by 16
// bytes) and written as 16-byte stores, consecutive threads on
// consecutive 16 bytes of one row of cols; a D that is not a multiple of
// 16 bytes, or an unaligned cols, is written element by element.
// Numbers: PERF.md, from chip_smoke.py and scripts/ab_spec_head.py.
#include "common.cuh"

namespace {

constexpr int GC = 16;                 // columns per CTA
constexpr int GD = 128;                // head rows per CTA
constexpr int GT = 256;                // threads per CTA
constexpr int GL = GC * GD / GT;       // loads in flight per thread

template <typename T>
__global__ void __launch_bounds__(GT)
spec_head_gather_kernel(const T* __restrict__ w, const int* __restrict__ ids,
                        T* __restrict__ cols, int C, int D, int V, int vec) {
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
    const int d = min(d0 + tdg + i * (GT / GC), D - 1);
    x[i] = __ldg(w + (size_t)d * V + col);
  }
#pragma unroll
  for (int i = 0; i < GL; ++i) tile[tc * TS + tdg + i * (GT / GC)] = x[i];
  __syncthreads();
  if (vec) {
    for (int q = threadIdx.x; q < GC * GD / E; q += GT) {
      const int r = q / (GD / E), e = (q % (GD / E)) * E;
      if (c0 + r < C && d0 + e < D)    // D % E == 0: the chunk is inside
        *reinterpret_cast<uint4*>(cols + (size_t)(c0 + r) * D + d0 + e) =
            *reinterpret_cast<const uint4*>(tile + r * TS + e);
    }
  } else {
    for (int q = threadIdx.x; q < GC * GD; q += GT) {
      const int r = q / GD, e = q % GD;
      if (c0 + r < C && d0 + e < D)
        cols[(size_t)(c0 + r) * D + d0 + e] = tile[r * TS + e];
    }
  }
}

template <typename T>
int run(const void* w, const void* ids, void* cols, int C, int D, int V,
        cudaStream_t st) {
  const int vec = D % (16 / static_cast<int>(sizeof(T))) == 0 &&
                  reinterpret_cast<uintptr_t>(cols) % 16 == 0;
  const dim3 grid((C + GC - 1) / GC, (D + GD - 1) / GD);
  spec_head_gather_kernel<T><<<grid, GT, 0, st>>>(
      static_cast<const T*>(w), static_cast<const int*>(ids),
      static_cast<T*>(cols), C, D, V, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* spec_head_gather_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// w (D, V) f32 or bf16; ids (C,) int32, C >= 1; cols (C, D) of w's dtype.
int spec_head_gather_launch(const void* w, const void* ids, void* cols,
                            int C, int D, int V, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C < 1 || D < 1 || V < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == rt::DT_BF16)
    return run<__nv_bfloat16>(w, ids, cols, C, D, V, st);
  return run<float>(w, ids, cols, C, D, V, st);
}

}  // extern "C"
