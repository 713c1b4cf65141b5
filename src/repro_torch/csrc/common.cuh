// Shared device helpers for the port's hand-written Hopper kernels.
//
// Every kernel file exposes a plain C interface (pointers and the stream as
// void*, sizes as int) and returns cudaGetLastError() after its launches, so
// the Python wrapper can raise on a refused launch. Kernels take fp32 or
// bf16 activations/weights (dtype code DT_F32 / DT_BF16) and accumulate in
// fp32.
#pragma once

#include <climits>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace rt {

enum { DT_F32 = 0, DT_BF16 = 1 };

constexpr float NEG_INF = -1e30f;   // masked score, as in the Pallas kernels

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Readers of a (D, V) row-major LM head: element (d, col) of the stored
// matrix is at index d * V + col. P is the number of hidden entries one
// stored element multiplies: 1 for fp weights and int8 codes, 2 for a
// plane-packed int4 byte (rows d and d + D/2 of the logical head, the
// layout of repro_torch.quant). A SCALED reader's column sums are
// multiplied by scale(col) once, after the dot (per-column scales are
// constant down the contracted dimension), as the Pallas kernels fold
// their scale after the tile dot. Loads go through the read-only path.
template <typename T>
struct FpCols {
  static constexpr int P = 1;
  static constexpr bool SCALED = false;
  const T* w;
  __device__ __forceinline__ void load(size_t i, float (&x)[P]) const {
    x[0] = to_f(__ldg(w + i));
  }
  __device__ __forceinline__ float scale(int) const { return 1.f; }
};

struct Int8Cols {
  static constexpr int P = 1;
  static constexpr bool SCALED = true;
  const int8_t* q;
  const float* s;
  __device__ __forceinline__ void load(size_t i, float (&x)[P]) const {
    x[0] = static_cast<float>(__ldg(q + i));
  }
  __device__ __forceinline__ float scale(int col) const {
    return __ldg(s + col);
  }
};

struct Int4Cols {
  static constexpr int P = 2;
  static constexpr bool SCALED = true;
  const int8_t* q;
  const float* s;
  // low nibble: row d, sign-extended by shifting it to the top of a byte
  // and back; high nibble: row d + D/2, an arithmetic shift of the byte
  // (JAX: (p << 28) >> 28 and p >> 4 on int32)
  __device__ __forceinline__ void load(size_t i, float (&x)[P]) const {
    const int8_t p = __ldg(q + i);
    x[0] = static_cast<float>(
        static_cast<int8_t>(static_cast<uint8_t>(p) << 4) >> 4);
    x[1] = static_cast<float>(p >> 4);
  }
  __device__ __forceinline__ float scale(int col) const {
    return __ldg(s + col);
  }
};

// Code (row, col) of a (rows, cols) weight stored as int8 codes (bits 8)
// or as plane-packed int4 bytes ((rows/2, cols): low nibble row, high
// nibble row + rows/2, sign-extended as Int4Cols does), widened to fp32.
// No local array: a register array indexed by a runtime value would go to
// the stack and wait on the load.
__device__ __forceinline__ float code_at(const int8_t* q, int bits, int row,
                                         int col, int rows, int cols) {
  if (bits == 8)
    return static_cast<float>(__ldg(q + (size_t)row * cols + col));
  const int half = rows / 2;
  const bool lo = row < half;
  const int8_t p = __ldg(q + (size_t)(lo ? row : row - half) * cols + col);
  return static_cast<float>(
      lo ? static_cast<int8_t>(static_cast<uint8_t>(p) << 4) >> 4 : p >> 4);
}

// Total order used by every argmax / top-k: larger value first, and among
// equal values the lower vocabulary id first (jnp.argmax's first
// occurrence, lax.top_k's lower-index-first rule).
__device__ __forceinline__ bool before(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

// Butterfly reduction: every lane ends with the warp's best (value, id).
__device__ __forceinline__ void warp_best(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (before(ov, oi, v, i)) { v = ov; i = oi; }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Block-wide best (value, id); every thread gets the result. blockDim.x is
// a multiple of 32 and at most 1024. sv/si: 32-entry shared scratch.
__device__ __forceinline__ void block_best(float& v, int& i, float* sv,
                                           int* si) {
  warp_best(v, i);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  __syncthreads();                     // scratch may hold a previous call's
  if (lane == 0) { sv[w] = v; si[w] = i; }
  __syncthreads();
  v = lane < nw ? sv[lane] : -CUDART_INF_F;
  i = lane < nw ? si[lane] : INT_MAX;
  warp_best(v, i);
}

// Runs LAUNCH<T, NREP, E>::run(args...) of an attention kernel for a
// runtime (dtype, n_rep, hd), E = hd / 32; false when no instance exists
// (n_rep in {1, 2, 4, 8}, hd in {32, 64, 128}; and, one instance each for
// the configs that need them, since each adds to the build's time: n_rep
// 12 at hd 128, StarCoder2-15B's 48 heads over 4 KV heads and Command R+'s
// 96 over 8; n_rep 6 at hd 128, DBRX's and InternVL2's 48 over 8; n_rep 16
// at hd 64, Qwen3-MoE's 64 over 4; n_rep 16 at hd 256, RecurrentGemma's 16
// heads over one; n_rep 8 and 4 at hd 256, a tensor-parallel shard of
// RecurrentGemma at P = 2 and 4: 8 or 4 query heads over its one KV head).
template <template <typename, int, int> class LAUNCH, typename... Args>
bool dispatch(int dtype, int n_rep, int hd, Args... args) {
#define DA_CASE_E(T, R)                                              \
  switch (hd) {                                                      \
    case 32: LAUNCH<T, R, 1>::run(args...); return true;             \
    case 64: LAUNCH<T, R, 2>::run(args...); return true;             \
    case 128: LAUNCH<T, R, 4>::run(args...); return true;            \
    default: return false;                                           \
  }
#define DA_CASE_R(T)                                                 \
  switch (n_rep) {                                                   \
    case 1: DA_CASE_E(T, 1)                                          \
    case 2: DA_CASE_E(T, 2)                                          \
    case 4:                                                          \
      if (hd == 256) { LAUNCH<T, 4, 8>::run(args...); return true; }  \
      DA_CASE_E(T, 4)                                                \
    case 8:                                                          \
      if (hd == 256) { LAUNCH<T, 8, 8>::run(args...); return true; }  \
      DA_CASE_E(T, 8)                                                \
    case 6:                                                          \
      if (hd != 128) return false;                                   \
      LAUNCH<T, 6, 4>::run(args...);                                 \
      return true;                                                   \
    case 12:                                                         \
      if (hd != 128) return false;                                   \
      LAUNCH<T, 12, 4>::run(args...);                                \
      return true;                                                   \
    case 16:                                                         \
      if (hd == 64) { LAUNCH<T, 16, 2>::run(args...); return true; } \
      if (hd == 256) { LAUNCH<T, 16, 8>::run(args...); return true; } \
      return false;                                                  \
    default: return false;                                           \
  }
  if (dtype == DT_BF16) {
    DA_CASE_R(__nv_bfloat16)
  } else {
    DA_CASE_R(float)
  }
#undef DA_CASE_R
#undef DA_CASE_E
}

}  // namespace rt
