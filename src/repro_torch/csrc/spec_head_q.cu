// Speculative LM head over a quantized head, the second of the two stages
// of spec_head_logits_q:
//   logits[r, j] = (hn[r] . codes[c, :]) * scales[c],  c = idx[r, j]
// fp32, over the (C, Dp) code buffer and (C,) scales that
// spec_head_gather_q.cu gathered (any R, any k); idx is clamped to [0, C).
// Codes are int8 (Dp = D) or plane-packed int4 bytes (Dp = D/2), where the
// byte at stored row d feeds hn[d] (low nibble, sign-extended) and
// hn[d + D/2] (high nibble), the Int4Cols rule of common.cuh. The scale is
// applied once, after the fp32 sum, as the fused gate exit_gate_q does.
// The softmax stays in the caller (kernels/spec_head/ops.py).
//
// With spec_head_gather_q.cu it replaces the Pallas kernel
// spec_head_logits_q (_kernel_q8 / _kernel_q4) in
// src/repro/kernels/spec_head/spec_head.py. The tree step gathers its node
// tokens' code columns once per step and runs this dot at every exit
// point that runs the gate, with idx[b*N + n, j] = b*N + child(n, j)
// (core/engine.py); spec_head_logits_q(hn, qt, ids) alone gathers
// ids.flatten() and dots with idx = arange(R*k).view(R, k).
//
// Bound on the H100: bytes — hn (R, D) and the C gathered code columns,
// read once (the tree's R = C = 160 at D = 4096 with bf16 hn: 1.3 MB +
// 0.66 MB of int8 codes, ~0.6 us at 3.35 TB/s); the 2 * R * k * D
// operations are tiny. Design (spec_head.cu's, on 1-byte codes): one warp
// per (r, j) pair, each its own CTA, so the R * k pairs spread over every
// SM; a lane reads its code chunks as 16-byte loads (16 stored rows) and
// the matching hn entries as 16-byte loads too (2 per chunk and plane in
// bf16, 4 in fp32), the chunk loop unrolled so that a D = 4096 row's
// chunks (8 a lane for int8, 4 for int4) are all in flight at once.
//
// Summation order (tests/test_torch_tree_gate_q.py emulates it): with
// Dp a multiple of 16 and 16-byte aligned hn and codes, lane l takes the
// 16-byte code chunks q = l, l + 32, l + 64, ... in order, and within a
// chunk its 16 stored rows d = 16q + e in order; an int8 code adds
// hn[d] * code, an int4 byte adds hn[d] * lo, then hn[d + D/2] * hi; each
// by fmaf into one fp32 accumulator. Otherwise lane l takes the stored
// rows d = l, l + 32, ... in order, each as above. The 32 lane sums are
// then added in a butterfly (xor 16, 8, 4, 2, 1), and lane 0 multiplies
// the sum by the column's scale. So a (r, j) pair's logit depends only on
// hn[r], its column and its scale, not on R, k or where the pair sits in
// the grid.
#include "common.cuh"

namespace {

// The 16 hn entries of one 16-byte code chunk, loaded 16 bytes at a time
template <typename T>
struct Entries {
  static constexpr int NV = sizeof(T);        // 16-byte loads for 16 of T
  uint4 v[NV];
  __device__ __forceinline__ void load(const T* p) {
    const uint4* p4 = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int i = 0; i < NV; ++i) v[i] = __ldg(p4 + i);
  }
  __device__ __forceinline__ float at(int e) const {
    return rt::to_f(reinterpret_cast<const T*>(v)[e]);
  }
};

__device__ __forceinline__ float lo_code(int8_t p) {
  return static_cast<float>(
      static_cast<int8_t>(static_cast<uint8_t>(p) << 4) >> 4);
}
__device__ __forceinline__ float hi_code(int8_t p) {
  return static_cast<float>(p >> 4);
}

template <typename T, int BITS>
__global__ void __launch_bounds__(32)
spec_head_q_dot_kernel(const T* __restrict__ hn,
                       const int8_t* __restrict__ codes,
                       const float* __restrict__ scales,
                       const int* __restrict__ idx,
                       float* __restrict__ logits, int C, int D, int k,
                       int vec) {
  constexpr int U = BITS == 4 ? 4 : 8;        // chunks a lane at D = 4096
  const int Dp = BITS == 4 ? D / 2 : D;       // stored rows
  const int lane = threadIdx.x;
  const int p = blockIdx.x;                   // the (r, j) pair
  const int c = min(max(__ldg(idx + p), 0), C - 1);
  const T* a = hn + (size_t)(p / k) * D;
  const int8_t* b = codes + (size_t)c * Dp;
  float acc = 0.f;
  if (vec) {
    const uint4* b4 = reinterpret_cast<const uint4*>(b);
#pragma unroll (U)
    for (int q = lane; q < Dp / 16; q += 32) {
      const uint4 bv = __ldg(b4 + q);
      const int8_t* be = reinterpret_cast<const int8_t*>(&bv);
      Entries<T> lo;
      lo.load(a + 16 * q);
      if constexpr (BITS == 4) {
        Entries<T> hi;
        hi.load(a + Dp + 16 * q);
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          acc = fmaf(lo.at(e), lo_code(be[e]), acc);
          acc = fmaf(hi.at(e), hi_code(be[e]), acc);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e)
          acc = fmaf(lo.at(e), static_cast<float>(be[e]), acc);
      }
    }
  } else {
#pragma unroll 4
    for (int d = lane; d < Dp; d += 32) {
      const int8_t code = __ldg(b + d);
      if constexpr (BITS == 4) {
        acc = fmaf(rt::to_f(__ldg(a + d)), lo_code(code), acc);
        acc = fmaf(rt::to_f(__ldg(a + Dp + d)), hi_code(code), acc);
      } else {
        acc = fmaf(rt::to_f(__ldg(a + d)), static_cast<float>(code), acc);
      }
    }
  }
  acc = rt::warp_sum(acc);
  if (lane == 0) logits[p] = acc * __ldg(scales + c);
}

template <typename T, int BITS>
int run(const void* hn, const void* codes, const void* scales,
        const void* idx, void* logits, int R, int C, int D, int k,
        cudaStream_t st) {
  const int Dp = BITS == 4 ? D / 2 : D;
  const int vec = Dp % 16 == 0 && reinterpret_cast<uintptr_t>(hn) % 16 == 0
                  && reinterpret_cast<uintptr_t>(codes) % 16 == 0;
  spec_head_q_dot_kernel<T, BITS><<<R * k, 32, 0, st>>>(
      static_cast<const T*>(hn), static_cast<const int8_t*>(codes),
      static_cast<const float*>(scales), static_cast<const int*>(idx),
      static_cast<float*>(logits), C, D, k, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run_bits(const void* hn, const void* codes, const void* scales,
             const void* idx, void* logits, int R, int C, int D, int k,
             int bits, cudaStream_t st) {
  if (bits == 4)
    return run<T, 4>(hn, codes, scales, idx, logits, R, C, D, k, st);
  return run<T, 8>(hn, codes, scales, idx, logits, R, C, D, k, st);
}

}  // namespace

extern "C" {

const char* spec_head_q_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// hn (R, D) f32 or bf16; codes (C, D) int8 for bits 8 or packed (C, D/2)
// for bits 4 (D even); scales (C,) f32; idx (R, k) int32; logits (R, k)
// f32.
int spec_head_q_launch(const void* hn, const void* codes, const void* scales,
                       const void* idx, void* logits, int R, int C, int D,
                       int k, int bits, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R < 1 || C < 1 || D < 1 || k < 1 || (bits != 8 && bits != 4)
      || (bits == 4 && D % 2))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == rt::DT_BF16)
    return run_bits<__nv_bfloat16>(hn, codes, scales, idx, logits, R, C, D,
                                   k, bits, st);
  return run_bits<float>(hn, codes, scales, idx, logits, R, C, D, k, bits,
                         st);
}

}  // extern "C"
