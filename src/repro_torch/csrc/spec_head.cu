// Speculative LM head, the second of the two stages of spec_head_logits:
// logits[r, j] = hn[r] . cols[idx[r, j], :], fp32 sums, over the (C, D)
// buffer of head columns that spec_head_gather.cu gathered (any R, any k).
// idx is clamped to [0, C). The softmax over the k logits stays in the
// Python wrapper's caller (kernels/spec_head/ops.py), as in the JAX
// package.
//
// With spec_head_gather.cu it replaces the Pallas kernel spec_head_logits
// (_kernel) in src/repro/kernels/spec_head/spec_head.py. The tree step
// gathers its node tokens' columns once per step and runs this dot at
// every exit point that runs the gate, with idx[b*N + n, j] = b*N +
// child(n, j) (core/engine.py); spec_head_logits(hn, W, ids) alone
// gathers ids.flatten() and dots with idx = arange(R*k).view(R, k).
//
// Bound on the H100: bytes — hn (R, D) and the C gathered columns, read
// once (the tree's R = C = 160 at D = 4096 in bf16: 2.6 MB, ~0.8 us at
// 3.35 TB/s); the 2 * R * k * D operations are tiny. Design: one warp
// per (r, j) pair, each its own CTA, so the R * k pairs spread over every
// SM; every lane reads both operands in 16-byte loads, its chunk loop
// unrolled 16 times (a D = 4096 bf16 row is 16 chunks a lane), so all of
// a lane's loads can be in flight at once. In CTAs of 2 to 8 warps ptxas
// gave a lane 32 registers and the call took 1.2-2x as long at R = 160
// and 320; unrolled 4 or 8 times, up to 11 % longer with its operands
// cold in L2 (PERF.md, PR 22).
//
// Summation order (tests/test_torch_spec_head_cols.py emulates it): with
// D a multiple of E = 16 / sizeof(T) and 16-byte aligned hn and cols,
// lane l takes the 16-byte chunks q = l, l + 32, l + 64, ... in order and,
// within a chunk, its E elements in order, into one fp32 accumulator by
// fmaf; otherwise lane l takes the elements d = l, l + 32, ... in order.
// The 32 lane sums are then added in a butterfly (xor 16, 8, 4, 2, 1).
// So a (r, j) pair's logit depends only on hn[r] and its column, not on R,
// k or where the pair sits in the grid.
#include "common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(32)
spec_head_dot_kernel(const T* __restrict__ hn, const T* __restrict__ cols,
                     const int* __restrict__ idx, float* __restrict__ logits,
                     int R, int C, int D, int k, int vec) {
  constexpr int E = 16 / sizeof(T);
  const int lane = threadIdx.x;
  const int p = blockIdx.x;                              // the (r, j) pair
  const int c = min(max(__ldg(idx + p), 0), C - 1);
  const T* a = hn + (size_t)(p / k) * D;
  const T* b = cols + (size_t)c * D;
  float acc = 0.f;
  if (vec) {
    const uint4* a4 = reinterpret_cast<const uint4*>(a);
    const uint4* b4 = reinterpret_cast<const uint4*>(b);
#pragma unroll 16
    for (int q = lane; q < D / E; q += 32) {
      const uint4 av = __ldg(a4 + q), bv = __ldg(b4 + q);
      const T* ae = reinterpret_cast<const T*>(&av);
      const T* be = reinterpret_cast<const T*>(&bv);
#pragma unroll
      for (int e = 0; e < E; ++e)
        acc = fmaf(rt::to_f(ae[e]), rt::to_f(be[e]), acc);
    }
  } else {
#pragma unroll 4
    for (int d = lane; d < D; d += 32)
      acc = fmaf(rt::to_f(__ldg(a + d)), rt::to_f(__ldg(b + d)), acc);
  }
  acc = rt::warp_sum(acc);
  if (lane == 0) logits[p] = acc;
}

template <typename T>
int run(const void* hn, const void* cols, const void* idx, void* logits,
        int R, int C, int D, int k, cudaStream_t st) {
  const int vec = D % (16 / static_cast<int>(sizeof(T))) == 0 &&
                  reinterpret_cast<uintptr_t>(hn) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(cols) % 16 == 0;
  spec_head_dot_kernel<T><<<R * k, 32, 0, st>>>(
      static_cast<const T*>(hn), static_cast<const T*>(cols),
      static_cast<const int*>(idx), static_cast<float*>(logits), R, C, D, k,
      vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* spec_head_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// hn (R, D) and cols (C, D) of one dtype, C >= 1; idx (R, k) int32;
// logits (R, k) f32.
int spec_head_launch(const void* hn, const void* cols, const void* idx,
                     void* logits, int R, int C, int D, int k, int dtype,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R < 1 || C < 1 || D < 1 || k < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == rt::DT_BF16)
    return run<__nv_bfloat16>(hn, cols, idx, logits, R, C, D, k, st);
  return run<float>(hn, cols, idx, logits, R, C, D, k, st);
}

}  // extern "C"
