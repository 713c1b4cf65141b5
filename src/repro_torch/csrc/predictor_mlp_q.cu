// Fused 2-layer predictor MLP on quantized weights, fp32:
//   h[j] = relu((x[r] . c1[:, j]) * s1[j] + b1[j])
//   p[r] = sigmoid((h . c2) * s2 + b2)
// x (R, F); W1 as int8 codes c1 (F, H) or plane-packed int4 (F/2, H) with
// scales s1 (H,); W2 as codes (H, 1) or packed (H/2, 1) with scale s2 (1,);
// biases b1 (H,), b2 (1,) fp32; any R >= 1. Each weight's bits are given
// on its own (an odd row count quantizes to int8 even under int4).
//
// Replaces the Pallas kernel predictor_mlp_fused_q (_kernel_q, _deq) in
// src/repro/kernels/predictor_mlp/predictor_mlp.py, which keeps the codes
// and scales in VMEM and folds each scale after its dot. On the path it
// is the quantized tree gate's predictor: one call per exit point that
// runs the gate, over the B*P merged paths (R = 108 at B = 4).
//
// Bound on the H100: tiny — the codes (F*H + H bytes in int8), 2H + 2
// floats of scales and biases, R*F inputs and R outputs, and about
// 2*R*(F+1)*H operations: well under a microsecond either way, so the
// launch floor (~3 us) sets what is reachable. Design: the body of
// predictor.cuh on the QPred weight form. A CTA of 256 threads takes
// PM_RB rows, so R = 108 spreads over 27 CTAs; its threads span the H
// hidden units (two each at H = 512) and load each unit's codes, scales
// and biases into registers once, coalesced, with no whole-matrix
// staging; the block's rows come in through shared memory. The feature
// loops are unrolled to 12 (the gate's F = 3k at k = 4) where F allows,
// else to 32. Its summation order is predictor.cuh's. Why these numbers
// (scripts/probe_predictor_mlp_q.py, PERF.md): at R = 108, 4 rows
// a CTA against 2 and 8 took the least time; loops unrolled to 32 with
// F = 12 took 1.5x as long as loops unrolled to 12.
#include "predictor.cuh"

namespace {

constexpr int PM_RB = 4;          // rows per CTA
constexpr int PM_SMALL_F = 12;    // the short instance's features, at most

template <int MAXF>
__global__ void __launch_bounds__(rt::PR_THREADS)
predictor_mlp_q_kernel(const float* __restrict__ x, rt::QPred pred,
                       float* __restrict__ out, int R, int F, int H) {
  rt::predictor_rows<rt::QPred, PM_RB, MAXF>(x, pred, out, R, F, H);
}

}  // namespace

extern "C" {

int predictor_mlp_q_max_f() { return rt::PR_MAXF; }
const char* predictor_mlp_q_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (R, F) f32; q1 int8 (F, H) or packed (F/2, H) by bits1; s1, b1 (H,)
// f32; q2 int8 (H, 1) or packed (H/2, 1) by bits2; s2, b2 (1,) f32;
// out (R,) f32.
int predictor_mlp_q_launch(const void* x, const void* q1, const void* s1,
                           const void* b1, const void* q2, const void* s2,
                           const void* b2, void* out, int R, int F, int H,
                           int bits1, int bits2, void* stream) {
  if (R < 1 || F < 1 || F > rt::PR_MAXF || H < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const rt::QPred pred{
      static_cast<const int8_t*>(q1), static_cast<const float*>(s1),
      static_cast<const float*>(b1), static_cast<const int8_t*>(q2),
      static_cast<const float*>(s2), static_cast<const float*>(b2), bits1,
      bits2};
  const int grid = (R + PM_RB - 1) / PM_RB;
  auto kernel = F <= PM_SMALL_F ? predictor_mlp_q_kernel<PM_SMALL_F>
                                : predictor_mlp_q_kernel<rt::PR_MAXF>;
  kernel<<<grid, rt::PR_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), pred, static_cast<float*>(out), R, F, H);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
