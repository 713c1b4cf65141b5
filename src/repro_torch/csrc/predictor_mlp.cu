// Fused 2-layer predictor MLP (the SpecEE exit predictor), fp32:
//   p[r] = sigmoid(relu(x[r] . W1 + b1) . W2 + b2)
// x (R, F), W1 (F, H), b1 (H,), W2 (H, 1), b2 (1,), any R >= 1.
//
// Replaces the Pallas kernel predictor_mlp_fused (_kernel) in
// src/repro/kernels/predictor_mlp/predictor_mlp.py, whose grid tiles the
// rows and keeps whole weight matrices in VMEM. On the path it is the fp
// tree gate's predictor: one call per exit point that runs the gate, over
// the B*P merged paths (R = 108 at B = 4).
//
// Bound on the H100: tiny — R*F*4 + the weights + R*4 bytes (~40 KB at
// R = 108) and 2*R*(F+1)*H operations (~1.4 MFLOP), well under a
// microsecond either way, so the launch floor (~3 us) sets what is
// reachable. Design: the body of predictor.cuh on the FpPred weight form,
// the fp twin of predictor_mlp_q.cu. A CTA of 256 threads takes PM_RB
// rows, one, so R = 108 spreads over 108 CTAs; its threads span the H
// hidden units (two each at H = 512) and load each unit's W1 column, b1
// and W2 entry into registers once, coalesced, with no whole-matrix
// staging; the row comes in through shared memory. The feature loops are
// unrolled to 12 (the gate's F = 3k at k = 4) where F allows, else to 32.
// Its summation order is predictor.cuh's: per unit the features' chain
// from b1, per thread its units in order, a butterfly in each warp, the
// warps in order. The first version (one CTA of 8 warps per 32 rows, W1
// staged whole in shared memory, each warp walking its rows with feature
// loops unrolled to 32) took 0.0257 ms at R = 108, 1.8x its plain version.
// Why one row a CTA (scripts/ab_predictor_mlp.py, PERF.md): at F = 12 it
// beat 2, 4, 8 and 16 rows at R = 108 and 216 (0.0030 against 0.0034 for
// 2 and 4); at F = 24, 2 rows were faster (0.0041 against 0.0045), but
// the gate's k = 4 gives F = 12. (The quantized twin widens its codes per
// unit and keeps 4 rows.)
#include "predictor.cuh"

namespace {

constexpr int PM_RB = 1;          // rows per CTA
constexpr int PM_SMALL_F = 12;    // the short instance's features, at most

template <int MAXF>
__global__ void __launch_bounds__(rt::PR_THREADS)
predictor_mlp_kernel(const float* __restrict__ x, rt::FpPred pred,
                     float* __restrict__ out, int R, int F, int H) {
  rt::predictor_rows<rt::FpPred, PM_RB, MAXF>(x, pred, out, R, F, H);
}

}  // namespace

extern "C" {

int predictor_mlp_max_f() { return rt::PR_MAXF; }
const char* predictor_mlp_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (R, F), w1 (F, H), b1 (H,), w2 (H, 1), b2 (1,), out (R,), all f32.
int predictor_mlp_launch(const void* x, const void* w1, const void* b1,
                         const void* w2, const void* b2, void* out, int R,
                         int F, int H, void* stream) {
  if (R < 1 || F < 1 || F > rt::PR_MAXF || H < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const rt::FpPred pred{
      static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<const float*>(b2)};
  const int grid = (R + PM_RB - 1) / PM_RB;
  auto kernel = F <= PM_SMALL_F ? predictor_mlp_kernel<PM_SMALL_F>
                                : predictor_mlp_kernel<rt::PR_MAXF>;
  kernel<<<grid, rt::PR_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), pred, static_cast<float*>(out), R, F, H);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
