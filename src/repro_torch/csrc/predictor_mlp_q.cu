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
// and scales in VMEM and folds each scale after its dot. Here each CTA
// widens the codes to fp32 into shared memory once (F*H + 3H floats: 30 KB
// at F=12, H=512), unpacking int4 planes as it goes, and takes a block of
// PM_ROWS rows; each warp takes one row at a time with its lanes over the
// hidden units, as in predictor_mlp.cu. The scales are applied after the
// sums, in the Pallas order.
//
// Bound on the H100: tiny — the codes (F*H + H bytes in int8), 2H + 2
// floats of scales and biases, R*F inputs and R outputs, and about
// 2*R*(F+1)*H operations: well under a microsecond either way. Like the fp
// kernel, it costs one launch and the latency of the weight stage.
#include "common.cuh"

namespace {

constexpr int PM_THREADS = 256;   // 8 warps
constexpr int PM_ROWS = 32;       // rows per CTA
constexpr int PM_MAXF = 32;       // one feature per lane

__global__ void __launch_bounds__(PM_THREADS)
predictor_mlp_q_kernel(const float* __restrict__ x,
                       const int8_t* __restrict__ q1,
                       const float* __restrict__ s1,
                       const float* __restrict__ b1,
                       const int8_t* __restrict__ q2,
                       const float* __restrict__ s2,
                       const float* __restrict__ b2, float* __restrict__ out,
                       int R, int F, int H, int bits1, int bits2) {
  extern __shared__ float smem[];
  float* s_c1 = smem;              // (F, H) codes as fp32
  float* s_s1 = smem + F * H;      // (H,)
  float* s_b1 = s_s1 + H;          // (H,)
  float* s_c2 = s_b1 + H;          // (H,)
  for (int i = threadIdx.x; i < F * H; i += PM_THREADS)
    s_c1[i] = rt::code_at(q1, bits1, i / H, i % H, F, H);
  for (int i = threadIdx.x; i < H; i += PM_THREADS) {
    s_s1[i] = s1[i];
    s_b1[i] = b1[i];
    s_c2[i] = rt::code_at(q2, bits2, i, 0, H, 1);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  constexpr int nw = PM_THREADS / 32;
  const float scale2 = s2[0], bias2 = b2[0];
  const int r1 = min(R, (int)(blockIdx.x + 1) * PM_ROWS);
  for (int r = blockIdx.x * PM_ROWS + wid; r < r1; r += nw) {
    const float xv = lane < F ? x[(size_t)r * F + lane] : 0.f;
    float xr[PM_MAXF];
#pragma unroll
    for (int f = 0; f < PM_MAXF; ++f) xr[f] = __shfl_sync(0xffffffffu, xv, f);
    float part = 0.f;
    for (int h = lane; h < H; h += 32) {
      float dot = 0.f;
#pragma unroll
      for (int f = 0; f < PM_MAXF; ++f)
        if (f < F) dot = fmaf(xr[f], s_c1[f * H + h], dot);
      const float hid = fmaxf(dot * s_s1[h] + s_b1[h], 0.f);
      part = fmaf(hid, s_c2[h], part);
    }
    part = rt::warp_sum(part);
    if (lane == 0) out[r] = 1.f / (1.f + expf(-(part * scale2 + bias2)));
  }
}

}  // namespace

extern "C" {

int predictor_mlp_q_max_f() { return PM_MAXF; }
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)(F * H + 3 * H) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        predictor_mlp_q_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int grid = (R + PM_ROWS - 1) / PM_ROWS;
  predictor_mlp_q_kernel<<<grid, PM_THREADS, smem, st>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(q1),
      static_cast<const float*>(s1), static_cast<const float*>(b1),
      static_cast<const int8_t*>(q2), static_cast<const float*>(s2),
      static_cast<const float*>(b2), static_cast<float*>(out), R, F, H,
      bits1, bits2);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
