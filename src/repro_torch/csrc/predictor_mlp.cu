// Fused 2-layer predictor MLP (the SpecEE exit predictor), fp32:
//   p[r] = sigmoid(relu(x[r] . W1 + b1) . W2 + b2)
// x (R, F), W1 (F, H), b1 (H,), W2 (H, 1), b2 (1,), any R >= 1.
//
// Replaces the Pallas kernel predictor_mlp_fused (_kernel) in
// src/repro/kernels/predictor_mlp/predictor_mlp.py, whose grid tiles the
// rows and keeps whole weight matrices in VMEM. Here each CTA copies the
// weights (F*H + 2H floats: 28 KB at F=12, H=512) into shared memory once
// and takes a block of PM_ROWS rows; each warp takes one row at a time, its
// lanes split the H hidden units (consecutive lanes, consecutive units: no
// bank conflicts), and a shuffle sum gives the output. The features and the
// hidden units never leave the chip.
//
// Bound on the H100: tiny — R*F*4 + the weights + R*4 bytes (~40 KB for
// the tree gate's R = B*P = 108 paths at B=4) and 2*R*(F+1)*H operations
// (~3 MFLOP), a fraction of a microsecond either way. The design keeps it to
// one launch with few CTAs (ceil(R / PM_ROWS)); the kernel still takes
// ~25 us, slower than the plain version's five launches (PERF.md), and
// 16-byte unrolled weight copies did not change that.
#include "common.cuh"

namespace {

constexpr int PM_THREADS = 256;   // 8 warps
constexpr int PM_ROWS = 32;       // rows per CTA
constexpr int PM_MAXF = 32;       // one feature per lane

__global__ void __launch_bounds__(PM_THREADS)
predictor_mlp_kernel(const float* __restrict__ x,
                     const float* __restrict__ w1,
                     const float* __restrict__ b1,
                     const float* __restrict__ w2,
                     const float* __restrict__ b2, float* __restrict__ out,
                     int R, int F, int H) {
  extern __shared__ float smem[];
  float* s_w1 = smem;              // (F, H)
  float* s_b1 = smem + F * H;      // (H,)
  float* s_w2 = s_b1 + H;          // (H,)
  for (int i = threadIdx.x; i < F * H; i += PM_THREADS) s_w1[i] = w1[i];
  for (int i = threadIdx.x; i < H; i += PM_THREADS) {
    s_b1[i] = b1[i];
    s_w2[i] = w2[i];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  constexpr int nw = PM_THREADS / 32;
  const float bias2 = b2[0];
  const int r1 = min(R, (int)(blockIdx.x + 1) * PM_ROWS);
  for (int r = blockIdx.x * PM_ROWS + wid; r < r1; r += nw) {
    const float xv = lane < F ? x[(size_t)r * F + lane] : 0.f;
    float xr[PM_MAXF];
#pragma unroll
    for (int f = 0; f < PM_MAXF; ++f) xr[f] = __shfl_sync(0xffffffffu, xv, f);
    float part = 0.f;
    for (int h = lane; h < H; h += 32) {
      float hid = s_b1[h];
#pragma unroll
      for (int f = 0; f < PM_MAXF; ++f)
        if (f < F) hid = fmaf(xr[f], s_w1[f * H + h], hid);
      part = fmaf(fmaxf(hid, 0.f), s_w2[h], part);
    }
    part = rt::warp_sum(part);
    if (lane == 0) out[r] = 1.f / (1.f + expf(-(part + bias2)));
  }
}

}  // namespace

extern "C" {

int predictor_mlp_max_f() { return PM_MAXF; }
const char* predictor_mlp_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (R, F), w1 (F, H), b1 (H,), w2 (H, 1), b2 (1,), out (R,), all f32.
int predictor_mlp_launch(const void* x, const void* w1, const void* b1,
                         const void* w2, const void* b2, void* out, int R,
                         int F, int H, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)(F * H + 2 * H) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        predictor_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int grid = (R + PM_ROWS - 1) / PM_ROWS;
  predictor_mlp_kernel<<<grid, PM_THREADS, smem, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<float*>(out), R, F, H);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
