// Fused SpecEE exit gate for one exit point, one CTA per row b:
//   logits[j] = hn[b] . W[:, ids[b, j]]            (k gathered head columns)
//   probs     = softmax(logits)
//   feats     = [logits, probs, probs - prev[b]]   (3k)
//   p_exit[b] = sigmoid(relu(feats . W1 + b1) . W2 + b2)
// all in fp32; the features and the H hidden units never leave the CTA.
//
// Replaces the Pallas kernel exit_gate_fused (_gate_kernel) in
// src/repro/kernels/exit_gate/exit_gate.py, whose (B, k, nd) grid gathers
// column blocks through scalar-prefetched index maps.
//
// The gather-dot (first stage) is spec_head.cuh, shared with spec_head.cu;
// its note records the strided-gather layout choice.
//
// Bound on the H100: bytes — the k * D useful head elements and the
// predictor weights (3k*H + 2H + 1 floats) per row; the arithmetic is tiny.
// The design gives the D loop to 256 threads so the strided loads of one
// row are all in flight at once, and B CTAs run in parallel.
#include "spec_head.cuh"

namespace {

constexpr int EG_THREADS = rt::SH_THREADS;
constexpr int EG_MAXK = rt::SH_MAXK;

template <typename T>
__global__ void __launch_bounds__(EG_THREADS)
exit_gate_kernel(const T* __restrict__ hn, rt::FpCols<T> w,
                 const int* __restrict__ ids, const float* __restrict__ prev,
                 const float* __restrict__ w1, const float* __restrict__ b1,
                 const float* __restrict__ w2, const float* __restrict__ b2,
                 float* __restrict__ p_out, float* __restrict__ probs_out,
                 float* __restrict__ logits_out, int D, int V, int k, int H) {
  __shared__ float red[EG_MAXK][32];
  __shared__ float s_logits[EG_MAXK];
  __shared__ float s_feats[3 * EG_MAXK];
  __shared__ float s_out[32];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = EG_THREADS / 32;

  rt::spec_head_row<T, rt::FpCols<T>, true>(hn + (size_t)b * D, w,
                                           ids + (size_t)b * k, D, V, k, red,
                                           s_logits);
  if (threadIdx.x == 0) {
    float logits[EG_MAXK];
    float m = -CUDART_INF_F;
    for (int j = 0; j < k; ++j) {
      logits[j] = s_logits[j];
      m = fmaxf(m, logits[j]);
    }
    float e[EG_MAXK];
    float z = 0.f;
    for (int j = 0; j < k; ++j) { e[j] = expf(logits[j] - m); z += e[j]; }
    for (int j = 0; j < k; ++j) {
      const float p = e[j] / z;
      s_feats[j] = logits[j];
      s_feats[k + j] = p;
      s_feats[2 * k + j] = p - prev[b * k + j];
      probs_out[b * k + j] = p;
      logits_out[b * k + j] = logits[j];
    }
  }
  __syncthreads();
  const int F = 3 * k;
  float part = 0.f;
  for (int h = threadIdx.x; h < H; h += EG_THREADS) {
    float hid = b1[h];
    for (int f = 0; f < F; ++f) hid = fmaf(s_feats[f], w1[f * H + h], hid);
    part = fmaf(fmaxf(hid, 0.f), w2[h], part);
  }
  part = rt::warp_sum(part);
  if (lane == 0) s_out[wid] = part;
  __syncthreads();
  if (threadIdx.x == 0) {
    float o = b2[0];
    for (int q = 0; q < nw; ++q) o += s_out[q];
    p_out[b] = 1.f / (1.f + expf(-o));
  }
}

}  // namespace

extern "C" {

int exit_gate_max_k() { return EG_MAXK; }
const char* exit_gate_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// hn (B, D) and w (D, V) of one dtype; ids (B, k) int32; prev (B, k) f32;
// w1 (3k, H), b1 (H,), w2 (H, 1), b2 (1,) f32; outputs p (B,),
// probs (B, k), logits (B, k) f32.
int exit_gate_launch(const void* hn, const void* w, const void* ids,
                     const void* prev, const void* w1, const void* b1,
                     const void* w2, const void* b2, void* p, void* probs,
                     void* logits, int B, int D, int V, int k, int H,
                     int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define EG_ARGS(T)                                                         \
  static_cast<const T*>(hn), rt::FpCols<T>{static_cast<const T*>(w)},     \
      static_cast<const int*>(ids), static_cast<const float*>(prev),       \
      static_cast<const float*>(w1), static_cast<const float*>(b1),        \
      static_cast<const float*>(w2), static_cast<const float*>(b2),        \
      static_cast<float*>(p), static_cast<float*>(probs),                  \
      static_cast<float*>(logits), D, V, k, H
  if (dtype == rt::DT_BF16) {
    exit_gate_kernel<__nv_bfloat16><<<B, EG_THREADS, 0, st>>>(
        EG_ARGS(__nv_bfloat16));
  } else {
    exit_gate_kernel<float><<<B, EG_THREADS, 0, st>>>(EG_ARGS(float));
  }
#undef EG_ARGS
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
