// Fused SpecEE exit gate for one exit point over an fp LM head and an fp32
// predictor, one thread-block cluster of C CTAs per row b:
//   logits[j] = hn[b] . W[:, ids[b, j]]            (k gathered head columns)
//   probs     = softmax(logits)
//   feats     = [logits, probs, probs - prev[b]]   (3k)
//   p_exit[b] = sigmoid(relu(feats . W1 + b1) . W2 + b2)
// all in fp32 (the body, its bound and its design: exit_gate.cuh).
//
// Replaces the Pallas kernel exit_gate_fused (_gate_kernel) in
// src/repro/kernels/exit_gate/exit_gate.py, whose (B, k, nd) grid gathers
// column blocks through scalar-prefetched index maps.
#include "exit_gate.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(rt::EG_THREADS, 1)
exit_gate_kernel(const T* __restrict__ hn, rt::FpCols<T> w,
                 const int* __restrict__ ids, const float* __restrict__ prev,
                 rt::FpPred pred, float* __restrict__ p_out,
                 float* __restrict__ probs_out,
                 float* __restrict__ logits_out, int D, int V, int k, int H) {
  rt::exit_gate_row(hn, w, ids, prev, pred, p_out, probs_out, logits_out, D,
                    V, k, H);
}

template <typename T>
cudaError_t run(const void* hn, const void* w, const void* ids,
                const void* prev, rt::FpPred pred, void* p, void* probs,
                void* logits, int B, int D, int V, int k, int H,
                cudaStream_t st) {
  return rt::launch_gate(
      exit_gate_kernel<T>, B, rt::cluster_size(D), st,
      static_cast<const T*>(hn), rt::FpCols<T>{static_cast<const T*>(w)},
      static_cast<const int*>(ids), static_cast<const float*>(prev), pred,
      static_cast<float*>(p), static_cast<float*>(probs),
      static_cast<float*>(logits), D, V, k, H);
}

}  // namespace

extern "C" {

int exit_gate_max_k() { return rt::EG_MAXK; }
const char* exit_gate_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// hn (B, D) and w (D, V) of one dtype; ids (B, k) int32; prev (B, k) f32;
// w1 (3k, H), b1 (H,), w2 (H, 1), b2 (1,) f32; outputs p (B,),
// probs (B, k), logits (B, k) f32. Returns cudaErrorInvalidValue for
// k outside [1, EG_MAXK] or B outside [1, 65535].
int exit_gate_launch(const void* hn, const void* w, const void* ids,
                     const void* prev, const void* w1, const void* b1,
                     const void* w2, const void* b2, void* p, void* probs,
                     void* logits, int B, int D, int V, int k, int H,
                     int dtype, void* stream) {
  if (k < 1 || k > rt::EG_MAXK || B < 1 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const rt::FpPred pred{
      static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<const float*>(b2)};
  const cudaError_t e =
      dtype == rt::DT_BF16
          ? run<__nv_bfloat16>(hn, w, ids, prev, pred, p, probs, logits, B,
                               D, V, k, H, st)
          : run<float>(hn, w, ids, prev, pred, p, probs, logits, B, D, V, k,
                       H, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
