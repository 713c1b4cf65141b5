// The SpecEE exit gate of one exit point with quantized weights, one
// launch, one thread-block cluster of C CTAs per row b:
//   logits[j] = (hn[b] . code[:, ids[b, j]]) * scale[ids[b, j]]
//   probs     = softmax(logits)
//   feats     = [logits, probs, probs - prev[b]]
//   p_exit[b] = sigmoid((relu((feats . c1) * s1 + b1) . c2) * s2 + b2)
// all in fp32 (the body, its bound and its design: exit_gate.cuh). The head
// is fp (of hn's dtype), int8 codes (D, V) or plane-packed int4 (D/2, V)
// with column scales; the predictor bank fp32 or quantized (int8 or int4
// for each weight on its own); at least one of the two is quantized (the
// fp pair is exit_gate.cu's).
//
// Replaces the two Pallas kernels that the JAX package composes for a
// quantized gate (src/repro/kernels/exit_gate/ops.py, exit_gate under
// "kernel" with quantized weights): spec_head_logits_q (_kernel_q8 /
// _kernel_q4) in src/repro/kernels/spec_head/spec_head.py, then the
// softmax and the features in XLA, then predictor_mlp_fused_q (_kernel_q)
// in src/repro/kernels/predictor_mlp/predictor_mlp.py. Here none of the
// k logits, the probabilities or the 3k features leaves the cluster, and
// the five launches of the piecewise chain (the gather, the softmax, the
// difference, the concatenation, the MLP) become one.
//
// An int4 head's cluster splits its D/2 stored rows (each feeds hidden
// entries d and d + D/2), so a row moves half the sectors of an int8 one;
// each column's sum is scaled once after the rank-order sum, every CTA
// alike.
#include "exit_gate.cuh"

namespace {

template <typename T, typename W, typename Pred>
__global__ void __launch_bounds__(rt::EG_THREADS, 1)
exit_gate_q_kernel(const T* __restrict__ hn, W w,
                   const int* __restrict__ ids,
                   const float* __restrict__ prev, Pred pred,
                   float* __restrict__ p_out, float* __restrict__ probs_out,
                   float* __restrict__ logits_out, int D, int V, int k,
                   int H) {
  rt::exit_gate_row(hn, w, ids, prev, pred, p_out, probs_out, logits_out, D,
                    V, k, H);
}

// Everything of a launch but the hidden rows, the head and the bank
struct Io {
  const int* ids;
  const float* prev;
  float* p;
  float* probs;
  float* logits;
  int B, D, V, k, H;
  cudaStream_t st;
};

// The predictor bank's pointers as given (fp32 weights, or codes + scales)
struct Bank {
  const void *w1, *s1, *b1, *w2, *s2, *b2;
  int bits1, bits2;
};

template <typename T, typename W, typename Pred>
cudaError_t go(const void* hn, W w, Pred pred, const Io& io) {
  const int C = rt::cluster_size(io.D / W::P);
  return rt::launch_gate(exit_gate_q_kernel<T, W, Pred>, io.B, C, io.st,
                         static_cast<const T*>(hn), w, io.ids, io.prev, pred,
                         io.p, io.probs, io.logits, io.D, io.V, io.k, io.H);
}

template <typename T, typename W>
cudaError_t with_head(const void* hn, W w, const Bank& a, const Io& io) {
  const float* b1 = static_cast<const float*>(a.b1);
  const float* b2 = static_cast<const float*>(a.b2);
  if (a.bits1 == 0) {
    if constexpr (W::SCALED)
      return go<T>(hn, w, rt::FpPred{static_cast<const float*>(a.w1), b1,
                                     static_cast<const float*>(a.w2), b2},
                   io);
    else
      return cudaErrorInvalidValue;    // fp head and bank: exit_gate.cu
  }
  return go<T>(hn, w,
               rt::QPred{static_cast<const int8_t*>(a.w1),
                         static_cast<const float*>(a.s1), b1,
                         static_cast<const int8_t*>(a.w2),
                         static_cast<const float*>(a.s2), b2, a.bits1,
                         a.bits2},
               io);
}

template <typename T>
cudaError_t with_dtype(const void* hn, const void* w, const void* w_scale,
                       int head_bits, const Bank& a, const Io& io) {
  const int8_t* q = static_cast<const int8_t*>(w);
  const float* s = static_cast<const float*>(w_scale);
  if (head_bits == 8) return with_head<T>(hn, rt::Int8Cols{q, s}, a, io);
  if (head_bits == 4) return with_head<T>(hn, rt::Int4Cols{q, s}, a, io);
  return with_head<T>(hn, rt::FpCols<T>{static_cast<const T*>(w)}, a, io);
}

bool bits_ok(int bits, bool fp_allowed) {
  return bits == 8 || bits == 4 || (fp_allowed && bits == 0);
}

}  // namespace

extern "C" {

int exit_gate_q_max_k() { return rt::EG_MAXK; }
const char* exit_gate_q_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// hn (B, D) f32 or bf16. Head by head_bits: 0 — w (D, V) of hn's dtype
// (w_scale unused); 8 — int8 codes (D, V); 4 — packed (D/2, V); with
// w_scale (V,) f32. Bank by bits1: 0 — fp32 w1 (3k, H), w2 (H, 1) (s1, s2
// and bits2 unused); 8 or 4 — codes w1 (3k, H) or packed (3k/2, H), w2 by
// bits2 (H, 1) or packed (H/2, 1), scales s1 (H,), s2 (1,) f32. b1 (H,),
// b2 (1,) f32; ids (B, k) int32; prev (B, k) f32; outputs p (B,),
// probs (B, k), logits (B, k) f32. Returns cudaErrorInvalidValue for k
// outside [1, EG_MAXK], B outside [1, 65535], bits outside those listed,
// an odd D or 3k under int4, or an fp head with an fp bank.
int exit_gate_q_launch(const void* hn, const void* w, const void* w_scale,
                       const void* ids, const void* prev, const void* w1,
                       const void* s1, const void* b1, const void* w2,
                       const void* s2, const void* b2, void* p, void* probs,
                       void* logits, int B, int D, int V, int k, int H,
                       int head_bits, int bits1, int bits2, int dtype,
                       void* stream) {
  const bool fp_bank = bits1 == 0;
  if (k < 1 || k > rt::EG_MAXK || B < 1 || B > 65535 ||
      !bits_ok(head_bits, true) || !bits_ok(bits1, true) ||
      (!fp_bank && !bits_ok(bits2, false)) ||
      (head_bits == 0 && fp_bank) || (head_bits == 4 && D % 2) ||
      (bits1 == 4 && (3 * k) % 2) || (!fp_bank && bits2 == 4 && H % 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const Io io{static_cast<const int*>(ids), static_cast<const float*>(prev),
              static_cast<float*>(p), static_cast<float*>(probs),
              static_cast<float*>(logits), B, D, V, k, H,
              static_cast<cudaStream_t>(stream)};
  const Bank a{w1, s1, b1, w2, s2, b2, bits1, bits2};
  const cudaError_t e =
      dtype == rt::DT_BF16
          ? with_dtype<__nv_bfloat16>(hn, w, w_scale, head_bits, a, io)
          : with_dtype<float>(hn, w, w_scale, head_bits, a, io);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
