// The SpecEE exit predictor's weight forms and its 2-layer MLP over a
// block of rows, shared by the fused exit gates (exit_gate.cuh) and the
// tree gate's predictors (predictor_mlp.cu, predictor_mlp_q.cu):
//   p[r] = sigmoid((relu((x[r] . W1) * s1 + b1) . W2) * s2 + b2)
// in fp32; a weight form gives W1's columns, s1, b1, W2's entries and s2
// (fp32 weights: no scales; int8 / int4 codes: per-column scales applied
// after each dot, the Pallas order of predictor_mlp_fused_q).
#pragma once

#include "common.cuh"

namespace rt {

// Predictor weights in fp32: W1 (F, H), b1 (H,), W2 (H, 1), b2 (1,).
struct FpPred {
  static constexpr bool SCALED = false;
  const float* w1;
  const float* b1;
  const float* w2;
  const float* b2;
  __device__ __forceinline__ float w1_at(int f, int h, int, int H) const {
    return __ldg(w1 + (size_t)f * H + h);
  }
  // W1's column h, rows f < F <= MAXF
  template <int MAXF>
  __device__ __forceinline__ void w1_col(int h, int F, int H,
                                         float (&x)[MAXF]) const {
#pragma unroll
    for (int f = 0; f < MAXF; ++f)
      if (f < F) x[f] = w1_at(f, h, F, H);
  }
  __device__ __forceinline__ float w2_at(int h, int) const {
    return __ldg(w2 + h);
  }
  __device__ __forceinline__ float s1(int) const { return 1.f; }
  __device__ __forceinline__ float s2() const { return 1.f; }
};

// Quantized predictor weights (repro_torch.quant's layout): W1 as int8
// codes (F, H) or plane-packed int4 (F/2, H) with column scales s1 (H,),
// W2 as codes (H, 1) or packed (H/2, 1) with scale s2 (1,), each weight's
// bits on its own (an odd F quantizes W1 to int8 even under int4); fp32
// biases.
struct QPred {
  static constexpr bool SCALED = true;
  const int8_t* q1;
  const float* sc1;
  const float* b1;
  const int8_t* q2;
  const float* sc2;
  const float* b2;
  int bits1, bits2;
  __device__ __forceinline__ float w1_at(int f, int h, int F, int H) const {
    return code_at(q1, bits1, f, h, F, H);
  }
  // W1's column h, rows f < F <= MAXF, the bits chosen once for the
  // column (int4: rows f < F/2 from the low nibbles, the rest from the
  // high nibbles of the same F/2 bytes)
  template <int MAXF>
  __device__ __forceinline__ void w1_col(int h, int F, int H,
                                         float (&x)[MAXF]) const {
    if (bits1 == 8) {
#pragma unroll
      for (int f = 0; f < MAXF; ++f)
        if (f < F) x[f] = code_at(q1, 8, f, h, F, H);
    } else {
#pragma unroll
      for (int f = 0; f < MAXF; ++f)
        if (f < F) x[f] = code_at(q1, 4, f, h, F, H);
    }
  }
  __device__ __forceinline__ float w2_at(int h, int H) const {
    return code_at(q2, bits2, h, 0, H, 1);
  }
  __device__ __forceinline__ float s1(int h) const { return __ldg(sc1 + h); }
  __device__ __forceinline__ float s2() const { return __ldg(sc2); }
};

// Hidden unit h before the ReLU, from the F features and W1's column h
// (codes for a scaled form: the dot, then s1[h], then b1[h])
template <typename Pred, int MAXF>
__device__ __forceinline__ float hidden_unit(const float* feats,
                                             const float* w1c, int F,
                                             float s1, float b1) {
  if constexpr (Pred::SCALED) {
    float dot = 0.f;
#pragma unroll
    for (int f = 0; f < MAXF; ++f)
      if (f < F) dot = fmaf(feats[f], w1c[f], dot);
    return fmaf(dot, s1, b1);
  } else {
    float hid = b1;
#pragma unroll
    for (int f = 0; f < MAXF; ++f)
      if (f < F) hid = fmaf(feats[f], w1c[f], hid);
    return hid;
  }
}

constexpr int PR_THREADS = 256;           // threads of a row block's CTA
constexpr int PR_WARPS = PR_THREADS / 32;
constexpr int PR_MAXF = 32;               // features per row, at most

// One hidden unit's weights, held in registers while a block's rows use it
template <typename Pred, int MAXF>
struct PredUnit {
  float w1c[MAXF];
  float s1, b1, w2;
  __device__ __forceinline__ void load(const Pred& pred, int h, int F,
                                       int H) {
    pred.w1_col(h, F, H, w1c);
    s1 = pred.s1(h);
    b1 = __ldg(pred.b1 + h);
    w2 = pred.w2_at(h, H);
  }
};

// The predictor over rows [RB * blockIdx.x, RB * blockIdx.x + RB) of
// x (R, F), F <= MAXF, one CTA of PR_THREADS threads. The feature loops
// are unrolled to MAXF, each step past F predicated off: take the least
// MAXF that holds F (predicated-off steps are not free: at F = 12,
// unrolled to 32, predictor_mlp_q.cu took 1.5x as long; PERF.md).
// Each thread takes the hidden units h = t, t + PR_THREADS, ... in order;
// for each it loads W1's column, s1, b1 and W2's entry once (coalesced
// across threads; its first unit's loads issued before the block's rows
// are staged in shared memory) and adds relu(hidden) * W2[h] of every row
// of the block to the row's partial sum by fmaf. The partials of a row
// are then summed in a fixed order: a butterfly within each warp (xor 16,
// 8, 4, 2, 1), then the warps' sums in warp order; thread r of the block
// then applies s2 and b2 (fmaf for a scaled form) and the sigmoid. So a
// row's probability depends only on its features and the weights, not on
// R or RB.
template <typename Pred, int RB, int MAXF>
__device__ __forceinline__ void predictor_rows(const float* __restrict__ x,
                                               const Pred& pred,
                                               float* __restrict__ out,
                                               int R, int F, int H) {
  __shared__ float s_x[RB][MAXF];
  __shared__ float s_red[RB][PR_WARPS];
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int r0 = blockIdx.x * RB;
  PredUnit<Pred, MAXF> u;
  if (tid < H) u.load(pred, tid, F, H);
  for (int i = tid; i < RB * MAXF; i += PR_THREADS) {
    const int r = i / MAXF, f = i % MAXF;
    s_x[r][f] = r0 + r < R && f < F ? __ldg(x + (size_t)(r0 + r) * F + f)
                                    : 0.f;
  }
  __syncthreads();
  float part[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) part[r] = 0.f;
  for (int h = tid; h < H; h += PR_THREADS) {
    if (h != tid) u.load(pred, h, F, H);
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const float hid = hidden_unit<Pred, MAXF>(s_x[r], u.w1c, F, u.s1,
                                                u.b1);
      part[r] = fmaf(fmaxf(hid, 0.f), u.w2, part[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    const float s = warp_sum(part[r]);
    if (lane == 0) s_red[r][wid] = s;
  }
  __syncthreads();
  if (tid < RB && r0 + tid < R) {
    float o = 0.f;
#pragma unroll
    for (int q = 0; q < PR_WARPS; ++q) o += s_red[tid][q];     // warp order
    o = Pred::SCALED ? fmaf(o, pred.s2(), __ldg(pred.b2))
                     : o + __ldg(pred.b2);
    out[r0 + tid] = 1.f / (1.f + expf(-o));
  }
}

}  // namespace rt
