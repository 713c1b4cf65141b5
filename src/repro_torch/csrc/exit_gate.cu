// Fused SpecEE exit gate for one exit point, one thread-block cluster of C
// CTAs per row b:
//   logits[j] = hn[b] . W[:, ids[b, j]]            (k gathered head columns)
//   probs     = softmax(logits)
//   feats     = [logits, probs, probs - prev[b]]   (3k)
//   p_exit[b] = sigmoid(relu(feats . W1 + b1) . W2 + b2)
// all in fp32; the logits, the features and the H hidden units never leave
// the cluster.
//
// Replaces the Pallas kernel exit_gate_fused (_gate_kernel) in
// src/repro/kernels/exit_gate/exit_gate.py, whose (B, k, nd) grid gathers
// column blocks through scalar-prefetched index maps.
//
// Bound on the H100: bytes — the k * D useful head elements and the
// predictor weights (3k*H + 2H + 1 floats) per row; the arithmetic is tiny.
// The gather reads one 32-byte sector per head element (the strided layout
// note of spec_head.cuh): k * D sectors, 512 KB a row at D = 4096, k = 4.
// Through one SM that took ~15 us (one CTA per row, ~34 GB/s); the card
// moves it in well under a microsecond. So the design spreads each row
// over the card:
//   - grid (C, B), a cluster of C CTAs per row, C = ceil(D / 256) up to
//     8, the portable cluster size (non-portable clusters of 16 were
//     slower at D = 4096 on the H100): CTA c gathers the partial logits of
//     its D / C head rows (spec_slice.cuh);
//   - the CTA loads its H / C hidden units' W1 columns, b1 and W2 before the
//     gather, so those loads are in flight with it;
//   - each CTA stores its partials into every peer's shared memory; after
//     a cluster barrier every CTA sums the C partials in rank order: every
//     CTA holds the same logits, bit for bit, whatever the scheduling, and
//     computes the softmax and the 3k features itself;
//   - each CTA computes its hidden units' share of relu(feats.W1 + b1).W2
//     and stores it into rank 0's shared memory; after a second barrier
//     rank 0 sums the C shares in rank order, adds b2 and writes p_exit,
//     probs and logits.
// Only stores cross the cluster, each before a barrier that orders it, so
// no CTA reads a peer's shared memory and none waits for another's reads
// before it exits. A first barrier phase, arrived at on entry and awaited
// before the first remote store, makes sure every CTA of the cluster has
// started (its shared memory exists).
// No global workspace, no ticket, one launch.
#include <algorithm>

#include <cooperative_groups.h>

#include "spec_slice.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int EG_THREADS = 256;
constexpr int EG_WARPS = EG_THREADS / 32;
constexpr int EG_MAXK = rt::SH_MAXK;
constexpr int EG_MAX_C = 8;             // CTAs of a row's cluster, at most
constexpr int EG_ROWS = EG_THREADS;     // head rows per CTA, at least

// CTAs per row for a hidden size D: one head row per thread where the
// cluster allows it (at D = 4096 two per thread)
int cluster_size(int D) {
  return std::min(EG_MAX_C, std::max(1, (D + EG_ROWS - 1) / EG_ROWS));
}

template <typename T>
__global__ void __launch_bounds__(EG_THREADS)
exit_gate_kernel(const T* __restrict__ hn, rt::FpCols<T> w,
                 const int* __restrict__ ids, const float* __restrict__ prev,
                 const float* __restrict__ w1, const float* __restrict__ b1,
                 const float* __restrict__ w2, const float* __restrict__ b2,
                 float* __restrict__ p_out, float* __restrict__ probs_out,
                 float* __restrict__ logits_out, int D, int V, int k, int H) {
  __shared__ float red[EG_MAXK][EG_WARPS];
  __shared__ float s_peer[EG_MAX_C][EG_MAXK];   // partial logits by rank
  __shared__ float s_feats[3 * EG_MAXK];
  __shared__ float s_warp[EG_WARPS];
  __shared__ float s_shares[EG_MAX_C];          // MLP shares by rank (rank 0)
  cg::cluster_group cluster = cg::this_cluster();
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int C = static_cast<int>(cluster.num_blocks());
  const int c = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int F = 3 * k;

  // loads that the gather does not feed, issued first so they are in
  // flight with it: this CTA's hidden units [h_lo, h_hi) (the first one of
  // each thread), the previous probabilities (lanes j < k), b2 (rank 0)
  const int Hc = (H + C - 1) / C, h_lo = c * Hc, h_hi = min(H, h_lo + Hc);
  const int h0 = h_lo + tid;
  float w1r[3 * EG_MAXK], b1r = 0.f, w2r = 0.f;
  if (h0 < h_hi) {
#pragma unroll
    for (int f = 0; f < 3 * EG_MAXK; ++f)
      if (f < F) w1r[f] = __ldg(w1 + (size_t)f * H + h0);
    b1r = __ldg(b1 + h0);
    w2r = __ldg(w2 + h0);
  }
  float pv = 0.f, bias = 0.f;
  if (tid < k) pv = prev[b * k + tid];
  if (c == 0 && tid == 0) bias = b2[0];

  const int Dc = (D + C - 1) / C;
  const float part = rt::spec_slice<EG_THREADS>(
      hn + (size_t)b * D, w, ids + (size_t)b * k, c * Dc,
      min(D, (c + 1) * Dc), D, V, k, red);
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (tid < k) {
#pragma unroll
    for (int r = 0; r < EG_MAX_C; ++r)
      if (r < C) *cluster.map_shared_rank(&s_peer[c][tid], r) = part;
  }
  cluster.sync();                          // every CTA's partials stored
  if (wid == 0) {                          // lane j < k: logit j, its prob
    float s = 0.f;
    if (lane < k) {
#pragma unroll
      for (int r = 0; r < EG_MAX_C; ++r)
        if (r < C) s += s_peer[r][lane];   // rank order
    }
    float m = lane < k ? s : -CUDART_INF_F;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    const float e = lane < k ? expf(s - m) : 0.f;
    const float z = rt::warp_sum(e);
    if (lane < k) {
      const float p = e / z;
      s_feats[lane] = s;
      s_feats[k + lane] = p;
      s_feats[2 * k + lane] = p - pv;
      if (c == 0) {
        probs_out[b * k + lane] = p;
        logits_out[b * k + lane] = s;
      }
    }
  }
  __syncthreads();

  float share = 0.f;
  if (h0 < h_hi) {
    float hid = b1r;
#pragma unroll
    for (int f = 0; f < 3 * EG_MAXK; ++f)
      if (f < F) hid = fmaf(s_feats[f], w1r[f], hid);
    share = fmaxf(hid, 0.f) * w2r;
  }
  for (int h = h0 + EG_THREADS; h < h_hi; h += EG_THREADS) {
    float hid = b1[h];
    for (int f = 0; f < F; ++f) hid = fmaf(s_feats[f], w1[f * H + h], hid);
    share = fmaf(fmaxf(hid, 0.f), w2[h], share);
  }
  share = rt::warp_sum(share);
  if (lane == 0) s_warp[wid] = share;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int q = 0; q < EG_WARPS; ++q) s += s_warp[q];
    *cluster.map_shared_rank(&s_shares[c], 0) = s;
  }
  cluster.sync();                          // every CTA's share stored
  if (c == 0 && tid == 0) {
    float o = 0.f;
#pragma unroll
    for (int r = 0; r < EG_MAX_C; ++r)
      if (r < C) o += s_shares[r];                       // rank order
    p_out[b] = 1.f / (1.f + expf(-(o + bias)));
  }
}

// One launch of grid (C, B) in clusters of (C, 1, 1)
template <typename T, typename... Args>
cudaError_t launch(int B, int C, cudaStream_t st, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, B);
  cfg.blockDim = dim3(EG_THREADS);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, exit_gate_kernel<T>, args...);
}

}  // namespace

extern "C" {

int exit_gate_max_k() { return EG_MAXK; }
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
  if (k < 1 || k > EG_MAXK || B < 1 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int C = cluster_size(D);
#define EG_ARGS(T)                                                         \
  static_cast<const T*>(hn), rt::FpCols<T>{static_cast<const T*>(w)},     \
      static_cast<const int*>(ids), static_cast<const float*>(prev),       \
      static_cast<const float*>(w1), static_cast<const float*>(b1),        \
      static_cast<const float*>(w2), static_cast<const float*>(b2),        \
      static_cast<float*>(p), static_cast<float*>(probs),                  \
      static_cast<float*>(logits), D, V, k, H
  const cudaError_t e =
      dtype == rt::DT_BF16
          ? launch<__nv_bfloat16>(B, C, st, EG_ARGS(__nv_bfloat16))
          : launch<float>(B, C, st, EG_ARGS(float));
#undef EG_ARGS
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
