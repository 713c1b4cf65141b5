// The SpecEE exit gate of one exit point, one thread-block cluster of C
// CTAs per row b, shared by the fp gate (exit_gate.cu) and the quantized
// one (exit_gate_q.cu):
//   logits[j] = (hn[b] . W[:, ids[b, j]]) * scale[ids[b, j]]   (k columns)
//   probs     = softmax(logits)
//   feats     = [logits, probs, probs - prev[b]]               (3k)
//   p_exit[b] = sigmoid((relu((feats . W1) * s1 + b1) . W2) * s2 + b2)
// all in fp32; the logits, the features and the H hidden units never leave
// the cluster. The head is read through a column reader of common.cuh (fp
// weights, int8 codes or plane-packed int4 bytes; an fp head has no
// scale); the predictor through a weight form of predictor.cuh (fp32
// weights, no scales, or int8 / int4 codes with column scales s1 (H,) and
// s2 (1,)).
//
// Bound on the H100: bytes — the k * D useful head elements and the
// predictor weights per row; the arithmetic is tiny. The gather reads one
// 32-byte sector per stored head element (the strided layout note of
// spec_head.cuh): k * D sectors, 512 KB a row at D = 4096, k = 4 (half of
// that for int4, whose byte holds two hidden rows' codes). Through one SM
// that took ~15 us (one CTA per row, ~34 GB/s); the card moves it in well
// under a microsecond. So the design spreads each row over the card:
//   - grid (C, B), a cluster of C CTAs per row, C = ceil(Dp / 256) up to
//     8, the portable cluster size (non-portable clusters of 16 were
//     slower at D = 4096 on the H100), Dp = D / P the head's stored rows:
//     CTA c gathers the partial logits of its Dp / C stored rows
//     (spec_slice.cuh);
//   - the CTA loads its H / C hidden units' W1 columns (codes), s1, b1 and
//     W2 before the gather, so those loads are in flight with it, as are
//     the k column scales;
//   - each CTA stores its partials into every peer's shared memory; after
//     a cluster barrier every CTA sums the C partials in rank order and
//     multiplies each sum by its column's scale: every CTA holds the same
//     logits, bit for bit, whatever the scheduling, and computes the
//     softmax and the 3k features itself;
//   - each CTA computes its hidden units' share of relu(.).W2 and stores
//     it into rank 0's shared memory; after a second barrier rank 0 sums
//     the C shares in rank order, applies s2 and b2 (the Pallas order of
//     predictor_mlp_fused_q) and writes p_exit, probs and logits.
// Only stores cross the cluster, each before a barrier that orders it, so
// no CTA reads a peer's shared memory and none waits for another's reads
// before it exits. A first barrier phase, arrived at on entry and awaited
// before the first remote store, makes sure every CTA of the cluster has
// started (its shared memory exists).
// No global workspace, no ticket, one launch.
#pragma once

#include <algorithm>

#include <cooperative_groups.h>

#include "predictor.cuh"
#include "spec_slice.cuh"

namespace rt {

namespace cg = cooperative_groups;

constexpr int EG_THREADS = 256;
constexpr int EG_WARPS = EG_THREADS / 32;
constexpr int EG_MAXK = SH_MAXK;
constexpr int EG_MAX_C = 8;             // CTAs of a row's cluster, at most
constexpr int EG_ROWS = EG_THREADS;     // head rows per CTA, at least
// Both kernels are declared __launch_bounds__(EG_THREADS, 1): without the
// minimum of one block, ptxas gave the int8-head instances 80 registers
// and spilled, and their gather took its two rows a thread one after the
// other (scripts/probe_exit_gate.py times both builds).

// CTAs per row for Dp stored head rows: one stored row per thread where
// the cluster allows it (at D = 4096 two per thread, one for int4)
inline int cluster_size(int Dp) {
  return std::min(EG_MAX_C, std::max(1, (Dp + EG_ROWS - 1) / EG_ROWS));
}

// The gate of row blockIdx.y, run by every CTA of its cluster.
template <typename T, typename W, typename Pred>
__device__ __forceinline__ void exit_gate_row(
    const T* __restrict__ hn, W w, const int* __restrict__ ids,
    const float* __restrict__ prev, Pred pred, float* __restrict__ p_out,
    float* __restrict__ probs_out, float* __restrict__ logits_out, int D,
    int V, int k, int H) {
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
  // each thread), the previous probabilities and column scales (lanes
  // j < k), b2 and s2 (rank 0)
  const int Hc = (H + C - 1) / C, h_lo = c * Hc, h_hi = min(H, h_lo + Hc);
  const int h0 = h_lo + tid;
  float w1r[3 * EG_MAXK], b1r = 0.f, w2r = 0.f, s1r = 1.f;
  if (h0 < h_hi) {
    pred.w1_col(h0, F, H, w1r);
    b1r = __ldg(pred.b1 + h0);
    w2r = pred.w2_at(h0, H);
    s1r = pred.s1(h0);
  }
  float pv = 0.f, cs = 1.f, bias = 0.f, s2 = 1.f;
  if (tid < k) {
    pv = prev[b * k + tid];
    if constexpr (W::SCALED)
      cs = w.scale(spec_col(ids + (size_t)b * k, tid, V));
  }
  if (c == 0 && tid == 0) {
    bias = pred.b2[0];
    s2 = pred.s2();
  }

  const int Dp = D / W::P, Dc = (Dp + C - 1) / C;   // stored rows
  const float part = spec_slice<EG_THREADS>(
      hn + (size_t)b * D, w, ids + (size_t)b * k, c * Dc,
      min(Dp, (c + 1) * Dc), D, V, k, red);
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
      if constexpr (W::SCALED) s *= cs;
    }
    float m = lane < k ? s : -CUDART_INF_F;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    const float e = lane < k ? expf(s - m) : 0.f;
    const float z = warp_sum(e);
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
  if (h0 < h_hi)
    share = fmaxf(hidden_unit<Pred, 3 * EG_MAXK>(s_feats, w1r, F, s1r,
                                                   b1r), 0.f) * w2r;
  for (int h = h0 + EG_THREADS; h < h_hi; h += EG_THREADS) {
    float hid = Pred::SCALED ? 0.f : __ldg(pred.b1 + h);
    for (int f = 0; f < F; ++f)
      hid = fmaf(s_feats[f], pred.w1_at(f, h, F, H), hid);
    if constexpr (Pred::SCALED)
      hid = fmaf(hid, pred.s1(h), __ldg(pred.b1 + h));
    share = fmaf(fmaxf(hid, 0.f), pred.w2_at(h, H), share);
  }
  share = warp_sum(share);
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
    o = Pred::SCALED ? fmaf(o, s2, bias) : o + bias;
    p_out[b] = 1.f / (1.f + expf(-o));
  }
}

// One launch of ``kernel`` on grid (C, B) in clusters of (C, 1, 1)
template <typename... KArgs, typename... Args>
cudaError_t launch_gate(void (*kernel)(KArgs...), int B, int C,
                        cudaStream_t st, Args... args) {
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
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace rt
