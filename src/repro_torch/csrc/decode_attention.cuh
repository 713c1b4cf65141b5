// Decode attention body of the dense kernel (decode_attention.cu): one
// query token per row against that row's live K/V prefix, with an optional
// sliding window.
//   out[b, h] = softmax_s(q[b, h] . k[b, s, g] / sqrt(hd)) . v[b, s, g]
// over lo <= s < len, lo = max(0, len - window), h = g * n_rep + r (GQA:
// the n_rep query heads of a KV head share its K/V). Where key s of row b
// lives is answered by an addressing functor (DenseAddr: element offset of
// the key's (g, 0) entry in a (B, S, KVH, hd) cache), how its K and V are
// stored by a reader (FpKV: K/V in the compute type). The paged kernels
// have their own split-KV body (paged_attention_split.cuh).
//
// CTA = one (row, KV head). DA_WARPS warps split the live keys DA_U at a
// time; each lane holds hd/32 consecutive elements of q, k, v, so one key's
// K (or V) row is one coalesced read per warp (2*hd bytes in bf16). Each
// warp keeps its own online softmax (m, l, acc) per query head in fp32;
// the warps' states merge in shared memory at the end. Keys outside [lo,
// len) are never read (the tail of the last group of DA_U re-reads key
// len - 1 and gets probability 0), and l == 0 (no live key) writes zeros,
// as the Pallas l == 0 guard does.
#pragma once

#include "common.cuh"

namespace da {

constexpr int DA_WARPS = 8;   // warps per CTA, each on its own keys
constexpr int DA_U = 4;       // keys per warp per iteration (loads in flight)

// key s of row b in a dense (B, S, KVH, hd) cache
struct DenseAddr {
  size_t row_base;            // ((b * S) * KVH + g) * hd
  size_t key_stride;          // KVH * hd
  __device__ __forceinline__ size_t operator()(int s) const {
    return row_base + (size_t)s * key_stride;
  }
};

// E consecutive values of a lane in one load of E * sizeof(T) bytes (8
// bytes of bf16 at hd = 128); the wrapper checks that the cache is
// aligned to it
__device__ __forceinline__ void load_vals(const float* p, float (&x)[4]) {
  const float4 f = __ldg(reinterpret_cast<const float4*>(p));
  x[0] = f.x; x[1] = f.y; x[2] = f.z; x[3] = f.w;
}
__device__ __forceinline__ void load_vals(const float* p, float (&x)[2]) {
  const float2 f = __ldg(reinterpret_cast<const float2*>(p));
  x[0] = f.x; x[1] = f.y;
}
__device__ __forceinline__ void load_vals(const float* p, float (&x)[1]) {
  x[0] = __ldg(p);
}
__device__ __forceinline__ void load_vals(const __nv_bfloat16* p,
                                          float (&x)[4]) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
}
__device__ __forceinline__ void load_vals(const __nv_bfloat16* p,
                                          float (&x)[2]) {
  const __nv_bfloat162 h = __ldg(reinterpret_cast<const __nv_bfloat162*>(p));
  const float2 a = __bfloat1622float2(h);
  x[0] = a.x; x[1] = a.y;
}
__device__ __forceinline__ void load_vals(const __nv_bfloat16* p,
                                          float (&x)[1]) {
  x[0] = __bfloat162float(__ldg(p));
}

// K and V of one key as a lane's E consecutive fp32 values, through the
// read-only path. ``base`` is the element offset of the key's (slot, g, 0)
// entry.
template <typename T>
struct FpKV {
  const T* k;
  const T* v;
  template <int E>
  __device__ __forceinline__ void load(size_t base, int lane, float (&kr)[E],
                                       float (&vr)[E]) const {
    const size_t i = base + lane * E;
    load_vals(k + i, kr);
    load_vals(v + i, vr);
  }
};

template <typename T, int NREP, int E, typename KV, typename Addr>
__device__ __forceinline__ void decode_body(
    const T* __restrict__ q, const KV kv, T* __restrict__ out, int b, int g,
    int KVH, int lo, int len, float scale, Addr addr) {
  constexpr int HD = 32 * E;
  __shared__ float s_m[DA_WARPS][NREP];
  __shared__ float s_l[DA_WARPS][NREP];
  __shared__ float s_acc[DA_WARPS][NREP][HD];
  const int H = KVH * NREP;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;

  float qr[NREP][E], acc[NREP][E], m[NREP], l[NREP];
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
    const T* qp = q + ((size_t)b * H + g * NREP + r) * HD + lane * E;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      qr[r][e] = rt::to_f(qp[e]);
      acc[r][e] = 0.f;
    }
    m[r] = rt::NEG_INF;
    l[r] = 0.f;
  }

  for (int s0 = lo + wid * DA_U; s0 < len; s0 += DA_WARPS * DA_U) {
    // keys past len load the last live key instead (always a valid
    // address, so all 2 * DA_U loads issue back to back without branches);
    // their probability is 0 below
    float kr[DA_U][E], vr[DA_U][E];
#pragma unroll
    for (int u = 0; u < DA_U; ++u)
      kv.template load<E>(addr(min(s0 + u, len - 1)), lane, kr[u], vr[u]);
#pragma unroll
    for (int r = 0; r < NREP; ++r) {
      float sc[DA_U];
#pragma unroll
      for (int u = 0; u < DA_U; ++u) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) d = fmaf(qr[r][e], kr[u][e], d);
        sc[u] = d;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int u = 0; u < DA_U; ++u)
          sc[u] += __shfl_xor_sync(0xffffffffu, sc[u], off);
      }
      float mx = m[r];
#pragma unroll
      for (int u = 0; u < DA_U; ++u) {
        sc[u] *= scale;
        if (s0 + u < len) mx = fmaxf(mx, sc[u]);
      }
      const float alpha = expf(m[r] - mx);
      float p[DA_U];
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < DA_U; ++u) {
        p[u] = s0 + u < len ? expf(sc[u] - mx) : 0.f;
        psum += p[u];
      }
      l[r] = alpha * l[r] + psum;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        float a = acc[r][e] * alpha;
#pragma unroll
        for (int u = 0; u < DA_U; ++u) a = fmaf(p[u], vr[u][e], a);
        acc[r][e] = a;
      }
      m[r] = mx;
    }
  }

#pragma unroll
  for (int r = 0; r < NREP; ++r) {
    if (lane == 0) { s_m[wid][r] = m[r]; s_l[wid][r] = l[r]; }
#pragma unroll
    for (int e = 0; e < E; ++e) s_acc[wid][r][lane * E + e] = acc[r][e];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < NREP * HD; t += DA_WARPS * 32) {
    const int r = t / HD, c = t - r * HD;
    float M = rt::NEG_INF;
#pragma unroll
    for (int w = 0; w < DA_WARPS; ++w) M = fmaxf(M, s_m[w][r]);
    float L = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < DA_WARPS; ++w) {
      const float f = expf(s_m[w][r] - M);
      L = fmaf(s_l[w][r], f, L);
      o = fmaf(s_acc[w][r][c], f, o);
    }
    if (L == 0.f) L = 1.f;
    rt::store_f(out + ((size_t)b * H + g * NREP + r) * HD + c, o / L);
  }
}

}  // namespace da
