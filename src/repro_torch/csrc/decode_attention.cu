// Decode attention: one query token per row against a dense (B, S, KVH, hd)
// KV cache, with a per-row live length and an optional sliding window.
//   out[b, h] = softmax_s(q[b, h] . k[b, s, g] / sqrt(hd)) . v[b, s, g]
// over lo <= s < cache_len[b], lo = max(0, cache_len[b] - window), with
// h = g * n_rep + r (GQA: the n_rep query heads of a KV head share its K/V).
//
// Replaces the Pallas kernel decode_attention_fwd (_kernel and
// _online_softmax_step) in src/repro/kernels/decode_attention/
// decode_attention.py, which walks key tiles in order with online-softmax
// scratch and skips dead tiles with pl.when.
//
// Grid (B, KVH): one CTA per (row, KV head) — 128 CTAs for Llama-2-7B at
// B = 4. The CTA's DA_WARPS warps split the live keys DA_U at a time; each
// lane holds hd/32 consecutive elements of q, k, v, so one key's K (or V)
// row is one coalesced 2*hd-byte read per warp. Each warp keeps its own
// online softmax (m, l, acc) per query head in fp32; the warps' states merge
// in shared memory at the end. Keys outside [lo, cache_len) are never read,
// masked scores inside a group of DA_U get probability 0, and l == 0 (no
// live key) writes zeros, as the Pallas l == 0 guard does.
//
// Bound on the H100: bytes — the live K and V prefix, read once:
// 2 * B * L * KVH * hd * sizeof(T) per layer. Split-KV across CTAs (for
// long caches or small B * KVH) is later work.
#include "common.cuh"

namespace {

constexpr int DA_WARPS = 8;   // warps per CTA, each on its own keys
constexpr int DA_U = 4;       // keys per warp per iteration (loads in flight)

template <typename T, int NREP, int E>
__global__ void __launch_bounds__(DA_WARPS * 32)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                        const T* __restrict__ vc,
                        const int* __restrict__ cache_len,
                        T* __restrict__ out, int S, int KVH, int window,
                        float scale) {
  constexpr int HD = 32 * E;
  __shared__ float s_m[DA_WARPS][NREP];
  __shared__ float s_l[DA_WARPS][NREP];
  __shared__ float s_acc[DA_WARPS][NREP][HD];
  const int b = blockIdx.x, g = blockIdx.y;
  const int H = KVH * NREP;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int len = min(cache_len[b], S);
  const int lo = window > 0 ? max(0, len - window) : 0;

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
    float kr[DA_U][E], vr[DA_U][E];
#pragma unroll
    for (int u = 0; u < DA_U; ++u) {
      const int s = s0 + u;
      const size_t base = (((size_t)b * S + s) * KVH + g) * HD + lane * E;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        kr[u][e] = s < len ? rt::to_f(kc[base + e]) : 0.f;
        vr[u][e] = s < len ? rt::to_f(vc[base + e]) : 0.f;
      }
    }
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

template <typename T, int NREP, int E>
void launch(const void* q, const void* k, const void* v, const void* clen,
            void* out, int B, int S, int KVH, int window, float scale,
            cudaStream_t st) {
  decode_attention_kernel<T, NREP, E><<<dim3(B, KVH), DA_WARPS * 32, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(clen),
      static_cast<T*>(out), S, KVH, window, scale);
}

template <typename T, int NREP>
bool dispatch_e(int hd, const void* q, const void* k, const void* v,
                const void* clen, void* out, int B, int S, int KVH,
                int window, float scale, cudaStream_t st) {
  switch (hd) {
    case 32: launch<T, NREP, 1>(q, k, v, clen, out, B, S, KVH, window, scale, st); return true;
    case 64: launch<T, NREP, 2>(q, k, v, clen, out, B, S, KVH, window, scale, st); return true;
    case 128: launch<T, NREP, 4>(q, k, v, clen, out, B, S, KVH, window, scale, st); return true;
    default: return false;
  }
}

template <typename T>
bool dispatch(int n_rep, int hd, const void* q, const void* k, const void* v,
              const void* clen, void* out, int B, int S, int KVH, int window,
              float scale, cudaStream_t st) {
  switch (n_rep) {
    case 1: return dispatch_e<T, 1>(hd, q, k, v, clen, out, B, S, KVH, window, scale, st);
    case 2: return dispatch_e<T, 2>(hd, q, k, v, clen, out, B, S, KVH, window, scale, st);
    case 4: return dispatch_e<T, 4>(hd, q, k, v, clen, out, B, S, KVH, window, scale, st);
    case 8: return dispatch_e<T, 8>(hd, q, k, v, clen, out, B, S, KVH, window, scale, st);
    default: return false;
  }
}

}  // namespace

extern "C" {

const char* decode_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q (B, 1, H, hd), k/v (B, S, KVH, hd) of one dtype, cache_len (B,) int32,
// out (B, 1, H, hd) in q's dtype. window <= 0 means no window. Returns
// cudaErrorInvalidValue for an (n_rep, hd) pair without an instance
// (n_rep in {1, 2, 4, 8}, hd in {32, 64, 128}).
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const void* cache_len, void* out, int B, int S,
                            int H, int KVH, int hd, int window, int dtype,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale = 1.f / sqrtf(static_cast<float>(hd));
  const int n_rep = H / KVH;
  const bool ok =
      dtype == rt::DT_BF16
          ? dispatch<__nv_bfloat16>(n_rep, hd, q, k, v, cache_len, out, B, S,
                                    KVH, window, scale, st)
          : dispatch<float>(n_rep, hd, q, k, v, cache_len, out, B, S, KVH,
                            window, scale, st);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
