// Decode attention against a dense (B, S, KVH, hd) KV cache with a per-row
// live length and an optional sliding window. The math and the CTA design
// are in decode_attention.cuh, shared with paged_decode_attention.cu.
//
// Replaces the Pallas kernel decode_attention_fwd (_kernel and
// _online_softmax_step) in src/repro/kernels/decode_attention/
// decode_attention.py, which walks key tiles in order with online-softmax
// scratch and skips dead tiles with pl.when.
//
// Grid (B, KVH): one CTA per (row, KV head) — 128 CTAs for Llama-2-7B at
// B = 4.
//
// Bound on the H100: bytes — the live K and V prefix, read once:
// 2 * B * L * KVH * hd * sizeof(T) per layer. Split-KV across CTAs (for
// long caches or small B * KVH) is later work.
#include "decode_attention.cuh"

namespace {

template <typename T, int NREP, int E>
__global__ void __launch_bounds__(da::DA_WARPS * 32)
decode_attention_kernel(const T* __restrict__ q, const da::FpKV<T> kv,
                        const int* __restrict__ cache_len,
                        T* __restrict__ out, int S, int KVH, int window,
                        float scale) {
  constexpr int HD = 32 * E;
  const int b = blockIdx.x, g = blockIdx.y;
  const int len = min(cache_len[b], S);
  const int lo = window > 0 ? max(0, len - window) : 0;
  const da::DenseAddr addr{((size_t)b * S * KVH + g) * HD, (size_t)KVH * HD};
  da::decode_body<T, NREP, E>(q, kv, out, b, g, KVH, lo, len, scale, addr);
}

template <typename T, int NREP, int E>
struct Launch {
  static void run(const void* q, const void* k, const void* v,
                  const void* clen, void* out, int B, int S, int KVH,
                  int window, float scale, cudaStream_t st) {
    decode_attention_kernel<T, NREP, E>
        <<<dim3(B, KVH), da::DA_WARPS * 32, 0, st>>>(
            static_cast<const T*>(q),
            da::FpKV<T>{static_cast<const T*>(k), static_cast<const T*>(v)},
            static_cast<const int*>(clen),
            static_cast<T*>(out), S, KVH, window, scale);
  }
};

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
  const bool ok = rt::dispatch<Launch>(dtype, H / KVH, hd, q, k, v,
                                       cache_len, out, B, S, KVH, window,
                                       scale, st);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
