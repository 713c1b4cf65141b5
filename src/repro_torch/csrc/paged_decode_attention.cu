// Paged decode attention: one query token per row against K/V read through
// a page table from a pool shared by all rows. Key s of row b lives at
// physical slot page_table[b, s / ps] * ps + s % ps of the (NP, ps, KVH, hd)
// pools. The math and the CTA design are in decode_attention.cuh, shared
// with the dense kernel (decode_attention.cu).
//
// Replaces the Pallas kernel paged_decode_attention_fwd (_paged_kernel) in
// src/repro/kernels/decode_attention/decode_attention.py. There the page
// table is scalar-prefetched and consumed by the K/V BlockSpec index maps,
// one page per grid step, and pages past the live prefix are clamped to the
// last live page so their DMA is elided: a compacted (retired) row costs no
// bytes. Here a CTA copies its row's live page ids into shared memory once
// and reads only keys in [lo, len) (da::paged_decode_attention_kernel), so
// the same holds.
//
// Grid (B, KVH). Offsets are 64-bit: page * ps * KVH * hd overflows int32
// for pools beyond 2**31 elements. A retired row (table row all trash page,
// cache_len 1) reads one key of the trash page; its output is never used.
//
// Bound on the H100: bytes — the live K and V keys, read once:
// 2 * sum_b (len_b - lo_b) * KVH * hd * sizeof(T) per layer.
#include "decode_attention.cuh"

namespace {

template <typename T, int NREP, int E>
struct Launch {
  static void run(const void* q, const void* k, const void* v,
                  const void* table, const void* clen, void* out, int B,
                  int P, int ps, int KVH, int window, float scale,
                  cudaStream_t st) {
    const da::FpKV<T> kv{static_cast<const T*>(k), static_cast<const T*>(v)};
    da::paged_decode_attention_kernel<T, NREP, E>
        <<<dim3(B, KVH), da::DA_WARPS * 32, P * sizeof(int), st>>>(
            static_cast<const T*>(q), kv, static_cast<const int*>(table),
            static_cast<const int*>(clen), static_cast<T*>(out), P, ps, KVH,
            window, scale);
  }
};

}  // namespace

extern "C" {

const char* paged_decode_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q (B, 1, H, hd); k/v pools (NP, ps, KVH, hd) of q's dtype; page_table
// (B, P) int32; cache_len (B,) int32; out (B, 1, H, hd). window <= 0 means
// no window. Returns cudaErrorInvalidValue for an (n_rep, hd) pair without
// an instance (n_rep in {1, 2, 4, 8}, hd in {32, 64, 128}) or more than
// da::MAX_PAGES pages per row.
int paged_decode_attention_launch(const void* q, const void* k, const void* v,
                                  const void* page_table,
                                  const void* cache_len, void* out, int B,
                                  int P, int ps, int H, int KVH, int hd,
                                  int window, int dtype, void* stream) {
  if (P > da::MAX_PAGES || ps <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale = 1.f / sqrtf(static_cast<float>(hd));
  const bool ok = da::dispatch<Launch>(dtype, H / KVH, hd, q, k, v,
                                       page_table, cache_len, out, B, P, ps,
                                       KVH, window, scale, st);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
