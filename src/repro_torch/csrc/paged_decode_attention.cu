// Paged decode attention: one query token per row against K/V read through
// a page table from a pool shared by all rows. Key s of row b lives at
// physical slot page_table[b, s / ps] * ps + s % ps of the (NP, ps, KVH, hd)
// pools. The design (split-KV CTAs, a cp.async ring, a last-CTA merge in
// split order) is in paged_attention_split.cuh, shared with the int8 pool
// kernel (paged_decode_attention_q.cu).
//
// Replaces the Pallas kernel paged_decode_attention_fwd (_paged_kernel) in
// src/repro/kernels/decode_attention/decode_attention.py. There the page
// table is scalar-prefetched and consumed by the K/V BlockSpec index maps,
// one page per grid step, and pages past the live prefix are clamped to the
// last live page so their DMA is elided: a compacted (retired) row costs no
// bytes. Here a CTA copies its split's live page ids into shared memory and
// reads only keys in [lo, len), so the same holds; the Pallas grid walks a
// row's pages in order on one core, where here a row's splits run on as
// many SMs and merge at the end.
//
// Offsets are 64-bit: page * ps * KVH * hd overflows int32 for pools
// beyond 2**31 elements. A retired row (table row all trash page,
// cache_len 1) reads one key of the trash page; its output is never used.
//
// Bound on the H100: bytes — the live K and V keys, read once:
// 2 * sum_b (len_b - lo_b) * KVH * hd * sizeof(T) per layer.
#include "paged_attention_split.cuh"

namespace {

template <typename T, int NREP, int E>
struct Launch {
  template <typename... Args>
  static void run(const void* k, const void* v, Args... args) {
    const pa::FpPools<T> pools{static_cast<const T*>(k),
                               static_cast<const T*>(v)};
    pa::launch<T, pa::FpPools<T>, NREP, 32 * E>(pools, args...);
  }
};

}  // namespace

extern "C" {

const char* paged_decode_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Keys per split for rows of P pages of ps tokens (a multiple of ps); the
// caller sizes the workspace from it and passes it back to the launch.
int paged_decode_attention_split_keys(int P, int ps) {
  return pa::split_keys<pa::FpPools<float>>(P, ps);
}

// The split a launch over B rows of KVH KV heads with n_rep query heads of
// hd takes: the shape rule above, cut shorter by pa::fill_split (whole
// pages, at least 256 KB of K and V of esize-byte elements) where one
// split index would leave SMs idle.
int paged_decode_attention_grid_split(int P, int ps, int hd, int esize,
                                      int B, int KVH, int n_rep) {
  return pa::fill_split(pa::split_keys<pa::FpPools<float>>(P, ps),
                        (long long)P * ps,
                        (long long)B * KVH * pa::head_split(n_rep, hd),
                        pa::floor_keys(hd, esize), ps);
}

// q (B, 1, H, hd); k/v pools (NP, ps, KVH, hd) of q's dtype, 16-byte
// aligned; page_table (B, P) int32; cache_len (B,) int32; out (B, 1, H,
// hd). ws: fp32 workspace of B * KVH * ceil(P * ps / split) * n_rep *
// (hd + 2) floats; tickets: B * H int32 (one per virtual KV head), zero before
// the call and zero after it. window <= 0 means no window. Returns cudaErrorInvalidValue for
// an (n_rep, hd) pair without an instance (rt::dispatch), more than
// pa::MAX_PAGES pages per row or a split that is not a multiple of ps.
int paged_decode_attention_launch(const void* q, const void* k, const void* v,
                                  const void* page_table,
                                  const void* cache_len, void* out, void* ws,
                                  void* tickets, int B, int P, int ps, int H,
                                  int KVH, int hd, int window, int split,
                                  int dtype, void* stream) {
  if (!pa::shape_ok(B, P, ps, KVH, split) || H % KVH ||
      !rt::dispatch<Launch>(dtype, H / KVH, hd, k, v, q, page_table,
                            cache_len, out, ws, tickets, B, P, ps, KVH,
                            window, split, static_cast<cudaStream_t>(stream)))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
