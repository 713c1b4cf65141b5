// Paged decode attention over an int8 KV cache: one query token per row
// against K/V stored as int8 codes in (NP, ps, KVH, hd) pools, each key's K
// and V with one fp32 scale per (slot, KV head) in (NP, ps, KVH) scale
// pools, all read through the (B, P) page table:
//   out[b, h] = softmax_s(q[b, h] . (K[s, g] * ks[s, g]) / sqrt(hd))
//               . (V[s, g] * vs[s, g])
// over lo <= s < len. The split-KV design is the fp paged kernel's
// (paged_attention_split.cuh) on the Int8Pools reader: a stage carries
// twice the keys of a bf16 stage (the same bytes) and the keys' scales;
// codes become fp32 exactly in registers (through the mantissa of 2^23),
// a key's score is its scale times q . codes, and its V row enters the sum
// at weight p * vs, all in fp32.
//
// Replaces the Pallas kernel paged_decode_attention_fwd with k_scale /
// v_scale (_paged_kernel_q) in
// src/repro/kernels/decode_attention/decode_attention.py, whose tile
// multiplies the fp32 codes by the (Bk, 1) scale tile gathered through the
// same page-table index map before the q.k dot.
//
// A retired row (table row all trash page, cache_len 1) reads one key of
// the trash page, codes and scale; the trash page is zeroed at allocation,
// so its scale is finite, and the output is never used.
//
// Bound on the H100: bytes — the live keys' codes and scales, read once:
// sum_b (len_b - lo_b) * KVH * (2 * hd + 8) per layer, about 1.9x fewer
// than the bf16 pools' 4 * hd per key and head.
#include "paged_attention_split.cuh"

namespace {

template <typename T, int NREP, int E>
struct Launch {
  template <typename... Args>
  static void run(const pa::Int8Pools& pools, Args... args) {
    pa::launch<T, pa::Int8Pools, NREP, 32 * E>(pools, args...);
  }
};

}  // namespace

extern "C" {

const char* paged_decode_attention_q_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Keys per split for rows of P pages of ps tokens (a multiple of ps).
int paged_decode_attention_q_split_keys(int P, int ps) {
  return pa::split_keys<pa::Int8Pools>(P, ps);
}

// The split a launch over B rows of KVH KV heads with n_rep query heads of
// hd takes: the shape rule above, cut shorter by pa::fill_split (whole
// pages, at least 256 KB of K and V of esize-byte elements) where one
// split index would leave SMs idle.
int paged_decode_attention_q_grid_split(int P, int ps, int hd, int esize,
                                        int B, int KVH, int n_rep) {
  (void)esize;                          // int8 pools: one byte
  return pa::fill_split(pa::split_keys<pa::Int8Pools>(P, ps),
                        (long long)P * ps,
                        (long long)B * KVH * pa::head_split(n_rep, hd),
                        pa::floor_keys(hd, 1), ps);
}

// q (B, 1, H, hd) fp32 or bf16 (dtype); k/v pools (NP, ps, KVH, hd) int8,
// 16-byte aligned; ks/vs (NP, ps, KVH) fp32; page_table (B, P) int32;
// cache_len (B,) int32; out (B, 1, H, hd) in q's dtype; ws and tickets as
// paged_decode_attention_launch's. window <= 0 means no window. Returns
// cudaErrorInvalidValue for a shape without an instance, as that one.
int paged_decode_attention_q_launch(const void* q, const void* k,
                                    const void* v, const void* ks,
                                    const void* vs, const void* page_table,
                                    const void* cache_len, void* out,
                                    void* ws, void* tickets, int B, int P,
                                    int ps, int H, int KVH, int hd,
                                    int window, int split, int dtype,
                                    void* stream) {
  const pa::Int8Pools pools{static_cast<const int8_t*>(k),
                            static_cast<const int8_t*>(v),
                            static_cast<const float*>(ks),
                            static_cast<const float*>(vs)};
  if (!pa::shape_ok(B, P, ps, KVH, split) || H % KVH ||
      !rt::dispatch<Launch>(dtype, H / KVH, hd, pools, q, page_table,
                            cache_len, out, ws, tickets, B, P, ps, KVH,
                            window, split, static_cast<cudaStream_t>(stream)))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
