// Paged decode attention over an int8 KV cache: one query token per row
// against K/V stored as int8 codes in (NP, ps, KVH, hd) pools, each key's K
// and V with one fp32 scale per (slot, KV head) in (NP, ps, KVH) scale
// pools, all read through the (B, P) page table:
//   out[b, h] = softmax_s(q[b, h] . (K[s, g] * ks[s, g]) / sqrt(hd))
//               . (V[s, g] * vs[s, g])
// over lo <= s < len. The page staging, the CTA design and the online
// softmax are the fp paged kernel's (da::paged_decode_attention_kernel in
// decode_attention.cuh) on the Int8KV reader: a lane loads its hd/32
// consecutive codes of a key in one load (4 bytes at hd = 128) and the
// key's scale in one broadcast read, and dequantizes in registers, in fp32.
//
// Replaces the Pallas kernel paged_decode_attention_fwd with k_scale /
// v_scale (_paged_kernel_q) in
// src/repro/kernels/decode_attention/decode_attention.py, whose tile
// multiplies the fp32 codes by the (Bk, 1) scale tile gathered through the
// same page-table index map before the q.k dot.
//
// Grid (B, KVH). A retired row (table row all trash page, cache_len 1)
// reads one key of the trash page, codes and scale; the trash page is
// zeroed at allocation, so its scale is finite, and the output is never
// used.
//
// Bound on the H100: bytes — the live keys' codes and scales, read once:
// sum_b (len_b - lo_b) * KVH * (2 * hd + 8) per layer, about 1.9x fewer
// than the bf16 pools' 4 * hd per key and head.
#include "decode_attention.cuh"

namespace {

template <typename T, int NREP, int E>
struct Launch {
  static void run(const void* q, const void* k, const void* v,
                  const void* ks, const void* vs, const void* table,
                  const void* clen, void* out, int B, int P, int ps, int KVH,
                  int window, float scale, cudaStream_t st) {
    const da::Int8KV kv{static_cast<const int8_t*>(k),
                        static_cast<const int8_t*>(v),
                        static_cast<const float*>(ks),
                        static_cast<const float*>(vs)};
    da::paged_decode_attention_kernel<T, NREP, E>
        <<<dim3(B, KVH), da::DA_WARPS * 32, P * sizeof(int), st>>>(
            static_cast<const T*>(q), kv, static_cast<const int*>(table),
            static_cast<const int*>(clen), static_cast<T*>(out), P, ps, KVH,
            window, scale);
  }
};

}  // namespace

extern "C" {

const char* paged_decode_attention_q_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q (B, 1, H, hd) fp32 or bf16 (dtype); k/v pools (NP, ps, KVH, hd) int8,
// 4-byte aligned; ks/vs (NP, ps, KVH) fp32; page_table (B, P) int32;
// cache_len (B,) int32; out (B, 1, H, hd) in q's dtype. window <= 0 means
// no window. Returns cudaErrorInvalidValue for an (n_rep, hd) pair without
// an instance (n_rep in {1, 2, 4, 8}, hd in {32, 64, 128}) or more than
// da::MAX_PAGES pages per row.
int paged_decode_attention_q_launch(const void* q, const void* k,
                                    const void* v, const void* ks,
                                    const void* vs, const void* page_table,
                                    const void* cache_len, void* out, int B,
                                    int P, int ps, int H, int KVH, int hd,
                                    int window, int dtype, void* stream) {
  if (P > da::MAX_PAGES || ps <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale = 1.f / sqrtf(static_cast<float>(hd));
  const bool ok = da::dispatch<Launch>(dtype, H / KVH, hd, q, k, v, ks, vs,
                                       page_table, cache_len, out, B, P, ps,
                                       KVH, window, scale, st);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
