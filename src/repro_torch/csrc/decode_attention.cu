// Decode attention against a dense (B, S, KVH, hd) KV cache with a per-row
// live length and an optional sliding window: the split-KV body of
// paged_attention_split.cuh (a producer warp feeding a cp.async ring, eight
// consumer warps, a last-CTA merge in split order) over DenseRows, whose
// key s of row b is slot b * S + s, under its own kernel name
// (dense_split_kernel).
//
// Replaces the Pallas kernel decode_attention_fwd (_kernel and
// _online_softmax_step) in src/repro/kernels/decode_attention/
// decode_attention.py, which walks key tiles in order with online-softmax
// scratch and skips dead tiles with pl.when.
//
// Grid (KVH * HS, B, ceil(S / split)), split from S, hd, the element size
// and the grid alone (pa::dense_split_keys: 2048 keys at hd = 128 in bf16;
// pa::fill_split where the grid would leave SMs idle), never from
// cache_len: the full run's 162-slot cache is one split per (row, KV head),
// 128 CTAs for Llama-2-7B at B = 4, with no merge; a 4096-slot cache is 2
// splits, of which one past a row's length returns at once.
//
// Bound on the H100: bytes — the live K and V prefix, read once:
// 2 * B * L * KVH * hd * sizeof(T) per layer.
#include "paged_attention_split.cuh"

namespace {

template <typename T, int NREP, int E>
struct Launch {
  static void run(const void* q, const void* k, const void* v,
                  const void* clen, void* out, void* ws, void* tickets,
                  int B, int S, int KVH, int window, int split,
                  cudaStream_t st) {
    pa::launch_dense<T, pa::FpPools<T>, NREP, 32 * E>(
        pa::FpPools<T>{static_cast<const T*>(k), static_cast<const T*>(v)},
        S, q, clen, out, ws, tickets, B, KVH, window, split, st);
  }
};

}  // namespace

extern "C" {

const char* decode_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Keys per split of a cache of S slots of head dim hd in elements of esize
// bytes; the caller sizes the workspace from it and passes it back to the
// launch.
int decode_attention_split_keys(int S, int hd, int esize) {
  return pa::dense_split_keys(S, hd, esize);
}

// The split a launch over B rows of KVH KV heads with n_rep query heads
// each takes: the shape rule above, cut shorter by pa::fill_split where
// one split index would leave SMs idle.
int decode_attention_grid_split(int S, int hd, int esize, int B, int KVH,
                                int n_rep) {
  return pa::fill_split(pa::dense_split_keys(S, hd, esize), S,
                        (long long)B * KVH * pa::head_split(n_rep, hd),
                        pa::floor_keys(hd, esize), 1);
}

// q (B, 1, H, hd), k/v (B, S, KVH, hd) of one dtype, 16-byte aligned,
// cache_len (B,) int32, out (B, 1, H, hd) in q's dtype. ws: fp32 workspace
// of B * KVH * ceil(S / split) * n_rep * (hd + 2) floats; tickets: B * H
// int32 (one per virtual KV head, KVH * HS <= H), zero before the call and
// zero after it. window <= 0 means no
// window. Returns cudaErrorInvalidValue for an (n_rep, hd) pair without an
// instance (rt::dispatch) or a split out of range.
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const void* cache_len, void* out, void* ws,
                            void* tickets, int B, int S, int H, int KVH,
                            int hd, int window, int split, int dtype,
                            void* stream) {
  if (!pa::dense_shape_ok(B, S, KVH, split) || H % KVH ||
      !rt::dispatch<Launch>(dtype, H / KVH, hd, q, k, v, cache_len, out, ws,
                            tickets, B, S, KVH, window, split,
                            static_cast<cudaStream_t>(stream)))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
