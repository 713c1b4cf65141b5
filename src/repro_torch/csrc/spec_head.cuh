// What every speculative LM-head kernel shares: the most columns a row
// asks for, and how a column id is read.
//
// Layout note: the head stays (D, V) row-major (int8 codes (D, V), or
// plane-packed int4 bytes (D/2, V)), shared with the verify kernels, so
// column ids[j] is a strided read of one element every V — each such read
// costs one 32-byte sector. A row's k columns move k * D * 32 B (4 * 4096
// * 32 B = 512 KB) from memory or L2 for k * D useful elements. Three ways
// to pay less: a V-major copy of the head (contiguous columns, but another
// copy of the head in card memory: 262 MB in bf16 for Llama-2-7B); a
// gather of each distinct column once, into a contiguous buffer that dots
// then read (the tree gate: its ids are the step's B*N node tokens, so it
// gathers once per step, spec_gather.cuh, and dots at each exit point,
// spec_head.cu and spec_head_q.cu); or fewer sectors per column (an int4
// byte holds two hidden rows' codes). The AR and serve gates spread a
// row's gather over a cluster of CTAs (spec_slice.cuh, exit_gate.cuh).
#pragma once

#include "common.cuh"

namespace rt {

constexpr int SH_MAXK = 8;

// Ids are clamped to [0, V) so a bad id cannot read outside the head.
__device__ __forceinline__ int spec_col(const int* ids_row, int j, int V) {
  return min(max(ids_row[j], 0), V - 1);
}

}  // namespace rt
