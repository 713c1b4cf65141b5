// LM-head verify on the tensor cores: the bf16 instances of
// argmax_verify.cu (argmax over a bf16 head), topk_verify.cu (top-k over a
// bf16 head), argmax_verify_q.cu and topk_verify_q.cu (argmax and top-k
// over int8 or plane-packed int4 codes, bf16 hidden rows). The fp32
// instances keep the streaming body of lm_head_stream.cuh.
//
// Grid: (row tiles, vocabulary strips), as argmax_partial's. A CTA owns a
// strip of LM_BN = 128 columns and a tile of 16 * MT * WM rows of the
// (R, D) hidden input: WM warp rows (1 or 2, chosen at launch) of four
// warps, each warp 32 columns (four n-tiles of 8) of MT m-tiles of 16 rows.
//
// Main loop (lm_mma_main), on a head reader H: it walks the stored head
// rows in BK-row chunks through a STAGES-deep ring of shared buffers
// (LmRing) filled by 16-byte cp.async copies: the head chunk (BK stored
// rows of 128 columns, N-contiguous as stored) and the hidden chunk (BK
// entries of each row, for each of the reader's P planes). Rows are padded
// by 16 bytes, so the eight rows an ldmatrix reads fall in distinct bank
// groups. Per 16-row k-step a warp loads its head fragment with
// ldmatrix.trans, the reader turns it into bf16 B fragments, and each
// m-tile's A fragment comes from ldmatrix; mma.sync.m16n8k16 bf16 x bf16
// -> fp32 (the fp32 sums the JAX verify promises). Rows past R and entries
// past D are zero-filled (a zero product adds +0); columns past V never
// enter an epilogue.
//
// The readers:
//   Bf16Tile — a bf16 head; the B fragments are ldmatrix.trans's output.
//   Int8Tile — int8 codes (D, V), staged as raw bytes (half the shared
//              bytes of bf16): one ldmatrix.trans of the bytes gives a lane
//              codes (k 2t..2t+1, columns 2g and 2g+1), which become two
//              bf16 pairs in registers (i8x4_to_bf16x2; every code is exact
//              in bf16). So n-tile 2h holds the even columns of the warp's
//              16-column block h and n-tile 2h+1 the odd ones (col()).
//   Int4Tile — plane-packed int4 bytes (D/2, V): stored row d holds logical
//              rows d (low nibble) and d + D/2 (high nibble). One packed
//              fragment feeds two MMAs per n-tile: plane 0 against the
//              hidden entries [d0, d0 + 16), plane 1 against [D/2 + d0,
//              ...); the hidden stage holds both halves of each chunk.
// A scaled reader's column sums are multiplied by the column scale once,
// before the epilogue (quant.matmul_codes' order, JAX's _q_verify_plan).
//
// Every row and column is summed by the same instructions in the same
// k-order whatever R, MT or the tile position, so identical columns give
// bit-identical logits, and a row's logits do not depend on how many rows
// are verified with it. No atomics.
//
// Epilogues, one per kernel:
//   argmax_partial_mma — each thread takes its best (value, id) of its 8
//     columns per row under rt::before, a quad shuffle gives the warp's
//     best of 32, and the four column warps meet in shared memory; one
//     partial per (row, strip), as argmax_partial writes, for argmax_merge.
//   topk_partial_mma — the sums are parked in shared memory; each thread
//     sorts its 8 columns per row and keeps its top KP (bitonic networks
//     under rt::before), two quad shuffles merge those into the warp's top
//     KP of 32, the four column warps write theirs to shared memory and
//     one thread per row merges the four sorted lists into the strip's top
//     k: the (row, strip, k) partials that topk_partial writes, for
//     topk_merge.
//
// A head whose rows are not 16-byte aligned (bf16: V % 8 != 0; codes: V %
// 16 != 0, or a pointer off 16 bytes) is staged with 4-byte copies (codes,
// V % 4 == 0) or element loads in the same kernel. The hidden input must
// have D % 8 == 0 (int4: D % 16 == 0, so the high half starts 16-byte
// aligned) and a 16-byte aligned pointer (the wrappers refuse others).
#pragma once

#include <type_traits>

#include "mma.cuh"

namespace rt {

constexpr int LM_BN = 128;        // vocabulary columns per CTA (strip)
constexpr int LM_THREADS = 128;   // one warp row: 4 warps x 32 columns
constexpr int LM_MT_MAX = 8;      // m-tiles of 16 rows per warp, at most

constexpr int LM_SMEM_MAX = 232448;   // shared memory a CTA may opt into

// Bytes of a ring of `stages` chunks of bk stored head rows (row stride ws
// bytes) and of the hidden entries they meet (p planes of bm rows).
constexpr int lm_ring_bytes(int stages, int bk, int ws, int p, int bm) {
  return stages * (bk * ws + p * bm * (bk + 8) * 2);
}

// The ring per reader H, m-tiles MT and warp-row count WM (measured on the
// H100): one warp row (R <= 128, bound by the head's bytes at decode
// batch) takes 64-row chunks of a bf16 head, 3 deep; two warp rows (the
// tree's 160-320 rows, 8 warps of up to 217 registers, one CTA per SM)
// take 32-row chunks, 4 deep. A byte head (int8 or packed int4 codes)
// takes twice the rows, the same head bytes a chunk, where the ring still
// fits in shared memory.
template <typename H, int MT, int WM>
struct LmRing {
  static constexpr int STAGES = WM == 1 ? 3 : 4;
  static constexpr int BK0 = WM == 1 ? 64 : 32;
  static constexpr bool WIDE =
      H::WS < 2 * LM_BN &&
      lm_ring_bytes(STAGES, 2 * BK0, H::WS, H::P, 16 * MT * WM) <= LM_SMEM_MAX;
  static constexpr int BK = WIDE ? 2 * BK0 : BK0;   // stored rows a stage
  static constexpr int AS = BK + 8;                // padded hidden row
  static constexpr int BYTES =
      lm_ring_bytes(STAGES, BK, H::WS, H::P, 16 * MT * WM);
};

// ---- head readers --------------------------------------------------------
// stage(): copy stored rows [k0, k0 + BK) of the strip into `ws` (row
// stride WS bytes), zero past Dp rows or V columns. frag(): the raw head
// fragment of k-step ks for this lane. unpack(): plane p's B fragments
// b[n-tile][2]. col(j, t, e): the warp-relative column of accumulator
// element (n-tile j, lane t = lane % 4, e) — element 2 * hr + e of the C
// fragment is row g + 8 hr of the m-tile.

struct Bf16Tile {
  static constexpr int P = 1, RAW = 8;
  static constexpr bool SCALED = false;
  static constexpr int WE = LM_BN + 8;            // padded row, elements
  static constexpr int WS = WE * 2;               // ... in bytes
  const __nv_bfloat16* w;

  template <int BK, int NTH>
  __device__ __forceinline__ void stage(unsigned char* wsb, int k0, int Dp,
                                        int col0, int V, int vec,
                                        int tid) const {
    __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(wsb);
    if (vec) {
      for (int c = tid; c < BK * LM_BN / 8; c += NTH) {
        const int r = c / (LM_BN / 8), cc = (c % (LM_BN / 8)) * 8;
        const bool ok = k0 + r < Dp && col0 + cc < V;
        cp_async16(ws + r * WE + cc,
                   ok ? w + (size_t)(k0 + r) * V + col0 + cc : w, ok);
      }
    } else {
      for (int e = tid; e < BK * LM_BN; e += NTH) {
        const int r = e / LM_BN, cc = e % LM_BN;
        ws[r * WE + cc] = k0 + r < Dp && col0 + cc < V
                              ? w[(size_t)(k0 + r) * V + col0 + cc]
                              : __float2bfloat16(0.f);
      }
    }
  }
  __device__ __forceinline__ void frag(const unsigned char* wsb, int ks,
                                       int warp, int lane,
                                       uint32_t (&raw)[RAW]) const {
    const __nv_bfloat16* ws = reinterpret_cast<const __nv_bfloat16*>(wsb);
#pragma unroll
    for (int h = 0; h < 2; ++h) {      // n-tiles 2h, 2h + 1
      uint32_t r[4];
      ldmatrix_x4_trans(
          r, ws + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * WE +
                 warp * 32 + h * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int i = 0; i < 4; ++i) raw[4 * h + i] = r[i];
    }
  }
  static __device__ __forceinline__ void unpack(const uint32_t (&raw)[RAW],
                                                int, uint32_t (&b)[4][2]) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      b[j][0] = raw[2 * j];
      b[j][1] = raw[2 * j + 1];
    }
  }
  static __device__ __forceinline__ int col(int j, int t, int e) {
    return j * 8 + 2 * t + e;
  }
};

// Raw int8 or packed int4 bytes; shared by the two code readers.
struct ByteTile {
  static constexpr int RAW = 4;
  static constexpr bool SCALED = true;
  static constexpr int WS = LM_BN + 16;           // padded row, bytes
  const int8_t* q;
  const float* s;

  // stage's copy width in bytes for a (., V) code array: 16, 4 or 0
  // (element loads, e.g. for an odd V); mamba2's V = 50280 takes 4
  int copy_width(int V) const {
    const uintptr_t a = reinterpret_cast<uintptr_t>(q);
    return V % 16 == 0 && a % 16 == 0 ? 16 : V % 4 == 0 && a % 4 == 0 ? 4 : 0;
  }

  template <int BK, int NTH>
  __device__ __forceinline__ void stage(unsigned char* ws, int k0, int Dp,
                                        int col0, int V, int vec,
                                        int tid) const {
    if (vec == 16) {
      for (int c = tid; c < BK * LM_BN / 16; c += NTH) {
        const int r = c / (LM_BN / 16), cc = (c % (LM_BN / 16)) * 16;
        const bool ok = k0 + r < Dp && col0 + cc < V;
        cp_async16(ws + r * WS + cc,
                   ok ? q + (size_t)(k0 + r) * V + col0 + cc : q, ok);
      }
    } else if (vec == 4) {
      for (int c = tid; c < BK * LM_BN / 4; c += NTH) {
        const int r = c / (LM_BN / 4), cc = (c % (LM_BN / 4)) * 4;
        const bool ok = k0 + r < Dp && col0 + cc < V;
        cp_async4(ws + r * WS + cc,
                  ok ? q + (size_t)(k0 + r) * V + col0 + cc : q, ok);
      }
    } else {
      for (int e = tid; e < BK * LM_BN; e += NTH) {
        const int r = e / LM_BN, cc = e % LM_BN;
        ws[r * WS + cc] = k0 + r < Dp && col0 + cc < V
                              ? q[(size_t)(k0 + r) * V + col0 + cc]
                              : 0;
      }
    }
  }
  // raw[0]: k 0-7 of columns 0-15 of the warp, raw[1]: k 8-15 of them,
  // raw[2], raw[3]: the same of columns 16-31; a lane holds (k 2t, col 2g),
  // (2t, 2g + 1), (2t + 1, 2g), (2t + 1, 2g + 1) of its 16 columns
  __device__ __forceinline__ void frag(const unsigned char* ws, int ks,
                                       int warp, int lane,
                                       uint32_t (&raw)[RAW]) const {
    ldmatrix_x4_trans(raw, ws + (ks * 16 + (lane & 7) +
                                 ((lane >> 3) & 1) * 8) * WS +
                               warp * 32 + (lane >> 4) * 16);
  }
  // n-tile j: the even (j % 2 == 0) or odd columns of 16-column block j / 2
  static __device__ __forceinline__ int col(int j, int t, int e) {
    return (j >> 1) * 16 + 2 * (2 * t + e) + (j & 1);
  }
  __device__ __forceinline__ float scale(int c) const { return __ldg(s + c); }
};

struct Int8Tile : ByteTile {
  static constexpr int P = 1;
  static __device__ __forceinline__ void unpack(const uint32_t (&raw)[RAW],
                                                int, uint32_t (&b)[4][2]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      i8x4_to_bf16x2(raw[2 * h], b[2 * h][0], b[2 * h + 1][0]);
      i8x4_to_bf16x2(raw[2 * h + 1], b[2 * h][1], b[2 * h + 1][1]);
    }
  }
};

struct Int4Tile : ByteTile {
  static constexpr int P = 2;
  static __device__ __forceinline__ void unpack(const uint32_t (&raw)[RAW],
                                                int p, uint32_t (&b)[4][2]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      i4x8_to_bf16x2(raw[2 * h], p, b[2 * h][0], b[2 * h + 1][0]);
      i4x8_to_bf16x2(raw[2 * h + 1], p, b[2 * h][1], b[2 * h + 1][1]);
    }
  }
};

// ---- main loop -----------------------------------------------------------
// acc[m][j][4]: m-tile m of this warp row, n-tile j (columns col() of the
// warp's 32), the C fragment. Ends with the ring drained and all threads
// past it, so the caller may reuse the shared memory.
template <typename H, int MT, int WM>
__device__ __forceinline__ void lm_mma_main(
    const __nv_bfloat16* __restrict__ hn, const H& head, int R, int D, int V,
    int vec, unsigned char* smem, float (&acc)[MT][4][4]) {
  using bf16 = __nv_bfloat16;
  constexpr int P = H::P;
  constexpr int BM = 16 * MT * WM;       // rows of the CTA's tile
  constexpr int NTH = LM_THREADS * WM;
  using Ring = LmRing<H, MT, WM>;
  constexpr int BK = Ring::BK, STAGES = Ring::STAGES, AS = Ring::AS;
  unsigned char* Ws = smem;                          // [STAGES][BK][WS]
  bf16* As = reinterpret_cast<bf16*>(smem + STAGES * BK * H::WS);
  // As: [STAGES][P][BM][AS]
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = (tid >> 5) & 3;       // column group: 32 columns
  const int mw = (tid >> 7) * MT;        // first m-tile of this warp row
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * LM_BN;
  const int Dp = D / P;                  // stored rows of the head
  const int nk = (Dp + BK - 1) / BK;

  auto load = [&](int stage, int kc) {
    const int k0 = kc * BK;
    head.template stage<BK, NTH>(Ws + stage * BK * H::WS, k0, Dp, col0, V,
                                 vec, tid);
    bf16* as = As + stage * P * BM * AS;
#pragma unroll
    for (int p = 0; p < P; ++p)
      for (int c = tid; c < BM * BK / 8; c += NTH) {
        const int r = c / (BK / 8), cc = (c % (BK / 8)) * 8;
        const bool ok = row0 + r < R && k0 + cc < Dp;
        cp_async16(as + (p * BM + r) * AS + cc,
                   ok ? hn + (size_t)(row0 + r) * D + p * Dp + k0 + cc : hn,
                   ok);
      }
  };

#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<STAGES - 2>();         // chunk kc has landed
    __syncthreads();                     // ... for all; chunk kc-1 is done
    const int pre = kc + STAGES - 1;
    if (pre < nk) load(pre % STAGES, pre);
    cp_async_commit();
    const unsigned char* ws = Ws + (kc % STAGES) * BK * H::WS;
    const bf16* as = As + (kc % STAGES) * P * BM * AS;
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t raw[H::RAW];
      head.frag(ws, ks, warp, lane, raw);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        uint32_t b[4][2];
        H::unpack(raw, p, b);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          uint32_t a[4];
          ldmatrix_x4(a, as + (p * BM + (mw + m) * 16 + (lane & 15)) * AS +
                             ks * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mma_bf16(acc[m][j], a, b[j][0], b[j][1]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                       // the ring becomes the scratch

  if constexpr (H::SCALED) {             // column sum x scale, once
    const int c0 = col0 + warp * 32, t = lane & 3;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = c0 + H::col(j, t, e);
        const float s = col < V ? head.scale(col) : 0.f;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          acc[m][j][e] *= s;
          acc[m][j][2 + e] *= s;
        }
      }
  }
}

// ---- argmax epilogue ----------------------------------------------------
template <typename H, int MT, int WM>
__global__ void __launch_bounds__(LM_THREADS * WM)
argmax_partial_mma(const __nv_bfloat16* __restrict__ hn, H head,
                   float* __restrict__ pval, int* __restrict__ pidx, int R,
                   int D, int V, int vec) {
  constexpr int BM = 16 * MT * WM;
  constexpr int NTH = LM_THREADS * WM;
  extern __shared__ __align__(16) unsigned char lm_smem[];
  float acc[MT][4][4];
  lm_mma_main<H, MT, WM>(hn, head, R, D, V, vec, lm_smem, acc);

  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = (tid >> 5) & 3, mw = (tid >> 7) * MT;
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * LM_BN;
  float* rv = reinterpret_cast<float*>(lm_smem);   // [4 warps][BM]
  int* ri = reinterpret_cast<int*>(rv + 4 * BM);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {     // rows g and g + 8 of the m-tile
      float v = -CUDART_INF_F;
      int i = INT_MAX;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = col0 + warp * 32 + H::col(j, t, e);
          const float x = acc[m][j][2 * hr + e];
          if (col < V && before(x, col, v, i)) { v = x; i = col; }
        }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, v, off);
        const int oi = __shfl_xor_sync(0xffffffffu, i, off);
        if (before(ov, oi, v, i)) { v = ov; i = oi; }
      }
      if (t == 0) {
        const int r = (mw + m) * 16 + hr * 8 + g;
        rv[warp * BM + r] = v;
        ri[warp * BM + r] = i;
      }
    }
  }
  __syncthreads();
  for (int r = tid; r < BM && row0 + r < R; r += NTH) {
    float v = rv[r];
    int i = ri[r];
#pragma unroll
    for (int wq = 1; wq < 4; ++wq)
      if (before(rv[wq * BM + r], ri[wq * BM + r], v, i)) {
        v = rv[wq * BM + r];
        i = ri[wq * BM + r];
      }
    const size_t o = (size_t)(row0 + r) * gridDim.y + blockIdx.y;
    pval[o] = v;
    pidx[o] = i;
  }
}

// ---- top-k epilogue -----------------------------------------------------
// Compare-exchange: the better of (i, j) under rt::before ends at i.
template <int N>
__device__ __forceinline__ void tk_cas(float (&v)[N], int (&id)[N], int i,
                                       int j) {
  const bool sw = before(v[j], id[j], v[i], id[i]);
  const float vi = v[i];
  const int ii = id[i];
  v[i] = sw ? v[j] : vi;
  id[i] = sw ? id[j] : ii;
  v[j] = sw ? vi : v[j];
  id[j] = sw ? ii : id[j];
}

// Bitonic sort, best first.
template <int N>
__device__ __forceinline__ void tk_sort(float (&v)[N], int (&id)[N]) {
#pragma unroll
  for (int size = 2; size <= N; size <<= 1)
#pragma unroll
    for (int stride = size / 2; stride > 0; stride >>= 1)
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int l = i ^ stride;
        if (l > i) {
          if ((i & size) == 0) tk_cas(v, id, i, l);
          else tk_cas(v, id, l, i);
        }
      }
}

// (v, id) and (ov, oi) each sorted best first: (v, id) becomes the best N
// of both, sorted. The pairwise better of v[i] and ov[N-1-i] is a bitonic
// sequence holding the best N; half-cleaners sort it.
template <int N>
__device__ __forceinline__ void tk_merge(float (&v)[N], int (&id)[N],
                                         const float (&ov)[N],
                                         const int (&oi)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (before(ov[N - 1 - i], oi[N - 1 - i], v[i], id[i])) {
      v[i] = ov[N - 1 - i];
      id[i] = oi[N - 1 - i];
    }
#pragma unroll
  for (int stride = N / 2; stride > 0; stride >>= 1)
#pragma unroll
    for (int i = 0; i < N; ++i)
      if ((i & stride) == 0) tk_cas(v, id, i, i + stride);
}

template <typename H, int KP, int MT, int WM>
constexpr int topk_mma_smem_bytes() {
  constexpr int ring = LmRing<H, MT, WM>::BYTES;
  // the parked sums [MT * 16][threads] and the lists [4][KP][BM] (f32 + i32)
  constexpr int epi = (MT * 16 * LM_THREADS * WM + 4 * KP * 16 * MT * WM * 2) *
                      static_cast<int>(sizeof(float));
  return ring > epi ? ring : epi;
}

// KP (4 or 8, >= k): the length of the sorted lists kept per thread, quad
// and warp; the strip's top k of the four warps' lists goes out.
template <typename H, int KP, int MT, int WM>
__global__ void __launch_bounds__(LM_THREADS * WM)
topk_partial_mma(const __nv_bfloat16* __restrict__ hn, H head,
                 float* __restrict__ pval, int* __restrict__ pidx, int R,
                 int D, int V, int k, int vec) {
  static_assert(KP <= 8 && (KP & (KP - 1)) == 0, "KP: 1, 2, 4 or 8");
  constexpr int BM = 16 * MT * WM;
  constexpr int NTH = LM_THREADS * WM;
  extern __shared__ __align__(16) unsigned char lm_smem[];
  float acc[MT][4][4];
  lm_mma_main<H, MT, WM>(hn, head, R, D, V, vec, lm_smem, acc);

  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = (tid >> 5) & 3, mw = (tid >> 7) * MT;
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * LM_BN;
  // Park the sums in shared memory, each thread in its own slots, so the
  // sorting below runs with the accumulators dead: with them live, ptxas
  // held the 5-m-tile, 8-warp instance to 128 registers (two CTAs per SM)
  // and spilled; asked for two CTAs per SM with the sums parked, it
  // spilled in the main loop and took twice the time (PERF.md).
  float* stash = reinterpret_cast<float*>(lm_smem);   // [MT * 16][NTH]
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        stash[((m * 4 + j) * 4 + c) * NTH + tid] = acc[m][j][c];
  float* sv = stash + MT * 16 * NTH;                  // [4 warps][KP][BM]
  int* si = reinterpret_cast<int*>(sv + 4 * KP * BM);
  const int g = lane >> 2, t = lane & 3;
  __syncthreads();
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {     // rows g and g + 8 of the m-tile
      // this thread's 8 columns in blocks of KP, each sorted, then merged
      float v[8 / KP][KP];
      int id[8 / KP][KP];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = col0 + warp * 32 + H::col(j, t, e);
          const int q = 2 * j + e;
          v[q / KP][q % KP] =
              col < V ? stash[((m * 4 + j) * 4 + 2 * hr + e) * NTH + tid]
                      : -CUDART_INF_F;
          id[q / KP][q % KP] = col < V ? col : INT_MAX;
        }
#pragma unroll
      for (int b = 0; b < 8 / KP; ++b) tk_sort(v[b], id[b]);
#pragma unroll
      for (int b = 1; b < 8 / KP; ++b) tk_merge(v[0], id[0], v[b], id[b]);
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {   // the quad: 32 columns
        float ov[KP];
        int oi[KP];
#pragma unroll
        for (int q = 0; q < KP; ++q) {
          ov[q] = __shfl_xor_sync(0xffffffffu, v[0][q], off);
          oi[q] = __shfl_xor_sync(0xffffffffu, id[0][q], off);
        }
        tk_merge(v[0], id[0], ov, oi);
      }
      if (t == 0) {
        const int r = (mw + m) * 16 + hr * 8 + g;
#pragma unroll
        for (int q = 0; q < KP; ++q) {
          sv[(warp * KP + q) * BM + r] = v[0][q];
          si[(warp * KP + q) * BM + r] = id[0][q];
        }
      }
    }
  }
  __syncthreads();
  for (int r = tid; r < BM && row0 + r < R; r += NTH) {
    int head_of[4] = {0, 0, 0, 0};       // next entry of each warp's list
    const size_t o = ((size_t)(row0 + r) * gridDim.y + blockIdx.y) * k;
    for (int j = 0; j < k; ++j) {
      float v = -CUDART_INF_F;
      int i = INT_MAX, wb = 0;
#pragma unroll
      for (int wq = 0; wq < 4; ++wq) {
        const int h = head_of[wq];
        if (h < KP) {
          const float ov = sv[(wq * KP + h) * BM + r];
          const int oi = si[(wq * KP + h) * BM + r];
          if (before(ov, oi, v, i)) { v = ov; i = oi; wb = wq; }
        }
      }
#pragma unroll
      for (int wq = 0; wq < 4; ++wq) head_of[wq] += wq == wb;
      pval[o + j] = v;
      pidx[o + j] = i;
    }
  }
}

// ---- launch --------------------------------------------------------------
// The row tile: as few tiles as cover R, evened out. Up to 8 m-tiles of 16
// rows: one warp row of 4 warps (R <= 16: one m-tile); more: two warp rows
// of 5-8 m-tiles each (R = 160: one tile of 160 rows; 320: two), so the
// head is read once per tile of up to 256 rows. Calls f(MT, WM) with both
// as std::integral_constant and returns its result.
template <typename F>
int lm_mma_dispatch(int R, F&& f) {
  const int mtiles = (R + 15) / 16;
  const int wm = mtiles > LM_MT_MAX ? 2 : 1;
  const int tiles = (mtiles + wm * LM_MT_MAX - 1) / (wm * LM_MT_MAX);
  const int mt = (mtiles + wm * tiles - 1) / (wm * tiles);
  using std::integral_constant;
  switch (wm * 16 + mt) {
#define RT_MT(W, M)        \
  case W * 16 + M:         \
    return f(integral_constant<int, M>{}, integral_constant<int, W>{});
    RT_MT(1, 1) RT_MT(1, 2) RT_MT(1, 3) RT_MT(1, 4) RT_MT(1, 5)
    RT_MT(1, 6) RT_MT(1, 7) RT_MT(1, 8) RT_MT(2, 5) RT_MT(2, 6)
    RT_MT(2, 7) RT_MT(2, 8)
#undef RT_MT
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// > 48 KB of shared memory needs an opt-in, once per kernel. The launch
// functions below have internal linkage, so each library keeps its own
// `configured` flag (a function-local static of an external template is
// one object in the whole process, and two libraries that instantiate the
// same launch would share it: the second kernel would never opt in).
template <typename K>
int lm_mma_opt_in(K* kernel, int smem, bool& configured) {
  if (configured) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  configured = true;
  return 0;
}

template <typename H, int MT, int WM>
static int argmax_partial_mma_launch(const void* hn, H head, void* pval,
                                     void* pidx, int R, int D, int V,
                                     int vec, cudaStream_t st) {
  constexpr int smem = LmRing<H, MT, WM>::BYTES;
  static bool configured = false;
  const int err = lm_mma_opt_in(argmax_partial_mma<H, MT, WM>, smem,
                                configured);
  if (err) return err;
  const dim3 grid((R + 16 * MT * WM - 1) / (16 * MT * WM),
                  (V + LM_BN - 1) / LM_BN);
  argmax_partial_mma<H, MT, WM><<<grid, LM_THREADS * WM, smem, st>>>(
      static_cast<const __nv_bfloat16*>(hn), head, static_cast<float*>(pval),
      static_cast<int*>(pidx), R, D, V, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename H, int KP, int MT, int WM>
static int topk_partial_mma_launch(const void* hn, H head, void* pval,
                                   void* pidx, int R, int D, int V, int k,
                                   int vec, cudaStream_t st) {
  constexpr int smem = topk_mma_smem_bytes<H, KP, MT, WM>();
  static bool configured = false;
  const int err = lm_mma_opt_in(topk_partial_mma<H, KP, MT, WM>, smem,
                                configured);
  if (err) return err;
  const dim3 grid((R + 16 * MT * WM - 1) / (16 * MT * WM),
                  (V + LM_BN - 1) / LM_BN);
  topk_partial_mma<H, KP, MT, WM><<<grid, LM_THREADS * WM, smem, st>>>(
      static_cast<const __nv_bfloat16*>(hn), head, static_cast<float*>(pval),
      static_cast<int*>(pidx), R, D, V, k, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rt
