// LM-head argmax on the tensor cores: the bf16 instance of argmax_verify.cu
// (the fp32 instance and the quantized and top-k kernels keep the streaming
// body of lm_head_stream.cuh).
//
// Grid: (row tiles, vocabulary strips), as argmax_partial's. A CTA owns a
// strip of LM_BN = 128 columns and a tile of 16 * MT * WM rows of the
// (R, D) hidden input: WM warp rows (1 or 2, chosen at launch) of four
// warps, each warp 32 columns (four n-tiles of 8) of MT m-tiles of 16 rows.
// It walks D in BK-entry chunks through a STAGES-deep ring of shared
// buffers (LmRing) filled by 16-byte cp.async copies: the head chunk (BK
// rows of 128 columns, N-contiguous as stored) and the hidden chunk (BK
// entries of each row). Rows are padded by 16 bytes, so the eight rows an
// ldmatrix reads fall in distinct bank groups. Per 16-entry k-step a warp
// loads its B fragments with ldmatrix.trans and each m-tile's A fragment
// with ldmatrix, and issues mma.sync.m16n8k16 bf16 x bf16 -> fp32 (the fp32
// sums the JAX verify promises). Rows past R and entries past D are
// zero-filled (a zero product adds +0); columns past V never win.
//
// Every row and column is summed by the same instruction in the same
// k-order whatever R, MT or the tile position, so identical columns give
// bit-identical logits, and a row's logits do not depend on how many rows
// are verified with it. No atomics.
//
// Epilogue: each thread takes its best (value, id) of its 8 columns per
// row under rt::before, a quad shuffle gives the warp's best of 32, and
// the four column warps meet in shared memory; one partial per (row,
// strip), as argmax_partial writes, for argmax_merge.
//
// A head whose rows are not 16-byte aligned (V % 8 != 0, or a pointer off
// 16 bytes) is staged with element loads in the same kernel. The hidden
// input must have D % 8 == 0 and a 16-byte aligned pointer (the wrapper
// refuses others).
#pragma once

#include "mma.cuh"

namespace rt {

constexpr int LM_BN = 128;        // vocabulary columns per CTA (strip)
constexpr int LM_THREADS = 128;   // one warp row: 4 warps x 32 columns
constexpr int LM_MT_MAX = 8;      // m-tiles of 16 rows per warp, at most
constexpr int LM_WS = LM_BN + 8;  // padded head row (elements)

// The ring per warp-row count WM (measured on the H100): one warp row
// (R <= 128, bound by the head's bytes at decode batch) takes 64-entry
// chunks, 3 deep; two warp rows (the tree's 160-320 rows, 8 warps of up to
// 217 registers, one CTA per SM) take 32-entry chunks, 4 deep.
template <int WM>
struct LmRing {
  static constexpr int BK = WM == 1 ? 64 : 32;     // hidden entries a stage
  static constexpr int STAGES = WM == 1 ? 3 : 4;
  static constexpr int AS = BK + 8;                // padded hidden row
};

template <int MT, int WM>
constexpr int lm_mma_smem_bytes() {
  using Ring = LmRing<WM>;
  return Ring::STAGES * (Ring::BK * LM_WS + 16 * MT * WM * Ring::AS) *
         static_cast<int>(sizeof(__nv_bfloat16));
}

template <int MT, int WM>
__global__ void __launch_bounds__(LM_THREADS * WM)
argmax_partial_mma(const __nv_bfloat16* __restrict__ hn,
                   const __nv_bfloat16* __restrict__ w,
                   float* __restrict__ pval, int* __restrict__ pidx, int R,
                   int D, int V, int vec) {
  using bf16 = __nv_bfloat16;
  constexpr int BM = 16 * MT * WM;       // rows of the CTA's tile
  constexpr int NTH = LM_THREADS * WM;
  constexpr int BK = LmRing<WM>::BK, STAGES = LmRing<WM>::STAGES;
  constexpr int AS = LmRing<WM>::AS;
  extern __shared__ __align__(16) unsigned char lm_smem[];
  bf16* Ws = reinterpret_cast<bf16*>(lm_smem);   // [STAGES][BK][WS]
  bf16* As = Ws + STAGES * BK * LM_WS;          // [STAGES][BM][AS]
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = (tid >> 5) & 3;       // column group: 32 columns
  const int mw = (tid >> 7) * MT;        // first m-tile of this warp row
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * LM_BN;
  const int nk = (D + BK - 1) / BK;

  auto load = [&](int stage, int kc) {
    const int k0 = kc * BK;
    bf16* ws = Ws + stage * BK * LM_WS;
    bf16* as = As + stage * BM * AS;
    if (vec) {
      for (int c = tid; c < BK * LM_BN / 8; c += NTH) {
        const int r = c / (LM_BN / 8), cc = (c % (LM_BN / 8)) * 8;
        const bool ok = k0 + r < D && col0 + cc < V;
        cp_async16(ws + r * LM_WS + cc,
                   ok ? w + (size_t)(k0 + r) * V + col0 + cc : w, ok);
      }
    } else {
      for (int e = tid; e < BK * LM_BN; e += NTH) {
        const int r = e / LM_BN, cc = e % LM_BN;
        ws[r * LM_WS + cc] = k0 + r < D && col0 + cc < V
                                 ? w[(size_t)(k0 + r) * V + col0 + cc]
                                 : __float2bfloat16(0.f);
      }
    }
    for (int c = tid; c < BM * BK / 8; c += NTH) {
      const int r = c / (BK / 8), cc = (c % (BK / 8)) * 8;
      const bool ok = row0 + r < R && k0 + cc < D;
      cp_async16(as + r * AS + cc,
                 ok ? hn + (size_t)(row0 + r) * D + k0 + cc : hn, ok);
    }
  };

  float acc[MT][4][4];
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
    const bf16* ws = Ws + (kc % STAGES) * BK * LM_WS;
    const bf16* as = As + (kc % STAGES) * BM * AS;
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t b[4][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {      // n-tiles 2h, 2h + 1
        uint32_t r[4];
        ldmatrix_x4_trans(
            r, ws + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LM_WS +
                   warp * 32 + h * 16 + (lane >> 4) * 8);
        b[2 * h][0] = r[0];
        b[2 * h][1] = r[1];
        b[2 * h + 1][0] = r[2];
        b[2 * h + 1][1] = r[3];
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        uint32_t a[4];
        ldmatrix_x4(a, as + ((mw + m) * 16 + (lane & 15)) * AS +
                           ks * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[m][j], a, b[j][0], b[j][1]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                       // the ring becomes the scratch

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
          const int col = col0 + warp * 32 + j * 8 + 2 * t + e;
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

template <int MT, int WM>
int argmax_partial_mma_launch(const void* hn, const void* w, void* pval,
                              void* pidx, int R, int D, int V, int vec,
                              cudaStream_t st) {
  constexpr int smem = lm_mma_smem_bytes<MT, WM>();
  static bool configured = false;        // > 48 KB needs an opt-in, once
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        argmax_partial_mma<MT, WM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid((R + 16 * MT * WM - 1) / (16 * MT * WM),
                  (V + LM_BN - 1) / LM_BN);
  argmax_partial_mma<MT, WM><<<grid, LM_THREADS * WM, smem, st>>>(
      static_cast<const __nv_bfloat16*>(hn),
      static_cast<const __nv_bfloat16*>(w), static_cast<float*>(pval),
      static_cast<int*>(pidx), R, D, V, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rt
