// Mamba2 SSD intra-chunk ("diagonal block") term, fp32 accumulation:
//   y[b, t, h, :] = sum_{s <= t} (C[b,t] . B[b,s]) * exp(cum[b,t,h] - cum[b,s,h])
//                   * xdt[b, s, h, :]
// xdt (Bn, c, nh, hd) fp32; cum (Bn, c, nh) fp32, the inclusive cumsum of
// A*dt inside the chunk; Bc, Cc (Bn, c, ds) fp32 or bf16, shared by the
// heads; y (Bn, c, nh, hd) fp32. Bn is batch x chunks of the caller.
//
// Replaces the Pallas kernel ssd_chunk_fwd (_kernel) in
// src/repro/kernels/ssd_chunk/ssd_chunk.py, whose grid (Bn, nh) computes
// the c x c Gram matrix C.B^T per cell and sweeps the heads innermost. The
// grid cannot carry a value from one block to the next here, so each CTA
// takes one cell and a group of heads: it forms the Gram matrix once in
// shared memory (B and C staged in 32-wide slices of ds), then for each
// head of its group loads that head's cum (c) and xdt (c x hd) into shared
// memory, forms the decayed weights w[t][s] = CB[t][s] * exp(cum_t - cum_s)
// for s <= t only (for s > t the exponent is positive and may overflow; 0
// is stored without evaluating it, as the Pallas kernel's jnp.where
// selects), and writes y[t] = sum_{s<=t} w[t][s] x[s]. Nothing but y is
// written to device memory.
//
// Bound on the H100: bytes = B and C once + cum + xdt + y; operations =
// 2 c^2 ds + 2 c^2 nh hd per cell (~6.6 MB and ~0.11 GFLOP for 8 cells of
// mamba2-130m: c=64, nh=24, hd=64, ds=128), about 2 us either way. The
// kernel runs on fp32 CUDA cores (TF32 tensor cores may miss the
// reference's atol 1e-4). Its limits are the issue rate of shared-memory
// loads and the few CTAs a short prompt gives, so: each thread keeps a
// 4 x 4 register tile of the Gram matrix and up to 4 x 8 of each head's
// output (rows t = ty + 16 i, interleaved so the causal work is even), two
// multiply-adds per shared load; and the launcher splits the heads into
// as many groups as fill the card about twice (recomputing the Gram
// matrix per group), one head per CTA for a 512-token admission.
#include "common.cuh"

namespace {

constexpr int SC_THREADS = 256;   // 16 x 16 threads
constexpr int SC_T = 16;          // thread rows (ty) and columns (tx)
constexpr int SC_MAXC = 64;       // chunk length c <= 64: 4 rows a thread
constexpr int SC_MAXHD = 128;     // head dim hd <= 128: 8 columns a thread
constexpr int SC_R = SC_MAXC / SC_T;
constexpr int SC_TILE = 32;       // ds slice staged per Gram pass
constexpr int SC_FILL = 264;      // CTAs that fill the card about twice

// P: output columns a thread keeps, ceil(hd / 16) rounded up to 2, 4 or 8
template <typename T, int P>
__global__ void __launch_bounds__(SC_THREADS)
ssd_chunk_kernel(const float* __restrict__ xdt, const float* __restrict__ cum,
                 const T* __restrict__ bm, const T* __restrict__ cm,
                 float* __restrict__ y, int c, int nh, int hd, int ds,
                 int heads_per_cta) {
  extern __shared__ float smem[];
  const int cw = c + 1;                  // padded row: rows t, t+1 differ
  float* s_cb = smem;                    // (c, c+1) Gram matrix C.B^T
  float* s_w = s_cb + c * cw;            // (c, c+1) decayed weights
  float* s_x = s_w + c * cw;             // (c, hd) xdt of one head
  float* s_cum = s_x + c * hd;           // (c,) cum of one head
  float* s_ct = s_cum + SC_MAXC;         // (c, SC_TILE + 1) slice of C
  float* s_bt = s_ct + c * (SC_TILE + 1);  // (c, SC_TILE + 1) slice of B
  const int b = blockIdx.x;
  const int tid = threadIdx.x, tx = tid % SC_T, ty = tid / SC_T;
  const T* cp = cm + (size_t)b * c * ds;
  const T* bp = bm + (size_t)b * c * ds;

  // ---- Gram matrix: a 4 x 4 tile (t = ty + 16 i, s = tx + 16 j) ----
  float g[SC_R][SC_R];
#pragma unroll
  for (int i = 0; i < SC_R; ++i)
#pragma unroll
    for (int j = 0; j < SC_R; ++j) g[i][j] = 0.f;
  for (int d0 = 0; d0 < ds; d0 += SC_TILE) {
    const int width = min(SC_TILE, ds - d0);
    __syncthreads();                     // previous slice consumed
    for (int i = tid; i < c * SC_TILE; i += SC_THREADS) {
      const int t = i / SC_TILE, dd = i % SC_TILE;
      const bool in = dd < width;
      s_ct[t * (SC_TILE + 1) + dd] =
          in ? rt::to_f(cp[(size_t)t * ds + d0 + dd]) : 0.f;
      s_bt[t * (SC_TILE + 1) + dd] =
          in ? rt::to_f(bp[(size_t)t * ds + d0 + dd]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int dd = 0; dd < SC_TILE; ++dd) {
      float cv[SC_R], bv[SC_R];
#pragma unroll
      for (int i = 0; i < SC_R; ++i) {
        const int t = min(ty + SC_T * i, c - 1);
        const int s = min(tx + SC_T * i, c - 1);
        cv[i] = s_ct[t * (SC_TILE + 1) + dd];
        bv[i] = s_bt[s * (SC_TILE + 1) + dd];
      }
#pragma unroll
      for (int i = 0; i < SC_R; ++i)
#pragma unroll
        for (int j = 0; j < SC_R; ++j) g[i][j] = fmaf(cv[i], bv[j], g[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < SC_R; ++i)
#pragma unroll
    for (int j = 0; j < SC_R; ++j) {
      const int t = ty + SC_T * i, s = tx + SC_T * j;
      if (t < c && s < c) s_cb[t * cw + s] = g[i][j];
    }

  // ---- heads of this CTA's group ----
  const int h1 = min(nh, (int)(blockIdx.y + 1) * heads_per_cta);
  for (int h = blockIdx.y * heads_per_cta; h < h1; ++h) {
    __syncthreads();                     // Gram done / previous head done
    for (int t = tid; t < c; t += SC_THREADS)
      s_cum[t] = cum[((size_t)b * c + t) * nh + h];
    for (int i = tid; i < c * hd; i += SC_THREADS) {
      const int s = i / hd, p = i % hd;
      s_x[i] = xdt[(((size_t)b * c + s) * nh + h) * hd + p];
    }
    __syncthreads();
    for (int e = tid; e < c * c; e += SC_THREADS) {
      const int t = e / c, s = e % c;
      s_w[t * cw + s] =
          s <= t ? s_cb[t * cw + s] * expf(s_cum[t] - s_cum[s]) : 0.f;
    }
    __syncthreads();
    // y tile: rows t = ty + 16 i, columns p = tx + 16 j; w[t][s] is 0 for
    // s > t, so each row's sum may run on to the tile's last row
    float acc[SC_R][P];
#pragma unroll
    for (int i = 0; i < SC_R; ++i)
#pragma unroll
      for (int j = 0; j < P; ++j) acc[i][j] = 0.f;
    const int s_end = min(c, ty + SC_T * (SC_R - 1) + 1);
    for (int s = 0; s < s_end; ++s) {
      float wv[SC_R], xv[P];
#pragma unroll
      for (int i = 0; i < SC_R; ++i)
        wv[i] = s_w[min(ty + SC_T * i, c - 1) * cw + s];
#pragma unroll
      for (int j = 0; j < P; ++j)
        xv[j] = s_x[s * hd + min(tx + SC_T * j, hd - 1)];
#pragma unroll
      for (int i = 0; i < SC_R; ++i)
#pragma unroll
        for (int j = 0; j < P; ++j)
          acc[i][j] = fmaf(wv[i], xv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < SC_R; ++i)
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const int t = ty + SC_T * i, p = tx + SC_T * j;
        if (t < c && p < hd)
          y[(((size_t)b * c + t) * nh + h) * hd + p] = acc[i][j];
      }
  }
}

template <typename T, int P>
int launch(const void* xdt, const void* cum, const void* bm, const void* cm,
           void* y, int Bn, int c, int nh, int hd, int ds,
           cudaStream_t st) {
  const size_t smem = ((size_t)2 * c * (c + 1) + (size_t)c * hd + SC_MAXC
                       + (size_t)2 * c * (SC_TILE + 1)) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_chunk_kernel<T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // heads per CTA: as few as keep about SC_FILL CTAs in flight
  const long work = (long)Bn * nh;
  const int per = (int)max(1L, min((long)nh, work / SC_FILL));
  const dim3 grid(Bn, (nh + per - 1) / per);
  ssd_chunk_kernel<T, P><<<grid, SC_THREADS, smem, st>>>(
      static_cast<const float*>(xdt), static_cast<const float*>(cum),
      static_cast<const T*>(bm), static_cast<const T*>(cm),
      static_cast<float*>(y), c, nh, hd, ds, per);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(const void* xdt, const void* cum, const void* bm,
              const void* cm, void* y, int Bn, int c, int nh, int hd, int ds,
              cudaStream_t st) {
  if (hd <= 2 * SC_T)
    return launch<T, 2>(xdt, cum, bm, cm, y, Bn, c, nh, hd, ds, st);
  if (hd <= 4 * SC_T)
    return launch<T, 4>(xdt, cum, bm, cm, y, Bn, c, nh, hd, ds, st);
  return launch<T, 8>(xdt, cum, bm, cm, y, Bn, c, nh, hd, ds, st);
}

}  // namespace

extern "C" {

int ssd_chunk_max_c() { return SC_MAXC; }
int ssd_chunk_max_hd() { return SC_MAXHD; }
const char* ssd_chunk_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// xdt (Bn, c, nh, hd) f32, cum (Bn, c, nh) f32, bm/cm (Bn, c, ds) of
// dtype code `dt` (f32 or bf16), y (Bn, c, nh, hd) f32.
int ssd_chunk_launch(const void* xdt, const void* cum, const void* bm,
                     const void* cm, void* y, int Bn, int c, int nh, int hd,
                     int ds, int dt, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (c < 1 || c > SC_MAXC || hd < 1 || hd > SC_MAXHD || ds < 1 || nh < 1 ||
      Bn < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dt == rt::DT_BF16)
    return launch_hd<__nv_bfloat16>(xdt, cum, bm, cm, y, Bn, c, nh, hd, ds,
                                    st);
  return launch_hd<float>(xdt, cum, bm, cm, y, Bn, c, nh, hd, ds, st);
}

}  // extern "C"
