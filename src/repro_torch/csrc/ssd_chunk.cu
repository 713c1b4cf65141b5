// Mamba2 SSD intra-chunk ("diagonal block") term, fp32 accumulation:
//   y[b, t, h, :] = sum_{s <= t} (C[b,t] . B[b,s]) * exp(cum[b,t,h] - cum[b,s,h])
//                   * xdt[b, s, h, :]
// xdt (Bn, c, nh, hd) fp32; cum (Bn, c, nh) fp32, the inclusive cumsum of
// A*dt inside the chunk; Bc, Cc (Bn, c, ds) fp32 or bf16, shared by the
// heads; y (Bn, c, nh, hd) fp32. Bn is batch x chunks of the caller; any
// 1 <= c <= 64, 1 <= hd <= 128 and ds >= 1.
//
// Replaces the Pallas kernel ssd_chunk_fwd (_kernel) in
// src/repro/kernels/ssd_chunk/ssd_chunk.py, whose grid (Bn, nh) computes
// the c x c Gram matrix C.B^T per cell and sweeps the heads innermost. The
// grid cannot carry a value from one block to the next here, so each CTA
// takes one cell and a group of heads, and keeps the cell's Gram matrix in
// registers while it walks its heads.
//
// Bound on the H100: bytes = B and C once + cum + xdt + y; operations =
// 2 c^2 ds + 2 c^2 nh hd per cell (~6.6 MB and ~0.11 GFLOP for 8 cells of
// mamba2-130m: c=64, nh=24, hd=64, ds=128), about 2 us either way. The
// first version (fp32 CUDA cores, the Gram matrix recomputed by each
// one-head CTA from four serially staged ds slices, the decayed weights
// written to shared memory) took 0.034 ms there, 0.023 ms at 1 cell.
// Design, on the tensor cores (mma.sync) with all loads up front:
//  - CTA of 8 warps: each takes the 16 rows t of one row tile and one half
//    of the head dim; the two warps on a scheduler take tiles i and 3 - i,
//    so each scheduler gets the same causal work; row tiles past c idle.
//  - Loads: B and C (their first 128 columns of ds), the first head's cum
//    and xdt are issued together as 16-byte cp.async copies (4-byte ones,
//    or plain loads for bf16, where a row is not 16-byte aligned) before
//    any product; each next head's cum and xdt are copied into a second
//    buffer while the current head computes. Rows past c and columns past
//    ds or hd are zero-filled.
//  - Gram matrix: each warp forms its row tile's causal part, the n-tiles
//    of 8 columns s <= its last row, in fp32 accumulator fragments: bf16
//    B/C by mma.m16n8k16 (exact products, fp32 sums; ldmatrix fragments),
//    fp32 B/C by mma.m16n8k8 tf32 on 3xTF32-split operands (~fp32
//    products). The two warps of a row tile both form it (cheap beside a
//    shared-memory exchange); it stays in registers for all the CTA's
//    heads.
//  - Decay in registers: w = G * exp(cum_t - cum_s) where s <= t < c,
//    else 0 selected without evaluating the exponent (for s > t it is
//    positive and overflows under steep decay). __expf (ex2.approx of the
//    argument times log2 e): its relative error grows with |cum_t - cum_s|,
//    but where that is large w is below any tolerance.
//  - Second product y = W . xdt on mma.m16n8k8 tf32, 3xTF32 on both fp32
//    operands (a 1e-4 tolerance rules out plain TF32). W's accumulator
//    fragments are the A operand as they lie: each k-block of 8 s values
//    is read in the order s = 2t, 2t + 1 for the fragment's k = t, t + 4,
//    and xdt's B fragment is read from shared memory in that same order.
//    Only k-blocks with some s <= t are multiplied.
//  - y is stored from the accumulators, two columns a lane (8 bytes).
// The launcher gives each CTA as few heads as keep about SC_FILL CTAs in
// flight: one head a CTA up to 11 cells (192 CTAs for a 512-token
// admission), two at 32 cells. What the time is
// (scripts/probe_ssd_chunk.py, PERF.md): the kernel is bound by the
// instructions each scheduler issues, not by the products' dependency
// chains (the small products in accumulators of their own changed
// nothing; multiplying the k-blocks past the diagonal too, or rounding to
// tf32 by cvt.rna, cost 10-20 %); 2 heads a CTA lose to 1 up to 8 cells
// and win at 32; 255 registers a thread (one CTA an SM) lose at 8 cells.
#include <type_traits>

#include "mma.cuh"

namespace {

using rt::cp_async16;
using rt::cp_async4;
using rt::cp_async_commit;
using rt::cp_async_wait;

constexpr int SC_THREADS = 256;   // 8 warps: 4 row tiles x 2 column halves
constexpr int SC_MAXC = 64;       // chunk length c <= 64: 4 row tiles of 16
constexpr int SC_MAXHD = 128;     // head dim hd <= 128: 8 n-tiles a warp
constexpr int SC_DSL = 128;       // columns of B and C staged per Gram pass
constexpr int SC_FILL = 264;      // CTAs that fill the card about twice

// padded rows of the staged B/C (16 bytes past SC_DSL: bf16 rows 272 bytes
// apart keep ldmatrix conflict-free, fp32 rows 132 floats = 4 mod 32 keep
// the scalar fragment loads conflict-free) and of xdt (16 NT + 4 floats,
// = 4 mod 32 for NT >= 2 and 20 for NT = 1: conflict-free B fragments)
template <typename T>
__host__ __device__ constexpr int bc_stride() {
  return SC_DSL + 16 / static_cast<int>(sizeof(T));
}
template <int NT>
__host__ __device__ constexpr int x_stride() {
  return 16 * NT + 4;
}
template <typename T, int NT>
constexpr size_t smem_bytes() {
  return 2 * SC_MAXC * bc_stride<T>() * sizeof(T)          // C, B
         + 2 * SC_MAXC * x_stride<NT>() * sizeof(float)    // xdt, 2 buffers
         + 2 * SC_MAXC * sizeof(float);                    // cum, 2 buffers
}

// NT: n-tiles of 8 head-dim columns a warp takes (its half of hd)
template <typename T, int NT>
__global__ void __launch_bounds__(SC_THREADS, 2)
ssd_chunk_kernel(const float* __restrict__ xdt, const float* __restrict__ cum,
                 const T* __restrict__ bm, const T* __restrict__ cm,
                 float* __restrict__ y, int c, int nh, int hd, int ds,
                 int heads_per_cta) {
  constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int BS = bc_stride<T>(), XS = x_stride<NT>();
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));   // per 16 bytes
  extern __shared__ __align__(16) unsigned char sc_smem[];
  T* s_c = reinterpret_cast<T*>(sc_smem);                  // [64][BS]
  T* s_b = s_c + SC_MAXC * BS;                             // [64][BS]
  float* s_x = reinterpret_cast<float*>(s_b + SC_MAXC * BS);  // [2][64][XS]
  float* s_cum = s_x + 2 * SC_MAXC * XS;                   // [2][64]

  const int b = blockIdx.x;
  const int h0 = blockIdx.y * heads_per_cta;
  const int n_heads = min(nh, h0 + heads_per_cta) - h0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  // row tile mi and column half of this warp: warps w and w + 4 share a
  // scheduler (w % 4), so they take tiles w and 3 - w, whose causal work
  // (mi + 1 k-steps of 16) sums to 5 on every scheduler
  const int half = warp >> 2;
  const int mi = half ? 3 - (warp & 3) : warp & 3, m0 = 16 * mi;
  const int cb = half * 8 * NT;                     // its first column
  const int rows = 16 * ((c + 15) / 16);            // rows the tiles read
  const bool active = m0 < c;
  const T* cp = cm + (size_t)b * c * ds;
  const T* bp = bm + (size_t)b * c * ds;
  const bool bc_vec = ds % VEC == 0 &&
                      ((reinterpret_cast<uintptr_t>(bm) |
                        reinterpret_cast<uintptr_t>(cm)) & 15) == 0;
  const bool x_vec = hd % 4 == 0 &&
                     (reinterpret_cast<uintptr_t>(xdt) & 15) == 0;

  // B and C columns [d0, d0 + 128) of rows t < rows, zero past c and ds,
  // up to the 16-column step the products read
  auto stage_bc = [&](int d0) {
    const int kw = (min(SC_DSL, ds - d0) + 15) & ~15;
    if (bc_vec) {
      const int per_row = kw / VEC, n = rows * per_row;
      for (int i = tid; i < 2 * n; i += SC_THREADS) {
        const int m = i / n, r = (i % n) / per_row;
        const int k = (i % n) % per_row * VEC;
        const bool ok = r < c && d0 + k < ds;
        const T* src = (m ? bp : cp) + (size_t)r * ds + d0 + k;
        cp_async16((m ? s_b : s_c) + r * BS + k, ok ? src : bm, ok);
      }
    } else {
      const int n = rows * kw;
      for (int i = tid; i < 2 * n; i += SC_THREADS) {
        const int m = i / n, r = (i % n) / kw, k = (i % n) % kw;
        const bool ok = r < c && d0 + k < ds;
        const T* src = (m ? bp : cp) + (size_t)r * ds + d0 + k;
        rt::store_f((m ? s_b : s_c) + r * BS + k, ok ? rt::to_f(*src) : 0.f);
      }
    }
  };
  // head h's cum (rows t < rows) and xdt (rows s < rows, the 16 NT columns
  // the warps read) into buffer buf, zero past c and hd
  auto stage_head = [&](int buf, int h) {
    float* xs = s_x + buf * SC_MAXC * XS;
    float* cs = s_cum + buf * SC_MAXC;
    for (int t = tid; t < rows; t += SC_THREADS) {
      const bool ok = t < c;
      cp_async4(cs + t, ok ? cum + ((size_t)b * c + t) * nh + h : cum, ok);
    }
    if (x_vec) {
      constexpr int per_row = 4 * NT;                // 16-byte chunks
      for (int i = tid; i < rows * per_row; i += SC_THREADS) {
        const int s = i / per_row, p = i % per_row * 4;
        const bool ok = s < c && p < hd;
        cp_async16(xs + s * XS + p,
                   ok ? xdt + (((size_t)b * c + s) * nh + h) * hd + p : xdt,
                   ok);
      }
    } else {
      constexpr int per_row = 16 * NT;
      for (int i = tid; i < rows * per_row; i += SC_THREADS) {
        const int s = i / per_row, p = i % per_row;
        const bool ok = s < c && p < hd;
        cp_async4(xs + s * XS + p,
                  ok ? xdt + (((size_t)b * c + s) * nh + h) * hd + p : xdt,
                  ok);
      }
    }
  };

  stage_bc(0);
  cp_async_commit();                     // group: B, C (first slice)
  stage_head(0, h0);
  cp_async_commit();                     // group: the first head

  // ---- Gram matrix: rows m0.. m0 + 15, n-tiles j <= 2 mi + 1 ----
  float g[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) g[j][e] = 0.f;
  for (int d0 = 0; d0 < ds; d0 += SC_DSL) {
    if (d0 > 0) {
      __syncthreads();                   // the previous slice is consumed
      stage_bc(d0);
      cp_async_commit();
      cp_async_wait<0>();
    } else {
      cp_async_wait<1>();                // B and C have landed
    }
    __syncthreads();
    if (!active) continue;
    const int ksteps = (min(SC_DSL, ds - d0) + 15) / 16;
#pragma unroll 4
    for (int kk = 0; kk < ksteps; ++kk) {
      if constexpr (BF16) {
        uint32_t a[4];
        rt::ldmatrix_x4(a, s_c + (m0 + (lane & 15)) * BS + kk * 16 +
                               (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < 4; ++np) {   // n-tiles 2 np, 2 np + 1
          if (np > mi) break;
          uint32_t r[4];
          rt::ldmatrix_x4(r, s_b + (np * 16 + (lane & 7) + (lane >> 4) * 8) *
                                       BS + kk * 16 + ((lane >> 3) & 1) * 8);
          rt::mma_bf16(g[2 * np], a, r[0], r[1]);
          rt::mma_bf16(g[2 * np + 1], a, r[2], r[3]);
        }
      } else {
#pragma unroll
        for (int hk = 0; hk < 2; ++hk) {   // two k-steps of 8
          const int k0 = kk * 16 + hk * 8 + tq;
          uint32_t ah[4], al[4];
          rt::split_tf32(s_c[(m0 + gq) * BS + k0], ah[0], al[0]);
          rt::split_tf32(s_c[(m0 + gq + 8) * BS + k0], ah[1], al[1]);
          rt::split_tf32(s_c[(m0 + gq) * BS + k0 + 4], ah[2], al[2]);
          rt::split_tf32(s_c[(m0 + gq + 8) * BS + k0 + 4], ah[3], al[3]);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (j > 2 * mi + 1) break;
            uint32_t bh0, bl0, bh1, bl1;
            rt::split_tf32(s_b[(8 * j + gq) * BS + k0], bh0, bl0);
            rt::split_tf32(s_b[(8 * j + gq) * BS + k0 + 4], bh1, bl1);
            rt::mma_3xtf32(g[j], ah, al, bh0, bh1, bl0, bl1);
          }
        }
      }
    }
  }

  // ---- the CTA's heads, the next one's loads in flight ----
  const int t0 = m0 + gq, t1 = t0 + 8;
  const int kblocks = min(2 * mi + 2, (c + 7) / 8);   // k-blocks with s <= t
  for (int i = 0; i < n_heads; ++i) {
    const int buf = i & 1, h = h0 + i;
    if (i + 1 < n_heads) {
      stage_head(buf ^ 1, h + 1);
      cp_async_commit();
      cp_async_wait<1>();                // head i has landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      const float* xs = s_x + buf * SC_MAXC * XS;
      const float* cs = s_cum + buf * SC_MAXC;
      const float ct0 = cs[t0], ct1 = cs[t1];
      float o[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j >= kblocks) break;
        const int s0 = 8 * j + 2 * tq, s1 = s0 + 1;
        const float cs0 = cs[s0], cs1 = cs[s1];
        // g[j] = (t0, s0), (t0, s1), (t1, s0), (t1, s1); as the A operand
        // k = tq reads s0 and k = tq + 4 reads s1
        const float w00 = s0 <= t0 && t0 < c ? g[j][0] * __expf(ct0 - cs0)
                                             : 0.f;
        const float w01 = s1 <= t0 && t0 < c ? g[j][1] * __expf(ct0 - cs1)
                                             : 0.f;
        const float w10 = s0 <= t1 && t1 < c ? g[j][2] * __expf(ct1 - cs0)
                                             : 0.f;
        const float w11 = s1 <= t1 && t1 < c ? g[j][3] * __expf(ct1 - cs1)
                                             : 0.f;
        uint32_t ah[4], al[4];
        rt::split_tf32(w00, ah[0], al[0]);
        rt::split_tf32(w10, ah[1], al[1]);
        rt::split_tf32(w01, ah[2], al[2]);
        rt::split_tf32(w11, ah[3], al[3]);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int p = cb + 8 * n + gq;
          uint32_t bh0, bl0, bh1, bl1;
          rt::split_tf32(xs[s0 * XS + p], bh0, bl0);
          rt::split_tf32(xs[s1 * XS + p], bh1, bl1);
          rt::mma_3xtf32(o[n], ah, al, bh0, bh1, bl0, bl1);
        }
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int p = cb + 8 * n + 2 * tq;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int t = hr ? t1 : t0;
          if (t >= c || p >= hd) continue;
          float* dst = y + (((size_t)b * c + t) * nh + h) * hd + p;
          if (hd % 2 == 0) {
            *reinterpret_cast<float2*>(dst) =
                make_float2(o[n][2 * hr], o[n][2 * hr + 1]);
          } else {
            dst[0] = o[n][2 * hr];
            if (p + 1 < hd) dst[1] = o[n][2 * hr + 1];
          }
        }
      }
    }
    __syncthreads();                     // buffer buf is free for head i + 2
  }
}

template <typename T, int NT>
int launch(const void* xdt, const void* cum, const void* bm, const void* cm,
           void* y, int Bn, int c, int nh, int hd, int ds,
           cudaStream_t st) {
  constexpr size_t smem = smem_bytes<T, NT>();
  static bool configured = false;        // > 48 KB needs an opt-in, once
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_chunk_kernel<T, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  // heads per CTA: as few as keep about SC_FILL CTAs in flight
  const long work = (long)Bn * nh;
  const int per = (int)max(1L, min((long)nh, work / SC_FILL));
  const dim3 grid(Bn, (nh + per - 1) / per);
  ssd_chunk_kernel<T, NT><<<grid, SC_THREADS, smem, st>>>(
      static_cast<const float*>(xdt), static_cast<const float*>(cum),
      static_cast<const T*>(bm), static_cast<const T*>(cm),
      static_cast<float*>(y), c, nh, hd, ds, per);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(const void* xdt, const void* cum, const void* bm,
              const void* cm, void* y, int Bn, int c, int nh, int hd, int ds,
              cudaStream_t st) {
  if (hd <= 16) return launch<T, 1>(xdt, cum, bm, cm, y, Bn, c, nh, hd, ds, st);
  if (hd <= 32) return launch<T, 2>(xdt, cum, bm, cm, y, Bn, c, nh, hd, ds, st);
  if (hd <= 64) return launch<T, 4>(xdt, cum, bm, cm, y, Bn, c, nh, hd, ds, st);
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
