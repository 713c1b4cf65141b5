// Flash attention for prefill: causal (optionally sliding-window) or full
// GQA attention over a whole sequence.
//   out[b, i, h] = softmax_j(q[b, i, h] . k[b, j, g] / sqrt(hd)) . v[b, j, g]
// over the keys j with j <= i and j > i - window (causal), or all j < S;
// g = h / n_rep. A query row with no live key gives 0.
//
// Replaces the Pallas kernel flash_attention_fwd (_kernel) in
// src/repro/kernels/flash_attention/flash_attention.py. There the grid
// (B, H, nQ, nK) walks the key blocks in order on one core with (m, l, acc)
// in VMEM scratch, and pl.when skips blocks above the diagonal or below the
// window. Its block halving (S % block == 0) is a TPU tiling rule; here the
// ragged last tile is masked, so any S (e.g. a 77-token prompt) is taken.
//
// Grid (ceil(S / BQ), H, B): one CTA per 64-query tile of one head. The CTA
// keeps its Q tile in shared memory (fp32) and loops over 64-key tiles from
// the first one inside the window up to the diagonal tile only, so tiles
// above the diagonal and below the window are never loaded. Per key tile:
// S = Q K^T * scale in fp32 (each of 256 threads owns a 4 x 4 block of S),
// masked, then one warp per 8 query rows updates the running max m and sum
// l and turns S into probabilities, and each thread rescales and
// accumulates its 4 x hd/16 block of the output in registers. One divide at
// the end. Masked entries are -inf, so they get probability exactly 0.
//
// Bound on the H100: operations for long prompts — 4 * B * H * hd *
// S(S+1)/2 multiply-adds' worth under the causal mask — against bytes (q,
// k, v read once, out written once) for short ones. This first version runs
// on the fp32 CUDA cores, not the tensor cores (wgmma, TMA and a pipeline
// are later work).
#include "common.cuh"

namespace {

constexpr int FA_THREADS = 256;
constexpr int BQ = 64;        // query rows per CTA
constexpr int BK = 64;        // keys per tile

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (BQ * (HD + 1) + BK * (HD + 1) + BK * HD + BQ * (BK + 1) + 3 * BQ);
}

template <typename T, int HD>
__global__ void __launch_bounds__(FA_THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int S,
                       int H, int KVH, int causal, int window, float scale) {
  constexpr int NJ = HD / 16;           // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                     // [BQ][HD + 1]
  float* Ks = Qs + BQ * (HD + 1);       // [BK][HD + 1]
  float* Vs = Ks + BK * (HD + 1);       // [BK][HD]
  float* Ps = Vs + BK * HD;             // [BQ][BK + 1]
  float* m_s = Ps + BQ * (BK + 1);      // [BQ] running max
  float* l_s = m_s + BQ;                // [BQ] running sum
  float* a_s = l_s + BQ;                // [BQ] rescale of this tile

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / KVH);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int lane = tid & 31, wid = tid >> 5;

  for (int idx = tid; idx < BQ * HD; idx += FA_THREADS) {
    const int r = idx / HD, c = idx - r * HD;
    const int qpos = q0 + r;
    Qs[r * (HD + 1) + c] =
        qpos < S ? rt::to_f(q[(((size_t)b * S + qpos) * H + h) * HD + c])
                 : 0.f;
  }
  if (tid < BQ) {
    m_s[tid] = rt::NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  int kt_lo = 0, kt_hi = (S - 1) / BK;
  if (causal) {
    kt_hi = min(q0 + BQ - 1, S - 1) / BK;
    if (window > 0) kt_lo = max(0, q0 - window + 1) / BK;
  }

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                    // previous tile's Ks/Vs/Ps are free
    for (int idx = tid; idx < BK * HD; idx += FA_THREADS) {
      const int r = idx / HD, c = idx - r * HD;
      const int kpos = k0 + r;
      const size_t off = (((size_t)b * S + kpos) * KVH + g) * HD + c;
      Ks[r * (HD + 1) + c] = kpos < S ? rt::to_f(k[off]) : 0.f;
      Vs[r * HD + c] = kpos < S ? rt::to_f(v[off]) : 0.f;
    }
    __syncthreads();

    // scores: rows ty + 16 i, keys tx + 16 j
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * (HD + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bb[j] = Ks[(tx + 16 * j) * (HD + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(a[i], bb[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty + 16 * i, qpos = q0 + row;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j, kpos = k0 + col;
        bool live = kpos < S && qpos < S;
        if (causal) {
          live = live && kpos <= qpos;
          if (window > 0) live = live && kpos > qpos - window;
        }
        Ps[row * (BK + 1) + col] = live ? sc[i][j] * scale : -CUDART_INF_F;
      }
    }
    __syncthreads();

    // online softmax: warp wid owns rows 8 wid .. 8 wid + 7
#pragma unroll
    for (int rr = 0; rr < BQ / 8; ++rr) {
      const int row = wid * (BQ / 8) + rr;
      float* pr = Ps + row * (BK + 1);
      const float s0 = pr[lane], s1 = pr[lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[row];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      pr[lane] = p0;
      pr[lane + 32] = p1;
      const float sum = rt::warp_sum(p0 + p1);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[row] = alpha;
        l_s[row] = fmaf(l_s[row], alpha, sum);
        m_s[row] = m_new;
      }
    }
    __syncthreads();

    // acc = alpha * acc + P V: rows ty + 16 i, columns tx + 16 j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * (BK + 1) + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float vv = Vs[kk * HD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty + 16 * i, qpos = q0 + row;
    if (qpos >= S) continue;
    float L = l_s[row];
    if (L == 0.f) L = 1.f;              // no live key: zeros
    T* op = out + (((size_t)b * S + qpos) * H + h) * HD;
#pragma unroll
    for (int j = 0; j < NJ; ++j) rt::store_f(op + tx + 16 * j, acc[i][j] / L);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int H, int KVH, int causal, int window, float scale,
           cudaStream_t st) {
  constexpr size_t smem = smem_bytes<HD>();
  static bool configured = false;       // > 48 KB needs an opt-in, once
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<T, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_attention_kernel<T, HD><<<grid, FA_THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, H, KVH, causal,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int hd, const void* q, const void* k, const void* v, void* out,
             int B, int S, int H, int KVH, int causal, int window,
             float scale, cudaStream_t st) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, out, B, S, H, KVH, causal, window, scale, st);
    case 64: return launch<T, 64>(q, k, v, out, B, S, H, KVH, causal, window, scale, st);
    case 128: return launch<T, 128>(q, k, v, out, B, S, H, KVH, causal, window, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

const char* flash_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q (B, S, H, hd), k/v (B, S, KVH, hd) of one dtype, out (B, S, H, hd) in
// q's dtype. causal != 0 applies the causal mask and, when window > 0, the
// sliding window. Returns cudaErrorInvalidValue for hd outside {32, 64, 128}
// or H not a multiple of KVH.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int B, int S, int H, int KVH, int hd,
                           int causal, int window, int dtype, void* stream) {
  if (S <= 0 || B <= 0) return 0;
  if (KVH <= 0 || H % KVH) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale = 1.f / sqrtf(static_cast<float>(hd));
  return dtype == rt::DT_BF16
             ? dispatch<__nv_bfloat16>(hd, q, k, v, out, B, S, H, KVH,
                                       causal, window, scale, st)
             : dispatch<float>(hd, q, k, v, out, B, S, H, KVH, causal,
                               window, scale, st);
}

}  // extern "C"
