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
// In both bodies below a CTA owns a 64-query tile of one head and loops
// over 64-key tiles from the first one inside the window up to the
// diagonal tile only, so tiles above the diagonal and below the window are
// never loaded; masked scores are -inf and get probability exactly 0.
//
// Which instance runs which body:
//   bf16 — flash_attention_kernel_mma, FlashAttention-2 on the tensor
//          cores: 4 warps of 16 query rows; K and V tiles double-buffered
//          through 16-byte cp.async copies (the next tile loads while this
//          one computes); S = Q K^T with mma.sync m16n8k16 (Q fragments
//          from ldmatrix once, K as the col-major B operand by plain
//          ldmatrix); the online softmax in registers (row max and sum by
//          quad shuffles, scores never stored); O += P V with P taken
//          straight from the score fragments as the A operand and V by
//          ldmatrix.trans. At hd = 256 (RecurrentGemma) the O accumulator
//          alone takes 128 registers a thread, so that instance takes
//          32-key tiles (101 KB of shared memory, two CTAs per SM) and
//          reloads the Q fragments from shared memory at every key tile
//          instead of holding all 64 of their registers. P is split into two bf16 parts, hi = bf16(p) and
//          lo = bf16(p - hi), and multiplied twice, so the product keeps ~16
//          bits of p and the output stays within the tolerance of the fp32
//          plain version. Only diagonal, window and ragged tiles are masked;
//          query tiles start heaviest (latest) first; 87 KB of shared
//          memory at hd = 128, two CTAs per SM.
//   fp32 — flash_attention_kernel, the first body, on the fp32 CUDA cores:
//          the Q tile in shared memory, each of 256 threads owns a 4 x 4
//          block of S, one warp per 8 query rows runs the online softmax
//          through shared memory, each thread accumulates a 4 x hd/16 block
//          of the output in registers.
//
// Bound on the H100 (700 W): operations for long prompts — 4 * B * H * hd
// * S(S+1)/2 under the causal mask — against bytes (q, k, v read once, out
// written once) for short ones: bytes at the prompts served here (0.0050
// ms at B=1, S=512, 32 heads of 128; the 2.2 GFLOP take 0.0022 ms at the
// bf16 tensor-core peak, and the split P adds half of that again). The
// first body took 0.2392 ms there on fp32 CUDA cores with four barriers per
// key tile and synchronous loads; the bf16 body takes 0.0232 ms (causal
// SDPA: 0.0133). Numbers: PERF.md, from chip_smoke.py and
// scripts/ab_flash_attention.py.
#include "mma.cuh"

namespace {

constexpr int FA_THREADS = 256;
constexpr int BQ = 64;        // query rows per CTA
constexpr int BK = 64;        // keys per tile

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (BQ * (HD + 1) + BK * (HD + 1) + BK * HD + BQ * (BK + 1) + 3 * BQ);
}

template <int HD>
__global__ void __launch_bounds__(FA_THREADS)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       int S, int H, int KVH, int causal, int window,
                       float scale) {
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
        qpos < S ? q[(((size_t)b * S + qpos) * H + h) * HD + c]
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
      Ks[r * (HD + 1) + c] = kpos < S ? k[off] : 0.f;
      Vs[r * HD + c] = kpos < S ? v[off] : 0.f;
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
    float* op = out + (((size_t)b * S + qpos) * H + h) * HD;
#pragma unroll
    for (int j = 0; j < NJ; ++j) op[tx + 16 * j] = acc[i][j] / L;
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int H, int KVH, int causal, int window, float scale,
           cudaStream_t st) {
  constexpr size_t smem = smem_bytes<HD>();
  static bool configured = false;       // > 48 KB needs an opt-in, once
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_attention_kernel<HD><<<grid, FA_THREADS, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), S, H, KVH,
      causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(int hd, const void* q, const void* k, const void* v, void* out,
             int B, int S, int H, int KVH, int causal, int window,
             float scale, cudaStream_t st) {
  switch (hd) {
    case 32: return launch<32>(q, k, v, out, B, S, H, KVH, causal, window, scale, st);
    case 64: return launch<64>(q, k, v, out, B, S, H, KVH, causal, window, scale, st);
    case 128: return launch<128>(q, k, v, out, B, S, H, KVH, causal, window, scale, st);
    case 256: return launch<256>(q, k, v, out, B, S, H, KVH, causal, window, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}


// ---- bf16: FlashAttention-2 on mma.sync ----
using rt::cp_async16;
using rt::cp_async_commit;
using rt::cp_async_wait;
using rt::ldmatrix_x4;
using rt::ldmatrix_x4_trans;
using rt::mma_bf16;
using rt::split_bf16;

constexpr int FM_THREADS = 128;   // 4 warps x 16 query rows
constexpr int FM_BQ = 64;         // query rows per CTA

// keys per tile: 64, and 32 at hd = 256 so two CTAs fit an SM
template <int HD>
__host__ __device__ constexpr int fm_bk() { return HD > 128 ? 32 : 64; }

// whether a thread holds its Q fragments (HD / 4 registers) for the whole
// loop; at hd = 256 they are reloaded from shared memory at every tile
template <int HD>
__host__ __device__ constexpr bool fm_q_in_regs() { return HD <= 128; }

template <int HD>
constexpr int fm_smem_bytes() {   // Q tile + 2 K and 2 V tiles, padded rows
  return (FM_BQ + 4 * fm_bk<HD>()) * (HD + 8) *
         static_cast<int>(sizeof(__nv_bfloat16));
}

template <int HD>
__global__ void __launch_bounds__(FM_THREADS, 2)
flash_attention_kernel_mma(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           __nv_bfloat16* __restrict__ out, int S, int H,
                           int KVH, int causal, int window,
                           float scale_log2) {
  using bf16 = __nv_bfloat16;
  constexpr int FM_BK = fm_bk<HD>();
  constexpr bool QREG = fm_q_in_regs<HD>();
  constexpr int ST = HD + 8;            // padded row: ldmatrix conflict-free
  constexpr int CH = HD / 8;            // 16-byte chunks per row
  constexpr int NT = HD / 8;            // output n-tiles per warp
  extern __shared__ __align__(16) unsigned char fm_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(fm_smem);   // [BQ][ST]
  bf16* Ks = Qs + FM_BQ * ST;                    // [2][BK][ST]
  bf16* Vs = Ks + 2 * FM_BK * ST;                // [2][BK][ST]

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * FM_BQ;  // heaviest first
  const int g = h / (H / KVH);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, t = lane & 3;

  for (int c = tid; c < FM_BQ * CH; c += FM_THREADS) {
    const int r = c / CH, cc = (c % CH) * 8;
    const bool ok = q0 + r < S;
    cp_async16(Qs + r * ST + cc,
               ok ? q + (((size_t)b * S + q0 + r) * H + h) * HD + cc : q, ok);
  }
  auto load_kv = [&](int buf, int kt) {
    const int k0 = kt * FM_BK;
    for (int c = tid; c < FM_BK * CH; c += FM_THREADS) {
      const int r = c / CH, cc = (c % CH) * 8;
      const bool ok = k0 + r < S;
      const size_t off = (((size_t)b * S + k0 + r) * KVH + g) * HD + cc;
      cp_async16(Ks + (buf * FM_BK + r) * ST + cc, ok ? k + off : k, ok);
      cp_async16(Vs + (buf * FM_BK + r) * ST + cc, ok ? v + off : v, ok);
    }
  };

  int kt_lo = 0, kt_hi = (S - 1) / FM_BK;
  if (causal) {
    kt_hi = min(q0 + FM_BQ - 1, S - 1) / FM_BK;
    if (window > 0) kt_lo = max(0, q0 - window + 1) / FM_BK;
  }
  load_kv(0, kt_lo);
  cp_async_commit();                    // group: Q and the first K/V tile

  uint32_t qf[QREG ? HD / 16 : 1][4];
  float o[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m_r[2] = {rt::NEG_INF, rt::NEG_INF};   // rows gr, gr + 8 (log2 units)
  float l_r[2] = {0.f, 0.f};                   // this thread's partial sums
  const int qr = q0 + warp * 16 + gr;

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int buf = (kt - kt_lo) & 1;
    if (kt < kt_hi) load_kv(buf ^ 1, kt + 1);
    cp_async_commit();
    cp_async_wait<1>();                 // tile kt (and Q) has landed
    __syncthreads();
    if constexpr (QREG) {
      if (kt == kt_lo) {
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          ldmatrix_x4(qf[kk], Qs + (warp * 16 + (lane & 15)) * ST + kk * 16 +
                                  (lane >> 4) * 8);
      }
    }
    const bf16* ks = Ks + buf * FM_BK * ST;
    const bf16* vs = Vs + buf * FM_BK * ST;

    float s[FM_BK / 8][4];              // 16 rows x BK keys of scores
#pragma unroll
    for (int j = 0; j < FM_BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int qi = QREG ? kk : 0;
      if constexpr (!QREG)
        ldmatrix_x4(qf[0], Qs + (warp * 16 + (lane & 15)) * ST + kk * 16 +
                               (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < FM_BK / 16; ++np) {   // key n-tiles 2np, 2np+1
        uint32_t r[4];
        ldmatrix_x4(r, ks + (np * 16 + (lane & 7) + (lane >> 4) * 8) * ST +
                           kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qf[qi], r[0], r[1]);
        mma_bf16(s[2 * np + 1], qf[qi], r[2], r[3]);
      }
    }

    // mask only the tiles that cross the ragged end, the diagonal or the
    // window's edge
    const int k0 = kt * FM_BK;
    const bool edge =
        k0 + FM_BK > S ||
        (causal && (k0 + FM_BK - 1 > q0 ||
                    (window > 0 && k0 <= q0 + FM_BQ - 1 - window)));
#pragma unroll
    for (int j = 0; j < FM_BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (edge) {
          const int kp = k0 + j * 8 + 2 * t + (e & 1);
          const int qp = qr + (e >> 1) * 8;
          bool live = kp < S;
          if (causal) {
            live = live && kp <= qp;
            if (window > 0) live = live && kp > qp - window;
          }
          if (!live) x = -CUDART_INF_F;
        }
        s[j][e] = x;
      }

    // online softmax, base 2: rows gr (e = 0, 1) and gr + 8 (e = 2, 3)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < FM_BK / 8; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * hr], s[j][2 * hr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_r[hr], mx);
      const float alpha = exp2f(m_r[hr] - m_new);
      m_r[hr] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < FM_BK / 8; ++j) {
        s[j][2 * hr] = exp2f(s[j][2 * hr] - m_new);
        s[j][2 * hr + 1] = exp2f(s[j][2 * hr + 1] - m_new);
        sum += s[j][2 * hr] + s[j][2 * hr + 1];
      }
      l_r[hr] = fmaf(l_r[hr], alpha, sum);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        o[j][2 * hr] *= alpha;
        o[j][2 * hr + 1] *= alpha;
      }
    }

    // O += P V, P = hi + lo in bf16 (two products)
#pragma unroll
    for (int kk = 0; kk < FM_BK / 16; ++kk) {
      uint32_t ph[4], pl[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int nd = 0; nd < HD / 16; ++nd) {      // hd n-tiles 2nd, 2nd+1
        uint32_t r[4];
        ldmatrix_x4_trans(
            r, vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ST +
                   nd * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * nd], ph, r[0], r[1]);
        mma_bf16(o[2 * nd], pl, r[0], r[1]);
        mma_bf16(o[2 * nd + 1], ph, r[2], r[3]);
        mma_bf16(o[2 * nd + 1], pl, r[2], r[3]);
      }
    }
    __syncthreads();                    // buffer buf is free for tile kt+2
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float L = l_r[hr];
    L += __shfl_xor_sync(0xffffffffu, L, 1);
    L += __shfl_xor_sync(0xffffffffu, L, 2);
    const int qp = qr + hr * 8;
    if (qp >= S) continue;
    if (L == 0.f) L = 1.f;              // no live key: zeros
    bf16* op = out + (((size_t)b * S + qp) * H + h) * HD + 2 * t;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      *reinterpret_cast<__nv_bfloat162*>(op + j * 8) = __floats2bfloat162_rn(
          o[j][2 * hr] / L, o[j][2 * hr + 1] / L);
  }
}

template <int HD>
int launch_mma(const void* q, const void* k, const void* v, void* out,
               int B, int S, int H, int KVH, int causal, int window,
               float scale, cudaStream_t st) {
  constexpr int smem = fm_smem_bytes<HD>();
  static bool configured = false;       // > 48 KB needs an opt-in, once
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel_mma<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid(H, B, (S + FM_BQ - 1) / FM_BQ);
  flash_attention_kernel_mma<HD><<<grid, FM_THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      S, H, KVH, causal, window, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_mma(int hd, const void* q, const void* k, const void* v,
                 void* out, int B, int S, int H, int KVH, int causal,
                 int window, float scale, cudaStream_t st) {
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) %
      16)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 32: return launch_mma<32>(q, k, v, out, B, S, H, KVH, causal, window, scale, st);
    case 64: return launch_mma<64>(q, k, v, out, B, S, H, KVH, causal, window, scale, st);
    case 128: return launch_mma<128>(q, k, v, out, B, S, H, KVH, causal, window, scale, st);
    case 256: return launch_mma<256>(q, k, v, out, B, S, H, KVH, causal, window, scale, st);
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
// sliding window. Returns cudaErrorInvalidValue for hd outside {32, 64, 128,
// 256},
// H not a multiple of KVH, or (bf16) a pointer off 16 bytes.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int B, int S, int H, int KVH, int hd,
                           int causal, int window, int dtype, void* stream) {
  if (S <= 0 || B <= 0) return 0;
  if (KVH <= 0 || H % KVH) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale = 1.f / sqrtf(static_cast<float>(hd));
  return dtype == rt::DT_BF16
             ? dispatch_mma(hd, q, k, v, out, B, S, H, KVH, causal, window,
                            scale, st)
             : dispatch(hd, q, k, v, out, B, S, H, KVH, causal, window,
                        scale, st);
}

}  // extern "C"
