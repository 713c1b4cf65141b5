// Split-KV ("flash-decoding") decode attention, shared by the dense cache
// kernel (decode_attention.cu), the bf16 / fp32 pool kernel
// (paged_decode_attention.cu) and the int8 pool kernel
// (paged_decode_attention_q.cu): one query token per row against that row's
// live K/V,
//   out[b, h] = softmax_s(q[b, h] . k[b, s, g] / sqrt(hd)) . v[b, s, g]
// over lo <= s < len, lo = max(0, len - window), h = g * n_rep + r. Where
// key s of row b lives is a Rows policy: PagedRows reads it through the
// row's page table (slot table[b, s / ps] * ps + s % ps of the (NP, ps, KVH,
// hd) pools), DenseRows from a (B, S, KVH, hd) cache (slot b * S + s).
//
// Work unit: one CTA per (split j, KV head g, row b) of `split` keys (paged:
// a multiple of the page size; chosen on the host from the shapes alone,
// never from cache_len, so the grid needs no sync), or, where one KV head
// has more query heads than a CTA's registers hold (16 heads of 256 at
// RecurrentGemma's MQA), HS CTAs per KV head, each taking NR = n_rep / HS
// of its heads and reading the same keys: "virtual" KV head gv = g * HS +
// hh owns query heads gv * NR .. gv * NR + NR - 1. A CTA whose split misses
// [lo, len) returns at once. In a live CTA one producer warp
// streams the split's keys into a ring of STAGES shared-memory stages,
// STAGES stages ahead of the eight consumer warps: 16-byte cp.async copies
// (a key row's chunks on neighbouring lanes), each stage's completion
// tracked by its "full" mbarrier, each stage handed back by the consumers
// through its "empty" mbarrier. So copies keep flowing while the consumers
// reduce, and neither side waits on a block-wide barrier. A stage holds the
// K and V rows of KS keys (int8 stages: twice the keys of a bf16 stage, the
// same bytes, and the keys' fp32 scales).
//
// Reduction inside a CTA: a key is reduced by a group of G = HD / EL lanes,
// each holding EL of its elements (EL fewer as n_rep grows, to bound the
// registers, but at least HD / 32, so a key fits one warp), so a warp takes
// 32 / G keys at once and a dot product needs log2(G) shuffles. Each group keeps its own online softmax (m, l, acc)
// per query head in fp32, in log2 units (q is scaled by log2(e) / sqrt(hd)
// once). At the end the groups merge in shared memory in a fixed order.
//
// Across CTAs: a row with one live split writes its output directly.
// Otherwise each split writes (m, l, acc[n_rep][hd]) to the fp32 workspace,
// takes a ticket of its (row, KV head) after a fence, and the CTA that
// draws the last ticket merges the partials in split order j = lo / split
// .. and resets the ticket to 0 for the next call: one launch, and an
// output that does not depend on which CTA finished last.
//
// Contracts of the kernels they replace: keys outside [lo, len) are never
// read; l == 0 writes zeros; a retired row (table all trash page,
// cache_len 1) reads one key of the trash page; 64-bit offsets.
#pragma once

#include <algorithm>

#include "mma.cuh"

namespace pa {

constexpr int WARPS = 8;                  // consumer warps
constexpr int THREADS = (WARPS + 1) * 32; // and one producer warp
constexpr int STAGES = 3;                 // ring depth
constexpr int STAGE_BYTES = 16 * 1024;    // K + V bytes of a stage, at least
constexpr int MAX_SPLITS = 64;            // splits of a row, at most (the
//                                           shape rule; the fill rule may
//                                           cut shorter ones)
constexpr int SMS = 132;                  // the H100 SXM's SMs
constexpr int MAX_PAGES = 2048;           // pages per row (P)
constexpr int MAX_SPLIT_PAGES = 256;      // page ids of one split in smem

// The K/V a kernel reads: E is the stored element type, MIN_SPLIT the
// fewest keys a split takes: 256 KB of K and V at hd = 128 (timed on the
// H100: shorter splits lose more to each CTA's fixed cost and to the merge
// than they win by spreading a row over more SMs).
template <typename T>
struct FpPools {
  using E = T;
  static constexpr bool SCALED = false;
  static constexpr int MIN_SPLIT = 512;
  const T* k;
  const T* v;
};

// int8 codes with one fp32 scale per (slot, KV head) in (NP, ps, KVH) pools
struct Int8Pools {
  using E = int8_t;
  static constexpr bool SCALED = true;
  static constexpr int MIN_SPLIT = 1024;
  const int8_t* k;
  const int8_t* v;
  const float* ks;
  const float* vs;
};

// Keys per split: a multiple of ps, at least PL::MIN_SPLIT keys (or one
// page) and at most MAX_SPLITS splits of the row's P * ps keys, within
// MAX_SPLIT_PAGES pages. Fewer, longer splits mean fewer partials to merge;
// more splits spread one long row over more SMs.
template <typename PL>
int split_keys(int P, int ps) {
  const long long keys = (long long)P * ps;
  const long long want = std::max<long long>(
      PL::MIN_SPLIT, (keys + MAX_SPLITS - 1) / MAX_SPLITS);
  return static_cast<int>(
      std::min<long long>((want + ps - 1) / ps, MAX_SPLIT_PAGES) * ps);
}

// Keys per split of a dense cache of S slots, by the same rule with P * ps
// replaced by S and no page to round to: at least the keys of 1 MB of K
// and V (2048 at hd = 128 in bf16) and at most MAX_SPLITS splits of the S
// slots. Timed on the H100 (scripts/probe_dense_split.py, Llama-2-7B's 32
// KV heads at B = 4: 128 CTAs per split index): one split per row was the
// fastest up to 2048 keys and 2048-key splits at 4096; shorter splits lost
// more to the merge and each CTA's fixed cost than they won in spread.
inline int dense_split_keys(int S, int hd, int esize) {
  const long long min_keys = (1LL << 20) / (2LL * hd * esize);
  return static_cast<int>(std::max<long long>(
      min_keys, ((long long)S + MAX_SPLITS - 1) / MAX_SPLITS));
}

// Elements of a key each lane of a key's group holds: fewer as n_rep grows
// (acc and q take n_rep * EL registers each), at least hd / 32 (a key's
// group fits one warp).
__host__ __device__ constexpr int lane_elems(int nrep, int hd) {
  return (nrep == 1 ? 16 : nrep <= 4 ? 8 : 4) * 32 >= hd
             ? (nrep == 1 ? 16 : nrep <= 4 ? 8 : 4)
             : hd / 32;
}

// CTAs per KV head: 1 while a CTA's acc and q registers (NR * EL each)
// stay within 48 (12 heads of 128), else 2. A CTA of nine warps gets at
// most 168 registers a thread (three warps share a quarter of the SM's
// register file): 16 heads of 64 in one CTA spilled 768 bytes a thread
// (ptxas), and 16 heads of 256 would hold 2 * 128; two CTAs of 8 heads
// each read the same keys.
__host__ __device__ constexpr int head_split(int nrep, int hd) {
  return nrep * lane_elems(nrep, hd) <= 48 ? 1 : 2;
}

// The fill rule, on top of the shape rules above: where one split index
// gives fewer CTAs (ctas = B * KVH * head_split) than the card has SMs,
// rows are cut into shorter splits, as many per row as fill the SMs, down
// to `floor_keys` (256 KB of K and V), rounded up to `unit` (the page
// size). RecurrentGemma's one KV head at B = 4 is 8 CTAs a split index:
// 2048-key splits left 120 of 132 SMs idle. Shapes whose grid fills the
// card (Llama-2-7B's 32 KV heads at B = 4 and more) keep their split.
inline int fill_split(long long split, long long keys, long long ctas,
                      long long floor_keys, int unit) {
  if (ctas * ((keys + split - 1) / split) >= SMS) return (int)split;
  const long long per = (SMS + ctas - 1) / ctas;
  long long want = std::max<long long>((keys + per - 1) / per, floor_keys);
  want = (want + unit - 1) / unit * unit;
  return (int)std::min<long long>(split, want);
}

// Keys of 256 KB of K and V at head dim hd in elements of esize bytes.
inline long long floor_keys(int hd, int esize) {
  return std::max<long long>(1, (1LL << 18) / (2LL * hd * esize));
}

// Where the keys of a row live. A CTA calls split(b, j, split, tid, ext)
// before it reads the row's length, stash(tid) once it knows its split is
// live, then slot(s): the slot of key s, whose (g, 0) entry is element
// slot * KVH * HD + g * HD of K and V. SMEM: bytes of shared memory the
// policy takes beside the body's (at ext).
struct PagedRows {
  static constexpr int SMEM = MAX_SPLIT_PAGES * 4;   // the split's page ids
  const int* table;                   // (B, P) int32
  int P, ps;
  struct Split {
    int* s_pages;
    int page0, n_pg, pg, ps;
    __device__ __forceinline__ void stash(int tid) const {
      if (tid < n_pg) s_pages[tid] = pg;
    }
    __device__ __forceinline__ size_t slot(int s) const {
      const int pi = s / ps;
      return (size_t)s_pages[pi - page0] * ps + (s - pi * ps);
    }
  };
  __device__ __forceinline__ int keys() const { return P * ps; }
  // the split's page ids, loaded beside its length (they are valid table
  // entries whatever the length)
  __device__ __forceinline__ Split split(int b, int j, int keys_per_split,
                                         int tid, unsigned char* ext) const {
    const int page0 = j * (keys_per_split / ps);
    const int n_pg = min(keys_per_split / ps, P - page0);
    return {reinterpret_cast<int*>(ext), page0, n_pg,
            tid < n_pg ? table[(size_t)b * P + page0 + tid] : 0, ps};
  }
};

struct DenseRows {
  static constexpr int SMEM = 0;
  int S;                              // slots per row
  struct Split {
    size_t row0;                      // b * S
    __device__ __forceinline__ void stash(int) const {}
    __device__ __forceinline__ size_t slot(int s) const { return row0 + s; }
  };
  __device__ __forceinline__ int keys() const { return S; }
  __device__ __forceinline__ Split split(int b, int, int, int,
                                         unsigned char*) const {
    return {(size_t)b * S};
  }
};

// 32-bit words of E as fp32: bf16 pairs (the lower element in the low
// half), int8 quads exactly through the mantissa of 2^23 (each byte biased
// to c + 128, then 2^23 + 128 subtracted), fp32 as they are.
template <typename E>
struct Words;
template <>
struct Words<float> {
  static constexpr int PER = 1;
  __device__ __forceinline__ static void to_f(uint32_t w, float* f) {
    f[0] = __uint_as_float(w);
  }
};
template <>
struct Words<__nv_bfloat16> {
  static constexpr int PER = 2;
  __device__ __forceinline__ static void to_f(uint32_t w, float* f) {
    f[0] = __uint_as_float(w << 16);
    f[1] = __uint_as_float(w & 0xffff0000u);
  }
};
template <>
struct Words<int8_t> {
  static constexpr int PER = 4;
  __device__ __forceinline__ static void to_f(uint32_t w, float* f) {
    const uint32_t u = w ^ 0x80808080u, base = 0x4B000000u;
    f[0] = __uint_as_float(__byte_perm(u, base, 0x7650)) - 8388736.f;
    f[1] = __uint_as_float(__byte_perm(u, base, 0x7651)) - 8388736.f;
    f[2] = __uint_as_float(__byte_perm(u, base, 0x7652)) - 8388736.f;
    f[3] = __uint_as_float(__byte_perm(u, base, 0x7653)) - 8388736.f;
  }
};

// NW 32-bit words from shared memory in one load (NW * 4 bytes, aligned)
template <int NW>
__device__ __forceinline__ void lds(const void* p, uint32_t (&w)[NW]) {
  if constexpr (NW == 4) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    w[0] = u.x; w[1] = u.y; w[2] = u.z; w[3] = u.w;
  } else if constexpr (NW == 2) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    w[0] = u.x; w[1] = u.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
}

// The static shape of one instance: T the query / output type, PL the
// pools, NREP query heads per KV head, HD the head dim.
template <typename T, typename PL, int NREP, int HD>
struct Shape {
  using E = typename PL::E;
  static constexpr int EL = lane_elems(NREP, HD);
  static constexpr int HS = head_split(NREP, HD);   // CTAs per KV head
  static constexpr int NR = NREP / HS;              // query heads a CTA
  static constexpr int G = HD / EL;             // lanes per key
  static constexpr int KPW = 32 / G;            // keys per warp at once
  static constexpr int NG = WARPS * KPW;        // groups of a CTA
  static constexpr int VB = EL * (int)sizeof(E) < 16 ? EL * (int)sizeof(E)
                                                     : 16;  // bytes per load
  static constexpr int VE = VB / (int)sizeof(E);   // elements per load
  static constexpr int NV = EL / VE;               // loads per key and lane
  static constexpr int ROW = HD * (int)sizeof(E);  // bytes of one K row
  static constexpr int KS_BYTES = STAGE_BYTES / (2 * ROW);
  static constexpr int KS = KS_BYTES > NG ? KS_BYTES : NG;   // keys / stage
  static constexpr int STAGE = 2 * KS * ROW + (PL::SCALED ? 2 * KS * 4 : 0);
  static constexpr int RING = STAGES * STAGE;
  static constexpr int SCRATCH = (NG * NR * (HD + 3) + 2 * NR) * 4;
  static constexpr int BODY = RING > SCRATCH ? RING : SCRATCH;
  static_assert(HD % EL == 0 && 32 % G == 0, "lane layout");
  static_assert(NREP % HS == 0 && NR * EL <= 64, "head split");
  static_assert(KS * (ROW / 16) % 32 == 0, "producer layout");
  static_assert(KS % NG == 0 && ROW % 16 == 0, "stage layout");
  static_assert(MAX_SPLIT_PAGES <= THREADS, "one page id per thread");
};

// mbarrier helpers of the producer / consumer ring
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   rt::smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   rt::smem_addr(bar))
               : "memory");
}
// the bar's pending count tracks this thread's cp.async issued so far
__device__ __forceinline__ void mbar_track_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n" ::"r"(
                   rt::smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(rt::smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
// The body of every split-KV kernel: one CTA of THREADS threads, grid
// (KVH * HS, B, ceil(rows.keys() / split)); SMEM of S::BODY + Rows::SMEM
// bytes. ws and tickets are indexed by virtual KV head (KVH * HS of them).
template <typename T, typename PL, int NREP, int HD, typename Rows>
__device__ __forceinline__ void split_body(
    const T* __restrict__ q, const PL pools, const Rows& rows,
    const int* __restrict__ cache_len, T* __restrict__ out,
    float* __restrict__ ws, int* __restrict__ tickets, int KVH, int window,
    int split, float qscale) {
  using S = Shape<T, PL, NREP, HD>;
  using E = typename S::E;
  constexpr int EL = S::EL, G = S::G, KPW = S::KPW, NG = S::NG, VE = S::VE,
                NV = S::NV, KS = S::KS, HS = S::HS, NR = S::NR;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t s_full[STAGES], s_empty[STAGES];
  __shared__ int s_last;

  const int gv = blockIdx.x, g = gv / HS, b = blockIdx.y, j = blockIdx.z;
  const int NS = gridDim.z, H = KVH * NREP, KVV = KVH * HS;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const typename Rows::Split cur = rows.split(b, j, split, tid,
                                              smem + S::BODY);
  const int len = max(0, min(cache_len[b], rows.keys()));
  const int lo = window > 0 ? max(0, len - window) : 0;
  T* o = out + ((size_t)b * H + (size_t)gv * NR) * HD;
  if (len <= lo) {                        // no live key: zeros, once
    if (j == 0)
      for (int t = tid; t < NR * HD; t += THREADS) rt::store_f(o + t, 0.f);
    return;
  }
  const int j_lo = lo / split, j_hi = (len + split - 1) / split;
  if (j < j_lo || j >= j_hi) return;
  const int s_begin = max(lo, j * split), s_end = min(len, (j + 1) * split);
  cur.stash(tid);
  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&s_full[i], 1);           // the producer's lane 0
      mbar_init(&s_empty[i], WARPS);      // each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int n_stage = (s_end - s_begin + KS - 1) / KS;
  const int kg = lane / G, sl = lane % G;
  float acc[NR][EL], m[NR], l[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
#pragma unroll
    for (int e = 0; e < EL; ++e) acc[r][e] = 0.f;
    m[r] = rt::NEG_INF;
    l[r] = 0.f;
  }
  if (wid == WARPS) {
    // ---- producer warp: STAGES stages ahead of the consumers, 16-byte
    // cp.async copies (a key row's chunks on neighbouring lanes), the int8
    // scales by 4-byte copies; the stage's full barrier tracks them ----
    constexpr int CPR = S::ROW / 16;      // 16-byte chunks per key row
    constexpr int NKB = (KS + 31) / 32;   // key offsets per lane
    const size_t key_stride = (size_t)KVH * HD;   // elements per slot
    const size_t g_off = (size_t)g * HD;
    for (int st = 0; st < n_stage; ++st) {
      const int buf = st % STAGES;
      if (st >= STAGES) mbar_wait(&s_empty[buf], (st / STAGES - 1) & 1);
      unsigned char* base = smem + buf * S::STAGE;
      const int s0 = s_begin + st * KS, nk = min(KS, s_end - s0);
      size_t slot[NKB];                   // of keys lane + 32 i
#pragma unroll
      for (int i = 0; i < NKB; ++i)
        slot[i] = cur.slot(min(s0 + lane + 32 * i, s_end - 1));
      // warp copy t moves chunks c = 32 t + lane: chunk c % CPR of key
      // c / CPR (several keys a copy for short rows, part of one for long)
#pragma unroll
      for (int t = 0; t < KS * CPR / 32; ++t) {
        const int kk = (32 * t + lane) / CPR, col = (32 * t + lane) % CPR;
        const size_t sl_kk =
            __shfl_sync(0xffffffffu, slot[(32 * t / CPR) / 32], kk % 32);
        const bool ok = kk < nk;
        const size_t off = ((sl_kk * key_stride + g_off) * sizeof(E)) +
                           col * 16;
        rt::cp_async16(base + kk * S::ROW + col * 16,
                       reinterpret_cast<const unsigned char*>(pools.k) + off,
                       ok);
        rt::cp_async16(base + (KS + kk) * S::ROW + col * 16,
                       reinterpret_cast<const unsigned char*>(pools.v) + off,
                       ok);
      }
      if constexpr (PL::SCALED) {
        float* sc = reinterpret_cast<float*>(base + 2 * KS * S::ROW);
#pragma unroll
        for (int i = 0; i < NKB; ++i) {
          const int kk = lane + 32 * i;
          if (kk < KS) {
            const size_t off = slot[i] * KVH + g;
            rt::cp_async4(sc + kk, pools.ks + off, kk < nk);
            rt::cp_async4(sc + KS + kk, pools.vs + off, kk < nk);
          }
        }
      }
      mbar_track_cp_async(&s_full[buf]);
      __syncwarp();
      if (lane == 0) mbar_arrive(&s_full[buf]);
    }
  } else {
    // ---- consumer warps: this lane's query elements, pre-scaled: dims
    // (v * G + sl) * VE + e ----
    float qr[NR][EL];
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const T* qp = q + ((size_t)b * H + (size_t)gv * NR + r) * HD;
#pragma unroll
      for (int v = 0; v < NV; ++v)
#pragma unroll
        for (int e = 0; e < VE; ++e)
          qr[r][v * VE + e] = rt::to_f(qp[(v * G + sl) * VE + e]) * qscale;
    }
    for (int st = 0; st < n_stage; ++st) {
      const int buf = st % STAGES;
      mbar_wait(&s_full[buf], (st / STAGES) & 1);
      const unsigned char* base = smem + buf * S::STAGE;
      const int s0 = s_begin + st * KS;
#pragma unroll
      for (int p = 0; p < KS / NG; ++p) {
        const int kk = (p * WARPS + wid) * KPW + kg;
        const E* kr = reinterpret_cast<const E*>(base + kk * S::ROW);
        const E* vr = reinterpret_cast<const E*>(base + (KS + kk) * S::ROW);
        float sc[NR][2];                  // two chains: more FMAs in flight
#pragma unroll
        for (int r = 0; r < NR; ++r) sc[r][0] = sc[r][1] = 0.f;
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          uint32_t w[S::VB / 4];
          lds(kr + (v * G + sl) * VE, w);
          float kf[VE];
#pragma unroll
          for (int i = 0; i < S::VB / 4; ++i)
            Words<E>::to_f(w[i], kf + i * Words<E>::PER);
#pragma unroll
          for (int r = 0; r < NR; ++r)
#pragma unroll
            for (int e = 0; e < VE; ++e)
              sc[r][e & 1] = fmaf(qr[r][v * VE + e], kf[e], sc[r][e & 1]);
        }
        float d[NR];
#pragma unroll
        for (int r = 0; r < NR; ++r) d[r] = sc[r][0] + sc[r][1];
#pragma unroll
        for (int off = G / 2; off > 0; off >>= 1)
#pragma unroll
          for (int r = 0; r < NR; ++r)
            d[r] += __shfl_xor_sync(0xffffffffu, d[r], off);
        if (s0 + kk < s_end) {
          float vscale = 1.f;
          if constexpr (PL::SCALED) {
            const float* scl =
                reinterpret_cast<const float*>(base + 2 * KS * S::ROW);
#pragma unroll
            for (int r = 0; r < NR; ++r) d[r] *= scl[kk];
            vscale = scl[KS + kk];
          }
          float pv[NR];
#pragma unroll
          for (int r = 0; r < NR; ++r) {
            if (d[r] > m[r]) {            // a new max: rescale the state
              const float a = exp2f(m[r] - d[r]);
              l[r] *= a;
#pragma unroll
              for (int e = 0; e < EL; ++e) acc[r][e] *= a;
              m[r] = d[r];
            }
            const float pr = exp2f(d[r] - m[r]);
            l[r] += pr;
            pv[r] = pr * vscale;
          }
#pragma unroll
          for (int v = 0; v < NV; ++v) {
            uint32_t w[S::VB / 4];
            lds(vr + (v * G + sl) * VE, w);
            float vf[VE];
#pragma unroll
            for (int i = 0; i < S::VB / 4; ++i)
              Words<E>::to_f(w[i], vf + i * Words<E>::PER);
#pragma unroll
            for (int r = 0; r < NR; ++r)
#pragma unroll
              for (int e = 0; e < VE; ++e)
                acc[r][v * VE + e] = fmaf(pv[r], vf[e], acc[r][v * VE + e]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&s_empty[buf]);   // buffer free again
    }
  }
  __syncthreads();                        // the ring becomes merge scratch

  // ---- the CTA's groups, merged in group order ----
  float* s_m = reinterpret_cast<float*>(smem);         // [NG][NR]
  float* s_l = s_m + NG * NR;                            // [NG][NR]
  float* s_f = s_l + NG * NR;                            // [NG][NR]
  float* s_ml = s_f + NG * NR;                           // [2][NR]: M, L
  float* s_acc = s_ml + 2 * NR;                          // [NG][NR][HD]
  if (wid < WARPS) {
    const int grp = wid * KPW + kg;
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      if (sl == 0) {
        s_m[grp * NR + r] = m[r];
        s_l[grp * NR + r] = l[r];
      }
#pragma unroll
      for (int v = 0; v < NV; ++v)
#pragma unroll
        for (int e = 0; e < VE; ++e)
          s_acc[(grp * NR + r) * HD + (v * G + sl) * VE + e] =
              acc[r][v * VE + e];
    }
  }
  __syncthreads();
  // warp w: heads w, w + 9, ...: each head's M, L and factors
  for (int r = wid; r < NR; r += THREADS / 32) {
    float M = rt::NEG_INF;
    for (int gi = lane; gi < NG; gi += 32) M = fmaxf(M, s_m[gi * NR + r]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
    float L = 0.f;
    for (int gi = lane; gi < NG; gi += 32) {
      const float f = exp2f(s_m[gi * NR + r] - M);
      s_f[gi * NR + r] = f;
      L = fmaf(s_l[gi * NR + r], f, L);
    }
    L = rt::warp_sum(L);
    if (lane == 0) { s_ml[r] = M; s_ml[NR + r] = L; }
  }
  __syncthreads();
  const int n_live = j_hi - j_lo;
  constexpr int PART = NR * (HD + 2);     // floats of one split's partial
  float* part = ws + (((size_t)b * KVV + gv) * NS + j) * PART;
  for (int t = tid; t < NR * HD; t += THREADS) {
    const int r = t / HD;
    float O = 0.f;
    for (int gi = 0; gi < NG; ++gi)
      O = fmaf(s_acc[(gi * NR + r) * HD + (t - r * HD)],
               s_f[gi * NR + r], O);
    const float L = s_ml[NR + r];
    if (n_live == 1)
      rt::store_f(o + t, L == 0.f ? 0.f : O / L);
    else
      part[2 * NR + t] = O;
  }
  if (n_live == 1) return;

  // ---- across splits: the last CTA of (b, gv) merges, in split order ----
  if (tid < 2 * NR) part[tid] = s_ml[tid];     // m then l, as s_ml
  __threadfence();
  __syncthreads();
  int* ticket = tickets + (size_t)b * KVV + gv;
  if (tid == 0) s_last = atomicAdd(ticket, 1) == n_live - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const float* parts = ws + (((size_t)b * KVV + gv) * NS) * PART;
  for (int t = tid; t < NR * HD; t += THREADS) {
    const int r = t / HD;
    float M = rt::NEG_INF;
    for (int jj = j_lo; jj < j_hi; ++jj)
      M = fmaxf(M, __ldcg(parts + (size_t)jj * PART + r));
    float L = 0.f, O = 0.f;
    for (int jj = j_lo; jj < j_hi; ++jj) {
      const float* pj = parts + (size_t)jj * PART;
      const float f = exp2f(__ldcg(pj + r) - M);
      L = fmaf(__ldcg(pj + NR + r), f, L);
      O = fmaf(__ldcg(pj + 2 * NR + t), f, O);
    }
    rt::store_f(o + t, L == 0.f ? 0.f : O / L);
  }
  if (tid == 0) *ticket = 0;              // ready for the next call
}

// CTAs an SM must fit: fewer as a CTA's per-head registers (acc and q, EL
// each, for NR heads) grow; at 12 heads of 128 (NR * EL = 48) one CTA, so
// the heads' state stays in registers rather than spilling under a 2-CTA
// cap of 113 a thread.
template <int NREP, int HD>
constexpr int min_ctas() {
  constexpr int w = NREP / head_split(NREP, HD) * lane_elems(NREP, HD);
  return w <= 16 ? 3 : w <= 32 ? 2 : 1;
}

// The kernels: the paged one and the dense one, each under its own name so
// a profile tells them apart.
template <typename T, typename PL, int NREP, int HD>
__global__ void __launch_bounds__(THREADS, (min_ctas<NREP, HD>()))
paged_split_kernel(const T* __restrict__ q, const PL pools,
                   const PagedRows rows,
                   const int* __restrict__ cache_len, T* __restrict__ out,
                   float* __restrict__ ws, int* __restrict__ tickets,
                   int KVH, int window, int split, float qscale) {
  split_body<T, PL, NREP, HD>(q, pools, rows, cache_len, out, ws, tickets,
                              KVH, window, split, qscale);
}

template <typename T, typename PL, int NREP, int HD>
__global__ void __launch_bounds__(THREADS, (min_ctas<NREP, HD>()))
dense_split_kernel(const T* __restrict__ q, const PL pools,
                   const DenseRows rows,
                   const int* __restrict__ cache_len, T* __restrict__ out,
                   float* __restrict__ ws, int* __restrict__ tickets,
                   int KVH, int window, int split, float qscale) {
  split_body<T, PL, NREP, HD>(q, pools, rows, cache_len, out, ws, tickets,
                              KVH, window, split, qscale);
}

// Launches one instance of `kernel` over rows of `keys` keys: grid (KVH *
// HS, B, ceil(keys / split)), the split index slowest, so every row's first splits
// are dispatched before any row's later ones (at a serve tick most later
// splits lie past the rows' lengths and return at once); S::BODY +
// Rows::SMEM bytes of dynamic shared memory (above 48 KB for bf16: opted
// into once per instance). The function is static, so each library keeps
// its own opt-in flag.
template <typename T, typename PL, int NREP, int HD, typename Rows,
          typename Kernel>
static void launch_rows(Kernel kernel, const PL& pools, const Rows& rows,
                        long long keys, const void* q, const void* clen,
                        void* out, void* ws, void* tickets, int B, int KVH,
                        int window, int split, cudaStream_t st) {
  constexpr int SMEM = Shape<T, PL, NREP, HD>::BODY + Rows::SMEM;
  static bool configured = false;
  if (!configured) {                      // a failure stays the last error
    if (cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM) != cudaSuccess)
      return;
    configured = true;
  }
  const int NS = (int)((keys + split - 1) / split);
  // scores in log2 units: exp2(x * log2 e) = exp(x)
  const float qscale = 1.4426950408889634f / sqrtf(static_cast<float>(HD));
  kernel<<<dim3(KVH * Shape<T, PL, NREP, HD>::HS, B, NS), THREADS, SMEM,
           st>>>(
      static_cast<const T*>(q), pools, rows, static_cast<const int*>(clen),
      static_cast<T*>(out), static_cast<float*>(ws),
      static_cast<int*>(tickets), KVH, window, split, qscale);
}

// Paged: rows of P pages of ps tokens through a (B, P) page table.
template <typename T, typename PL, int NREP, int HD>
static void launch(const PL& pools, const void* q, const void* table,
                   const void* clen, void* out, void* ws, void* tickets,
                   int B, int P, int ps, int KVH, int window, int split,
                   cudaStream_t st) {
  launch_rows<T, PL, NREP, HD>(
      paged_split_kernel<T, PL, NREP, HD>, pools,
      PagedRows{static_cast<const int*>(table), P, ps}, (long long)P * ps,
      q, clen, out, ws, tickets, B, KVH, window, split, st);
}

// Dense: rows of S slots of a (B, S, KVH, hd) cache.
template <typename T, typename PL, int NREP, int HD>
static void launch_dense(const PL& pools, int S, const void* q,
                         const void* clen, void* out, void* ws,
                         void* tickets, int B, int KVH, int window,
                         int split, cudaStream_t st) {
  launch_rows<T, PL, NREP, HD>(dense_split_kernel<T, PL, NREP, HD>, pools,
                               DenseRows{S}, S, q, clen, out, ws, tickets,
                               B, KVH, window, split, st);
}

// Whether the launchers take these shapes: P <= MAX_PAGES, split a
// positive multiple of ps with at most MAX_SPLIT_PAGES pages, grid
// dimensions within range (n_rep and hd: rt::dispatch).
inline bool shape_ok(int B, int P, int ps, int KVH, int split) {
  return P > 0 && P <= MAX_PAGES && ps > 0 && split > 0 && split % ps == 0 &&
         split / ps <= MAX_SPLIT_PAGES && B > 0 && B <= 65535 && KVH > 0 &&
         KVH <= 65535;
}

// The same for a dense cache of S slots: a positive split, at most 65535
// splits of a row.
inline bool dense_shape_ok(int B, int S, int KVH, int split) {
  return S > 0 && split > 0 && ((long long)S + split - 1) / split <= 65535 &&
         B > 0 && B <= 65535 && KVH > 0 && KVH <= 65535;
}

}  // namespace pa
