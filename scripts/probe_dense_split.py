#!/usr/bin/env python3
"""How the port's dense split-KV decode attention (``csrc/decode_attention
.cu``) trades CTAs against merging, and its cp.async producer against a TMA
tensor copy per stage, on one card.

Builds this tree's ``decode_attention.cu`` and a variant of it made from a
copy of the sources under ``build/probe_dense/tma/``, whose producer warp
copies each whole stage as one TMA tensor copy of K and one of V
(``cp.async.bulk.tensor.2d`` over the (B * S, KVH * hd) matrix, a box of
the stage's keys by hd columns at column g * hd, the tensor maps encoded
through ``cudaGetDriverEntryPoint`` and passed as ``__grid_constant__``
kernel parameters; a split's ragged last stage keeps the cp.async copies).
Times them (bf16, B = 4, 32 heads of 128; CUDA graphs of 24 calls over
2-8 distinct caches, CUDA events, alternating order) at 150 live keys of
a 162-slot cache (the full run's) and at 1024, 2048 and 4096 slots with
every slot live: the rule's split (``decode_attention_split_keys``) with
either producer, and at 1024 slots and more also splits of 256, 512, 1024
and 2048 keys and the S / 3 keys that give B * KVH * 3 = 384 CTAs (one
wave of three CTAs per SM on 132 SMs). Each is held to the plain version
(atol 1e-4, rtol 2**-7) and timed beside
``torch.nn.functional.scaled_dot_product_attention`` on the same caches;
then the card's name and power limit are printed.

    python3 scripts/probe_dense_split.py
"""
from __future__ import annotations

import shutil
import statistics
import sys

import ab_common as ab

B, H, HD = 4, 32, 128
# (slots, live keys per row, distinct caches: > 50 MB of live K/V together
# where they fit, so each call reads its K/V from memory)
CASES = ((162, 150, 8), (1024, 1024, 2), (2048, 2048, 2), (4096, 4096, 2))
# (text of this tree's paged_attention_split.cuh, text of the TMA variant)
TMA = (
    ('#include "mma.cuh"\n',
     '#include "mma.cuh"\n\n#include <cudaTypedefs.h>\n\n#include <cstdio>\n'
     '#include <cstdlib>\n'),
    ("""struct DenseRows {
  static constexpr int SMEM = 0;
  int S;                              // slots per row
""", """struct DenseRows {
  static constexpr int SMEM = 128;    // to align the ring
  int S;                              // slots per row
  CUtensorMap kmap, vmap;
  __device__ __forceinline__ void copy_stage(void* k_dst, void* v_dst,
                                             size_t row, int col,
                                             uint64_t* full,
                                             int bytes) const {
    const uint32_t bar = rt::smem_addr(full);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\\n"
                 ::"r"(bar), "r"(bytes) : "memory");
    const CUtensorMap* maps[2] = {&kmap, &vmap};
    void* dst[2] = {k_dst, v_dst};
#pragma unroll
    for (int i = 0; i < 2; ++i)
      asm volatile(
          "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
          "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\\n" ::"r"(
              rt::smem_addr(dst[i])),
          "l"(reinterpret_cast<uint64_t>(maps[i])), "r"(col),
          "r"(static_cast<int>(row)), "r"(bar)
          : "memory");
  }
"""),
    ("  extern __shared__ __align__(16) unsigned char smem[];\n",
     "  extern __shared__ __align__(16) unsigned char smem_raw[];\n"
     "  unsigned char* const smem = reinterpret_cast<unsigned char*>(\n"
     "      (reinterpret_cast<uintptr_t>(smem_raw) + 127) &\n"
     "      ~static_cast<uintptr_t>(127));\n"),
    ("      size_t slot[NKB];",
     "      if (nk == KS) {                   // a whole stage: two copies\n"
     "        if (lane == 0)\n"
     "          rows.copy_stage(base, base + KS * S::ROW, cur.slot(s0),\n"
     "                          g * HD, &s_full[buf], 2 * KS * S::ROW);\n"
     "        continue;\n"
     "      }\n"
     "      size_t slot[NKB];"),
    ("                   const DenseRows rows,",
     "                   const __grid_constant__ DenseRows rows,"),
    ("// Dense: rows of S slots of a (B, S, KVH, hd) cache.", """// A (rows, cols) row-major matrix of T as a tensor map with a box of
// box_rows x box_cols; aborts if the driver refuses it.
template <typename T>
void encode(CUtensorMap* map, const T* base, unsigned long long rows,
            unsigned long long cols, int box_rows, int box_cols) {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  cudaDriverEntryPointQueryResult found;
  if (fn == nullptr &&
      (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled",
                               reinterpret_cast<void**>(&fn),
                               cudaEnableDefault, &found) != cudaSuccess ||
       found != cudaDriverEntryPointSuccess)) {
    std::fprintf(stderr, "cuTensorMapEncodeTiled not found\\n");
    std::abort();
  }
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * sizeof(T)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  if (fn(map,
         sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                        : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
         2, const_cast<T*>(base), dims, strides, box, unit,
         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    std::fprintf(stderr, "tensor map refused\\n");
    std::abort();
  }
}

template <typename T, int KS, int HD>
DenseRows tma_rows(const T* k, const T* v, int B, int S, int KVH) {
  DenseRows rows{S};
  const unsigned long long n = (unsigned long long)B * S;
  encode(&rows.kmap, k, n, (unsigned long long)KVH * HD, KS, HD);
  encode(&rows.vmap, v, n, (unsigned long long)KVH * HD, KS, HD);
  return rows;
}

// Dense: rows of S slots of a (B, S, KVH, hd) cache."""),
    ("                               DenseRows{S}, S,",
     "                               tma_rows<T, Shape<T, PL, NREP, HD>::KS,"
     " HD>(\n                                   pools.k, pools.v, B, S,"
     " KVH),\n                               S,"),
)


def tma_variant():
    """A copy of this tree's dense kernel sources with the TMA producer."""
    out = ab.ROOT / "build" / "probe_dense" / "tma"
    out.mkdir(parents=True, exist_ok=True)
    shutil.copy(ab.CSRC / "decode_attention.cu", out)
    text = (ab.CSRC / "paged_attention_split.cuh").read_text()
    for old, new in TMA:
        if text.count(old) != 1:
            raise RuntimeError("the text to replace is not in "
                               "paged_attention_split.cuh")
        text = text.replace(old, new)
    (out / "paged_attention_split.cuh").write_text(text)
    return out


def main() -> int:
    import torch
    import torch.nn.functional as F
    if len(sys.argv) != 1 or not torch.cuda.is_available():
        print(__doc__)
        return 1
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    fns = {}
    for tag, src in (("cp.async", ab.CSRC), ("TMA", tma_variant())):
        lib, _, report = ab.build(tag.replace(".", "_"), src,
                                  "decode_attention",
                                  ab.ROOT / "build" / "probe_dense")
        print(f"{tag}: {ab.registers(report)}", flush=True)
        fns[tag] = ab.c_fn(lib, "decode_attention_launch", 7, 8)
    rule = lib.decode_attention_split_keys
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    for S, live, n_c in CASES:
        q, out = rnd((B, 1, H, HD)), torch.empty(B, 1, H, HD, device=dev,
                                                 dtype=torch.bfloat16)
        cl = torch.full((B,), live, dtype=torch.int32, device=dev)
        caches = [(rnd((B, S, H, HD)), rnd((B, S, H, HD)))
                  for _ in range(n_c)]
        want = decode_attention_ref(q.float(), caches[0][0].float(),
                                    caches[0][1].float(), cl)
        best = rule(S, HD, 2)
        runs = [("cp.async", best), ("TMA", best)]
        if S >= 1024:
            runs += [("cp.async", split) for split in sorted(
                {256, 512, 1024, 2048, -(-S // 3)} - {best}) if split <= S]
        cases = {}
        for tag, split in runs:
            ws = torch.empty(B * H * -(-S // split) * (HD + 2), device=dev)
            tickets = torch.zeros(B * H, dtype=torch.int32, device=dev)
            calls = [lambda c=c, ws=ws, tickets=tickets, split=split,
                     f=fns[tag]: f(
                *map(ab.ptr, (q, c[0], c[1], cl, out, ws, tickets)), B, S,
                H, H, HD, 0, split, 1, ab.stream())
                for c in caches] * (24 // n_c)
            label = f"{tag} split {split}"
            if calls[0]() != 0:
                raise RuntimeError(f"S={S}, {label}: launch failed")
            torch.cuda.synchronize()
            torch.testing.assert_close(out.float(), want, atol=1e-4,
                                       rtol=2.0 ** -7)
            cases[label] = calls
        qs = q.transpose(1, 2)
        kv_t = [(k[:, :live].transpose(1, 2), v[:, :live].transpose(1, 2))
                for k, v in caches]

        def sdpa(k, v, qs=qs):
            F.scaled_dot_product_attention(qs, k, v)
            return 0                      # as a launch's error code
        cases["SDPA"] = [lambda c=c: sdpa(*c) for c in kv_t] * (24 // n_c)
        times = {label: [] for label in cases}
        for r in range(6):
            for label in (list(cases) if r % 2 == 0 else list(cases)[::-1]):
                times[label].append(ab.graph_ms(cases[label]))
        print(f"{live} live keys of {S} slots (rule: split {best}): " +
              "; ".join(f"{label} {statistics.median(ts):.4f} ms "
                        f"({min(ts):.4f}-{max(ts):.4f})"
                        for label, ts in times.items()), flush=True)
    print(ab.card())
    return 0


if __name__ == "__main__":
    sys.exit(main())
