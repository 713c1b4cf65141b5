#!/usr/bin/env python3
"""A/B of the port's LM-head verify kernels between another version of the
sources and this tree's, on one card.

Builds ``argmax_verify.cu``, ``topk_verify.cu``, ``argmax_verify_q.cu``
and ``topk_verify_q.cu`` (whose bf16 instances are the tensor-core tile of
``csrc/lm_head_mma.cuh``) from both trees with the flags of
``repro_torch.kernels.build``; prints each build's registers, this tree's
ptxas report (registers, spills) of the four tile libraries and the HMMA
count per kernel in their ``cuobjdump -sass`` (it fails if a tile kernel
has none: the argmax, the top-k and the int8 and int4 argmax and top-k). Then times both versions in one
process, in alternating order (base, tree, tree, base, then reversed; 12
timings each), each timing a CUDA graph of calls on distinct hidden rows:
  bf16 argmax at B=4, R=8, 160, 320 (D=4096, V=32000: Llama-2-7B's head)
  and B=4 at D=768, V=50280 (mamba2-130m's tied head);
  bf16 top-k (k=4) at B=4, R=160 and 320; the int8 and int4 argmax at
  B=4, R=160 and 320 and the int8 and int4 top-k at B=4, R=160 and 320
  (D=4096, V=32000, bf16 hidden rows).
Each version of each case is first held to the plain version (ids exact,
values atol = rtol = 1e-4: fp32 sums in another order), and the bf16
argmax of both versions to each other (bit-equal ids and values).

    python3 scripts/ab_argmax_verify.py <dir holding the other csrc>

e.g. after ``git archive HEAD src/repro_torch/csrc | tar -x -C build/base``:
``python3 scripts/ab_argmax_verify.py build/base/src/repro_torch/csrc``.
"""
from __future__ import annotations

import sys
from pathlib import Path

import ab_common as ab

NAMES = ("argmax_verify", "topk_verify", "argmax_verify_q", "topk_verify_q")
K_TOP = 4
# the tensor-core tile kernels each library must hold, with HMMA
TILES = {"argmax_verify": ("argmax_partial_mma",),
         "topk_verify": ("topk_partial_mma",),
         "argmax_verify_q": ("Int8Tile", "Int4Tile"),
         "topk_verify_q": ("Int8Tile", "Int4Tile")}


def main() -> int:
    import torch
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__)
        return 1
    from repro_torch.kernels.exit_gate import ref
    from repro_torch.quant import QTensor
    out = ab.ROOT / "build" / "ab_verify"
    libs = {}
    for tag, src in (("base", Path(sys.argv[1]).resolve()),
                     ("tree", ab.CSRC)):
        for name in NAMES:
            lib, so, report = ab.build(tag, src, name, out)
            libs[(tag, name)] = lib
            print(f"{tag} {name}: {ab.registers(report)}", flush=True)
            if tag == "tree" and name in TILES:
                print(f"tree {name} ptxas report:\n  " + "\n  ".join(report),
                      flush=True)
                hmma = ab.hmma_by_function(so)
                print(f"tree {name} SASS, HMMA per kernel: {hmma}",
                      flush=True)
                for key in TILES[name]:
                    tile = [n for n in hmma if key in n and "partial" in n]
                    if not tile or any(hmma[n] == 0 for n in tile):
                        raise RuntimeError(f"a tensor-core {name} kernel "
                                           f"({key}) has no HMMA instruction")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16

    def rnd(shape, dtype=bf, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale
                ).to(dtype)

    heads = {(4096, 32000): rnd((4096, 32000), scale=0.05),
             (768, 50280): rnd((768, 50280), scale=0.05)}
    qheads = {}
    for bits in (8, 4):
        rows = 4096 if bits == 8 else 2048
        codes = torch.randint(-127 if bits == 8 else -128, 128,
                              (rows, 32000), generator=gen, device=dev,
                              dtype=torch.int32).to(torch.int8)
        qheads[bits] = QTensor(codes, torch.rand(32000, generator=gen,
                                                 device=dev) * 0.01 + 1e-3,
                               bits)

    cases, checks = {}, []
    n_sets = 8

    def plain_case(label, name, R, D, V, head, k=None, bits=None):
        sets = []
        for _ in range(n_sets):
            nblk = -(-V // 128)
            kk = k or 1
            sets.append((rnd((R, D)),
                         torch.empty(R, nblk, kk, device=dev),
                         torch.empty(R, nblk, kk, device=dev,
                                     dtype=torch.int32),
                         torch.empty((R, kk) if k else (R,), device=dev,
                                     dtype=torch.int32),
                         torch.empty((R, kk) if k else (R,), device=dev)))

        def calls(tag):
            f = ab.c_fn(libs[(tag, name)], f"{name}_launch",
                        7 if bits else 6,
                        (5 if k else 4) + (1 if bits else 0))
            res = []
            for hn, pv, pi, a, b in sets:
                heads_p = ((ab.ptr(head.q), ab.ptr(head.scale)) if bits
                           else (ab.ptr(head),))
                ints = [R, D, V] + ([k] if k else []) + (
                    [bits] if bits else []) + [1]
                res.append(lambda hn=hn, pv=pv, pi=pi, a=a, b=b, hp=heads_p,
                           ints=ints: f(ab.ptr(hn), *hp, ab.ptr(pv),
                                        ab.ptr(pi), ab.ptr(a), ab.ptr(b),
                                        *ints, ab.stream()))
            return res
        cases[label] = calls
        hn, _, _, a, b = sets[0]
        if bits:
            want = (ref.verify_topk_q_ref(hn, head, k) if k
                    else ref.verify_argmax_q_ref(hn, head))
        else:
            want = (ref.verify_topk_ref(hn, head, k) if k
                    else ref.verify_argmax_ref(hn, head))
        checks.append((label, calls, a, b, want))

    for R in (4, 8, 160, 320):
        plain_case(f"argmax bf16 R={R}", "argmax_verify", R, 4096, 32000,
                   heads[(4096, 32000)])
    plain_case("argmax bf16 B=4 D=768 V=50280", "argmax_verify", 4, 768,
               50280, heads[(768, 50280)])
    for R in (4, 160, 320):
        plain_case(f"topk bf16 R={R}", "topk_verify", R, 4096, 32000,
                   heads[(4096, 32000)], k=K_TOP)
    for bits in (8, 4):
        for R in (4, 160, 320):
            plain_case(f"argmax_q int{bits} R={R}", "argmax_verify_q", R,
                       4096, 32000, qheads[bits], bits=bits)
        for R in (4, 160, 320):
            plain_case(f"topk_q int{bits} R={R}", "topk_verify_q", R, 4096,
                       32000, qheads[bits], k=K_TOP, bits=bits)

    for label, calls, a, b, (ids_r, vals_r) in checks:
        got = {}
        for tag in ("base", "tree"):
            a.fill_(-1)
            b.fill_(float("nan"))
            if calls(tag)[0]() != 0:
                raise RuntimeError(f"{tag} {label}: launch failed")
            torch.cuda.synchronize()
            if not torch.equal(a, ids_r):
                raise AssertionError(f"{tag} {label}: ids differ from the "
                                     f"plain version")
            torch.testing.assert_close(b, vals_r, atol=1e-4, rtol=1e-4)
            got[tag] = (a.clone(), b.clone())
        if label.startswith("argmax bf16") and not (
                torch.equal(got["base"][0], got["tree"][0])
                and torch.equal(got["base"][1], got["tree"][1])):
            raise AssertionError(f"{label}: the two versions differ")
    print("every case of both versions equals the plain version (ids "
          "exact, values atol = rtol = 1e-4); the bf16 argmax of both "
          "versions is bit-equal", flush=True)
    times = ab.alternate(cases)
    for label in cases:
        print(f"{label}: " + "; ".join(
            f"{tag} {ab.summary(times[(label, tag)])}"
            for tag in ("base", "tree")), flush=True)
    print(ab.card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
