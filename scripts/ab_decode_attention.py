#!/usr/bin/env python3
"""A/B of the port's fp decode-attention kernels (dense and paged) between
another version of ``src/repro_torch/csrc`` and this tree's, on one card.

Both versions are built side by side with ``nvcc`` (the flags of
``repro_torch.kernels.build``) and timed in one process, in alternating
order (base, tree, tree, base, then reversed), at the shapes of
``chip_smoke.py`` phase 2: dense B=4 over the full run's 162-slot cache
with 150 live keys and over 1024 live keys, paged B=8 with 128-token pages
at 785 and 4563 live keys; bf16, 32 heads of 128. Outputs must be
bit-equal between the versions (the arithmetic is the same).

    git archive <commit> src/repro_torch/csrc | tar -x -C build/base
    python3 scripts/ab_decode_attention.py build/base/src/repro_torch/csrc

Prints the ptxas report of each build, then per case the median and range
of each version's device time per call (CUDA graph of 12-24 calls, CUDA
events), and the card's name and power limit.
"""
from __future__ import annotations

import sys
from pathlib import Path

import ab_common as ab

NAMES = ("decode_attention", "paged_decode_attention")
H, HD, PAGE = 32, 128, 128


def main() -> int:
    import numpy as np
    import torch
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__)
        return 1
    fns = {}
    for tag, src in (("base", Path(sys.argv[1]).resolve()),
                     ("tree", ab.CSRC)):
        for name in NAMES:
            lib, _, report = ab.build(tag, src, name,
                                      ab.ROOT / "build" / "ab")
            print(f"{tag} {name}: {ab.registers(report)}", flush=True)
            fns[(tag, name)] = (ab.c_fn(lib, f"{name}_launch", 5, 7)
                                if name == "decode_attention"
                                else ab.c_fn(lib, f"{name}_launch", 6, 8))
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(shape):
        return torch.randn(shape, generator=gen, device=dev).bfloat16()

    ptr = ab.ptr
    cases, outs = {}, {}
    for label, S, live, n in (("dense, 150 live keys", 162, 150, 8),
                              ("dense, 1024 live keys", 1024, 1024, 2)):
        B = 4
        q, out = rnd((B, 1, H, HD)), torch.empty(B, 1, H, HD, device=dev,
                                                 dtype=torch.bfloat16)
        cl = torch.full((B,), live, dtype=torch.int32, device=dev)
        caches = [(rnd((B, S, H, HD)), rnd((B, S, H, HD))) for _ in range(n)]

        def calls(tag, q=q, out=out, cl=cl, caches=caches, B=B, S=S):
            f = fns[(tag, "decode_attention")]
            return [lambda c=c: f(ptr(q), ptr(c[0]), ptr(c[1]), ptr(cl),
                                  ptr(out), B, S, H, H, HD, 0, 1,
                                  ab.stream()) for c in caches] * 3
        cases[label], outs[label] = calls, out
    for P, lens in ((2, [150, 1, 77, 149, 150, 128, 129, 1]),
                    (8, [1024, 1, 700, 1000, 513, 1024, 300, 1])):
        B, NP = len(lens), len(lens) * P + 5
        q, out = rnd((B, 1, H, HD)), torch.empty(B, 1, H, HD, device=dev,
                                                 dtype=torch.bfloat16)
        cl = torch.tensor(lens, dtype=torch.int32, device=dev)
        pools = []
        for j in range(4):
            perm = np.random.default_rng(j).permutation(NP)[:B * P]
            table = torch.as_tensor(perm.reshape(B, P).astype(np.int32),
                                    device=dev)
            table[-1] = NP                     # a retired row: trash page
            pools.append((rnd((NP + 1, PAGE, H, HD)),
                          rnd((NP + 1, PAGE, H, HD)), table))

        def calls(tag, q=q, out=out, cl=cl, pools=pools, B=B, P=P):
            f = fns[(tag, "paged_decode_attention")]
            return [lambda c=c: f(ptr(q), ptr(c[0]), ptr(c[1]), ptr(c[2]),
                                  ptr(cl), ptr(out), B, P, PAGE, H, H, HD, 0,
                                  1, ab.stream()) for c in pools] * 3
        label = f"paged, {sum(lens)} live keys"
        cases[label], outs[label] = calls, out

    for label, calls in cases.items():
        got = []
        for tag in ("base", "tree"):
            calls(tag)[0]()
            torch.cuda.synchronize()
            got.append(outs[label].clone())
        if not torch.equal(got[0], got[1]):
            raise AssertionError(f"{label}: outputs differ between versions")
    times = ab.alternate(cases)
    for label in cases:
        print(f"{label}: outputs bit-equal; " + "; ".join(
            f"{tag} {ab.summary(times[(label, tag)])}"
            for tag in ("base", "tree")), flush=True)
    print(ab.card())
    return 0


if __name__ == "__main__":
    sys.exit(main())
