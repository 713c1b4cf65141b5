#!/usr/bin/env python3
"""A/B of the port's SSD intra-chunk kernel (``csrc/ssd_chunk.cu``) between
another version of the source and this tree's, on one card.

Both versions are built side by side with ``nvcc`` (the flags of
``repro_torch.kernels.build``) and timed in one process, in alternating
order (base, tree, tree, base, then reversed), at mamba2-130m's shapes
(c=64, 24 heads of 64, d_state 128, bf16 B/C) for 1, 2, 8 and 32 cells:
a prefill of 64, 128 and 512 tokens of one row, and of 4 rows of 512.
Each version's output is held against the plain version
(``ssd_chunk_ref``) at atol = rtol = 1e-4 (fp32 sums in another order).

    python3 scripts/ab_ssd_chunk.py <dir holding the other ssd_chunk.cu>

The other directory may hold its own ``common.cuh``; this tree's is found
after it. Prints the ptxas report of each build, then per case the median
and range of each version's device time per call (CUDA graph of 16 calls
on distinct inputs, CUDA events), and the card's name and power limit.
"""
from __future__ import annotations

import sys
from pathlib import Path

import ab_common as ab

C, NH, HD, DS = 64, 24, 64, 128


def main() -> int:
    import torch
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__)
        return 1
    from repro_torch.kernels.ssd_chunk.ref import ssd_chunk_ref
    versions = {}
    for tag, src in (("base", Path(sys.argv[1]).resolve()),
                     ("tree", ab.CSRC)):
        lib, _, report = ab.build(tag, src, "ssd_chunk",
                                  ab.ROOT / "build" / "ab_ssd")
        print(f"{tag}: {ab.registers(report)}", flush=True)
        versions[tag] = ab.c_fn(lib, "ssd_chunk_launch", 5, 6)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    ptr = ab.ptr

    cases, firsts = {}, {}
    for cells in (1, 2, 8, 32):
        sets = []
        for _ in range(16):
            cum = -torch.cumsum(torch.rand((cells, C, NH), generator=gen,
                                           device=dev), dim=1)
            sets.append((torch.randn((cells, C, NH, HD), generator=gen,
                                     device=dev), cum,
                         (torch.randn((cells, C, DS), generator=gen,
                                      device=dev) * DS ** -0.25).bfloat16(),
                         (torch.randn((cells, C, DS), generator=gen,
                                      device=dev) * DS ** -0.25).bfloat16(),
                         torch.empty((cells, C, NH, HD), device=dev)))

        def calls(tag, sets=sets, cells=cells):
            f = versions[tag]
            return [lambda a=a: f(ptr(a[0]), ptr(a[1]), ptr(a[2]),
                                  ptr(a[3]), ptr(a[4]), cells, C, NH, HD,
                                  DS, 1, ab.stream()) for a in sets]
        cases[f"{cells} cells"], firsts[f"{cells} cells"] = calls, sets[0]

    for label, calls in cases.items():
        a = firsts[label]
        want = ssd_chunk_ref(*a[:4])
        for tag in versions:
            a[4].fill_(float("nan"))
            if calls(tag)[0]() != 0:
                raise RuntimeError(f"{tag} launch failed")
            torch.cuda.synchronize()
            torch.testing.assert_close(a[4], want, atol=1e-4, rtol=1e-4)
    times = ab.alternate(cases)
    for label in cases:
        print(f"{label}: both equal the plain version (atol 1e-4); " +
              "; ".join(f"{tag} {ab.summary(times[(label, tag)])}"
                        for tag in versions), flush=True)
    print(ab.card())
    return 0


if __name__ == "__main__":
    sys.exit(main())
