#!/usr/bin/env python3
"""A/B of the port's flash-attention kernel (``csrc/flash_attention.cu``)
between another version of the source and this tree's, on one card.

Builds both with the flags of ``repro_torch.kernels.build``, prints each
ptxas report and the HMMA count per kernel in ``cuobjdump -sass`` of this
tree's library (it fails if the bf16 tensor-core kernel has none), then
times both in one process, in alternating order (base, tree, tree, base,
then reversed; 12 timings each), each timing a CUDA graph of 10 calls, in
bf16 at ``chip_smoke.py``'s flash cases: Llama-2-7B's 32 heads of 128,
causal, B=1 and 4, S=77 and 512, and S=512 with GQA n_rep=4. Each version
is first held to the plain version on the inputs upcast to fp32 (atol
1e-4, rtol 2**-7: the output's rounding to bf16), causal with windows
None and 64.

    python3 scripts/ab_flash_attention.py <dir holding the other csrc>
"""
from __future__ import annotations

import sys
from pathlib import Path

import ab_common as ab

HEADS, HD = 32, 128
CASES = ((1, 77, HEADS), (1, 512, HEADS), (4, 77, HEADS), (4, 512, HEADS),
         (1, 512, HEADS // 4))


def main() -> int:
    import torch
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__)
        return 1
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    out = ab.ROOT / "build" / "ab_flash"
    fns = {}
    for tag, src in (("base", Path(sys.argv[1]).resolve()),
                     ("tree", ab.CSRC)):
        lib, so, report = ab.build(tag, src, "flash_attention", out)
        fns[tag] = ab.c_fn(lib, "flash_attention_launch", 4, 8)
        print(f"{tag} flash_attention: {ab.registers(report)}", flush=True)
        if tag == "tree":
            print("tree flash_attention ptxas report:\n  "
                  + "\n  ".join(report), flush=True)
            hmma = ab.hmma_by_function(so)
            print(f"tree flash_attention SASS, HMMA per kernel: {hmma}",
                  flush=True)
            mma = [n for n in hmma if "flash_attention_kernel_mma" in n]
            if not mma or any(hmma[n] == 0 for n in mma):
                raise RuntimeError("the tensor-core flash kernel has no HMMA "
                                   "instruction")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(shape):
        return torch.randn(shape, generator=gen, device=dev).bfloat16()

    cases = {}
    for Bf, S, kvh in CASES:
        q = rnd((Bf, S, HEADS, HD))
        k = rnd((Bf, S, kvh, HD))
        v = rnd((Bf, S, kvh, HD))
        o = torch.empty_like(q)

        def run(tag, window=0, q=q, k=k, v=v, o=o, Bf=Bf, S=S, kvh=kvh):
            return fns[tag](ab.ptr(q), ab.ptr(k), ab.ptr(v), ab.ptr(o), Bf,
                            S, HEADS, kvh, HD, 1, window, 1, ab.stream())
        for window in (None, 64):
            want = flash_attention_ref(q.float(), k.float(), v.float(), True,
                                       window)
            for tag in fns:
                o.fill_(float("nan"))
                if run(tag, window or 0) != 0:
                    raise RuntimeError(f"{tag} launch failed")
                torch.cuda.synchronize()
                torch.testing.assert_close(o.float(), want, atol=1e-4,
                                           rtol=2.0 ** -7)
        cases[f"B={Bf} S={S} n_rep={HEADS // kvh}"] = (
            lambda tag, run=run: [lambda: run(tag)] * 10)
    print("both versions equal the plain version in every case (atol 1e-4, "
          "rtol 2**-7; windows None and 64)", flush=True)
    times = ab.alternate(cases)
    for label in cases:
        print(f"{label}: " + "; ".join(
            f"{tag} {ab.summary(times[(label, tag)])}"
            for tag in ("base", "tree")), flush=True)
    print(ab.card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
