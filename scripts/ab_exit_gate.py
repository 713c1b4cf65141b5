#!/usr/bin/env python3
"""A/B of the port's fused exit gate (``csrc/exit_gate.cu``) between
another version of ``src/repro_torch/csrc`` and this tree's, on one card,
with the two spec-head kernels that share the gather header
(``spec_head.cu``, ``spec_head_q.cu``).

Each version is built side by side with ``nvcc`` (the flags of
``repro_torch.kernels.build``) and timed in one process, in alternating
order (base, tree, tree, base, then reversed), bf16 activations and head,
k = 4, H = 512, 20 distinct speculative id sets per CUDA graph (the
gathered columns start cold), at the gate shapes of ``chip_smoke.py``
phase 2: B = 4 and B = 8 rows of Llama-2-7B (D = 4096, V = 32000) and B =
4 of mamba2-130m (D = 768, V = 50280). Every gate output of each version
is held against the plain version (``exit_gate_ref``) at atol = rtol =
1e-4; the spec heads (B = 4 and R = 160, bf16; int8 and int4 codes) must
be bit-equal between the versions.

    git archive <commit> src/repro_torch/csrc | tar -x -C build/base
    python3 scripts/ab_exit_gate.py build/base/src/repro_torch/csrc

Prints the ptxas report of each build, then per case the median and range
of each version's device time per call (CUDA events) beside the gate's
byte bound (useful bytes) and sector bound (a 32-byte sector per gathered
element) at 3.35 TB/s, and the card's name and power limit.
"""
from __future__ import annotations

import sys
from pathlib import Path

import ab_common as ab

K_SPEC, H_PRED, N_SETS = 4, 512, 20
# pointer and int arguments before the stream of each launch function
C_ARGS = {"exit_gate": (11, 6), "spec_head": (4, 5), "spec_head_q": (5, 6)}
GATES = (("gate B=4 D=4096", 4, 4096, 32000),
         ("gate B=8 D=4096", 8, 4096, 32000),
         ("gate B=4 D=768", 4, 768, 50280))


def gate_bounds(B: int, D: int):
    """(useful-byte bound, sector bound) in ms of one bf16 gate call."""
    fixed = (B * D * 2 + B * K_SPEC * 8
             + (3 * K_SPEC * H_PRED + 2 * H_PRED + 1) * 4
             + B * (1 + 2 * K_SPEC) * 4)
    return ((fixed + B * K_SPEC * D * 2) / 3.35e9,
            (fixed + B * K_SPEC * D * 32) / 3.35e9)


def main() -> int:
    import torch
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__)
        return 1
    from repro_torch.kernels.exit_gate.ref import exit_gate_ref
    from repro_torch.quant.core import quantize_tensor
    out_dir = ab.ROOT / "build" / "ab_gate"
    fns = {}
    for tag, src in (("base", Path(sys.argv[1]).resolve()),
                     ("tree", ab.CSRC)):
        for name in ("exit_gate", "spec_head", "spec_head_q"):
            lib, _, report = ab.build(tag, src, name, out_dir)
            print(f"{tag} {name}: {ab.registers(report)}", flush=True)
            fns[(tag, name)] = ab.c_fn(lib, f"{name}_launch",
                                       *C_ARGS[name])
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    ptr = ab.ptr

    def rnd(shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(
            dtype)

    w1 = rnd((3 * K_SPEC, H_PRED), torch.float32, 12 ** -0.5)
    b1 = rnd((H_PRED,), torch.float32, 0.1)
    w2 = rnd((H_PRED, 1), torch.float32, H_PRED ** -0.5)
    b2 = rnd((1,), torch.float32, 0.1)
    pred = {"layers": [{"w": w1, "b": b1}, {"w": w2, "b": b2}]}
    gate_cases, spec_cases, bounds, checks = {}, {}, {}, []
    for label, B, D, V in GATES:
        hn, w = rnd((B, D)), rnd((D, V), scale=0.05)
        prev = torch.softmax(rnd((B, K_SPEC), torch.float32), -1)
        id_sets = [torch.randint(0, V, (B, K_SPEC), generator=gen,
                                 device=dev, dtype=torch.int32)
                   for _ in range(N_SETS)]
        outs = (torch.empty(B, device=dev),
                torch.empty(B, K_SPEC, device=dev),
                torch.empty(B, K_SPEC, device=dev))

        def calls(tag, hn=hn, w=w, prev=prev, id_sets=id_sets, outs=outs,
                  B=B, D=D, V=V):
            f = fns[(tag, "exit_gate")]
            return [lambda i=i: f(ptr(hn), ptr(w), ptr(i), ptr(prev),
                                  ptr(w1), ptr(b1), ptr(w2), ptr(b2),
                                  *map(ptr, outs), B, D, V, K_SPEC, H_PRED,
                                  1, ab.stream()) for i in id_sets]
        gate_cases[label] = calls
        bounds[label] = gate_bounds(B, D)
        checks.append((label, calls, outs,
                       exit_gate_ref(hn, w, id_sets[0], prev, pred)))

    heads = {}
    w = rnd((4096, 32000), scale=0.05)
    heads[None] = w
    for bits in (8, 4):
        heads[bits] = quantize_tensor(w.float(), bits)
    spec_outs = {}
    for R in (4, 160):
        hn = rnd((R, 4096))
        id_sets = [torch.randint(0, 32000, (R, K_SPEC), generator=gen,
                                 device=dev, dtype=torch.int32)
                   for _ in range(N_SETS)]
        for bits, head in heads.items():
            name = "spec_head" if bits is None else "spec_head_q"
            label = f"{name} R={R}" + ("" if bits is None else f" int{bits}")
            out = torch.empty(R, K_SPEC, device=dev)

            def calls(tag, name=name, hn=hn, head=head, bits=bits, R=R,
                      id_sets=id_sets, out=out):
                f = fns[(tag, name)]
                if bits is None:
                    return [lambda i=i: f(ptr(hn), ptr(head), ptr(i),
                                          ptr(out), R, 4096, 32000, K_SPEC,
                                          1, ab.stream()) for i in id_sets]
                return [lambda i=i: f(ptr(hn), ptr(head.q), ptr(head.scale),
                                      ptr(i), ptr(out), R, 4096, 32000,
                                      K_SPEC, bits, 1, ab.stream())
                        for i in id_sets]
            spec_cases[label], spec_outs[label] = calls, out

    for label, calls, outs, want in checks:
        for tag in ("base", "tree"):
            for o in outs:
                o.fill_(float("nan"))
            if calls(tag)[0]() != 0:
                raise RuntimeError(f"{label}: {tag} launch failed")
            torch.cuda.synchronize()
            err = 0.0
            for a, b in zip(outs, want):
                torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
                err = max(err, (a - b).abs().max().item())
            print(f"{label}: {tag} max abs err {err:.3g} against the plain "
                  f"version", flush=True)
    for label, calls in spec_cases.items():
        got = {}
        for tag in ("base", "tree"):
            if calls(tag)[0]() != 0:
                raise RuntimeError(f"{label}: {tag} launch failed")
            torch.cuda.synchronize()
            got[tag] = spec_outs[label].clone()
        if not torch.equal(got["base"], got["tree"]):
            raise AssertionError(f"{label}: outputs differ between versions")

    times = ab.alternate({**gate_cases, **spec_cases})
    for label in gate_cases:
        byte_b, sector_b = bounds[label]
        print(f"{label}: both held to the plain version; bound "
              f"{byte_b:.5f} ms (bytes), {sector_b:.5f} ms (sectors); " +
              "; ".join(f"{tag} {ab.summary(times[(label, tag)])}"
                        for tag in ("base", "tree")), flush=True)
    for label in spec_cases:
        print(f"{label}: outputs bit-equal; " + "; ".join(
            f"{tag} {ab.summary(times[(label, tag)])}"
            for tag in ("base", "tree")), flush=True)
    print(ab.card())
    return 0


if __name__ == "__main__":
    sys.exit(main())
