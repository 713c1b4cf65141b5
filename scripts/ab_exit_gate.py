#!/usr/bin/env python3
"""A/B of the port's fused exit gates between another version of
``src/repro_torch/csrc`` and this tree's, on one card: the fp gate
(``csrc/exit_gate.cu``) and the quantized gate (``csrc/exit_gate_q.cu``),
both on the cluster body ``csrc/exit_gate.cuh`` (with the predictor's
weight forms of ``csrc/predictor.cuh``), each against the other version's.

Each version is built side by side with ``nvcc`` (the flags of
``repro_torch.kernels.build``) and timed in one process, in alternating
order (base, tree, tree, base, then reversed), bf16 hidden rows, k = 4,
H = 512, 20 distinct speculative id sets per CUDA graph (the gathered
columns start cold): the fp gate at B = 4 and B = 8 rows of Llama-2-7B
(D = 4096, V = 32000) and B = 4 of mamba2-130m (D = 768, V = 50280); the
quantized gate with an int8 head and bank, and with int4 ones, at B = 4
and B = 8 of both widths. Every gate output of each version is held
against the plain version (``exit_gate_ref`` / ``exit_gate_q_ref``) at
atol = rtol = 1e-4, and every output must be bit-equal between the
versions.

    git archive <commit> src/repro_torch/csrc | tar -x -C build/base
    python3 scripts/ab_exit_gate.py build/base/src/repro_torch/csrc

Prints the ptxas report of each build, then per case the median and range
of each version's device time per call (CUDA events) beside the gate's
byte bound (useful bytes) and sector bound (a 32-byte sector per gathered
stored element) at 3.35 TB/s, and the card's name and power limit.
"""
from __future__ import annotations

import sys
from pathlib import Path

import ab_common as ab

K_SPEC, H_PRED, N_SETS = 4, 512, 20
F_PRED = 3 * K_SPEC
# pointer and int arguments before the stream of each launch function
C_ARGS = {"exit_gate": (11, 6), "exit_gate_q": (14, 9)}
LIBS = ("exit_gate", "exit_gate_q")
GATES = (("gate B=4 D=4096", 4, 4096, 32000),
         ("gate B=8 D=4096", 8, 4096, 32000),
         ("gate B=4 D=768", 4, 768, 50280))
QGATES = tuple((f"gate_q int{bits} B={B} D={D}", bits, B, D, V)
               for bits in (8, 4) for D, V in ((4096, 32000), (768, 50280))
               for B in (4, 8))


def gate_bounds(B: int, D: int, stored_b: float = 2.0, bank_b: float = (
        F_PRED * H_PRED + 2 * H_PRED + 1) * 4, rows: int = None,
        col_b: float = 0.0):
    """(useful-byte bound, sector bound) in ms of one gate call with bf16
    hidden rows: ``stored_b`` bytes per gathered head element (2 for bf16,
    1 for int8, 0.5 for int4 per hidden entry), ``rows`` stored head rows
    (D, or D/2 for int4) each costing a 32-byte sector per column,
    ``col_b`` bytes of scale per column, ``bank_b`` bytes of predictor."""
    rows = D if rows is None else rows
    fixed = (B * D * 2 + B * K_SPEC * 8 + bank_b + 4
             + B * (1 + 2 * K_SPEC) * 4)
    return ((fixed + B * K_SPEC * (D * stored_b + col_b)) / 3.35e9,
            (fixed + B * K_SPEC * rows * 32) / 3.35e9)


def main() -> int:
    import torch
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__)
        return 1
    from repro_torch.kernels.exit_gate.ref import (exit_gate_q_ref,
                                                   exit_gate_ref)
    from repro_torch.quant.core import quantize_tensor
    out_dir = ab.ROOT / "build" / "ab_gate"
    jobs = [(tag, src, name, out_dir) for tag, src in (
        ("base", Path(sys.argv[1]).resolve()), ("tree", ab.CSRC))
        for name in LIBS]
    fns = {}
    for (tag, _, name, _), (lib, _, report) in zip(jobs,
                                                   ab.build_many(jobs)):
        print(f"{tag} {name}: {ab.registers(report)}", flush=True)
        fns[(tag, name)] = ab.c_fn(lib, f"{name}_launch", *C_ARGS[name])
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    ptr = ab.ptr

    def rnd(shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(
            dtype)

    def ids_for(B, V):
        return [torch.randint(0, V, (B, K_SPEC), generator=gen, device=dev,
                              dtype=torch.int32) for _ in range(N_SETS)]

    w1 = rnd((F_PRED, H_PRED), torch.float32, F_PRED ** -0.5)
    b1 = rnd((H_PRED,), torch.float32, 0.1)
    w2 = rnd((H_PRED, 1), torch.float32, H_PRED ** -0.5)
    b2 = rnd((1,), torch.float32, 0.1)
    pred = {"layers": [{"w": w1, "b": b1}, {"w": w2, "b": b2}]}
    qbank = {bits: (quantize_tensor(w1, bits), quantize_tensor(w2, bits))
             for bits in (8, 4)}
    gate_cases, bounds, checks = {}, {}, []
    for label, B, D, V in GATES:
        hn, w = rnd((B, D)), rnd((D, V), scale=0.05)
        prev = torch.softmax(rnd((B, K_SPEC), torch.float32), -1)
        id_sets = ids_for(B, V)
        outs = {tag: (torch.empty(B, device=dev),
                      torch.empty(B, K_SPEC, device=dev),
                      torch.empty(B, K_SPEC, device=dev))
                for tag in ("base", "tree")}

        def calls(tag, hn=hn, w=w, prev=prev, id_sets=id_sets, outs=outs,
                  B=B, D=D, V=V):
            f = fns[(tag, "exit_gate")]
            return [lambda i=i: f(ptr(hn), ptr(w), ptr(i), ptr(prev),
                                  ptr(w1), ptr(b1), ptr(w2), ptr(b2),
                                  *map(ptr, outs[tag]), B, D, V, K_SPEC,
                                  H_PRED, 1, ab.stream()) for i in id_sets]
        gate_cases[label] = calls
        bounds[label] = gate_bounds(B, D)
        checks.append((label, calls, outs,
                       exit_gate_ref(hn, w, id_sets[0], prev, pred)))

    for label, bits, B, D, V in QGATES:
        hn = rnd((B, D))
        head = quantize_tensor(rnd((D, V), torch.float32, 0.05), bits)
        q1, q2 = qbank[bits]
        prev = torch.softmax(rnd((B, K_SPEC), torch.float32), -1)
        id_sets = ids_for(B, V)
        outs = {tag: (torch.empty(B, device=dev),
                      torch.empty(B, K_SPEC, device=dev),
                      torch.empty(B, K_SPEC, device=dev))
                for tag in ("base", "tree")}

        def calls(tag, hn=hn, head=head, q1=q1, q2=q2, prev=prev,
                  id_sets=id_sets, outs=outs, B=B, D=D, V=V, bits=bits):
            f = fns[(tag, "exit_gate_q")]
            return [lambda i=i: f(
                ptr(hn), ptr(head.q), ptr(head.scale), ptr(i), ptr(prev),
                ptr(q1.q), ptr(q1.scale), ptr(b1), ptr(q2.q), ptr(q2.scale),
                ptr(b2), *map(ptr, outs[tag]), B, D, V, K_SPEC, H_PRED, bits,
                q1.bits, q2.bits, 1, ab.stream()) for i in id_sets]
        rows = D // 2 if bits == 4 else D
        gate_cases[label] = calls
        bounds[label] = gate_bounds(
            B, D, stored_b=0.5 if bits == 4 else 1.0,
            bank_b=q1.nbytes() + q2.nbytes() + (H_PRED + 1) * 4, rows=rows,
            col_b=4)
        l1, l2 = {"w": q1, "b": b1}, {"w": q2, "b": b2}
        checks.append((label, calls, outs,
                       exit_gate_q_ref(hn, head, id_sets[0], prev, l1, l2)))

    for label, calls, outs, want in checks:
        for tag in ("base", "tree"):
            for o in outs[tag]:
                o.fill_(float("nan"))
            if calls(tag)[0]() != 0:
                raise RuntimeError(f"{label}: {tag} launch failed")
            torch.cuda.synchronize()
            err = 0.0
            for a, b in zip(outs[tag], want):
                torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
                err = max(err, (a - b).abs().max().item())
            print(f"{label}: {tag} max abs err {err:.3g} against the plain "
                  f"version", flush=True)
    for label, _, outs, _ in checks:
        if not all(torch.equal(a, b) for a, b in zip(outs["base"],
                                                     outs["tree"])):
            raise AssertionError(f"{label}: outputs differ between versions")

    times = ab.alternate(gate_cases)
    for label in gate_cases:
        byte_b, sector_b = bounds[label]
        print(f"{label}: bit-equal between the versions, held to the plain "
              f"version; bound {byte_b:.5f} ms (bytes), {sector_b:.5f} ms "
              f"(sectors); " +
              "; ".join(f"{tag} {ab.summary(times[(label, tag)])}"
                        for tag in ("base", "tree")), flush=True)
    print(ab.card())
    return 0


if __name__ == "__main__":
    sys.exit(main())
