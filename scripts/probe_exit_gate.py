#!/usr/bin/env python3
"""Where the time of the port's cluster-split exit gates
(``csrc/exit_gate.cu`` and ``csrc/exit_gate_q.cu`` on the body of
``csrc/exit_gate.cuh``) goes, on one card, and what clusters of 16 CTAs
would change.

Builds this tree's gates and four variants of the fp gate, each made from
a copy of the sources under ``build/probe_gate/``:
  - clusters of 16: the cap of a row's cluster raised from the portable 8
    to 16 (opted into with ``cudaFuncAttributeNonPortableClusterSizeAllowed``),
    so at D = 4096 each thread gathers one head row; its outputs, as the
    gate's, are held to the plain version (atol = rtol = 1e-4).
Three more have one stage cut out (their outputs are wrong by
construction; only their times are read):
  - no gather: the head columns are not read (each gathered element is
    replaced by the row's own hidden value), so the W loads are gone and
    every other step remains;
  - no MLP: each CTA returns after the features (no predictor share, no
    second cluster barrier);
  - floor: both cut: launch, the id and hidden loads, the block and
    cluster reductions of the logits, the softmax.
Times each fp gate (bf16, k = 4, H = 512, 20 distinct speculative id sets
per CUDA graph, CUDA events, alternating order) at B = 1, 4 and 8 rows of
Llama-2-7B (D = 4096, V = 32000: clusters of 8 CTAs, or 16) and B = 4 of
mamba2-130m (D = 768, V = 50280: clusters of 3), beside the number of
32-byte sectors the gather reads; then the quantized gate (int8 and int4
head and bank, the same shapes but B = 1, outputs held to its plain
version first); then prints the card's name and power limit.

    python3 scripts/probe_exit_gate.py
"""
from __future__ import annotations

import shutil
import statistics
import sys

import ab_common as ab

K_SPEC, H_PRED, N_SETS = 4, 512, 20
SHAPES = ((1, 4096, 32000), (4, 4096, 32000), (8, 4096, 32000),
          (4, 768, 50280))
# (file, text of this tree, text of the variant)
NO_GATHER = ("spec_slice.cuh", "if (j < k) w.load(row + col[j], c[j]);",
             "if (j < k) c[j][0] = x[0];")
NO_MLP = ("exit_gate.cuh", "  __syncthreads();\n\n  float share = 0.f;",
          "  __syncthreads();\n  if (c == 0 && tid == 0) p_out[b] = bias;\n"
          "  return;\n\n  float share = 0.f;")
WIDE = (("exit_gate.cuh", "constexpr int EG_MAX_C = 8; ",
         "constexpr int EG_MAX_C = 16;"),
        ("exit_gate.cuh", "  cudaLaunchConfig_t cfg = {};",
         "  static bool wide = false;\n"
         "  if (!wide) {\n"
         "    const cudaError_t e = cudaFuncSetAttribute(\n"
         "        kernel,\n"
         "        cudaFuncAttributeNonPortableClusterSizeAllowed, 1);\n"
         "    if (e != cudaSuccess) return e;\n"
         "    wide = true;\n"
         "  }\n"
         "  cudaLaunchConfig_t cfg = {};"))


def variant(tag: str, cuts):
    """A copy of this tree's gate sources with each cut applied."""
    out = ab.ROOT / "build" / "probe_gate" / tag
    out.mkdir(parents=True, exist_ok=True)
    for name in ("exit_gate.cu", "exit_gate_q.cu", "exit_gate.cuh",
                 "spec_slice.cuh"):
        shutil.copy(ab.CSRC / name, out / name)
    for name, old, new in cuts:
        text = (out / name).read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"{tag}: the text to cut is not in {name}")
        (out / name).write_text(text.replace(old, new))
    return out


def main() -> int:
    import torch
    if len(sys.argv) != 1 or not torch.cuda.is_available():
        print(__doc__)
        return 1
    from repro_torch.kernels.exit_gate.ref import (exit_gate_q_ref,
                                                   exit_gate_ref)
    from repro_torch.quant.core import quantize_tensor
    sources = {"gate": ab.CSRC,
               "clusters of 16": variant("c16", WIDE),
               "no gather": variant("no_gather", [NO_GATHER]),
               "no MLP": variant("no_mlp", [NO_MLP]),
               "floor": variant("floor", [NO_GATHER, NO_MLP])}
    fns = {}
    for tag, src in sources.items():
        lib, _, report = ab.build(tag.replace(" ", "_"), src, "exit_gate",
                                  ab.ROOT / "build" / "probe_gate")
        print(f"{tag}: {ab.registers(report)}", flush=True)
        fns[tag] = ab.c_fn(lib, "exit_gate_launch", 11, 6)
    lib, _, report = ab.build("gate", ab.CSRC, "exit_gate_q",
                              ab.ROOT / "build" / "probe_gate")
    print(f"gate (exit_gate_q): {ab.registers(report)}", flush=True)
    qfn = ab.c_fn(lib, "exit_gate_q_launch", 14, 9)
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
    for B, D, V in SHAPES:
        hn, w = rnd((B, D)), rnd((D, V), scale=0.05)
        prev = torch.softmax(rnd((B, K_SPEC), torch.float32), -1)
        id_sets = [torch.randint(0, V, (B, K_SPEC), generator=gen,
                                 device=dev, dtype=torch.int32)
                   for _ in range(N_SETS)]
        outs = (torch.empty(B, device=dev),
                torch.empty(B, K_SPEC, device=dev),
                torch.empty(B, K_SPEC, device=dev))

        def calls(tag):
            f = fns[tag]
            return [lambda i=i: f(ptr(hn), ptr(w), ptr(i), ptr(prev),
                                  ptr(w1), ptr(b1), ptr(w2), ptr(b2),
                                  *map(ptr, outs), B, D, V, K_SPEC, H_PRED,
                                  1, ab.stream()) for i in id_sets]
        want = exit_gate_ref(hn, w, id_sets[0], prev, pred)
        for tag in ("gate", "clusters of 16"):
            if calls(tag)[0]() != 0:
                raise RuntimeError(f"B={B} D={D}: {tag} launch failed")
            torch.cuda.synchronize()
            for a, b in zip(outs, want):
                torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
        times = {tag: [] for tag in sources}
        for r in range(6):
            for tag in (list(sources) if r % 2 == 0
                        else list(sources)[::-1]):
                times[tag].append(ab.graph_ms(calls(tag)))
        print(f"B={B} D={D} ({B * K_SPEC * D} sectors gathered): " +
              "; ".join(f"{tag} {statistics.median(ts):.4f} ms "
                        f"({min(ts):.4f}-{max(ts):.4f})"
                        for tag, ts in times.items()), flush=True)
        if B == 1:
            continue
        for bits in (8, 4):
            head = quantize_tensor(w.float(), bits)
            q1, q2 = quantize_tensor(w1, bits), quantize_tensor(w2, bits)

            def qcalls(head=head, q1=q1, q2=q2, bits=bits):
                return [lambda i=i: qfn(
                    ptr(hn), ptr(head.q), ptr(head.scale), ptr(i), ptr(prev),
                    ptr(q1.q), ptr(q1.scale), ptr(b1), ptr(q2.q),
                    ptr(q2.scale), ptr(b2), *map(ptr, outs), B, D, V, K_SPEC,
                    H_PRED, bits, q1.bits, q2.bits, 1, ab.stream())
                    for i in id_sets]
            want = exit_gate_q_ref(hn, head, id_sets[0], prev,
                                   {"w": q1, "b": b1}, {"w": q2, "b": b2})
            if qcalls()[0]() != 0:
                raise RuntimeError(f"B={B} D={D} int{bits}: launch failed")
            torch.cuda.synchronize()
            for a, b in zip(outs, want):
                torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
            ts = [ab.graph_ms(qcalls()) for _ in range(6)]
            print(f"exit_gate_q int{bits} B={B} D={D}: "
                  f"{statistics.median(ts):.4f} ms ({min(ts):.4f}-"
                  f"{max(ts):.4f})", flush=True)
    print(ab.card())
    return 0


if __name__ == "__main__":
    sys.exit(main())
