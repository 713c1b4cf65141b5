#!/usr/bin/env python3
"""A/B of the tree gate's kernels between another version of the sources
and this tree's, on one card: the quantized spec head (the other
version's one kernel per call, ``spec_head_q.cu`` taking (hn, codes,
scales, ids), against this tree's two stages, ``spec_head_gather_q.cu``
then the ``spec_head_q.cu`` dot over the gathered code columns), the fp
spec head (two stages in both versions, ``spec_head_gather.cu`` and the
``spec_head.cu`` dot: outputs bit-equal between them) and the quantized
predictor (``predictor_mlp_q.cu``, one C interface in both).

Builds both versions' libraries at once with the flags of
``repro_torch.kernels.build`` (printing each build's registers), then
times in one process, in alternating order (base, tree, tree, base, then
reversed; 12 timings each), bf16 hidden rows, Llama-2-7B's head (D =
4096, V = 32000; fp in bf16, int8 codes, plane-packed int4 codes), k = 4,
TreeSpec(3, 3) (N = 40 nodes):
  a tree step at B = 4 and B = 8 (R = B*N = 160 and 320 node rows), one
  call or dot per exit point (3 for the fp head; 2 for int8 and 3 for
  int4, the quantized tree step's exit points that run the gate), each
  exit point on its own hidden rows: quantized, the base's calls at the
  nodes' children's ids against this tree's gather of the R node tokens
  plus the dots; fp, both versions' gather plus dots;
  one exit point alone (quantized base: 1 call; else 1 dot over gathered
  columns);
  one call at R = 160 random ids (quantized base: 1 call; else
  spec_head_logits or spec_head_logits_q, a gather of the R*k ids and a
  dot);
  the quantized predictor at R = 108 and 216 (B*P merged paths at B = 4
  and 8; F = 12, H = 512), int8 and int4, 20 calls per graph.
Every spec-head case draws from 8 distinct id sets and hidden rows (the
gathered columns start cold). Every output of both versions is first held
to the plain version (spec head: atol = rtol = 1e-4, fp32 sums in another
order; predictor: 1e-5).

    git archive <commit> src/repro_torch/csrc | tar -x -C build/base
    python3 scripts/ab_spec_head.py build/base/src/repro_torch/csrc

Prints per case the median and range of each version's device time per
step or call (CUDA graphs), and the card's name and power limit.
"""
from __future__ import annotations

import sys
from pathlib import Path

import ab_common as ab

D, V, K_SPEC, DEPTH, BRANCH, N_SETS = 4096, 32000, 4, 3, 3, 8
F_PRED, H_PRED, N_CALLS = 12, 512, 20
# exit points that run the gate in a tree step, by head
EXITS = {"fp": 3, 8: 2, 4: 3}
# (tag, library, pointer and int arguments before the stream)
LIBS = (("base", "spec_head_gather", (3, 4)),
        ("base", "spec_head", (4, 5)), ("base", "spec_head_q", (5, 6)),
        ("base", "predictor_mlp_q", (8, 5)),
        ("tree", "spec_head_gather", (3, 4)), ("tree", "spec_head", (4, 5)),
        ("tree", "spec_head_gather_q", (5, 3)),
        ("tree", "spec_head_q", (5, 6)), ("tree", "predictor_mlp_q", (8, 5)))


def main() -> int:
    import torch
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__)
        return 1
    from repro_torch.core.tree import TreeSpec
    from repro_torch.kernels.predictor_mlp.ref import predictor_mlp_q_ref
    from repro_torch.kernels.spec_head.ref import spec_logits_ref
    from repro_torch.quant.core import quantize_tensor
    out_dir = ab.ROOT / "build" / "ab_spec_head"
    srcs = {"base": Path(sys.argv[1]).resolve(), "tree": ab.CSRC}
    built = ab.build_many([(tag, srcs[tag], name, out_dir)
                           for tag, name, _ in LIBS])
    fns = {}
    for (tag, name, nargs), (lib, _, report) in zip(LIBS, built):
        print(f"{tag} {name}: {ab.registers(report)}", flush=True)
        fns[(tag, name)] = ab.c_fn(lib, f"{name}_launch", *nargs)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    ptr, bf = ab.ptr, torch.bfloat16
    w = (torch.randn((D, V), generator=gen, device=dev) * 0.05)
    heads = {"fp": w.to(bf), 8: quantize_tensor(w, 8),
             4: quantize_tensor(w, 4)}
    del w
    tree = TreeSpec(DEPTH, BRANCH)
    N = tree.num_nodes
    child = torch.as_tensor(tree.children, device=dev).long().clamp(min=0)
    if BRANCH < K_SPEC:
        child = torch.cat([child, child[:, :1].expand(N, K_SPEC - BRANCH)], 1)
    child = child[:, :K_SPEC]

    def step_sets(B, exits):
        """N_SETS steps: node tokens (B*N,), rows (B*N, k), children's ids
        (B*N, k), ``exits`` hidden-row sets (B*N, D)."""
        R = B * N
        rows = (torch.arange(B, device=dev)[:, None, None] * N
                + child[None]).reshape(R, K_SPEC).to(torch.int32)
        sets = []
        for _ in range(N_SETS):
            toks = torch.randint(0, V, (R,), generator=gen, device=dev,
                                 dtype=torch.int32)
            sets.append((toks, rows, toks[rows.long()].contiguous(),
                         [torch.randn((R, D), generator=gen,
                                      device=dev).to(bf)
                          for _ in range(exits)]))
        return sets

    def base_call(head, hn, ids, out):
        """The other version's one-kernel quantized spec head."""
        R = hn.shape[0]
        qt = heads[head]
        return fns[("base", "spec_head_q")](
            ptr(hn), ptr(qt.q), ptr(qt.scale), ptr(ids), ptr(out), R, D, V,
            K_SPEC, head, 1, ab.stream())

    def new_cols(head, C):
        """The gathered-column buffers of this tree's first stage."""
        if head == "fp":
            return (torch.empty(C, D, dtype=bf, device=dev),)
        return (torch.empty(C, heads[head].q.shape[0], dtype=torch.int8,
                            device=dev),
                torch.empty(C, device=dev))

    def gather(tag, head, ids, cols):
        C = ids.shape[0]
        if head == "fp":
            return fns[(tag, "spec_head_gather")](
                ptr(heads["fp"]), ptr(ids), ptr(cols[0]), C, D, V, 1,
                ab.stream())
        qt = heads[head]
        return fns[("tree", "spec_head_gather_q")](
            ptr(qt.q), ptr(qt.scale), ptr(ids), ptr(cols[0]), ptr(cols[1]),
            C, qt.q.shape[0], V, ab.stream())

    def dot(tag, head, hn, cols, idx, out):
        R, C = hn.shape[0], cols[0].shape[0]
        if head == "fp":
            return fns[(tag, "spec_head")](
                ptr(hn), ptr(cols[0]), ptr(idx), ptr(out), R, C, D, K_SPEC,
                1, ab.stream())
        return fns[("tree", "spec_head_q")](
            ptr(hn), ptr(cols[0]), ptr(cols[1]), ptr(idx), ptr(out), R, C, D,
            K_SPEC, head, 1, ab.stream())

    def name(head):
        return "fp bf16" if head == "fp" else f"int{head}"

    cases, checks = {}, []
    for head in ("fp", 8, 4):
        exits = EXITS[head]
        for B in (4, 8):
            R = B * N
            sets = step_sets(B, exits)
            cols = {tag: [new_cols(head, R) for _ in sets]
                    for tag in ("base", "tree")}
            outs = {tag: [[torch.empty(R, K_SPEC, device=dev)
                           for _ in range(exits)] for _ in sets]
                    for tag in ("base", "tree")}

            def step(tag, q, head=head, sets=sets, cols=cols, outs=outs):
                toks, rows, ids, hns = sets[q]
                o, c = outs[tag][q], cols[tag][q]
                if tag == "base" and head != "fp":
                    return lambda: sum(base_call(head, hn, ids, oo)
                                       for hn, oo in zip(hns, o))
                return lambda: gather(tag, head, toks, c) + sum(
                    dot(tag, head, hn, c, rows, oo)
                    for hn, oo in zip(hns, o))

            def exit_point(tag, q, head=head, sets=sets, cols=cols,
                           outs=outs):
                toks, rows, ids, hns = sets[q]
                if tag == "base" and head != "fp":
                    return lambda: base_call(head, hns[0], ids,
                                             outs[tag][q][0])
                return lambda: dot(tag, head, hns[0], cols[tag][q], rows,
                                   outs[tag][q][0])

            how = (f"gather + {exits} dots both" if head == "fp" else
                   f"base {exits} calls, tree gather + {exits} dots")
            cases[f"{name(head)} tree step B={B} (R={R}): {how}"] = (
                lambda tag, f=step: [f(tag, q) for q in range(N_SETS)])
            how = ("1 dot both" if head == "fp" else
                   "base 1 call, tree 1 dot")
            cases[f"{name(head)} one exit point, R={R}: {how}"] = (
                lambda tag, f=exit_point: [f(tag, q)
                                           for q in range(N_SETS)])
            checks.append((head, step, sets, outs))

        R = 4 * N
        rand = [(torch.randint(0, V, (R, K_SPEC), generator=gen, device=dev,
                               dtype=torch.int32),
                 torch.randn((R, D), generator=gen, device=dev).to(bf))
                for _ in range(N_SETS)]
        rcols = {tag: [new_cols(head, R * K_SPEC) for _ in rand]
                 for tag in ("base", "tree")}
        ridx = torch.arange(R * K_SPEC, dtype=torch.int32,
                            device=dev).view(R, K_SPEC)
        routs = {tag: [torch.empty(R, K_SPEC, device=dev) for _ in rand]
                 for tag in ("base", "tree")}

        def rand_call(tag, q, head=head, rand=rand, rcols=rcols,
                      routs=routs):
            ids, hn = rand[q]
            o, c = routs[tag][q], rcols[tag][q]
            if tag == "base" and head != "fp":
                return lambda: base_call(head, hn, ids, o)
            return lambda: (gather(tag, head, ids.reshape(-1), c)
                            + dot(tag, head, hn, c, ridx, o))

        how = (f"a gather of {R * K_SPEC} ids + dot" if head == "fp" else
               f"base 1 call, tree a gather of {R * K_SPEC} ids + dot")
        cases[f"{name(head)} one call at random ids, R={R}: {how}"] = (
            lambda tag, f=rand_call: [f(tag, q) for q in range(N_SETS)])
        checks.append((head, None, rand, (rand_call, routs)))

    for tag in ("base", "tree"):
        for head, step, sets, outs in checks:
            want_head = heads[head]
            if step is None:
                rand_call, routs = outs
                for q, (ids, hn) in enumerate(sets):
                    if rand_call(tag, q)() != 0:
                        raise RuntimeError(f"{tag}: launch failed")
                    torch.cuda.synchronize()
                    torch.testing.assert_close(
                        routs[tag][q], spec_logits_ref(hn, want_head, ids),
                        atol=1e-4, rtol=1e-4)
                continue
            for q, (_, _, ids, hns) in enumerate(sets):
                if step(tag, q)() != 0:
                    raise RuntimeError(f"{tag}: launch failed")
                torch.cuda.synchronize()
                for hn, o in zip(hns, outs[tag][q]):
                    torch.testing.assert_close(
                        o, spec_logits_ref(hn, want_head, ids), atol=1e-4,
                        rtol=1e-4)
    for head, step, sets, outs in checks:
        if head != "fp":
            continue
        pairs = (zip(outs[1]["base"], outs[1]["tree"]) if step is None else
                 ((a, b) for qa, qb in zip(outs["base"], outs["tree"])
                  for a, b in zip(qa, qb)))
        if not all(torch.equal(a, b) for a, b in pairs):
            raise AssertionError("fp spec head: outputs differ between the "
                                 "versions")
    print("every spec-head output of both versions equals the plain version "
          "(atol = rtol = 1e-4); the fp ones are bit-equal between them",
          flush=True)

    # the quantized predictor at the tree's path counts
    b1 = torch.randn((H_PRED,), generator=gen, device=dev) * 0.1
    b2 = torch.randn((1,), generator=gen, device=dev) * 0.1
    w1 = torch.randn((F_PRED, H_PRED), generator=gen, device=dev) * (
        F_PRED ** -0.5)
    w2 = torch.randn((H_PRED, 1), generator=gen, device=dev) * (
        H_PRED ** -0.5)
    for bits in (8, 4):
        q1, q2 = quantize_tensor(w1, bits), quantize_tensor(w2, bits)
        for R in (108, 216):
            x = torch.randn((R, F_PRED), generator=gen, device=dev)
            out = {tag: torch.empty(R, device=dev) for tag in ("base",
                                                               "tree")}

            def calls(tag, x=x, out=out, q1=q1, q2=q2, R=R):
                f = fns[(tag, "predictor_mlp_q")]
                return [lambda: f(ptr(x), ptr(q1.q), ptr(q1.scale), ptr(b1),
                                  ptr(q2.q), ptr(q2.scale), ptr(b2),
                                  ptr(out[tag]), R, F_PRED, H_PRED, q1.bits,
                                  q2.bits, ab.stream())] * N_CALLS
            want = predictor_mlp_q_ref(x, q1, b1, q2, b2)
            for tag in ("base", "tree"):
                if calls(tag)[0]() != 0:
                    raise RuntimeError(f"{tag}: predictor launch failed")
                torch.cuda.synchronize()
                torch.testing.assert_close(out[tag], want, atol=1e-5,
                                           rtol=1e-5)
            cases[f"predictor_mlp_q int{bits} R={R}"] = calls
    print("every predictor output of both versions equals the plain version "
          "(atol = rtol = 1e-5)", flush=True)
    times = ab.alternate(cases)
    for label in cases:
        print(f"{label}: " + "; ".join(
            f"{tag} {ab.summary(times[(label, tag)])}"
            for tag in ("base", "tree")), flush=True)
    print(ab.card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
