#!/usr/bin/env python3
"""A/B of the fp speculative LM head between another version of the
sources (one kernel per call, ``spec_head.cu`` taking (hn, W, ids)) and
this tree's two stages (``spec_head_gather.cu``, then the ``spec_head.cu``
dot over the gathered columns), on one card.

Builds the other version's ``spec_head.cu`` and this tree's
``spec_head_gather.cu`` and ``spec_head.cu`` with the flags of
``repro_torch.kernels.build`` (printing each build's registers), then
times in one process, in alternating order (base, tree, tree, base, then
reversed; 12 timings each), bf16, Llama-2-7B's head (D = 4096, V = 32000),
k = 4, TreeSpec(3, 3) (N = 40 nodes):
  a tree step at B = 4 and B = 8 (R = B*N = 160 and 320 node rows): the
  base's 3 calls at the nodes' children's ids (one per exit point, 3 exit
  points per step) against this tree's gather of the R node tokens plus 3
  dots over them, each exit point on its own hidden rows;
  one exit point alone (base: 1 call; tree: 1 dot over gathered columns);
  one call at R = 160 random ids (base: 1 call; tree: spec_head_logits,
  a gather of the R*k ids and a dot).
Every case draws from 8 distinct id sets and hidden rows (the gathered
columns start cold). Every output of both versions is first held to the
plain version (atol = rtol = 1e-4: fp32 sums in another order).

    git archive <commit> src/repro_torch/csrc | tar -x -C build/base
    python3 scripts/ab_spec_head.py build/base/src/repro_torch/csrc

Prints per case the median and range of each version's device time per
step or call (CUDA graphs), and the card's name and power limit.
"""
from __future__ import annotations

import sys
from pathlib import Path

import ab_common as ab

D, V, K_SPEC, DEPTH, BRANCH, N_SETS, EXITS = 4096, 32000, 4, 3, 3, 8, 3


def main() -> int:
    import torch
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__)
        return 1
    from repro_torch.core.tree import TreeSpec
    from repro_torch.kernels.spec_head.ref import spec_logits_ref
    out_dir = ab.ROOT / "build" / "ab_spec_head"
    fns = {}
    for tag, src, name, nargs in (
            ("base", Path(sys.argv[1]).resolve(), "spec_head", (4, 5)),
            ("tree", ab.CSRC, "spec_head_gather", (3, 4)),
            ("tree", ab.CSRC, "spec_head", (4, 5))):
        lib, _, report = ab.build(tag, src, name, out_dir)
        print(f"{tag} {name}: {ab.registers(report)}", flush=True)
        fns[(tag, name)] = ab.c_fn(lib, f"{name}_launch", *nargs)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    ptr, bf = ab.ptr, torch.bfloat16
    w = (torch.randn((D, V), generator=gen, device=dev) * 0.05).to(bf)
    tree = TreeSpec(DEPTH, BRANCH)
    N = tree.num_nodes
    child = torch.as_tensor(tree.children, device=dev).long().clamp(min=0)
    if BRANCH < K_SPEC:
        child = torch.cat([child, child[:, :1].expand(N, K_SPEC - BRANCH)], 1)
    child = child[:, :K_SPEC]

    def step_sets(B):
        """N_SETS steps: node tokens (B*N,), rows (B*N, k), children's ids
        (B*N, k), EXITS hidden-row sets (B*N, D)."""
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
                          for _ in range(EXITS)]))
        return sets

    base_f = fns[("base", "spec_head")]
    gather_f = fns[("tree", "spec_head_gather")]
    dot_f = fns[("tree", "spec_head")]

    def base_call(hn, ids, out):
        R = hn.shape[0]
        return base_f(ptr(hn), ptr(w), ptr(ids), ptr(out), R, D, V, K_SPEC,
                      1, ab.stream())

    def gather(ids, cols):
        return gather_f(ptr(w), ptr(ids), ptr(cols), ids.shape[0], D, V, 1,
                        ab.stream())

    def dot(hn, cols, idx, out):
        return dot_f(ptr(hn), ptr(cols), ptr(idx), ptr(out), hn.shape[0],
                     cols.shape[0], D, K_SPEC, 1, ab.stream())

    cases, checks = {}, []
    for B in (4, 8):
        R = B * N
        sets = step_sets(B)
        cols = [torch.empty(R, D, dtype=bf, device=dev) for _ in sets]
        outs = {tag: [[torch.empty(R, K_SPEC, device=dev)
                       for _ in range(EXITS)] for _ in sets]
                for tag in ("base", "tree")}

        def step(tag, q, sets=sets, cols=cols, outs=outs):
            toks, rows, ids, hns = sets[q]
            o = outs[tag][q]
            if tag == "base":
                return lambda: (base_call(hns[0], ids, o[0])
                                | base_call(hns[1], ids, o[1])
                                | base_call(hns[2], ids, o[2]))
            return lambda: (gather(toks, cols[q])
                            | dot(hns[0], cols[q], rows, o[0])
                            | dot(hns[1], cols[q], rows, o[1])
                            | dot(hns[2], cols[q], rows, o[2]))

        def exit_point(tag, q, sets=sets, cols=cols, outs=outs):
            toks, rows, ids, hns = sets[q]
            if tag == "base":
                return lambda: base_call(hns[0], ids, outs[tag][q][0])
            return lambda: dot(hns[0], cols[q], rows, outs[tag][q][0])

        cases[f"tree step B={B} (R={R}): base 3 calls, tree gather + 3 "
              f"dots"] = lambda tag, f=step: [f(tag, q)
                                              for q in range(N_SETS)]
        cases[f"one exit point, R={R}: base 1 call, tree 1 dot"] = (
            lambda tag, f=exit_point: [f(tag, q) for q in range(N_SETS)])
        checks.append((step, sets, outs))

    R = 4 * N
    rand = [(torch.randint(0, V, (R, K_SPEC), generator=gen, device=dev,
                           dtype=torch.int32),
             torch.randn((R, D), generator=gen, device=dev).to(bf))
            for _ in range(N_SETS)]
    rcols = [torch.empty(R * K_SPEC, D, dtype=bf, device=dev) for _ in rand]
    ridx = torch.arange(R * K_SPEC, dtype=torch.int32,
                        device=dev).view(R, K_SPEC)
    routs = {tag: [torch.empty(R, K_SPEC, device=dev) for _ in rand]
             for tag in ("base", "tree")}

    def rand_call(tag, q):
        ids, hn = rand[q]
        o = routs[tag][q]
        if tag == "base":
            return lambda: base_call(hn, ids, o)
        return lambda: (gather(ids.reshape(-1), rcols[q])
                        | dot(hn, rcols[q], ridx, o))

    cases[f"one call at random ids, R={R}: base 1 call, tree "
          f"spec_head_logits (gather of {R * K_SPEC} ids + dot)"] = (
        lambda tag: [rand_call(tag, q) for q in range(N_SETS)])

    for tag in ("base", "tree"):
        for step, sets, outs in checks:
            for q, (_, _, ids, hns) in enumerate(sets):
                if step(tag, q)() != 0:
                    raise RuntimeError(f"{tag}: launch failed")
                torch.cuda.synchronize()
                for hn, o in zip(hns, outs[tag][q]):
                    torch.testing.assert_close(
                        o, spec_logits_ref(hn, w, ids), atol=1e-4,
                        rtol=1e-4)
        for q, (ids, hn) in enumerate(rand):
            if rand_call(tag, q)() != 0:
                raise RuntimeError(f"{tag}: launch failed")
            torch.cuda.synchronize()
            torch.testing.assert_close(routs[tag][q],
                                       spec_logits_ref(hn, w, ids),
                                       atol=1e-4, rtol=1e-4)
    print("every output of both versions equals the plain version (atol = "
          "rtol = 1e-4)", flush=True)
    times = ab.alternate(cases)
    for label in cases:
        print(f"{label}: " + "; ".join(
            f"{tag} {ab.summary(times[(label, tag)])}"
            for tag in ("base", "tree")), flush=True)
    print(ab.card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
