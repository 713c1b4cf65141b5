#!/usr/bin/env python3
"""Where the time of the fp spec head's two stages goes, on one card: the
column gather (``csrc/spec_head_gather.cu`` on the tile of
``csrc/spec_gather.cuh``) and the dot over the gathered columns
(``csrc/spec_head.cu``).

The gather, timed (bf16, Llama-2-7B's head: D = 4096, V = 32000; 8
distinct id sets per CUDA graph, the head's 262 MB start cold; 6 rounds in
turn) at C = 160 and 320 columns (a tree step's B*N node tokens at B = 4
and 8) and C = 640 (spec_head_logits' R*k ids at R = 160), each also on
the same ids sorted ascending; beside its floor, a copy built under
``build/probe_gather/`` whose loads all hit one contiguous 16 KB of the
head (L2 hits; its output is wrong by construction, only its time is
read), and the bound in 32-byte sectors (C*D sectors at 3.35 TB/s). The
gather's output must equal the plain version (bit-equal).

The dot, timed at R = 160 and 320 node rows of a TreeSpec(3, 3) step
(k = 4), cold (distinct hidden rows and column buffers, more than the
50 MB L2 in all) and warm (4 sets, in L2), beside its byte bound.

Then prints the card's name and power limit.

    python3 scripts/probe_spec_head.py
"""
from __future__ import annotations

import shutil
import statistics
import sys

import ab_common as ab

D, V, N_SETS, ROUNDS = 4096, 32000, 8, 6
LOAD = "x[i] = __ldg(w + (size_t)d * V + col);"


def floor_dir():
    """A copy of the gather whose loads all hit one contiguous 16 KB (its
    tile, ``spec_gather.cuh``, patched beside ``spec_head_gather.cu``)."""
    out = ab.ROOT / "build" / "probe_gather" / "floor"
    if out.exists():
        shutil.rmtree(out)
    out.mkdir(parents=True)
    shutil.copy(ab.CSRC / "spec_head_gather.cu", out / "spec_head_gather.cu")
    src = (ab.CSRC / "spec_gather.cuh").read_text()
    if src.count(LOAD) != 1:
        raise RuntimeError(f"floor: text not found: {LOAD!r}")
    (out / "spec_gather.cuh").write_text(src.replace(
        LOAD, "x[i] = __ldg(w + (d % 64) * 128 + (col % 64));"))
    return out


def time_cases(cases) -> dict:
    """{key: [ms per round]}, the cases timed in turn, in alternating
    order."""
    times = {key: [] for key in cases}
    for r in range(ROUNDS):
        for key in (list(cases) if r % 2 == 0 else list(cases)[::-1]):
            times[key].append(ab.graph_ms(cases[key]()))
    return times


def median(ts) -> str:
    return (f"median {statistics.median(ts):.4f} ms (range {min(ts):.4f}-"
            f"{max(ts):.4f})")


def probe_dot(torch, dev, gen, w) -> None:
    from repro_torch.core.tree import TreeSpec
    from repro_torch.kernels.spec_head.ref import spec_dot_ref, spec_gather_ref
    lib, _, report = ab.build("tree", ab.CSRC, "spec_head",
                              ab.ROOT / "build" / "probe_dot")
    print(f"dot: {ab.registers(report)}", flush=True)
    f = ab.c_fn(lib, "spec_head_launch", 4, 5)
    bf = torch.bfloat16
    tree = TreeSpec(3, 3)
    N = tree.num_nodes
    child = torch.as_tensor(tree.children, device=dev).long().clamp(min=0)
    child = torch.cat([child, child[:, :1]], 1)[:, :4]
    cases = {}
    for R in (160, 320):
        rows = (torch.arange(R // N, device=dev)[:, None, None] * N
                + child[None]).reshape(R, 4).to(torch.int32)
        for temp, n_sets in (("cold", int(64e6 // (2 * R * D * 2)) + 1),
                             ("warm", 4)):
            sets = [(torch.randn((R, D), generator=gen, device=dev).to(bf),
                     spec_gather_ref(w, torch.randint(
                         0, V, (R,), generator=gen, device=dev,
                         dtype=torch.int32)),
                     torch.empty(R, 4, device=dev)) for _ in range(n_sets)]

            def calls(sets=sets, R=R, rows=rows):
                return [lambda a=a, c=c, o=o: f(
                    ab.ptr(a), ab.ptr(c), ab.ptr(rows), ab.ptr(o), R, R, D,
                    4, 1, ab.stream()) for a, c, o in sets]
            if calls()[0]() != 0:
                raise RuntimeError("dot: launch failed")
            torch.cuda.synchronize()
            a, c, o = sets[0]
            torch.testing.assert_close(o, spec_dot_ref(a, c, rows),
                                       atol=1e-4, rtol=1e-4)
            cases[(R, temp)] = calls
    print("the dot matches its plain version", flush=True)
    for (R, temp), ts in time_cases(cases).items():
        print(f"dot R={R}, {temp}: {median(ts)}; bound "
              f"{2 * R * D * 2 / 3.35e9:.4f} ms (bytes)", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print(__doc__)
        return 1
    from repro_torch.kernels.spec_head.ref import spec_gather_ref
    fns = {}
    for label, src in (("this tree", ab.CSRC), ("floor", floor_dir())):
        lib, _, report = ab.build(label.replace(" ", "_"), src,
                                  "spec_head_gather",
                                  ab.ROOT / "build" / "probe_gather")
        print(f"gather, {label}: {ab.registers(report)}", flush=True)
        fns[label] = ab.c_fn(lib, "spec_head_gather_launch", 3, 4)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    w = (torch.randn((D, V), generator=gen, device=dev) * 0.05).to(bf)
    cases = {}
    for C in (160, 320, 640):
        ids = [torch.randint(0, V, (C,), generator=gen, device=dev,
                             dtype=torch.int32) for _ in range(N_SETS)]
        for order, sets in (("random order", ids),
                            ("sorted", [i.sort().values.contiguous()
                                        for i in ids])):
            cols = [torch.empty(C, D, dtype=bf, device=dev) for _ in sets]
            for label, f in fns.items():
                def calls(f=f, sets=sets, cols=cols, C=C):
                    return [lambda i=i, c=c: f(ab.ptr(w), ab.ptr(i),
                                               ab.ptr(c), C, D, V, 1,
                                               ab.stream())
                            for i, c in zip(sets, cols)]
                if label == "this tree":
                    if calls()[0]() != 0:
                        raise RuntimeError("gather: launch failed")
                    torch.cuda.synchronize()
                    if not torch.equal(cols[0], spec_gather_ref(w, sets[0])):
                        raise AssertionError("gather: output differs")
                cases[(C, order, label)] = calls
    print("the gather equals the plain version (bit-equal)", flush=True)
    for (C, order, label), ts in time_cases(cases).items():
        print(f"gather C={C}, {order}, {label}: {median(ts)}; bound in "
              f"32-byte sectors {C * D * 32 / 3.35e9:.4f} ms", flush=True)
    probe_dot(torch, dev, gen, w)
    print(ab.card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
