#!/usr/bin/env python3
"""A/B of the port's fp predictor MLP (``csrc/predictor_mlp.cu``, the fp
tree gate's predictor) between another version of the source and this
tree's, on one card, and this tree's kernel at other rows per CTA.

Both versions are built side by side with ``nvcc`` (the flags of
``repro_torch.kernels.build``), with four copies of this tree's kernel
made under ``build/ab_pred/`` whose PM_RB, its rows per CTA, is each
other one of 1, 2, 4, 8 and 16; all are timed in one process. The A/B
runs in alternating order (base, tree, tree, base, then reversed) at
R = 1, 108 and 216 (one row; the B*P merged paths at B = 4 and 8) with
F = 12 (the gate's 3k at k = 4) and at R = 108 with F = 15 and 24 (the
instance unrolled to 32), H = 512; then every build of this tree at
R = 108 and 216 with F = 12 and at R = 108 with F = 24, 6 rounds in
turn. Every build's output is first held against the plain version
(``predictor_mlp_ref``) at atol = rtol = 1e-5.

    git archive <commit> src/repro_torch/csrc | tar -x -C build/base
    python3 scripts/ab_predictor_mlp.py build/base/src/repro_torch/csrc

The other directory may hold its own headers; this tree's are found after
them. Prints the ptxas report of each build, then per case the median and
range of each version's device time per call (CUDA graph of 20 calls,
CUDA events) beside the bound (inputs, weights and outputs at 3.35 TB/s;
~2*R*(F+1)*H fp32 operations at 67 TFLOP/s), and the card's name and
power limit.
"""
from __future__ import annotations

import re
import shutil
import statistics
import sys
from pathlib import Path

import ab_common as ab

H, N_CALLS, ROUNDS = 512, 20, 6
AB_CASES = ((1, 12), (108, 12), (216, 12), (108, 15), (108, 24))
RB_CASES = ((108, 12), (216, 12), (108, 24))
RB = re.compile(r"constexpr int PM_RB = (\d+);")


def tree_rb() -> int:
    """This tree's PM_RB."""
    found = RB.findall((ab.CSRC / "predictor_mlp.cu").read_text())
    if len(found) != 1:
        raise RuntimeError("PM_RB is not in this tree's predictor_mlp.cu")
    return int(found[0])


def rb_variant(rb: int) -> Path:
    """A copy of this tree's predictor_mlp.cu and headers with PM_RB set
    to ``rb``."""
    out = ab.ROOT / "build" / "ab_pred" / f"rb{rb}"
    if out.exists():
        shutil.rmtree(out)
    out.mkdir(parents=True)
    for p in list(ab.CSRC.glob("*.cuh")) + [ab.CSRC / "predictor_mlp.cu"]:
        shutil.copy(p, out / p.name)
    ker = out / "predictor_mlp.cu"
    ker.write_text(RB.sub(f"constexpr int PM_RB = {rb};", ker.read_text()))
    return out


def main() -> int:
    import torch
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__)
        return 1
    from repro_torch.kernels.predictor_mlp.ref import predictor_mlp_ref
    rb0 = tree_rb()
    srcs = {"base": Path(sys.argv[1]).resolve(), "tree": ab.CSRC}
    srcs.update({f"tree, {rb} rows a CTA": rb_variant(rb)
                 for rb in (1, 2, 4, 8, 16) if rb != rb0})
    libs = ab.build_many([(f"v{i}", src, "predictor_mlp",
                           ab.ROOT / "build" / "ab_pred")
                          for i, src in enumerate(srcs.values())])
    fns = {}
    for tag, (lib, _, report) in zip(srcs, libs):
        print(f"{tag}: {ab.registers(report)}", flush=True)
        fns[tag] = ab.c_fn(lib, "predictor_mlp_launch", 6, 3)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    weights = {}
    for F in sorted({F for _, F in AB_CASES}):
        weights[F] = (rnd((F, H), F ** -0.5), rnd((H,), 0.1),
                      rnd((H, 1), H ** -0.5), rnd((1,), 0.1))
    made, bounds = {}, {}

    def case(R, F):
        """{tag: closures} of one (R, F), every build held to the plain
        version first."""
        if (R, F) in made:
            return made[(R, F)]
        w1, b1, w2, b2 = weights[F]
        x = rnd((R, F))
        out = torch.empty(R, device=dev)
        want = predictor_mlp_ref(x, w1, b1, w2, b2)
        bounds[(R, F)] = max((R * F + F * H + 2 * H + 1 + R) * 4 / 3.35e9,
                             R * (2 * F * H + 2 * H) / 67e9)
        calls = {}
        for tag, f in fns.items():
            calls[tag] = [lambda f=f: f(
                ab.ptr(x), ab.ptr(w1), ab.ptr(b1), ab.ptr(w2), ab.ptr(b2),
                ab.ptr(out), R, F, H, ab.stream())] * N_CALLS
            out.fill_(float("nan"))
            if calls[tag][0]() != 0:
                raise RuntimeError(f"{tag}: launch failed (R={R}, F={F})")
            torch.cuda.synchronize()
            torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-5)
        made[(R, F)] = calls
        return calls

    ab_cases = {f"R={R}, F={F}": (lambda tag, c=case(R, F): c[tag])
                for R, F in AB_CASES}
    print("every build matches the plain version (atol = rtol = 1e-5)",
          flush=True)
    times = ab.alternate(ab_cases)
    for (R, F), label in zip(AB_CASES, ab_cases):
        print(f"{label}: " + "; ".join(
            f"{tag} {ab.summary(times[(label, tag)])}"
            for tag in ("base", "tree"))
            + f"; bound {bounds[(R, F)]:.5f} ms", flush=True)
    sweep = {(R, F, tag): case(R, F)[tag] for R, F in RB_CASES
             for tag in fns if tag != "base"}
    st = {key: [] for key in sweep}
    for r in range(ROUNDS):
        for key in (list(sweep) if r % 2 == 0 else list(sweep)[::-1]):
            st[key].append(ab.graph_ms(sweep[key]))
    for (R, F, tag), ts in st.items():
        label = tag if "rows" in tag else f"tree, {rb0} rows a CTA"
        print(f"R={R}, F={F}, {label}: median {statistics.median(ts):.4f} "
              f"ms (range {min(ts):.4f}-{max(ts):.4f})", flush=True)
    print(ab.card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
