#!/usr/bin/env python3
"""Where the time of the SSD intra-chunk kernel (``csrc/ssd_chunk.cu``)
goes, on one card, and how many heads a CTA should take.

With another version of ``src/repro_torch/csrc`` whose ``ssd_chunk.cu``
is the fp32 CUDA-core kernel (one CTA per cell and head group: the Gram
matrix from four serially staged 32-wide ds slices, then per head its
cum and xdt, the decayed weights through shared memory, the product),
builds that kernel and copies of it made under ``build/probe_ssd/`` whose
phases are cut one after another:
  - no product: the product loop cut to its first step;
  - no decay or product: the decay loop cut as well (the product reads
    weights that nothing wrote: only the time is read);
  - staging alone: the Gram matrix's multiply-add loop cut as well, so
    only the loads of B, C, cum and xdt and the stores are left;
  - 1, 2, 4 and 24 heads a CTA in place of its fill rule.
The differences give the staging, Gram, decay and product shares. Then
this tree's kernel (tensor cores, the Gram matrix kept in registers over
a CTA's heads) as it stands, without its second product (the compiler
then drops the decay and the xdt fragment loads too), without its Gram
matrix, with up to 255 registers a thread (one CTA an SM) in place of
128, and at 1, 2, 4 and 24 heads a CTA.

Times every build at mamba2-130m's shapes (c=64, 24 heads of 64, d_state
128, bf16 B/C, mild decay) for 1, 2, 8 and 32 cells (CUDA graph of 16
calls on distinct inputs, 6 rounds in turn), beside the bound (B and C
once, cum, xdt and y at 3.35 TB/s; 2 c^2 ds + 2 c^2 nh hd fp32
operations a cell at 67 TFLOP/s). Every uncut build is first held to the
plain version (atol = rtol = 1e-4). Then prints the card's name and power
limit.

    git archive <commit> src/repro_torch/csrc | tar -x -C build/base
    python3 scripts/probe_ssd_chunk.py build/base/src/repro_torch/csrc
"""
from __future__ import annotations

import shutil
import statistics
import sys
from pathlib import Path

import ab_common as ab

C, NH, HD, DS = 64, 24, 64, 128
CELLS, N_SETS, ROUNDS = (1, 2, 8, 32), 16, 6
KER = "ssd_chunk.cu"
PER = "  const int per = (int)max(1L, min((long)nh, work / SC_FILL));"
OLD_PRODUCT = ("    for (int s = 0; s < s_end; ++s) {",
               "    for (int s = 0; s < min(s_end, 1); ++s) {")
OLD_DECAY = ("    for (int e = tid; e < c * c; e += SC_THREADS) {",
             "    for (int e = tid; e < min(c * c, 1); e += SC_THREADS) {")
OLD_GRAM = ("    for (int dd = 0; dd < SC_TILE; ++dd) {",
            "    for (int dd = 0; dd < 1; ++dd) {")
NEW_PRODUCT = ("          rt::mma_3xtf32(o[n], ah, al, bh0, bh1, bl0, bl1);",
               "")
NEW_GRAM = ("    for (int kk = 0; kk < ksteps; ++kk) {",
            "    for (int kk = 0; kk < 0; ++kk) {")
NEW_REGS = ("__launch_bounds__(SC_THREADS, 2)",
            "__launch_bounds__(SC_THREADS, 1)")
# the small products a_hi.b_lo, a_lo.b_hi into accumulators of their own
NEW_TWO_ACC = [
    (KER, "      float o[NT][4];", "      float o[NT][4], o2[NT][4];"),
    (KER, "        for (int e = 0; e < 4; ++e) o[n][e] = 0.f;",
     "        for (int e = 0; e < 4; ++e) o[n][e] = o2[n][e] = 0.f;"),
    (KER, NEW_PRODUCT[0],
     "          rt::mma_tf32(o2[n], ah, bl0, bl1);\n"
     "          rt::mma_tf32(o2[n], al, bh0, bh1);\n"
     "          rt::mma_tf32(o[n], ah, bh0, bh1);"),
    (KER, "        const int p = cb + 8 * n + 2 * tq;",
     "        for (int e = 0; e < 4; ++e) o[n][e] += o2[n][e];\n"
     "        const int p = cb + 8 * n + 2 * tq;")]
# the tf32 rounding by the conversion instruction
NEW_CVT = ("mma.cuh", "  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;",
           "  uint32_t r;\n"
           "  asm(\"cvt.rna.tf32.f32 %0, %1;\\n\" : \"=r\"(r) : \"f\"(x));\n"
           "  return r;")
# every warp multiplies all 8 k-blocks (zeros past its diagonal)
NEW_ALL_K = [(KER, "        if (j >= kblocks) break;\n", "")]


def grids(label):
    return tuple((f"{label}, {n} heads a CTA",
                  [(KER, PER, f"  const int per = min(nh, {n});")])
                 for n in (1, 2, 4, 24))


# (label, [(file, old text, new text)]); labels with "no " or "alone" are
# cut and not checked
OLD = (("old", []),
       ("old, no product", [(KER, *OLD_PRODUCT)]),
       ("old, no decay or product", [(KER, *OLD_PRODUCT),
                                     (KER, *OLD_DECAY)]),
       ("old, staging alone", [(KER, *OLD_PRODUCT), (KER, *OLD_DECAY),
                               (KER, *OLD_GRAM)])) + grids("old")
NEW = (("this tree", []),
       ("this tree, no decay or second product",
        [(KER, *NEW_PRODUCT)]),
       ("this tree, no Gram matrix", [(KER, *NEW_GRAM)]),
       ("this tree, up to 255 registers", [(KER, *NEW_REGS)]),
       ("this tree, tf32 by cvt.rna", [NEW_CVT]),
       ("this tree, small products apart", NEW_TWO_ACC),
       ("this tree, all k-blocks", NEW_ALL_K),
       ("this tree, small products apart, all k-blocks",
        NEW_TWO_ACC + NEW_ALL_K)) + grids("this tree")


def variant(tag: str, src_dir: Path, cuts) -> Path:
    """A copy of ``src_dir``'s ssd_chunk.cu and headers, each cut (file,
    text, replacement) applied (its text must occur once)."""
    out = ab.ROOT / "build" / "probe_ssd" / tag
    if out.exists():
        shutil.rmtree(out)
    out.mkdir(parents=True)
    for p in list(src_dir.glob("*.cuh")) + [src_dir / KER]:
        shutil.copy(p, out / p.name)
    for name, old, new in cuts:
        text = (out / name).read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"{tag}: the text to cut is not in {name}")
        (out / name).write_text(text.replace(old, new))
    return out


def main() -> int:
    import torch
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__)
        return 1
    from repro_torch.kernels.ssd_chunk.ref import ssd_chunk_ref
    base = Path(sys.argv[1]).resolve()
    builds = [(label, variant(f"v{i}", base if i < len(OLD) else ab.CSRC,
                              cuts),
               "no " not in label and "alone" not in label)
              for i, (label, cuts) in enumerate(OLD + NEW)]
    libs = ab.build_many([(f"v{i}", src, "ssd_chunk",
                           ab.ROOT / "build" / "probe_ssd")
                          for i, (_, src, _) in enumerate(builds)])
    fns = {}
    for (label, _, _), (lib, _, report) in zip(builds, libs):
        print(f"{label}: {ab.registers(report)}", flush=True)
        fns[label] = ab.c_fn(lib, "ssd_chunk_launch", 5, 6)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    cases, bounds = {}, {}
    for cells in CELLS:
        sets = []
        for _ in range(N_SETS):
            cum = -torch.cumsum(torch.rand((cells, C, NH), generator=gen,
                                           device=dev), dim=1)
            sets.append((torch.randn((cells, C, NH, HD), generator=gen,
                                     device=dev), cum,
                         (torch.randn((cells, C, DS), generator=gen,
                                      device=dev) * DS ** -0.25).bfloat16(),
                         (torch.randn((cells, C, DS), generator=gen,
                                      device=dev) * DS ** -0.25).bfloat16(),
                         torch.empty((cells, C, NH, HD), device=dev)))
        nbytes = (2 * cells * C * DS * 2 + cells * C * NH * 4
                  + 2 * cells * C * NH * HD * 4)
        ops = cells * (2 * C * C * DS + 2 * C * C * NH * HD)
        bounds[cells] = max(nbytes / 3.35e9, ops / 67e9)
        want = ssd_chunk_ref(*sets[0][:4])
        for label, _, checked in builds:
            f = fns[label]

            def calls(f=f, sets=sets, cells=cells):
                return [lambda a=a: f(ab.ptr(a[0]), ab.ptr(a[1]),
                                      ab.ptr(a[2]), ab.ptr(a[3]),
                                      ab.ptr(a[4]), cells, C, NH, HD, DS, 1,
                                      ab.stream()) for a in sets]
            if checked:
                sets[0][4].fill_(float("nan"))
                if calls()[0]() != 0:
                    raise RuntimeError(f"{label}: launch failed")
                torch.cuda.synchronize()
                torch.testing.assert_close(sets[0][4], want, atol=1e-4,
                                           rtol=1e-4)
            cases[(cells, label)] = calls
    print("every uncut build matches the plain version (atol = rtol = "
          "1e-4)", flush=True)
    times = {key: [] for key in cases}
    for r in range(ROUNDS):
        for key in (list(cases) if r % 2 == 0 else list(cases)[::-1]):
            times[key].append(ab.graph_ms(cases[key]()))
    for (cells, label), ts in times.items():
        print(f"{cells} cells, {label}: median {statistics.median(ts):.4f} "
              f"ms (range {min(ts):.4f}-{max(ts):.4f}); bound "
              f"{bounds[cells]:.4f} ms", flush=True)
    print(ab.card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
