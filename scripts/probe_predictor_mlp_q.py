#!/usr/bin/env python3
"""Where the time of the quantized predictor MLP (``predictor_mlp_q``, the
quantized tree gate's predictor) goes, on one card, and how many rows a
CTA of this tree's kernel should take.

With another version of ``src/repro_torch/csrc`` whose
``predictor_mlp_q.cu`` is the one-CTA-per-32-rows kernel (each CTA widens
all F*H + H codes into shared memory through ``code_at``, then each warp
walks its rows), builds that kernel and five copies of it made under
``build/probe_pred/``:
  - staging alone: the CTA returns after the codes are widened (one
    thread writes one staged value, so the staging stays);
  - row loop alone: the staging loops cut (the rows read shared memory
    that nothing wrote: wrong by construction, only the time is read);
  - grids of 27 and 108 CTAs at R = 108: 4 rows and 1 row a CTA (each
    CTA still stages the whole matrix);
  - its feature loops unrolled to 12 (F here) in place of 32, so no
    multiply-add is predicated off.
Then this tree's kernel (``csrc/predictor_mlp_q.cu`` on
``csrc/predictor.cuh``: 4 rows a CTA, its feature loops unrolled to 12)
as it stands and with PM_RB, its rows per CTA, set to 1, 2, 8 and 16, and
at 4, 8 and 16 rows with its feature loops unrolled to 32 (the instance
for F > 12; copies under ``build/probe_pred/``).

Times every build (int8 and int4 weights, F = 12, H = 512: the tree
gate's predictor; 20 calls per CUDA graph, 6 rounds in turn) at R = 4,
108 and 216 (B*P paths at B = 4 and 8), beside the bound (codes, scales,
biases, inputs and outputs at 3.35 TB/s; ~2*R*(F+1)*H fp32 operations at
67 TFLOP/s). Every build but the cut ones is first held to the plain
version (atol = rtol = 1e-5). Then prints the card's name and power
limit.

    git archive <commit> src/repro_torch/csrc | tar -x -C build/base
    python3 scripts/probe_predictor_mlp_q.py build/base/src/repro_torch/csrc
"""
from __future__ import annotations

import shutil
import statistics
import sys
from pathlib import Path

import ab_common as ab

F, H, N_CALLS, ROUNDS = 12, 512, 20, 6
ROWS = (4, 108, 216)
OLD_LOOP = "  __syncthreads();\n  const int lane = threadIdx.x & 31"
OLD_STAGE = ("  for (int i = threadIdx.x; i < F * H; i += PM_THREADS)\n"
             "    s_c1[i] = rt::code_at(q1, bits1, i / H, i % H, F, H);\n"
             "  for (int i = threadIdx.x; i < H; i += PM_THREADS) {\n"
             "    s_s1[i] = s1[i];\n"
             "    s_b1[i] = b1[i];\n"
             "    s_c2[i] = rt::code_at(q2, bits2, i, 0, H, 1);\n"
             "  }\n")
OLD_ROWS = "constexpr int PM_ROWS = 32;"
OLD_MAXF = "constexpr int PM_MAXF = 32;"
NEW_RB = "constexpr int PM_RB = 4;"
NEW_SMALL = "F <= PM_SMALL_F ?"
KER = "predictor_mlp_q.cu"
# (label, [(file, old text, new text)]); the cut ones are not checked
OLD = (("old", []), ("old, staging alone", [(KER, OLD_LOOP, (
    "  __syncthreads();\n  if (threadIdx.x == 0) out[blockIdx.x] = "
    "s_c1[blockIdx.x % (F * H)] + s_c2[0];\n  return;\n"
    "  const int lane = threadIdx.x & 31"))]),
       ("old, row loop alone", [(KER, OLD_STAGE, "")]),
       ("old, 4 rows a CTA",
        [(KER, OLD_ROWS, "constexpr int PM_ROWS = 4;")]),
       ("old, 1 row a CTA",
        [(KER, OLD_ROWS, "constexpr int PM_ROWS = 1;")]),
       ("old, 12 features unrolled", [
           (KER, OLD_MAXF, "constexpr int PM_MAXF = 12;")]))
NEW = tuple((f"this tree, {rb} rows a CTA",
             [] if rb == 4 else [(KER, NEW_RB,
                                  f"constexpr int PM_RB = {rb};")])
            for rb in (1, 2, 4, 8, 16)) + tuple(
    (f"this tree, {rb} rows a CTA, 32 features unrolled",
     [(KER, NEW_SMALL, "F < 0 ?")]
     + ([] if rb == 4 else [(KER, NEW_RB, f"constexpr int PM_RB = {rb};")]))
    for rb in (4, 8, 16))
CUT = ("staging alone", "row loop alone")


def variant(tag: str, src_dir: Path, cuts) -> Path:
    """A copy of ``src_dir``'s predictor_mlp_q.cu and headers, each cut
    (file, text, replacement) applied (its text must occur once)."""
    out = ab.ROOT / "build" / "probe_pred" / tag
    if out.exists():
        shutil.rmtree(out)
    out.mkdir(parents=True)
    for p in list(src_dir.glob("*.cuh")) + [src_dir / "predictor_mlp_q.cu"]:
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
    from repro_torch.kernels.predictor_mlp.ref import predictor_mlp_q_ref
    from repro_torch.quant.core import quantize_tensor
    base = Path(sys.argv[1]).resolve()
    builds = [(label, variant(f"v{i}", base if i < len(OLD) else ab.CSRC,
                              cuts), not any(c in label for c in CUT))
              for i, (label, cuts) in enumerate(OLD + NEW)]
    libs = ab.build_many([(f"v{i}", src, "predictor_mlp_q",
                           ab.ROOT / "build" / "probe_pred")
                          for i, (_, src, _) in enumerate(builds)])
    fns = {}
    for (label, _, _), (lib, _, report) in zip(builds, libs):
        print(f"{label}: {ab.registers(report)}", flush=True)
        fns[label] = ab.c_fn(lib, "predictor_mlp_q_launch", 8, 5)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    b1, b2 = rnd((H,), 0.1), rnd((1,), 0.1)
    w1, w2 = rnd((F, H), F ** -0.5), rnd((H, 1), H ** -0.5)
    cases, bounds = {}, {}
    for bits in (8, 4):
        q1, q2 = quantize_tensor(w1, bits), quantize_tensor(w2, bits)
        for R in ROWS:
            x = rnd((R, F))
            out = torch.empty(R, device=dev)
            want = predictor_mlp_q_ref(x, q1, b1, q2, b2)
            nbytes = (R * F * 4 + q1.nbytes() + q2.nbytes() + (H + 1) * 4
                      + R * 4)
            ops = R * (2 * F * H + 2 * H)
            bounds[(bits, R)] = max(nbytes / 3.35e9, ops / 67e9)
            for label, _, checked in builds:
                def calls(f=fns[label], x=x, out=out, q1=q1, q2=q2, R=R):
                    return [lambda: f(
                        ab.ptr(x), ab.ptr(q1.q), ab.ptr(q1.scale), ab.ptr(b1),
                        ab.ptr(q2.q), ab.ptr(q2.scale), ab.ptr(b2),
                        ab.ptr(out), R, F, H, q1.bits, q2.bits,
                        ab.stream())] * N_CALLS
                if checked:
                    out.fill_(float("nan"))
                    if calls()[0]() != 0:
                        raise RuntimeError(f"{label}: launch failed")
                    torch.cuda.synchronize()
                    torch.testing.assert_close(out, want, atol=1e-5,
                                               rtol=1e-5)
                cases[(bits, R, label)] = calls
    print("every build but the cut ones matches the plain version (atol = "
          "rtol = 1e-5)", flush=True)
    times = {key: [] for key in cases}
    for r in range(ROUNDS):
        for key in (list(cases) if r % 2 == 0 else list(cases)[::-1]):
            times[key].append(ab.graph_ms(cases[key]()))
    for (bits, R, label), ts in times.items():
        print(f"int{bits} R={R}, {label}: median "
              f"{statistics.median(ts):.4f} ms (range {min(ts):.4f}-"
              f"{max(ts):.4f}); bound {bounds[(bits, R)]:.5f} ms",
              flush=True)
    print(ab.card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
