#!/usr/bin/env python3
"""A/B of the port's fp decode-attention kernels (dense and paged) between
another version of ``src/repro_torch/csrc`` and this tree's, on one card.

Both versions are built side by side with ``nvcc`` (the flags of
``repro_torch.kernels.build``) and timed in one process, in alternating
order (base, tree, tree, base, then reversed), at the shapes of
``chip_smoke.py`` phase 2: dense B=4 over the full run's 162-slot cache
with 150 live keys and over 1024 live keys, paged B=8 with 128-token pages
at 785 and 4563 live keys; bf16, 32 heads of 128. Outputs must be
bit-equal between the versions (the arithmetic is the same).

    git archive <commit> src/repro_torch/csrc | tar -x -C build/base
    python3 scripts/ab_decode_attention.py build/base/src/repro_torch/csrc

Prints the ptxas report of each build, then per case the median and range
of each version's device time per call (CUDA graph of 12-24 calls, CUDA
events), and the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "ab"
NAMES = ("decode_attention", "paged_decode_attention")
H, HD, PAGE = 32, 128, 128


def build(tag: str, csrc: Path) -> dict:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build as kbuild
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in NAMES:
        so = OUT / f"{tag}_{name}.so"
        procs[name] = (subprocess.Popen(
            [kbuild._nvcc(), *kbuild.NVCC_FLAGS, "-I", str(csrc), "-o",
             str(so), str(csrc / f"{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {tag} {name}.cu failed:\n{log}")
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"{tag} {name}: " + " | ".join(regs[:3]), flush=True)
        libs[name] = ctypes.CDLL(str(so))
    return libs


def launcher(lib, name):
    P, I = ctypes.c_void_p, ctypes.c_int
    f = getattr(lib, f"{name}_launch")
    f.argtypes = ([P] * 5 + [I] * 7 + [P] if name == "decode_attention"
                  else [P] * 6 + [I] * 8 + [P])
    f.restype = ctypes.c_int
    return f


def main() -> int:
    import numpy as np
    import torch
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__)
        return 1
    versions = {"base": build("base", Path(sys.argv[1]).resolve()),
                "tree": build("tree", ROOT / "src" / "repro_torch" / "csrc")}
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(shape):
        return torch.randn(shape, generator=gen, device=dev).bfloat16()

    def ptr(t):
        return ctypes.c_void_p(t.data_ptr())

    def stream():
        return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    cases = {}
    for label, S, live, n in (("dense, 150 live keys", 162, 150, 8),
                              ("dense, 1024 live keys", 1024, 1024, 2)):
        B = 4
        q, out = rnd((B, 1, H, HD)), torch.empty(B, 1, H, HD, device=dev,
                                                 dtype=torch.bfloat16)
        cl = torch.full((B,), live, dtype=torch.int32, device=dev)
        caches = [(rnd((B, S, H, HD)), rnd((B, S, H, HD))) for _ in range(n)]

        def calls(tag, q=q, out=out, cl=cl, caches=caches, B=B, S=S):
            f = launcher(versions[tag]["decode_attention"],
                         "decode_attention")
            return [lambda c=c: f(ptr(q), ptr(c[0]), ptr(c[1]), ptr(cl),
                                  ptr(out), B, S, H, H, HD, 0, 1, stream())
                    for c in caches]
        cases[label] = (calls, out)
    for P, lens in ((2, [150, 1, 77, 149, 150, 128, 129, 1]),
                    (8, [1024, 1, 700, 1000, 513, 1024, 300, 1])):
        B, NP = len(lens), len(lens) * P + 5
        q, out = rnd((B, 1, H, HD)), torch.empty(B, 1, H, HD, device=dev,
                                                 dtype=torch.bfloat16)
        cl = torch.tensor(lens, dtype=torch.int32, device=dev)
        pools = []
        for j in range(4):
            perm = np.random.default_rng(j).permutation(NP)[:B * P]
            table = torch.as_tensor(perm.reshape(B, P).astype(np.int32),
                                    device=dev)
            table[-1] = NP                     # a retired row: trash page
            pools.append((rnd((NP + 1, PAGE, H, HD)),
                          rnd((NP + 1, PAGE, H, HD)), table))

        def calls(tag, q=q, out=out, cl=cl, pools=pools, B=B, P=P):
            f = launcher(versions[tag]["paged_decode_attention"],
                         "paged_decode_attention")
            return [lambda c=c: f(ptr(q), ptr(c[0]), ptr(c[1]), ptr(c[2]),
                                  ptr(cl), ptr(out), B, P, PAGE, H, H, HD, 0,
                                  1, stream()) for c in pools]
        cases[f"paged, {sum(lens)} live keys"] = (calls, out)

    def graph_ms(calls, reps=5):
        for fn in calls[:3]:
            if fn() != 0:
                raise RuntimeError("launch failed")
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for fn in calls:
                fn()
        g.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            g.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (reps * len(calls))

    for label, (calls, out) in cases.items():
        outs = []
        for tag in versions:
            calls(tag)[0]()
            torch.cuda.synchronize()
            outs.append(out.clone())
        if not torch.equal(outs[0], outs[1]):
            raise AssertionError(f"{label}: outputs differ between versions")
    times = {(label, tag): [] for label in cases for tag in versions}
    order = ["base", "tree", "tree", "base"]
    for r in range(6):
        for label, (calls, _) in cases.items():
            for tag in (order if r % 2 == 0 else order[::-1]):
                times[(label, tag)].append(graph_ms(calls(tag) * 3))
    for label in cases:
        print(f"{label}: outputs bit-equal; " + "; ".join(
            f"{tag} median {statistics.median(times[(label, tag)]):.4f} ms "
            f"(range {min(times[(label, tag)]):.4f}-"
            f"{max(times[(label, tag)]):.4f}, "
            f"{len(times[(label, tag)])} runs)" for tag in versions),
            flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
