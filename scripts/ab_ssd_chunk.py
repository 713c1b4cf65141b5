#!/usr/bin/env python3
"""A/B of the port's SSD intra-chunk kernel (``csrc/ssd_chunk.cu``) between
another version of the source and this tree's, on one card.

Both versions are built side by side with ``nvcc`` (the flags of
``repro_torch.kernels.build``) and timed in one process, in alternating
order (base, tree, tree, base, then reversed), at mamba2-130m's shapes
(c=64, 24 heads of 64, d_state 128, bf16 B/C) for 1, 2, 8 and 32 cells:
a prefill of 64, 128 and 512 tokens of one row, and of 4 rows of 512.
Each version's output is held against the plain version
(``ssd_chunk_ref``) at atol = rtol = 1e-4 (fp32 sums in another order).

    python3 scripts/ab_ssd_chunk.py <dir holding the other ssd_chunk.cu>

The other directory may hold its own ``common.cuh``; this tree's is found
after it. Prints the ptxas report of each build, then per case the median
and range of each version's device time per call (CUDA graph of 16 calls
on distinct inputs, CUDA events), and the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "ab_ssd"
C, NH, HD, DS = 64, 24, 64, 128


def build(tag: str, src_dir: Path):
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build as kbuild
    OUT.mkdir(parents=True, exist_ok=True)
    so = OUT / f"{tag}_ssd_chunk.so"
    proc = subprocess.run(
        [kbuild._nvcc(), *kbuild.NVCC_FLAGS, "-I", str(src_dir), "-I",
         str(CSRC), "-o", str(so), str(src_dir / "ssd_chunk.cu")],
        capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc {tag} failed:\n{proc.stdout}{proc.stderr}")
    regs = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
            if "registers" in ln]
    print(f"{tag}: " + " | ".join(regs), flush=True)
    lib = ctypes.CDLL(str(so))
    f = lib.ssd_chunk_launch
    f.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def main() -> int:
    import torch
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.ssd_chunk.ref import ssd_chunk_ref
    versions = {"base": build("base", Path(sys.argv[1]).resolve()),
                "tree": build("tree", CSRC)}
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def ptr(t):
        return ctypes.c_void_p(t.data_ptr())

    def stream():
        return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    cases = {}
    for cells in (1, 2, 8, 32):
        sets = []
        for _ in range(16):
            cum = -torch.cumsum(torch.rand((cells, C, NH), generator=gen,
                                           device=dev), dim=1)
            sets.append((torch.randn((cells, C, NH, HD), generator=gen,
                                     device=dev), cum,
                         (torch.randn((cells, C, DS), generator=gen,
                                      device=dev) * DS ** -0.25).bfloat16(),
                         (torch.randn((cells, C, DS), generator=gen,
                                      device=dev) * DS ** -0.25).bfloat16(),
                         torch.empty((cells, C, NH, HD), device=dev)))

        def calls(tag, sets=sets, cells=cells):
            f = versions[tag]
            return [lambda a=a: f(ptr(a[0]), ptr(a[1]), ptr(a[2]),
                                  ptr(a[3]), ptr(a[4]), cells, C, NH, HD,
                                  DS, 1, stream()) for a in sets]
        cases[f"{cells} cells"] = (calls, sets[0])

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

    for label, (calls, a) in cases.items():
        want = ssd_chunk_ref(*a[:4])
        for tag in versions:
            a[4].fill_(float("nan"))
            if calls(tag)[0]() != 0:
                raise RuntimeError(f"{tag} launch failed")
            torch.cuda.synchronize()
            torch.testing.assert_close(a[4], want, atol=1e-4, rtol=1e-4)
    times = {(label, tag): [] for label in cases for tag in versions}
    order = ["base", "tree", "tree", "base"]
    for r in range(6):
        for label, (calls, _) in cases.items():
            for tag in (order if r % 2 == 0 else order[::-1]):
                times[(label, tag)].append(graph_ms(calls(tag)))
    for label in cases:
        print(f"{label}: both equal the plain version (atol 1e-4); " +
              "; ".join(
                  f"{tag} median {statistics.median(times[(label, tag)]):.4f}"
                  f" ms (range {min(times[(label, tag)]):.4f}-"
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
