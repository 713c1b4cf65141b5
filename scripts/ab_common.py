"""Helpers of the kernel A/B scripts (``scripts/ab_*.py``): build one
kernel source of two source trees side by side, read its SASS, and time
closures in a CUDA graph."""
from __future__ import annotations

import ctypes
import os
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "csrc"
sys.path.insert(0, str(ROOT / "src"))


def build(tag: str, src_dir: Path, name: str, out: Path):
    """Compile library ``name`` of ``src_dir`` (its sources there, its own
    headers first, then this tree's) with the port's nvcc flags; returns
    (loaded library, path, ptxas report: each kernel's name, spills and
    registers)."""
    return build_many([(tag, src_dir, name, out)])[0]


def build_many(jobs):
    """``build`` for each (tag, src_dir, name, out) of ``jobs``, one nvcc
    each, all started at once; returns their results in order."""
    from repro_torch.kernels import build as kbuild
    procs = []
    for tag, src_dir, name, out in jobs:
        out.mkdir(parents=True, exist_ok=True)
        so = out / f"{tag}_{name}.so"
        srcs = [src_dir / f"{p}.cu" for p in kbuild.parts(name)
                if (src_dir / f"{p}.cu").exists()]
        procs.append((tag, name, so, subprocess.Popen(
            [kbuild._nvcc(), *kbuild.NVCC_FLAGS, "-I", str(src_dir), "-I",
             str(CSRC), "-o", str(so), *map(str, srcs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs = [(tag, name, so, proc.communicate()[0], proc.returncode)
            for tag, name, so, proc in procs]
    results = []
    for tag, name, so, log, rc in logs:
        if rc:
            raise RuntimeError(f"nvcc {tag} {name} failed:\n{log}")
        report = [ln.strip() for ln in log.splitlines()
                  if "Compiling entry" in ln or "registers" in ln
                  or "spill" in ln]
        results.append((ctypes.CDLL(str(so)), so, report))
    return results


def registers(report) -> str:
    """The register counts of a ptxas report, on one line."""
    return " | ".join(ln for ln in report if "registers" in ln)


def c_fn(lib, fn: str, n_ptr: int, n_int: int, n_ptr_after: int = 1):
    f = getattr(lib, fn)
    f.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                  + [ctypes.c_void_p] * n_ptr_after)
    f.restype = ctypes.c_int
    return f


def hmma_by_function(so: Path) -> dict:
    """{mangled kernel name: count of HMMA instructions} in the SASS of
    the library ``so`` (``cuobjdump -sass``)."""
    tool = shutil.which("cuobjdump") or str(
        Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin"
        / "cuobjdump")
    return count_hmma(subprocess.run([tool, "-sass", str(so)],
                                     capture_output=True, text=True,
                                     check=True).stdout)


def count_hmma(sass: str) -> dict:
    """{function name: HMMA instructions} of a ``cuobjdump -sass``
    listing."""
    counts, fn = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            fn = m.group(1)
            counts[fn] = 0
        elif fn is not None and re.search(r"\bHMMA\b", ln):
            counts[fn] += 1
    return counts


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream() -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def graph_ms(calls, reps: int = 5) -> float:
    """Device time per call of a CUDA graph replaying ``calls`` (closures
    returning a CUDA error code) back to back."""
    import torch
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


def alternate(cases: dict, tags=("base", "tree"), rounds: int = 6) -> dict:
    """``cases``: {label: fn(tag) -> list of closures}. Times each (label,
    tag) ``rounds * 2`` times in the order a, b, b, a (reversed every
    other round); returns {(label, tag): [ms, ...]}."""
    a, b = tags
    order = [a, b, b, a]
    times = {(label, tag): [] for label in cases for tag in tags}
    for r in range(rounds):
        for label, calls in cases.items():
            for tag in (order if r % 2 == 0 else order[::-1]):
                times[(label, tag)].append(graph_ms(calls(tag)))
    return times


def summary(ts) -> str:
    return (f"median {statistics.median(ts):.4f} ms (range {min(ts):.4f}-"
            f"{max(ts):.4f}, {len(ts)} runs)")


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
