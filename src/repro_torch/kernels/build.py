"""Build and load the port's CUDA kernels (``src/repro_torch/csrc/*.cu``).

Each kernel source is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface under ``build/kernels/`` at the
repository root, named by a hash of the sources so an edited kernel is
rebuilt, and loaded with ``ctypes``. A library of several sources
(``PARTS``) has each compiled to an object, then linked. ``build_all``
starts one ``nvcc`` per source at once. Nothing is built or loaded on
import: the CPU tests import every module on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("exit_gate", "argmax_verify", "topk_verify", "decode_attention",
           "paged_decode_attention", "flash_attention", "spec_head",
           "predictor_mlp", "argmax_verify_q", "topk_verify_q",
           "spec_head_q", "predictor_mlp_q", "paged_decode_attention_q",
           "ssd_chunk", "exit_gate_q", "spec_head_gather",
           "spec_head_gather_q")
# libraries split over several sources, so that their parts compile at
# once: topk_verify_q's int4 tile instances are as many as its int8 ones
PARTS = {"topk_verify_q": ("topk_verify_q", "topk_verify_q4")}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
COMPILE_FLAGS = tuple(f for f in NVCC_FLAGS if f != "-shared")

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return str(path)


def parts(name: str):
    """The sources (names without ``.cu``) of library ``name``."""
    return PARTS.get(name, (name,))


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{p}.cu"
                                             for p in parts(name)]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every missing library in parallel; returns ``{name: ptxas
    report}`` for the ones built now. Raises with the compiler's output on
    the first failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    libs, procs = {}, {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        srcs = parts(name)
        objs = [tmp.with_suffix(f".{p}.o") for p in srcs]
        libs[name] = (tmp, out, objs if len(srcs) > 1 else [])
        for p, obj in zip(srcs, objs):
            cmd = ([_nvcc(), *NVCC_FLAGS, "-o", str(tmp)] if len(srcs) == 1
                   else [_nvcc(), *COMPILE_FLAGS, "-c", "-o", str(obj)])
            procs[p] = subprocess.Popen(
                cmd + ["-I", str(CSRC), str(CSRC / f"{p}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs, done, failed = {}, {}, []
    for p, proc in procs.items():
        logs[p], _ = proc.communicate()
        done[p] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"--- nvcc {p}.cu failed ---\n{logs[p]}")
    reports = {}
    for name, (tmp, out, objs) in libs.items():
        secs = max(done[p] for p in parts(name))
        ok = all(procs[p].returncode == 0 for p in parts(name))
        if objs and ok:
            t1 = time.perf_counter()
            link = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                                   *map(str, objs)], capture_output=True,
                                  text=True)
            if link.returncode != 0:
                failed.append(f"--- nvcc link of {name} failed ---\n"
                              f"{link.stdout}{link.stderr}")
                ok = False
            secs += time.perf_counter() - t1            # parts, then link
        for obj in objs:
            obj.unlink(missing_ok=True)
        if not ok:
            continue
        os.replace(tmp, out)
        reports[name] = (f"built {out.name} in {secs:.1f}s\n"
                         + "".join(logs[p] for p in parts(name)))
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel source ``name`` (built if missing)."""
    lib = _LIBS.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build_all([name])
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib


def c_func(name: str, fn: str, argtypes, restype=ctypes.c_int):
    f = getattr(load(name), fn)
    f.argtypes = list(argtypes)
    f.restype = restype
    return f


def check(name: str, rc: int, what: Optional[str] = None) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if rc != 0:
        err = c_func(name, f"{name}_error", [ctypes.c_int], ctypes.c_char_p)
        raise RuntimeError(f"{what or name} kernel launch failed: "
                           f"{err(rc).decode()} (cudaError {rc})")
