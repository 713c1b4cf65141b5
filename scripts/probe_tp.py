#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 16 alone, after the kernel build: multi-GPU
serving with every shard of a (1, P) mesh on the one card — the sharded
verify against the unsharded kernels, the collectives, tensor-parallel
decode at P = 1, 2 and 4 (fp32, 8 layers; then 32 layers in bf16), a
remesh on device loss and a replica pool's kill and requeue (see
``chip_smoke.tp_phase``). Prints each main path's launches. A few
minutes with the build, where the whole smoke takes fifteen.

    python3 scripts/probe_tp.py
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print(__doc__)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cs.log("device", cs.card_line())
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.build_all()
    cs.log("build", f"{len(build.SOURCES)} kernels ready in "
           f"{time.perf_counter() - t0:.1f} s")
    by_path, _ = cs.tp_phase(torch, dev)
    for path, launches in by_path.items():
        cs.log("tp", f"{path} launches: " + ", ".join(
            f"{k} {v}" for k, v in launches.items() if v))
    print("PROBE-TP-OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
