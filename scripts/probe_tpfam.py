#!/usr/bin/env python3
"""``chip_smoke.py``'s new-family kernel shapes (phase 2's
``check_new_family_kernels``, among them the decode-attention instances
at 8 and 4 query heads over one KV head of 256 and every other shard's
head shape phase 17 decodes with; ``check_ssd_kernel``, ``ssd_chunk`` at
24, 12 and 6 heads) and its phase 17 alone,
after the kernel build: tensor-parallel serving of MoE, Mamba2, the
RG-LRU hybrid, the VLM and the encoder with every shard of a (1, P) mesh
on the one card (see ``chip_smoke.tp_family_phase``). Prints each main
path's launches.

    python3 scripts/probe_tpfam.py
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
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 stays fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cs.log("device", cs.card_line())
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.build_all()
    cs.log("build", f"{len(build.SOURCES)} kernels ready in "
           f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cs.check_ssd_kernel(torch, dev)
    cs.check_new_family_kernels(torch, dev)
    cs.log("kernels", f"new family shapes in {time.perf_counter() - t0:.1f} s")
    by_path = cs.tp_family_phase(torch, dev)
    for path, launches in by_path.items():
        cs.log("tpfam", f"{path} launches: " + ", ".join(
            f"{k} {v}" for k, v in launches.items() if v))
    print("PROBE-TPFAM-OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
