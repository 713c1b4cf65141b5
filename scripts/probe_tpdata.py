#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 19 alone, after the kernel build: serving
over (DATA, MODEL) meshes with DATA > 1, every slot on the one card —
llama2-70b's widths at 2 layers (SpecEE on the dense cache and
``ServingEngine`` on the paged one at (2, 1) tp2d, (2, 2) tp_dp / tp2d /
fsdp_tp and (4, 1) tp2d; tree and int8 at (2, 2) tp2d), dbrx-132b's at 1
layer (both MoE forms, expert parallelism at (2, 2)), qwen3-moe's at 1
(top-k, paged), mamba2-130m (serving at (2, 2)) and recurrentgemma-9b's
at 3 layers (dense and paged), each against its (1, 1) run (see
``chip_smoke.tpdata_phase``). fp32 with TF32 off, as the smoke runs it.

    python3 scripts/probe_tpdata.py
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
    by_path = cs.tpdata_phase(torch, dev)
    for path, launches in by_path.items():
        cs.log("tpdata", f"{path} launches: " + ", ".join(
            f"{k} {v}" for k, v in launches.items() if v))
    print("PROBE-TPDATA-OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
