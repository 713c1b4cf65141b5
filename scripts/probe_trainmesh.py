#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 18 alone: training under a (DATA, MODEL) mesh
at fsdp_tp with every slot on the one card (llama2-7b's width at 2
layers, unsharded then at (2, 2) and (1, 4), a checkpoint restored
across meshes; qwen3-moe at 1 layer with expert parallelism, plain,
``moe_ep_quant`` and ``moe_bf16_reduce``; mamba2-130m; recurrentgemma-9b
at (1, 4)). The path runs no kernel, so nothing is built. About a
minute.

    python3 scripts/probe_trainmesh.py
"""
from __future__ import annotations

import sys
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
    cs.trainmesh_phase(torch, dev)
    print("PROBE-TRAINMESH-OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
