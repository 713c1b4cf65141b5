#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 20 alone: the dry run on the meta device held
against the card (llama2-70b's widths at 2 layers, fp32, a decode cell
of 4 rows of 256 slots at (2, 2) under tp_dp, tp2d and fsdp_tp: the
allocation growth across placement against the predicted bytes summed
over the slots, one step's per-device collectives, the meta step's
branches taken, against the meta step's), then
llama2-7b's decode_32k cell at published size on a (4, 4) mesh of meta
slots. The path runs no kernel, so nothing is built. Under a minute.

    python3 scripts/probe_dryrun.py
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
    cs.log("device", f"{cs.card_line()}; torch {torch.__version__}")
    cs.dryrun_phase(torch, dev)
    print("PROBE-DRYRUN-OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
