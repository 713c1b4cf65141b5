#!/usr/bin/env python3
"""How long the target must train before a SpecEE bundle stops being
degenerate, on one card.

``chip_smoke.py``'s phase 11 trains its bundles with
``benchmarks/common.py::get_bundle``'s 30 target steps. This probe runs the
same recipe (``chip_smoke.train_bundle``: target, draft, predictors,
offline exit counts and mask) with the target trained for each of
``TARGET_STEPS`` steps (the cosine schedule spanning each run), for
configuration (a) (llama2-7b at published width, 8 layers, fp32, batches
of 4 x 256) and (b) (get_bundle's: the smoke config deepened to 12
layers, fp32, batches of 4 x 32), then decodes once with each bundle
(``chip_smoke.trained_decode``: dense, SpecEE and tree in turns, one run
each, B=4 pipeline prompts of 128 tokens, 32 tokens a row), logging the
distinct tokens each mode emits beside its exits, units_run, share of
tokens equal to dense and the tree's accepted length.

    python3 scripts/probe_trained_bundle.py
"""
from __future__ import annotations

import dataclasses
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

TARGET_STEPS = (30, 100, 300)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print(__doc__)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(cs.card_line(), flush=True)
    from repro_torch.data import DataPipeline
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.build_all()
    cs.log("build", f"{len(build.SOURCES)} kernels in "
           f"{time.perf_counter() - t0:.1f} s")
    cs.TRAINED_RUNS = 1
    for steps in TARGET_STEPS:
        cs.TRAIN_STEPS = steps
        run_a = cs.llama(cs.TRAINED_A_LAYERS, "float32")
        run_a = dataclasses.replace(run_a, train=dataclasses.replace(
            run_a.train, global_batch=4, seq_len=cs.TRAINED_A_SEQ,
            steps=steps))
        run_b = cs.bundle_b_run()
        for label, run, seq in (("(a)", run_a, cs.TRAINED_A_SEQ),
                                ("(b)", run_b, cs.TRAINED_B_SEQ)):
            label = f"{label} {steps} target steps"
            params, sw = cs.train_bundle(torch, dev, label, run, seq)
            prompts = DataPipeline(run.model, cs.B, cs.TRAINED_PROMPT,
                                   seed=1).next()["tokens"]
            cs.trained_decode(torch, dev, label, run, params, sw, prompts)
            del params, sw
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
