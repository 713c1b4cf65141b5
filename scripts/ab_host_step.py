#!/usr/bin/env python3
"""The unsharded decode path's time per step, this tree against another
source tree (the parent commit unpacked with ``git archive``), on one
card: phase 4's whole-batch SpecEE (llama2-7b, 32 layers, bf16, seeded,
B = 4, 128-token prompts, 32 steps, dense cache), phase 5's blocking
``ServingEngine`` (the paged cache, 8 slots of 4096 tokens, 16 requests
of 64-512 tokens, 32 new each) and phase 9's mamba2-130m SpecEE (24
layers, bf16, B = 4, 32 steps). The harness is this file's for both
trees; only the ``repro_torch`` package differs. Each tree runs in a
fresh process, in the order A B B A A B B A (A = this tree), each run
after a warm-up session; each step and tick is timed alone (the host
clock after a device sync) and a run reports their median, since a
shared host stalls single steps by tens of ms. The kernels are built
once, in this tree, and copied into the other tree's build directory
(the sources must be the same).

Prints per run: the median ms/step of each whole-batch run, the median
ms/tick of the serving run, and a digest of every token, so the trees'
outputs can be compared; then each tree's median over its runs.

    python3 scripts/ab_host_step.py OTHER_TREE
"""
from __future__ import annotations

import hashlib
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
B, PROMPT, STEPS = 4, 128, 32
SERVE_BATCH, SERVE_SEQ, PAGE = 8, 4096, 128
SERVE_REQS, SERVE_NEW, SERVE_PROMPTS = 16, 32, (64, 512)


def _config(arch: str, layers: int, **serve):
    import dataclasses
    from repro_torch.configs import get_config
    run = get_config(arch)
    return dataclasses.replace(
        run, model=dataclasses.replace(run.model, num_layers=layers,
                                       dtype="bfloat16"),
        serve=dataclasses.replace(run.serve, **serve))


def _weights(torch, model, dev, seed: int):
    from repro_torch.core import engine as eng
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = model.init(gen, dev)
    return params, eng.init_specee(model, gen, dev)


def _whole_batch(torch, model, params, sw, vocab: int, digest) -> float:
    """Median ms/step of ``STEPS`` whole-batch SpecEE steps (after a
    warm-up session of 4 steps)."""
    import numpy as np
    from repro_torch.api import Engine, SpecEEStrategy
    prompts = np.random.default_rng(1).integers(0, vocab, (B, PROMPT))
    engine = Engine.create(model, params, sw, strategy=SpecEEStrategy())
    for steps in (4, STEPS):
        session = engine.new_session()
        r = session.prefill(prompts, max_new_tokens=steps + 1)
        torch.cuda.synchronize()
        toks, ms = [r.tokens], []
        for _ in range(steps):
            t0 = time.perf_counter()
            toks.append(session.step().tokens)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
    digest.update(np.concatenate([np.asarray(t).ravel()
                                  for t in toks]).tobytes())
    return statistics.median(ms)


def _serve(torch, model, params, sw, vocab: int, digest) -> float:
    """Median ms/tick of a blocking ``ServingEngine`` run (after a warm-up
    run of 2 requests)."""
    import numpy as np
    from repro_torch.serving import ServingEngine
    rng = np.random.default_rng(11)
    lo, hi = SERVE_PROMPTS
    prompts = [rng.integers(0, vocab, int(n))
               for n in rng.integers(lo, hi + 1, SERVE_REQS)]
    for reqs in (prompts[:2], prompts):
        se = ServingEngine(model, params, sw, cache="paged",
                           prefill_chunk=0)
        for p in reqs:
            se.submit(p, max_new_tokens=SERVE_NEW)
        torch.cuda.synchronize()
        ms = []
        while True:
            t0 = time.perf_counter()
            se.step()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            if not se.busy:
                break
        se.close()
    for r in sorted(se.completed, key=lambda r: r.uid):
        digest.update(np.asarray(r.output, dtype=np.int64).tobytes())
    return statistics.median(ms)


def worker(tree: Path) -> dict:
    sys.path.insert(0, str(tree / "src"))
    import torch
    from repro_torch.kernels import build
    from repro_torch.models.model import ModelFlags, build_model
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    build.build_all()
    kern = dict(flash_attention=True, decode_kernel=True,
                exit_gate_kernel=True, exit_gate_impl="kernel")
    out, digest = {"tree": str(tree)}, hashlib.sha256()
    model = build_model(_config("llama2-7b", 32, max_batch=SERVE_BATCH,
                                max_seq_len=SERVE_SEQ, page_size=PAGE),
                        ModelFlags(**kern))
    params, sw = _weights(torch, model, dev, 7)
    V = model.run.model.vocab_size
    out["llama_ms_step"] = _whole_batch(torch, model, params, sw, V, digest)
    out["llama_serve_ms_tick"] = _serve(torch, model, params, sw, V, digest)
    del params, sw
    torch.cuda.empty_cache()
    model = build_model(_config("mamba2-130m", 24),
                        ModelFlags(**kern, ssd_kernel=True))
    params, sw = _weights(torch, model, dev, 8)
    out["mamba_ms_step"] = _whole_batch(torch, model, params, sw,
                                        model.run.model.vocab_size, digest)
    out["tokens_sha256"] = digest.hexdigest()[:16]
    return out


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--worker":
        print("AB-RESULT " + json.dumps(worker(Path(sys.argv[2]))),
              flush=True)
        return 0
    if len(sys.argv) != 2:
        print(__doc__)
        return 2
    import torch
    if not torch.cuda.is_available():
        print(__doc__)
        return 1
    other = Path(sys.argv[1]).resolve()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.build_all()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    dst = other / "build" / "kernels"
    dst.mkdir(parents=True, exist_ok=True)
    for so in build.BUILD_DIR.glob("*.so"):
        shutil.copy2(so, dst / so.name)
    results = []
    for tree in (ROOT, other, other, ROOT) * 2:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, __file__, "--worker",
                               str(tree)], capture_output=True, text=True,
                              timeout=300)
        line = next((ln for ln in proc.stdout.splitlines()
                     if ln.startswith("AB-RESULT ")), None)
        if proc.returncode or line is None:
            print(proc.stdout[-4000:], proc.stderr[-4000:], flush=True)
            return 1
        res = json.loads(line[len("AB-RESULT "):])
        res["wall_s"] = round(time.perf_counter() - t0, 1)
        results.append(res)
        print(json.dumps(res), flush=True)
    for tree in (ROOT, other):
        mine = [r for r in results if r["tree"] == str(tree)]
        print(json.dumps({"tree": str(tree), **{
            k: statistics.median(r[k] for r in mine)
            for k in ("llama_ms_step", "llama_serve_ms_tick",
                      "mamba_ms_step")}}), flush=True)
    same = len({r["tokens_sha256"] for r in results}) == 1
    print(f"tokens equal across the runs: {same}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
