#!/usr/bin/env python3
"""Where the host time of a megatick goes, on one card.

Llama-2-7B at published size (32 layers, bf16, seeded as
``chip_smoke.py``'s phase 4) decodes whole-batch sessions (B = 4,
128-token prompts) two ways: single steps (``DecodeSession.step()``) and
megaticks of 4 (``step(num_ticks=4)``), SpecEE for 32 ticks and T3 tree
(TreeSpec(3, 3)) for 16. Per strategy: 3 rounds in turns (single,
megatick, megatick, single, ...), each run's tokens held to the first
single run's, host-clock ms per tick around synchronised runs; then one
run of each under ``cProfile``, its host functions by own time (the
profiler inflates Python time, not the card's), with the calls per tick
of the tensor methods that read the card from the host (``__bool__``,
``__int__``, ``item``, ``cpu``, ``tolist``; counted by wrapping them for
that run only).

    python3 scripts/probe_megatick.py
"""
from __future__ import annotations

import cProfile
import io
import pstats
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

K, ROUNDS, TOP = 4, 3, 14
READS = ("__bool__", "__int__", "item", "cpu", "tolist")


def counted_reads(torch):
    """Wrap the tensor methods of ``READS`` to count their calls; returns
    (counts, a function that restores them)."""
    counts = dict.fromkeys(READS, 0)
    saved = {fn: getattr(torch.Tensor, fn) for fn in READS}

    def wrap(fn, orig):
        def f(self, *a, **kw):
            counts[fn] += 1
            return orig(self, *a, **kw)
        return f

    for fn, orig in saved.items():
        setattr(torch.Tensor, fn, wrap(fn, orig))

    def restore():
        for fn, orig in saved.items():
            setattr(torch.Tensor, fn, orig)
    return counts, restore


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print(__doc__)
        return 1
    from repro_torch.api import Engine, SpecEEStrategy
    from repro_torch.core import engine as eng
    from repro_torch.kernels import build
    from repro_torch.models.model import ModelFlags, build_model
    dev = torch.device("cuda", 0)
    print(cs.card_line(), flush=True)
    build.build_all()
    plain = build_model(cs.llama(32, "bfloat16"))
    gen = torch.Generator(device=dev).manual_seed(7)
    params = plain.init(gen, dev)
    sw = eng.init_specee(plain, gen, dev)
    prompts = np.random.default_rng(1).integers(0, cs.V, (cs.B, 128))
    tree = cs.tree_strategy().tree
    cells = (
        ("SpecEE", build_model(cs.llama(32, "bfloat16"), ModelFlags(
            exit_gate_kernel=True, exit_gate_impl="kernel",
            decode_kernel=True)), SpecEEStrategy(), 32, 33),
        ("tree", build_model(cs.llama(32, "bfloat16"),
                             ModelFlags(**cs.TREE_KERNELS)),
         cs.tree_strategy(), 16, 20 * (tree.depth + 1)))
    for label, model, strategy, n_ticks, budget in cells:
        def run(ticks):
            session = Engine.create(model, params, sw,
                                    strategy=strategy).new_session()
            session.prefill(prompts, max_new_tokens=budget)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = [session.step(num_ticks=ticks)
                   for _ in range(n_ticks // ticks)]
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            toks = [sum((r.row_tokens(b) for r in res), [])
                    for b in range(cs.B)]
            return dt, toks

        want = None
        times = {1: [], K: []}
        for r in range(ROUNDS):
            for ticks in ((1, K) if r % 2 == 0 else (K, 1)):
                dt, toks = run(ticks)
                want = toks if want is None else want
                if toks != want:
                    raise AssertionError(f"{label}: {ticks}-tick run's "
                                         "tokens differ")
                times[ticks].append(dt / n_ticks * 1e3)
        for ticks, name in ((1, "single steps"), (K, f"megaticks of {K}")):
            print(f"{label} {name}: ms/tick " + ", ".join(
                f"{t:.2f}" for t in times[ticks]) + f" (median "
                f"{statistics.median(times[ticks]):.2f})", flush=True)
        for ticks, name in ((1, "single steps"), (K, f"megaticks of {K}")):
            reads, restore = counted_reads(torch)
            prof = cProfile.Profile()
            try:
                prof.enable()
                dt, _ = run(ticks)
                prof.disable()
            finally:
                restore()
            out = io.StringIO()
            stats = pstats.Stats(prof, stream=out)
            print(f"{label} {name} under cProfile: {dt / n_ticks * 1e3:.2f} "
                  f"ms/tick; host reads per tick " + ", ".join(
                      f"{fn} {n / n_ticks:.2f}" for fn, n in reads.items()),
                  flush=True)
            stats.sort_stats("tottime").print_stats(TOP)
            print("\n".join(ln for ln in out.getvalue().splitlines()
                            if ln.strip()), flush=True)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
