#!/usr/bin/env python3
"""Per-CTA probes of the port's split-KV paged decode-attention kernels
(bf16 pools and int8 pools) on one card: what one call costs when little
is live, what one CTA streams alone, what a split row's merge adds, and
what the grid's CTAs past the live keys cost.

    python3 scripts/probe_paged_attention.py [other csrc]

Builds ``paged_decode_attention.cu`` and ``paged_decode_attention_q.cu``
of this tree (or of the given ``src/repro_torch/csrc``) with the port's
nvcc flags and times each case in a CUDA graph of 12 calls on 4 distinct
pool sets (CUDA events), bf16 queries, hd 128, 128-token pages. Cases:
  - floor: one KV head, one row of 1 key;
  - one CTA alone: one KV head, one row of one split's keys; then of two
    splits (two CTAs side by side, then the merge: the difference is the
    merge's cost);
  - the grid's spare CTAs: a serve tick (32 KV heads, phase 5's first
    eight requests 16 tokens into decoding) over 32-page rows, then over
    5-page rows (the same live keys, a quarter of the CTAs).
Prints per case the device time per call and the rate of K and V bytes
read, then the card's name and power limit.
"""
from __future__ import annotations

import sys
from pathlib import Path

import ab_common as ab
import ab_decode_attention as abd

HD, PAGE = 128, 128
SERVE_TICK = [140, 137, 437, 304, 344, 350, 399, 92]


def main() -> int:
    import numpy as np
    import torch
    if len(sys.argv) > 2 or not torch.cuda.is_available():
        print(__doc__)
        return 1
    src = Path(sys.argv[1]).resolve() if len(sys.argv) == 2 else ab.CSRC
    from repro_torch.models.model import _kv_quantize
    callers, splits = {}, {}
    for name in abd.NAMES[1:]:
        lib, _, report = ab.build("probe", src, name,
                                  ab.ROOT / "build" / "probe")
        print(f"{name}: {ab.registers(report)}", flush=True)
        callers[name] = abd.paged_caller(lib, name)
        splits[name] = getattr(lib, f"{name}_split_keys")(32, PAGE)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def calls(name, lens, kvh, P):
        B, NP = len(lens), len(lens) * P + 5
        q = rnd((B, 1, kvh, HD))
        out = torch.empty_like(q)
        cl = torch.tensor(lens, dtype=torch.int32, device=dev)
        sets = []
        for j in range(4):
            perm = np.random.default_rng(j).permutation(NP)[:B * P]
            table = torch.as_tensor(perm.reshape(B, P).astype(np.int32),
                                    device=dev)
            if name.endswith("_q"):
                pools = []
                for _ in range(2):
                    pools += list(_kv_quantize(rnd((NP + 1, PAGE, kvh, HD),
                                                   torch.float32)))
                sets.append((q, pools[0], pools[2], pools[1], pools[3],
                             table, cl, out))
            else:
                sets.append((q, rnd((NP + 1, PAGE, kvh, HD)),
                             rnd((NP + 1, PAGE, kvh, HD)), table, cl, out))
        return [callers[name](a, B, P, kvh) for a in sets] * 3

    for name in abd.NAMES[1:]:
        split = splits[name]
        item = 1 if name.endswith("_q") else 2
        cases = (("floor: 1 head, 1 key", [1], 1, 32),
                 (f"one CTA: 1 head, {split} keys", [split], 1, 32),
                 (f"two splits: 1 head, {2 * split} keys", [2 * split], 1,
                  32),
                 ("serve tick, 32 heads, 32-page rows", SERVE_TICK, 32, 32),
                 ("serve tick, 32 heads, 5-page rows", SERVE_TICK, 32, 5))
        for label, lens, kvh, P in cases:
            ms = ab.graph_ms(calls(name, lens, kvh, P))
            nbytes = 2 * sum(lens) * kvh * HD * item
            print(f"{name}, {label}: {ms * 1e3:.2f} us, "
                  f"{nbytes / ms / 1e6:.1f} GB/s", flush=True)
    print(ab.card())
    return 0


if __name__ == "__main__":
    sys.exit(main())
