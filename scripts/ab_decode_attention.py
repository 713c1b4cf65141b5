#!/usr/bin/env python3
"""A/B of the port's decode-attention kernels (dense, paged over bf16
pools, paged over int8 pools) between another version of
``src/repro_torch/csrc`` and this tree's, on one card.

Both versions are built side by side with ``nvcc`` (the flags of
``repro_torch.kernels.build``) and timed in one process, in alternating
order (base, tree, tree, base, then reversed), at the shapes of
``chip_smoke.py`` phase 2: dense B=4 over the full run's 162-slot cache
with 150 live keys, over a 4096-slot cache with 150 live keys, over 1024
and over 4096 live keys; paged B=8 with 128-token pages
at 785 (2 pages per row), 4563 (8 pages), 4103 (32 pages: one 4096-token
row among fresh ones), 32768 (32 pages: 8 x 4096) and 2203 live keys (32
pages: a serve tick of phase 5); bf16, 32 heads of 128. Each version is
called through its own C signature (the split-KV kernels take a
workspace and a split; a library that exports ``<name>_split_keys`` has
them). Every output is held against the plain version on the inputs
upcast to fp32 (atol 1e-4, rtol 2**-7) on its live rows; the paged
outputs must also be bit-equal between the versions (the dense kernel's
split-KV redesign sums in another order than its one-CTA-per-row
predecessor, so its outputs are held to the plain version only).

    git archive <commit> src/repro_torch/csrc | tar -x -C build/base
    python3 scripts/ab_decode_attention.py build/base/src/repro_torch/csrc

Prints the ptxas report of each build, then per case the median and range
of each version's device time per call (CUDA graph of 12-24 calls, CUDA
events) beside the case's byte bound at 3.35 TB/s, and the card's name and
power limit.
"""
from __future__ import annotations

import sys
from pathlib import Path

import ab_common as ab

NAMES = ("decode_attention", "paged_decode_attention",
         "paged_decode_attention_q")
H, HD, PAGE = 32, 128, 128
PAGED_CASES = ((2, [150, 1, 77, 149, 150, 128, 129, 1]),
               (8, [1024, 1, 700, 1000, 513, 1024, 300, 1]),
               (32, [4096, 1, 1, 1, 1, 1, 1, 1]),
               (32, [4096] * 8),
               # a serve tick of chip_smoke.py phase 5: its first eight
               # requests 16 tokens into decoding, on 4096-token rows
               (32, [140, 137, 437, 304, 344, 350, 399, 92]))
# (label, slots, live keys per row, distinct caches: > 50 MB of live K/V
# together where they fit, so each call reads its K/V from memory)
DENSE_CASES = (("dense, 150 live keys", 162, 150, 8),
               ("dense, 150 live keys of 4096 slots", 4096, 150, 8),
               ("dense, 1024 live keys", 1024, 1024, 2),
               ("dense, 4096 live keys", 4096, 4096, 2))


def paged_caller(lib, name: str):
    """``call(args, B, P, heads)``: a closure launching ``name`` of ``lib``
    on ``args`` (q, pools, [scale pools,] table, cache_len, out; ``heads``
    query and KV heads of HD) through the library's own signature: with a
    workspace and the library's split when it exports
    ``<name>_split_keys``."""
    import torch
    n_in = 8 if name.endswith("_q") else 6
    if not hasattr(lib, f"{name}_split_keys"):
        fn = ab.c_fn(lib, f"{name}_launch", n_in, 8)

        def call(args, B, P, heads=H):
            return lambda: fn(*map(ab.ptr, args), B, P, PAGE, heads, heads,
                              HD, 0, 1, ab.stream())
        return call
    fn = ab.c_fn(lib, f"{name}_launch", n_in + 2, 9)
    split_keys = getattr(lib, f"{name}_split_keys")

    def call(args, B, P, heads=H):
        split = split_keys(P, PAGE)
        n_split = -(-P * PAGE // split)
        dev = args[0].device
        ws = torch.empty(B * heads * n_split * (HD + 2), dtype=torch.float32,
                         device=dev)
        tickets = torch.zeros(B * heads, dtype=torch.int32, device=dev)
        return lambda: fn(*map(ab.ptr, args), ab.ptr(ws), ab.ptr(tickets), B,
                          P, PAGE, heads, heads, HD, 0, split, 1, ab.stream())
    return call


def dense_caller(lib):
    """``call(args, B, S)``: a closure launching ``decode_attention`` of
    ``lib`` on ``args`` (q, k, v, cache_len, out; H query and KV heads of
    HD) through the library's own signature: with a workspace and the
    library's split when it exports ``decode_attention_split_keys``."""
    import torch
    if not hasattr(lib, "decode_attention_split_keys"):
        fn = ab.c_fn(lib, "decode_attention_launch", 5, 7)
        return lambda args, B, S: lambda: fn(*map(ab.ptr, args), B, S, H, H,
                                             HD, 0, 1, ab.stream())
    fn = ab.c_fn(lib, "decode_attention_launch", 7, 8)
    split_keys = lib.decode_attention_split_keys

    def call(args, B, S):
        split = split_keys(S, HD, 2)
        dev = args[0].device
        ws = torch.empty(B * H * -(-S // split) * (HD + 2),
                         dtype=torch.float32, device=dev)
        tickets = torch.zeros(B * H, dtype=torch.int32, device=dev)
        return lambda: fn(*map(ab.ptr, args), ab.ptr(ws), ab.ptr(tickets), B,
                          S, H, H, HD, 0, split, 1, ab.stream())
    return call


def main() -> int:
    import numpy as np
    import torch
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__)
        return 1
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_ref, paged_decode_attention_ref)
    from repro_torch.models.model import _kv_quantize
    fns = {}
    for tag, src in (("base", Path(sys.argv[1]).resolve()),
                     ("tree", ab.CSRC)):
        for name in NAMES:
            lib, _, report = ab.build(tag, src, name,
                                      ab.ROOT / "build" / "ab")
            print(f"{tag} {name}: {ab.registers(report)}", flush=True)
            fns[(tag, name)] = (dense_caller(lib)
                                if name == "decode_attention"
                                else paged_caller(lib, name))
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    cases, outs, bounds, checks = {}, {}, {}, []
    for label, S, live, n in DENSE_CASES:
        B = 4
        q, out = rnd((B, 1, H, HD)), torch.empty(B, 1, H, HD, device=dev,
                                                 dtype=torch.bfloat16)
        cl = torch.full((B,), live, dtype=torch.int32, device=dev)
        caches = [(rnd((B, S, H, HD)), rnd((B, S, H, HD))) for _ in range(n)]

        def calls(tag, q=q, out=out, cl=cl, caches=caches, B=B, S=S):
            call = fns[(tag, "decode_attention")]
            return [call((q, c[0], c[1], cl, out), B, S)
                    for c in caches] * (24 // n)
        cases[label], outs[label] = calls, out
        bounds[label] = (2 * B * live + 2 * B) * H * HD * 2 / 3.35e9
        k, v = caches[0]
        checks.append((label, decode_attention_ref(
            q.float(), k.float(), v.float(), cl), B))
    dense = list(cases)
    for P, lens in PAGED_CASES:
        B, NP = len(lens), len(lens) * P + 5
        live = sum(lens)
        q, out = rnd((B, 1, H, HD)), torch.empty(B, 1, H, HD, device=dev,
                                                 dtype=torch.bfloat16)
        cl = torch.tensor(lens, dtype=torch.int32, device=dev)
        retired = lens[-1] == 1
        sets = {"paged_decode_attention": [], "paged_decode_attention_q": []}
        for j in range(4):
            perm = np.random.default_rng(j).permutation(NP)[:B * P]
            table = torch.as_tensor(perm.reshape(B, P).astype(np.int32),
                                    device=dev)
            if retired:
                table[-1] = NP                 # a retired row: trash page
            sets["paged_decode_attention"].append(
                (q, rnd((NP + 1, PAGE, H, HD)), rnd((NP + 1, PAGE, H, HD)),
                 table, cl, out))
            pools = []
            for _ in range(2):
                codes, scale = _kv_quantize(rnd((NP + 1, PAGE, H, HD),
                                                torch.float32))
                codes[-1], scale[-1] = 0, 0.0
                pools += [codes, scale]
            sets["paged_decode_attention_q"].append(
                (q, pools[0], pools[2], pools[1], pools[3], table, cl, out))
        for name, args in sets.items():
            label = f"{name}, {live} live keys ({P} pages/row)"

            def calls(tag, name=name, args=args, B=B, P=P):
                call = fns[(tag, name)]
                return [call(a, B, P) for a in args] * 3
            cases[label], outs[label] = calls, out
            a = args[0]
            if name.endswith("_q"):
                plain = paged_decode_attention_ref(
                    q.float(), a[1], a[2], a[5], cl, None, a[3], a[4])
                nbytes = live * H * (2 * HD + 8)
            else:
                plain = paged_decode_attention_ref(
                    q.float(), a[1].float(), a[2].float(), a[3], cl)
                nbytes = 2 * live * H * HD * 2
            bounds[label] = (nbytes + 2 * B * H * HD * 2
                             + B * (P + 1) * 4) / 3.35e9
            checks.append((label, plain, B - retired))

    got = {}
    for label, calls in cases.items():
        for tag in ("base", "tree"):
            if calls(tag)[0]() != 0:
                raise RuntimeError(f"{label}: {tag} launch failed")
            torch.cuda.synchronize()
            got[(label, tag)] = outs[label].clone()
        if label not in dense and not torch.equal(got[(label, "base")],
                                                  got[(label, "tree")]):
            raise AssertionError(f"{label}: outputs differ between versions")
    for label, plain, n in checks:
        for tag in ("base", "tree"):
            o = got[(label, tag)].float()[:n]
            torch.testing.assert_close(o, plain[:n], atol=1e-4,
                                       rtol=2.0 ** -7)
            err = (o - plain[:n]).abs().max().item()
            print(f"{label}: {tag} max abs err {err:.3g} against the plain "
                  f"version", flush=True)
    times = ab.alternate(cases)
    for label in cases:
        held = ("both held to the plain version" if label in dense else
                "outputs bit-equal, both held to the plain version")
        print(f"{label}: {held}; bound "
              f"{bounds[label]:.4f} ms; " + "; ".join(
                  f"{tag} {ab.summary(times[(label, tag)])}"
                  for tag in ("base", "tree")), flush=True)
    print(ab.card())
    return 0


if __name__ == "__main__":
    sys.exit(main())
