#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
Hopper card: builds the port's CUDA kernels, holds each against its plain
PyTorch version, and drives greedy SpecEE decode of Llama-2-7B through the
port's public entry points.

    python3 chip_smoke.py

Phases (one line each, ``[phase] ...``):
  1. device + build — the card's name and power limit, then ``nvcc`` builds
     every kernel of ``src/repro_torch/csrc`` for sm_90a (in parallel);
  2. kernels — each kernel vs its plain version at the decode path's shapes
     (B=4, D=4096, V=32000, k=4, H=512, 32 heads of 128, caches up to 1024)
     in fp32 and bf16, then timed beside its plain version, a library call
     as yardstick, and the least time the card could take (bound);
  3. parity — llama2-7b at full width, 4 layers, fp32, seeded weights:
     Engine.create → new_session → prefill(4 prompts) → step x 8 at
     thresholds 1.5, 0.4, -0.1, with the kernels and with the plain
     versions; tokens, exit points and exits must match, threshold 1.5 must
     equal dense decoding, and an oracle speculative set must force exits;
  4. full run — llama2-7b, 32 layers, bf16, 4 prompts of 128 tokens,
     32 SpecEE decode steps; the kernel launch counts are zeroed right
     before and read right after;
  5. the ``{"kernels": [...]}`` line, the card line, and as the last line
     ``{"ok": true, "device": {...}}``.

Any failure exits non-zero without the last line. Without a CUDA card, or
without the repository beside this file, it fails at once.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Published peaks of one H100 SXM (NVIDIA data sheet, dense): HBM rate and
# the arithmetic rate for each input type (bf16 on the tensor cores, fp32
# outside them).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}

REPLACES = {
    "exit_gate": "src/repro/kernels/exit_gate/exit_gate.py:126",
    "argmax_verify": "src/repro/kernels/exit_gate/exit_gate.py:232",
    "topk_verify": "src/repro/kernels/exit_gate/exit_gate.py:336",
    "decode_attention":
        "src/repro/kernels/decode_attention/decode_attention.py:143",
}

B, D, V, K_SPEC, H_PRED = 4, 4096, 32000, 4, 512
HEADS, HD = 32, 128
FULL_PROMPT, FULL_STEPS = 128, 32


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------
def graph_ms(torch, calls) -> float:
    """Device time of one call, from a CUDA graph replaying ``calls`` (a
    list of closures, e.g. over distinct buffers so caches start cold)
    back to back; host launch cost is outside the graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm up off the default stream
        for fn in calls[:3]:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for fn in calls:
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    reps = 5
    start.record()
    for _ in range(reps):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * len(calls))


def bound_ms(nbytes: float, ops: float, dtype_name: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------
def check_kernels(torch, dev):
    import torch.nn.functional as F
    from repro_torch import kernels as K
    from repro_torch.kernels.decode_attention.decode_attention import (
        decode_attention_fwd)
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.exit_gate import exit_gate as eg
    from repro_torch.kernels.exit_gate import ref as gref

    gen = torch.Generator(device=dev).manual_seed(1234)

    def rnd(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale
                ).to(dtype)

    rows = {}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[1]
        hn = rnd((B, D), dt)
        w = rnd((D, V), dt, 0.05)
        # tolerances: the kernels and the plain versions both sum fp32
        # products of the same (upcast) inputs, in different orders —
        # atol = rtol = 1e-4 on logits of size ~3; ids exact (the top-2 gap
        # of random logits dwarfs fp32 rounding)
        tok, mx = eg.argmax_verify_fused(hn, w)
        tok_r, mx_r = gref.verify_argmax_ref(hn, w)
        require(torch.equal(tok, tok_r), f"argmax ids differ ({name})")
        torch.testing.assert_close(mx, mx_r, atol=1e-4, rtol=1e-4)
        err_av = (mx - mx_r).abs().max().item()
        ids, vals = eg.topk_verify_fused(hn, w, K_SPEC)
        ids_r, vals_r = gref.verify_topk_ref(hn, w, K_SPEC)
        require(torch.equal(ids, ids_r), f"top-k ids differ ({name})")
        torch.testing.assert_close(vals, vals_r, atol=1e-4, rtol=1e-4)
        err_tk = (vals - vals_r).abs().max().item()
        # ties: duplicated best columns resolve to the lowest id
        wt = w.clone()
        best = int(tok[0])
        for j in (3, (best + 1) % V, V - 1):
            wt[:, j] = wt[:, best]
        want = sorted({3, best, (best + 1) % V, V - 1})
        require(int(eg.argmax_verify_fused(hn, wt)[0][0]) == want[0],
                f"argmax tie-break ({name})")
        require(eg.topk_verify_fused(hn, wt, K_SPEC)[0][0].tolist()
                == want[:4], f"top-k tie-break ({name})")
        del wt

        spec_ids = torch.randint(0, V, (B, K_SPEC), generator=gen,
                                 device=dev, dtype=torch.int32)
        prev = torch.softmax(rnd((B, K_SPEC), torch.float32), -1)
        w1 = rnd((3 * K_SPEC, H_PRED), torch.float32, 12 ** -0.5)
        b1 = rnd((H_PRED,), torch.float32, 0.1)
        w2 = rnd((H_PRED, 1), torch.float32, H_PRED ** -0.5)
        b2 = rnd((1,), torch.float32, 0.1)
        got = eg.exit_gate_fused(hn, w, spec_ids, prev, w1, b1, w2, b2)
        pred = {"layers": [{"w": w1, "b": b1}, {"w": w2, "b": b2}]}
        want_g = gref.exit_gate_ref(hn, w, spec_ids, prev, pred)
        err_eg = 0.0
        for a, b in zip(got, want_g):
            # fp32 gate on upcast inputs: atol = rtol = 1e-4
            torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
            err_eg = max(err_eg, (a - b).abs().max().item())

        err_da = 0.0
        # attention: the kernel keeps scores, probabilities and sums in
        # fp32, so the plain version runs on the same inputs upcast to fp32
        # (exact for bf16). atol 1e-4 covers the summation order; in bf16
        # rtol 2**-7: rounding the output to bf16 errs by at most 2**-8
        # relative — dropping one of 150 keys moves an output by ~5 %
        rtol = 1e-4 if dt == torch.float32 else 2.0 ** -7
        for S, clen, window in ((FULL_PROMPT + FULL_STEPS + 2,
                                 [150, 150, 150, 150], None),
                                (1024, [1024, 700, 300, 1], None),
                                (1024, [1024, 700, 300, 1], 256)):
            q = rnd((B, 1, HEADS, HD), dt)
            kc = rnd((B, S, HEADS, HD), dt)
            vc = rnd((B, S, HEADS, HD), dt)
            cl = torch.tensor(clen, dtype=torch.int32, device=dev)
            o = decode_attention_fwd(q, kc, vc, cl, window=window).float()
            o_r = decode_attention_ref(q.float(), kc.float(), vc.float(), cl,
                                       window)
            torch.testing.assert_close(o, o_r, atol=1e-4, rtol=rtol)
            err_da = max(err_da, (o - o_r).abs().max().item())
        torch.cuda.synchronize()
        log("kernels", f"{name}: argmax ids exact, max err {err_av:.3g}; "
            f"top-k ids exact, err {err_tk:.3g}; ties -> lowest id; "
            f"exit_gate err {err_eg:.3g}; decode_attention err {err_da:.3g}")
        rows[name] = {"argmax_verify": err_av, "topk_verify": err_tk,
                      "exit_gate": err_eg, "decode_attention": err_da}
        del hn, w

    # ---- timing at the full run's shapes and dtype (bf16) ----
    dt, dname = torch.bfloat16, "bfloat16"
    hn = rnd((B, D), dt)
    w = rnd((D, V), dt, 0.05)
    n = 20
    t = {}
    t["argmax_verify"] = (
        graph_ms(torch, [lambda: eg.argmax_verify_fused(hn, w)] * n),
        graph_ms(torch, [lambda: gref.verify_argmax_ref(hn, w)] * n),
        graph_ms(torch, [lambda: torch.argmax(hn @ w, -1)] * n),
        bound_ms(B * D * 2 + D * V * 2 + B * 8, 2 * B * D * V, dname))
    t["topk_verify"] = (
        graph_ms(torch, [lambda: eg.topk_verify_fused(hn, w, K_SPEC)] * n),
        graph_ms(torch, [lambda: gref.verify_topk_ref(hn, w, K_SPEC)] * n),
        graph_ms(torch, [lambda: torch.topk(hn @ w, K_SPEC, -1)] * n),
        bound_ms(B * D * 2 + D * V * 2 + B * K_SPEC * 8, 2 * B * D * V,
                 dname))
    ids_sets = [torch.randint(0, V, (B, K_SPEC), generator=gen, device=dev,
                              dtype=torch.int32) for _ in range(n)]
    prev = torch.softmax(rnd((B, K_SPEC), torch.float32), -1)
    w1 = rnd((3 * K_SPEC, H_PRED), torch.float32, 12 ** -0.5)
    b1 = rnd((H_PRED,), torch.float32)
    w2 = rnd((H_PRED, 1), torch.float32, H_PRED ** -0.5)
    b2 = rnd((1,), torch.float32)
    pred = {"layers": [{"w": w1, "b": b1}, {"w": w2, "b": b2}]}
    gate_bytes = (B * D * 2 + B * K_SPEC * D * 2 + B * K_SPEC * 8
                  + (3 * K_SPEC * H_PRED + 2 * H_PRED + 1) * 4
                  + B * (1 + 2 * K_SPEC) * 4)
    gate_ops = B * (2 * K_SPEC * D + 2 * 3 * K_SPEC * H_PRED + 4 * H_PRED)
    # distinct speculative ids per call: the gathered columns start cold
    t["exit_gate"] = (
        graph_ms(torch, [lambda i=i: eg.exit_gate_fused(
            hn, w, i, prev, w1, b1, w2, b2) for i in ids_sets]),
        graph_ms(torch, [lambda i=i: gref.exit_gate_ref(hn, w, i, prev, pred)
                         for i in ids_sets]),
        None,
        bound_ms(gate_bytes, gate_ops, "float32"))
    # the full run's attention: S slots, 150 live per row; 8 distinct
    # caches (>50 MB together) so each call reads its K/V from memory, as a
    # decode step does after the layer's weights have passed through L2
    S, live = FULL_PROMPT + FULL_STEPS + 2, 150
    q = rnd((B, 1, HEADS, HD), dt)
    cl = torch.full((B,), live, dtype=torch.int32, device=dev)
    caches = [(rnd((B, S, HEADS, HD), dt), rnd((B, S, HEADS, HD), dt))
              for _ in range(8)]
    mask = (torch.arange(S, device=dev) < live)[None, None, None, :]
    qs = q.transpose(1, 2)
    kv_t = [(k.transpose(1, 2), v.transpose(1, 2)) for k, v in caches]
    da_bytes = 2 * B * live * HEADS * HD * 2 + 2 * B * HEADS * HD * 2 + B * 4
    da_ops = 4 * B * live * HEADS * HD
    t["decode_attention"] = (
        graph_ms(torch, [lambda c=c: decode_attention_fwd(q, c[0], c[1], cl)
                         for c in caches] * 3),
        graph_ms(torch, [lambda c=c: decode_attention_ref(q, c[0], c[1], cl)
                         for c in caches] * 3),
        graph_ms(torch, [lambda c=c: F.scaled_dot_product_attention(
            qs, c[0], c[1], attn_mask=mask) for c in kv_t] * 3),
        bound_ms(da_bytes, da_ops, dname))
    # one more attention time at a 1024-slot cache, fully live
    big = [(rnd((B, 1024, HEADS, HD), dt), rnd((B, 1024, HEADS, HD), dt))
           for _ in range(2)]
    cl_big = torch.full((B,), 1024, dtype=torch.int32, device=dev)
    ms_big = graph_ms(torch, [lambda c=c: decode_attention_fwd(
        q, c[0], c[1], cl_big) for c in big] * 4)
    b_big = bound_ms(2 * B * 1024 * HEADS * HD * 2, 0, dname)[0]
    log("kernels", f"decode_attention at 1024 live slots, bf16: "
        f"{ms_big:.4f} ms (bound {b_big:.4f} ms)")
    for name, (ms, plain, lib, (bnd, by)) in t.items():
        lib_s = "n/a" if lib is None else f"{lib:.4f} ms"
        log("kernels", f"{name} bf16 timing: kernel {ms:.4f} ms, plain "
            f"{plain:.4f} ms, library {lib_s}, bound {bnd:.4f} ms ({by})")
    K.reset_launches()
    return rows["bfloat16"], t


# ---------------------------------------------------------------------------
# phases 3 and 4: the decode path through the public entry points
# ---------------------------------------------------------------------------
def llama(layers: int, dtype: str):
    import dataclasses
    from repro_torch.configs import get_config
    run = get_config("llama2-7b")
    return dataclasses.replace(run, model=dataclasses.replace(
        run.model, num_layers=layers, dtype=dtype))


def drive(model, params, sw, strategy, prompts, new_tokens):
    from repro_torch.api import Engine
    session = Engine.create(model, params, sw,
                            strategy=strategy).new_session()
    results = [session.prefill(prompts, max_new_tokens=new_tokens)]
    while not session.all_done():
        results.append(session.step())
    return results


def parity(torch, dev):
    import numpy as np
    from repro_torch.api import DenseStrategy, SpecEEStrategy
    from repro_torch.core import engine as eng
    from repro_torch.models.model import ModelFlags, build_model
    run = llama(4, "float32")
    m_plain = build_model(run)
    m_ker = build_model(run, ModelFlags(exit_gate_kernel=True,
                                        exit_gate_impl="kernel",
                                        decode_kernel=True))
    gen = torch.Generator(device=dev).manual_seed(0)
    params = m_plain.init(gen, dev)
    sw = eng.init_specee(m_plain, gen, dev)
    prompts = np.random.default_rng(0).integers(0, V, (B, 16))

    def summary(results):
        return [(r.tokens.tolist(), r.exit_layer.tolist(), r.exited.tolist(),
                 r.units_run) for r in results]

    for thresh in (1.5, 0.4, -0.1):
        a = summary(drive(m_ker, params, sw,
                          SpecEEStrategy(threshold=thresh), prompts, 9))
        b = summary(drive(m_plain, params, sw,
                          SpecEEStrategy(threshold=thresh), prompts, 9))
        require(a == b, f"kernel vs plain run differs at threshold {thresh}")
        exits = sum(sum(x) for _, _, x, _ in a[1:])
        log("parity", f"threshold {thresh}: 8 steps, tokens/exit points/"
            f"exits identical with kernels and plain versions "
            f"({exits} exits)")
        if thresh == 1.5:
            dense = summary(drive(m_ker, params, sw, DenseStrategy(),
                                  prompts, 9))
            require([r[0] for r in dense] == [r[0] for r in a],
                    "specee at threshold 1.5 differs from dense")
            log("parity", "threshold 1.5 equals dense greedy decoding")

    # oracle speculative set: the full-head argmax after unit 1 forces an
    # exit there (threshold < 0) — exercises verify, exit and propagation
    toks = {"tokens": torch.as_tensor(prompts, device=dev)}
    first, probe = eng.init_decode_state(m_plain, params, sw, toks, 24)
    h = m_plain.embed(params, first[:, None])[:, 0, :]
    layer_argmax = []
    for u in range(2):
        h, _ = m_plain.run_unit(params, 0, u, h, probe.cache["segments"][0],
                                probe.cache["len"])
        layer_argmax.append(torch.argmax(m_plain.logits(params, h), -1))
    oracle = layer_argmax[1].to(torch.int32)
    # a row exits at the first unit whose argmax is in the set: unit 0 if
    # its argmax already equals the oracle token, else unit 1
    expect = torch.where(layer_argmax[0] == layer_argmax[1], 0, 1).tolist()
    outs = []
    for m in (m_ker, m_plain):
        _, st = eng.init_decode_state(m, params, sw, toks, 24)
        tok, st, info = eng.ar_decode_step(
            m, params, sw, st, threshold=-0.1,
            spec_ids_override=oracle[:, None].expand(B, K_SPEC))
        require(bool(info.exited.all())
                and info.exit_point.tolist() == expect
                and info.units_run == max(expect) + 1
                and torch.equal(tok, oracle),
                f"oracle set: exits {info.exit_point.tolist()}, expected "
                f"{expect}")
        outs.append((tok.tolist(), st.cache["segments"][0]["u0"]["k"]))
    require(outs[0][0] == outs[1][0], "oracle exit tokens differ")
    torch.testing.assert_close(outs[0][1], outs[1][1], atol=1e-4, rtol=1e-4)
    log("parity", f"oracle set: every row exits (exit points {expect}) with "
        "the verified token; propagated K/V equal (atol 1e-4) with kernels "
        "and plain")
    del params, sw


def full_run(torch, dev):
    import numpy as np
    from repro_torch import kernels as K
    from repro_torch.api import DenseStrategy, Engine, SpecEEStrategy
    from repro_torch.core import engine as eng
    from repro_torch.models.model import ModelFlags, build_model
    run = llama(32, "bfloat16")
    model = build_model(run, ModelFlags(exit_gate_kernel=True,
                                        exit_gate_impl="kernel",
                                        decode_kernel=True))
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(7)
    params = model.init(gen, dev)
    sw = eng.init_specee(model, gen, dev)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(params))
    log("full", f"llama2-7b 32 layers bf16: {n_params / 1e9:.3f} B params "
        f"seeded on the card in {time.perf_counter() - t0:.1f} s")
    prompts = np.random.default_rng(1).integers(0, V, (B, FULL_PROMPT))
    torch.cuda.reset_peak_memory_stats()

    K.reset_launches()                     # ---- the main path ----
    session = Engine.create(model, params, sw,
                            strategy=SpecEEStrategy()).new_session()
    t0 = time.perf_counter()
    first = session.prefill(prompts, max_new_tokens=FULL_STEPS + 1)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    steps = []
    t0 = time.perf_counter()
    for _ in range(FULL_STEPS):
        steps.append(session.step())
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)            # ---- read right after ----

    require(session.all_done(), "session not done after the budget")
    toks = np.stack([r.tokens[:, 0] for r in [first] + steps], 1)
    require(toks.shape == (B, FULL_STEPS + 1), f"token shape {toks.shape}")
    require(((toks >= 0) & (toks < V)).all(), "token out of vocabulary")
    require(bool(torch.isfinite(session._state.h_last.float()).all()),
            "non-finite hidden state")
    exits = sum(int(r.exited.sum()) for r in steps)
    units = [r.units_run for r in steps]
    log("full", f"prefill {B}x{FULL_PROMPT} in {t_prefill:.3f} s; "
        f"{FULL_STEPS} steps in {t_decode:.3f} s = "
        f"{B * FULL_STEPS / t_decode:.2f} tokens/s "
        f"({t_decode / FULL_STEPS * 1e3:.2f} ms/step); exits per token "
        f"{exits / (B * FULL_STEPS):.4f}; mean units_run "
        f"{sum(units) / len(units):.2f} of {model.num_exit_points}; peak "
        f"card memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log("full", "launches: " + ", ".join(
        f"{k} {v} ({v / FULL_STEPS:.2f}/step)" for k, v in launches.items()))
    missing = [k for k, v in launches.items() if v == 0]
    require(not missing, f"kernels never launched on the main path: "
            f"{missing}")
    if exits == 0:
        # no row exited, so SpecEE must emit dense greedy decoding's tokens
        dense = drive(model, params, sw, DenseStrategy(), prompts,
                      FULL_STEPS + 1)
        require(np.array_equal(np.stack([r.tokens[:, 0] for r in dense], 1),
                               toks), "full run differs from dense greedy")
        log("full", "no row exited: tokens equal dense greedy decoding")
    profile_steps(torch, model, params, sw, prompts, t_decode / FULL_STEPS)
    return launches


# where the device time of a decode step goes, by kernel family
FAMILIES = (("argmax_verify", ("argmax_partial", "argmax_merge")),
            ("topk_verify", ("topk_partial", "topk_merge")),
            ("exit_gate", ("exit_gate_kernel",)),
            ("decode_attention", ("decode_attention_kernel",)),
            ("matmul", ("gemm", "gemv", "cutlass", "cublas", "sm90_xmma",
                        "splitK", "nvjet")))


def profile_steps(torch, model, params, sw, prompts, step_s: float,
                  n: int = 4) -> None:
    """torch.profiler over ``n`` more SpecEE steps: device time per kernel
    family per step, and the device's busy share of the profiled wall time
    (the profiler's own cost inflates that wall time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.api import Engine, SpecEEStrategy
    session = Engine.create(model, params, sw,
                            strategy=SpecEEStrategy()).new_session()
    session.prefill(prompts, max_new_tokens=n + 1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            session.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    fam = {name: 0.0 for name, _ in FAMILIES}
    fam["other"] = 0.0
    total = 0.0
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        total += us / 1e3
        for name, keys in FAMILIES:
            if any(k in evt.key for k in keys):
                fam[name] += us / 1e3
                break
        else:
            fam["other"] += us / 1e3
    if total == 0.0:
        log("profile", "the profiler recorded no device time")
        return
    log("profile", f"{n} steps: wall {wall_ms / n:.2f} ms/step profiled "
        f"({step_s * 1e3:.2f} unprofiled), device busy "
        f"{total / n:.2f} ms/step = {100 * total / wall_ms:.1f}% of the "
        f"profiled wall; " + ", ".join(
            f"{k} {v / n:.3f} ms/step" for k, v in
            sorted(fam.items(), key=lambda kv: -kv[1])))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device (torch.cuda.is_available() is False)",
              flush=True)
        return 1
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print(f"FAIL: the port (src/repro_torch) is not beside {__file__}",
              flush=True)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 stays fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    card = card_line()
    log("device", f"{card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} card(s)")
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    reports = build.build_all()
    for name, rep in reports.items():
        regs = [ln.strip() for ln in rep.splitlines() if "registers" in ln]
        log("build", f"{rep.splitlines()[0]}; " + " | ".join(regs[:6]))
    log("build", f"{len(build.SOURCES)} kernels ready in "
        f"{time.perf_counter() - t0:.1f} s")

    errs, timing = check_kernels(torch, dev)
    torch.cuda.empty_cache()
    parity(torch, dev)
    torch.cuda.empty_cache()
    launches = full_run(torch, dev)

    sources = {"exit_gate": "exit_gate.cu", "argmax_verify":
               "argmax_verify.cu", "topk_verify": "topk_verify.cu",
               "decode_attention": "decode_attention.cu"}
    kernels = []
    for name in build.SOURCES:
        ms, plain, lib, (bnd, by) = timing[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{sources[name]}",
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain,
            "bound_ms": bnd, "bound_by": by, "library_ms": lib})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:                      # any failed phase fails the run
        traceback.print_exc()
        print("FAIL: a phase failed (traceback above)", flush=True)
        code = 1
    sys.exit(code)
