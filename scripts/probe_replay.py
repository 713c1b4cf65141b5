#!/usr/bin/env python3
"""Does a served request decode the same whatever its slot and the rows
beside it, on the card? Eviction and restore re-prefill a request and
verify its recorded tokens, so a row's numbers must not depend on either.

Llama-2-7B at published size (32 layers, bf16, seeded as
``chip_smoke.py``'s phase 5) serves one request (phase 5's first prompt,
32 new tokens) through ``chip_smoke.fault_engine`` (SpecEE, blocking
admission, 8 slots of 1024 tokens) at one tick a step: (a) alone, in slot
0; (b) admitted at the third tick into slot 3 beside 3 requests admitted
before it, with 4 more admitted after it. After each of its decode ticks
the row's final hidden state and its logits (``Model.logits`` on it) are
read; the two runs must agree bit for bit, and so must its tokens and exit
points. Prints the first tick that differs, with the largest difference
and the top-2 logit margin there.

    python3 scripts/probe_replay.py
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

NEW = 32


def serve(torch, params, sw, prompts, target: int, admit_at):
    """Serve ``prompts`` one tick a step, submitting prompt ``i`` before
    step ``admit_at[i]``; return the target's (tokens, exit points, slot,
    per-tick hidden rows, per-tick logits). At one tick a step, a step
    that admits the target also decodes its first tick."""
    se = cs.fault_engine(torch, params, sw, cs.FAULT_REF_PAGES, megatick=1)
    reqs, hidden, logits, slot, tick = {}, [], [], None, 0
    while len(reqs) < len(prompts) or se.busy:
        for i, at in enumerate(admit_at):
            if at == tick:
                reqs[i] = se.submit(prompts[i], max_new_tokens=NEW)
        req = reqs.get(target)
        before = len(req.output) if req is not None else 0
        se.step()
        tick += 1
        if req is None or len(req.output) == before:
            continue
        if slot is None:
            slot = next(s for s, r in enumerate(se.slots) if r is req)
        h = se.session._state.h_last[slot:slot + 1]
        hidden.append(h.float().cpu())
        logits.append(se.model.logits(se.engine.params, h).float().cpu())
    torch.cuda.synchronize()
    req = reqs[target]
    se.close()
    return req.output, req.exit_points, slot, hidden, logits


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print(__doc__)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(cs.card_line(), flush=True)
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.build_all()
    print(f"built the kernels in {time.perf_counter() - t0:.1f} s",
          flush=True)
    params, sw = cs.full_weights(torch, dev)
    prompts = cs.serve_prompts()[:8]
    alone = serve(torch, params, sw, prompts[:1], 0, [0])
    # three first, the target at tick 2 (slot 3), four more later
    crowd = serve(torch, params, sw, prompts[1:4] + prompts[:1] + prompts[4:],
                  3, [0, 0, 0, 2, 5, 6, 9, 12])
    (tok_a, ex_a, slot_a, h_a, lg_a), (tok_b, ex_b, slot_b, h_b, lg_b) = \
        alone, crowd
    first = next((t for t, (x, y) in enumerate(zip(lg_a, lg_b))
                  if not torch.equal(x, y)), None)
    summary = {"slots": [slot_a, slot_b], "ticks": [len(lg_a), len(lg_b)],
               "tokens_equal": tok_a == tok_b,
               "exit_points_equal": ex_a == ex_b,
               "hidden_bit_equal": all(torch.equal(x, y)
                                       for x, y in zip(h_a, h_b)),
               "logits_bit_equal": first is None, "first_differing_tick": first}
    if first is not None:
        x, y = lg_a[first][0], lg_b[first][0]
        top = torch.topk(x, 2).values
        summary.update(max_abs_logit_diff=float((x - y).abs().max()),
                       max_abs_hidden_diff=float(
                           (h_a[first] - h_b[first]).abs().max()),
                       top2_margin=float(top[0] - top[1]))
    print("replay probe: " + json.dumps(summary), flush=True)
    ok = tok_a == tok_b and ex_a == ex_b and first is None
    print("OK: the request decodes bit-identically alone and in a crowd"
          if ok else "FAIL: the request's decode depends on its slot or "
          "its neighbours", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
