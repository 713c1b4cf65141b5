"""SpecEE decode engine (counterpart of ``repro/core/engine.py``).

``ar_decode_step`` — autoregressive decoding with speculative early exit:
    the draft proposes k candidate ids → layer-by-layer loop with the T1
    predictor at T2-scheduled exit points → verification (exit iff the full
    LM-head argmax at the exit layer is in the speculative set) → KV
    propagation for the layers the loop never reached.

JAX's ``lax.while_loop`` / ``lax.cond`` become host loops and branches
here. Their conditions (``all(exited)``, ``any(act)``, ``any(would)``) are
read back from the card once per layer; removing those syncs with a CUDA
graph is later work. ``StepInfo.units_run`` counts the loop's iterations
exactly as the JAX while loop does.

Semantics guarantees (held against the JAX package in tests/):
  * with the predictor disabled (threshold > 1) the emitted tokens equal
    dense greedy decoding;
  * when a row exits, its token is the argmax of the full LM head at the
    exit layer and a member of the speculative set.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import draft as draft_lib
from repro_torch.core import predictor as pred_lib
from repro_torch.core import scheduler as sched_lib
from repro_torch.kernels.exit_gate import ops as gate_lib
from repro_torch.models.common import Params, lm_head_weight
from repro_torch.models.model import Model


class SpecEEWeights(NamedTuple):
    """Everything SpecEE adds next to the frozen target model."""
    draft: Params
    predictors: Params          # stacked over exit points, fp32
    offline_mask: torch.Tensor  # (E,) bool — T2 offline schedule


class DecodeState(NamedTuple):
    cache: Any                  # target model cache (segments + len)
    draft_cache: Any
    sched: Dict[str, torch.Tensor]
    last_token: torch.Tensor    # (B,) int32
    h_last: torch.Tensor        # (B, D) final hidden at the last position


class StepInfo(NamedTuple):
    exit_point: torch.Tensor    # (B,) unit index at exit (E if full depth)
    exited: torch.Tensor        # (B,) bool — predictor-driven exit happened
    units_run: int              # units the layer loop executed
    spec_hit: torch.Tensor      # (B,) bool — final token ∈ speculative set


def init_specee(model: Model, gen: torch.Generator,
                device="cuda") -> SpecEEWeights:
    device = torch.device(device)
    return SpecEEWeights(
        draft=draft_lib.init_draft(model.cfg, gen, model.dtype, device),
        predictors=pred_lib.init_predictors(model.run.specee,
                                            model.num_exit_points, gen,
                                            device),
        offline_mask=torch.ones(model.num_exit_points, dtype=torch.bool,
                                device=device))


def init_decode_state(model: Model, params: Params,
                      sw: Optional[SpecEEWeights],
                      batch: Dict[str, torch.Tensor], max_seq: int
                      ) -> Tuple[torch.Tensor, DecodeState]:
    """Prefill the target (+ draft when ``sw`` is given) and build the
    decode state. Returns (first greedy token (B,) int32, state)."""
    logits, cache, extras = model.prefill(params, batch, max_seq=max_seq)
    h_all = extras["h_final"]
    if sw is not None:
        embeds = model.embed(params, batch["tokens"])
        dcache = draft_lib.draft_prefill(model.cfg, sw.draft, embeds, h_all,
                                         max_seq)
    else:
        dcache = {}
    first = torch.argmax(logits, dim=-1).to(torch.int32)
    state = DecodeState(
        cache=cache, draft_cache=dcache,
        sched=sched_lib.init_state(h_all.shape[0], model.run.specee,
                                   h_all.device),
        last_token=first, h_last=h_all[:, -1, :])
    return first, state


def empty_decode_state(model: Model, sw: Optional[SpecEEWeights], batch: int,
                       max_seq: int, device="cuda", cache=None) -> DecodeState:
    """All-zeros batched state with ``batch`` empty slots — the serving
    engine's starting point; rows are later filled by inserting batch-1
    ``init_decode_state`` results. ``cache``: a cache built by a
    ``KVCacheManager`` (``repro_torch.api.cache``), e.g. paged pools + page
    table; None allocates the dense layout."""
    device = torch.device(device)
    return DecodeState(
        cache=(cache if cache is not None
               else model.empty_cache(batch, max_seq, device)),
        draft_cache=(draft_lib.draft_cache(model.cfg, batch, max_seq,
                                           model.dtype, device)
                     if sw is not None else {}),
        sched=sched_lib.init_state(batch, model.run.specee, device),
        last_token=torch.zeros(batch, dtype=torch.int32, device=device),
        h_last=torch.zeros(batch, model.cfg.d_model, dtype=model.dtype,
                           device=device))


def ar_decode_step(model: Model, params: Params, sw: SpecEEWeights,
                   state: DecodeState, threshold: Optional[float] = None,
                   spec_ids_override: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, DecodeState, StepInfo]:
    """Decode one token for every row with speculative early exiting.

    The caches in ``state`` are updated in place; use the returned state.
    spec_ids_override: (B, k) — oracle speculative set (bypasses the draft
    proposal; the draft cache is still maintained).
    """
    spec = model.run.specee
    thresh = spec.exit_threshold if threshold is None else threshold
    E = model.num_exit_points
    lm_w = lm_head_weight(params)
    pos = state.cache["len"]
    pages = state.cache.get("page_table")       # paged KV: table indirection
    B = state.last_token.shape[0]
    k = spec.num_speculative
    dev = pos.device
    gate_impl = gate_lib.impl_for_flags(model.flags)

    # ---- 1. speculate: draft proposes k candidate tokens ----
    emb = model.embed(params, state.last_token[:, None])[:, 0, :]
    h_draft, draft_cache = draft_lib.draft_step(
        model.cfg, sw.draft, emb, state.h_last, state.draft_cache, pos)
    spec_ids, _ = draft_lib.propose_topk(model, params, h_draft, k, lm_w=lm_w)
    if spec_ids_override is not None:
        spec_ids = spec_ids_override.to(device=dev,
                                        dtype=torch.int32).contiguous()

    # ---- 2. T2 scheduling: which exit points run a predictor ----
    active = sched_lib.active_mask(state.sched, sw.offline_mask, spec, E)

    # ---- 3. layer loop with early exit ----
    h = emb
    exited = torch.zeros(B, dtype=torch.bool, device=dev)
    exit_token = torch.zeros(B, dtype=torch.int32, device=dev)
    exit_pt = torch.full((B,), E, dtype=torch.int32, device=dev)
    prev_probs = torch.full((B, k), 1.0 / k, dtype=torch.float32, device=dev)
    units_run = 0
    ep_base = 0
    for seg, (_, reps) in enumerate(model.segments):
        seg_cache = state.cache["segments"][seg]
        u = 0
        while u < reps and not bool(exited.all()):
            h_new, seg_cache = model.run_unit(params, seg, u, h, seg_cache,
                                              pos, pages=pages)
            h = torch.where(exited[:, None], h, h_new)
            ep = ep_base + u
            act = active[:, ep] & ~exited
            if bool(act.any()):
                hn = model.final_norm(params, h)
                p_exit, probs, _ = gate_lib.exit_gate(
                    hn, lm_w, spec_ids, prev_probs, sw.predictors, ep,
                    impl=gate_impl)
                would = act & (p_exit > thresh)
                if bool(would.any()):
                    gtok, _ = gate_lib.verify_argmax(hn, lm_w, impl=gate_impl)
                    newly = would & (gtok[:, None] == spec_ids).any(dim=1)
                    exit_token = torch.where(newly, gtok, exit_token)
                    exit_pt = torch.where(newly, torch.full_like(exit_pt, ep),
                                          exit_pt)
                    exited = exited | newly
                prev_probs = torch.where(act[:, None], probs, prev_probs)
            u += 1
            units_run += 1

        # ---- 4. KV propagation for units the loop never reached ----
        for u_skip in range(u, reps):
            seg_cache = model.propagate_unit(params, seg, u_skip, h,
                                             seg_cache, pos, pages=pages)
        ep_base += reps

    # ---- 5. emit: exited rows use the verified token, others the full head
    final_tok, _ = gate_lib.verify_argmax(model.final_norm(params, h), lm_w,
                                          impl=gate_impl)
    token = torch.where(exited, exit_token, final_tok)
    spec_hit = (token[:, None] == spec_ids).any(dim=1)

    # ---- 6. bookkeeping ----
    sched = sched_lib.update(state.sched, exit_pt.clamp(max=E - 1))
    new_state = DecodeState(cache=dict(state.cache, len=pos + 1),
                            draft_cache=draft_cache, sched=sched,
                            last_token=token, h_last=h)
    info = StepInfo(exit_point=exit_pt, exited=exited, units_run=units_run,
                    spec_hit=spec_hit)
    return token, new_state, info


def dense_decode_step(model: Model, params: Params,
                      sw: Optional[SpecEEWeights], state: DecodeState
                      ) -> Tuple[torch.Tensor, DecodeState, StepInfo]:
    """One dense (full-depth) greedy step; the emit streams the LM head
    through ``verify_argmax`` with the impl the model's flags select."""
    h, cache = model.decode_step_hidden(params, state.last_token, state.cache)
    token, _ = gate_lib.verify_argmax(
        model.final_norm(params, h), lm_head_weight(params),
        impl=gate_lib.impl_for_flags(model.flags))
    B, E = token.shape[0], model.num_exit_points
    new_state = DecodeState(cache=cache, draft_cache=state.draft_cache,
                            sched=state.sched, last_token=token, h_last=h)
    info = StepInfo(
        exit_point=torch.full((B,), E, dtype=torch.int32, device=h.device),
        exited=torch.zeros(B, dtype=torch.bool, device=h.device),
        units_run=E,
        spec_hit=torch.zeros(B, dtype=torch.bool, device=h.device))
    return token, new_state, info
