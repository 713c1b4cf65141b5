"""SpecEE decode engine (counterpart of ``repro/core/engine.py``).

``ar_decode_step`` — autoregressive decoding with speculative early exit:
    the draft proposes k candidate ids → layer-by-layer loop with the T1
    predictor at T2-scheduled exit points → verification (exit iff the full
    LM-head argmax at the exit layer is in the speculative set) → KV
    propagation for the layers the loop never reached.

``tree_decode_step`` — T3: tree speculative decoding with the hyper-token
    merged mapping: the draft expands a static token tree, the target runs
    every node at once under a tree mask with one predictor evaluation per
    root→leaf path (the Cannikin min-merge of its nodes' features), and the
    accepted chain is the greedy path match at the exit layer.

``megatick_decode`` — up to K strategy steps in one call, with the per-row
    budgets, EOS cut-off and done mask kept on the device.

JAX's ``lax.while_loop`` / ``lax.cond`` become host loops and branches
here. Their conditions (``all(exited)``, ``any(act)``, ``any(would)``, and
the megatick's ``all(done)``) are read back from the card once per layer or
tick; removing those syncs with a CUDA graph is later work. ``units_run``
counts the loops' iterations exactly as the JAX while loops do. The AR
step reads its three through ``host_read``, which gives a meta tensor (the
dry run, ``launch/dryrun.py``) the full-depth answer.

Weight-only quantization: each step takes an optional bundle ``qw``
(``repro_torch.quant.quantize_params``). ``_apply_qw`` resolves it as the
JAX package does: the LM head the gate, the verify and the draft's top-k
read is the ``QTensor`` (the quantized kernels) and the predictor bank is
the quantized one. Unlike JAX's, the steps take no ``proj`` entry: the
caller passes params whose projections are already dequantized
(``Engine.decode_weights``, once per engine, not once per step). The tree's top-b expansion reads ``params``' own LM head, the fp
original, as JAX's ``build_tree`` does.

Semantics guarantees (held against the JAX package in tests/):
  * with the predictor disabled (threshold > 1) the emitted tokens equal
    dense greedy decoding;
  * when a row exits, its token is the argmax of the full LM head at the
    exit layer and a member of the speculative set.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import draft as draft_lib
from repro_torch.core import features as feat_lib
from repro_torch.core import predictor as pred_lib
from repro_torch.core import scheduler as sched_lib
from repro_torch.core.tree import TreeSpec
from repro_torch.kernels.exit_gate import ops as gate_lib
from repro_torch.models.common import Params, lm_head_weight
from repro_torch.models.model import Model
from repro_torch.quant import QTensor


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
    prng: int = 0               # the session's sampling seed (constant)


class StepInfo(NamedTuple):
    exit_point: torch.Tensor    # (B,) unit index at exit (E if full depth)
    exited: torch.Tensor        # (B,) bool — predictor-driven exit happened
    units_run: int              # units the layer loop executed
    spec_hit: torch.Tensor      # (B,) bool — final token ∈ speculative set


def _apply_qw(params: Params, sw: Optional[SpecEEWeights], qw):
    """One step's weight views under an optional quantized bundle ``qw``.
    Returns ``(params, lm_w, predictors)``: ``lm_w`` the quantized LM head
    or else ``params``' own, ``predictors`` the quantized bank or else
    ``sw``'s. ``params`` must already hold dequantized projections, so a
    ``proj`` entry is refused (see the module docstring)."""
    predictors = sw.predictors if sw is not None else None
    if not qw:
        return params, lm_head_weight(params), predictors
    if qw.get("proj") is not None:
        raise ValueError("qw['proj'] is not taken by a decode step: pass "
                         "params with dequantized projections and "
                         "qw['proj']=None (Engine.decode_weights)")
    lm_w = qw.get("lm_head")
    if lm_w is None:
        lm_w = lm_head_weight(params)
    if qw.get("predictors") is not None:
        predictors = qw["predictors"]
    return params, lm_w, predictors


def _verify_head(params: Params, lm_w):
    """The head the full-LM-head reductions read — the draft's top-k, the
    exit verify and the emit (JAX threads ``shard`` into the same three):
    a sharded model's vocabulary slices (``lm_head/vocab_shards``, the
    sharded verify), else ``lm_w``. A quantized head stays whole, as in
    JAX. The gates keep ``lm_w``, the lead device's whole copy."""
    if isinstance(lm_w, QTensor):
        return lm_w
    return params.get("lm_head", {}).get("vocab_shards", lm_w)


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
                      batch: Dict[str, torch.Tensor], max_seq: int,
                      prng: int = 0) -> Tuple[torch.Tensor, DecodeState]:
    """Prefill the target (+ draft when ``sw`` is given) and build the
    decode state. Returns (first greedy token (B,) int32, state).
    ``prng``: the session's sampling seed, carried in the state."""
    if sw is not None and "patches" in batch:
        raise ValueError(
            "SpecEE's draft fuses each prompt token's embedding with the "
            "target's hidden at that position; a prompt with prepended "
            "image patches has more hiddens than tokens (the JAX package "
            "fails here too): decode it with the dense strategy")
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
        last_token=first, h_last=h_all[:, -1, :], prng=int(prng))
    return first, state


def empty_decode_state(model: Model, sw: Optional[SpecEEWeights], batch: int,
                       max_seq: int, device="cuda", cache=None,
                       prng: int = 0) -> DecodeState:
    """All-zeros batched state with ``batch`` empty slots — the serving
    engine's starting point; rows are later filled by inserting batch-1
    ``init_decode_state`` results. ``cache``: a cache built by a
    ``KVCacheManager`` (``repro_torch.api.cache``), e.g. paged pools + page
    table; None allocates the dense layout. ``prng``: the session's
    sampling seed."""
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
                           device=device),
        prng=int(prng))


def host_read(flag: torch.Tensor, on_meta: bool) -> bool:
    """``bool(flag)``, read back to the host. A meta tensor holds no
    value, so it answers ``on_meta``: the answer JAX's dry run takes
    (``repro/launch/hlo_analysis.py``): a dynamic loop runs to the full
    unit count and a conditional counts both branches."""
    if flag.device.type == "meta":
        return on_meta
    return bool(flag)


def ar_decode_step(model: Model, params: Params, sw: SpecEEWeights,
                   state: DecodeState, threshold: Optional[float] = None,
                   spec_ids_override: Optional[torch.Tensor] = None,
                   qw=None) -> Tuple[torch.Tensor, DecodeState, StepInfo]:
    """Decode one token for every row with speculative early exiting.

    The caches in ``state`` are updated in place; use the returned state.
    spec_ids_override: (B, k) — oracle speculative set (bypasses the draft
    proposal; the draft cache is still maintained).
    qw: optional quantized-weight bundle (``_apply_qw``).
    """
    spec = model.run.specee
    thresh = spec.exit_threshold if threshold is None else threshold
    E = model.num_exit_points
    params, lm_w, predictors = _apply_qw(params, sw, qw)
    vw = _verify_head(params, lm_w)
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
    spec_ids, _ = draft_lib.propose_topk(model, params, h_draft, k, lm_w=vw)
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
        while u < reps and not host_read(exited.all(), False):
            h_new, seg_cache = model.run_unit(params, seg, u, h, seg_cache,
                                              pos, live_mask=~exited,
                                              pages=pages)
            h = torch.where(exited[:, None], h, h_new)
            ep = ep_base + u
            act = active[:, ep] & ~exited
            if host_read(act.any(), True):
                hn = model.final_norm(params, h)
                p_exit, probs, _ = gate_lib.exit_gate(
                    hn, lm_w, spec_ids, prev_probs, predictors, ep,
                    impl=gate_impl,
                    spec_head_kernel=model.flags.spec_head_kernel)
                would = act & (p_exit > thresh)
                if host_read(would.any(), True):
                    gtok, _ = gate_lib.verify_argmax(hn, vw, impl=gate_impl)
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
    final_tok, _ = gate_lib.verify_argmax(model.final_norm(params, h), vw,
                                          impl=gate_impl)
    token = torch.where(exited, exit_token, final_tok)
    spec_hit = (token[:, None] == spec_ids).any(dim=1)

    # ---- 6. bookkeeping ----
    sched = sched_lib.update(state.sched, exit_pt.clamp(max=E - 1))
    new_state = DecodeState(cache=dict(state.cache, len=pos + 1),
                            draft_cache=draft_cache, sched=sched,
                            last_token=token, h_last=h, prng=state.prng)
    info = StepInfo(exit_point=exit_pt, exited=exited, units_run=units_run,
                    spec_hit=spec_hit)
    return token, new_state, info


# ---------------------------------------------------------------------------
# T3: tree speculative decoding with hyper-token merged early exit
# ---------------------------------------------------------------------------
class TreeStepInfo(NamedTuple):
    accepted_len: torch.Tensor  # (B,) matched draft tokens (excl. bonus)
    exit_point: torch.Tensor    # (B,) unit index at exit
    exited: torch.Tensor        # (B,)
    units_run: int              # units the layer loop executed


def _top_b(logits: torch.Tensor, b: int) -> torch.Tensor:
    """Ids of the b largest logits per row, ties by ascending id (a stable
    descending sort, as ``lax.top_k``; ``torch.topk`` makes no promise)."""
    return torch.sort(logits, dim=-1, descending=True, stable=True)[1][:, :b]


def build_tree(model: Model, params: Params, sw: SpecEEWeights,
               state: DecodeState, tree: TreeSpec
               ) -> Tuple[torch.Tensor, torch.Tensor, Any]:
    """Draft-expand the static tree. Returns (node_tokens (B, N) int32,
    node draft hiddens (B, N, D), the draft cache with the root written)."""
    cfg = model.cfg
    B = state.last_token.shape[0]
    pos0 = state.cache["len"]
    b = tree.branch
    # root draft step (writes the trunk cache at pos0)
    emb = model.embed(params, state.last_token[:, None])[:, 0, :]
    h_root, draft_cache = draft_lib.draft_step(
        cfg, sw.draft, emb, state.h_last, state.draft_cache, pos0)
    node_tokens = torch.zeros(B, tree.num_nodes, dtype=torch.int32,
                              device=emb.device)
    node_tokens[:, 0] = state.last_token
    h_nodes = h_root.new_zeros((B, tree.num_nodes, h_root.shape[-1]))
    h_nodes[:, 0] = h_root
    for lvl in range(1, tree.depth + 1):
        p_off, p_size = tree.level_offsets[lvl - 1], tree.level_sizes[lvl - 1]
        off, size = tree.level_offsets[lvl], tree.level_sizes[lvl]
        # children = top-b of each parent's draft logits
        hp = h_nodes[:, p_off:p_off + p_size].reshape(B * p_size, -1)
        toks = _top_b(model.logits(params, hp), b).to(torch.int32).reshape(
            B, size)
        node_tokens[:, off:off + size] = toks
        if lvl < tree.depth:            # hiddens to expand further
            emb_c = model.embed(params, toks.reshape(B * size, 1))[:, 0, :]
            hp_rep = hp.repeat_interleave(b, dim=0)
            h_c = draft_lib.draft_step_readonly(
                cfg, sw.draft, emb_c, hp_rep, draft_cache, pos0 + lvl,
                pos0 + 1)
            h_nodes[:, off:off + size] = h_c.reshape(B, size, -1)
    return node_tokens, h_nodes, draft_cache


def tree_decode_step(model: Model, params: Params, sw: SpecEEWeights,
                     state: DecodeState, tree: TreeSpec,
                     threshold: Optional[float] = None,
                     node_tokens_override: Optional[torch.Tensor] = None,
                     qw=None) -> Tuple[torch.Tensor, torch.Tensor,
                                       DecodeState, TreeStepInfo]:
    """One tree-speculative step with hyper-token merged early exit.

    Returns (tokens (B, depth+1) emitted left-aligned, num_emitted (B,),
    new state, info). The cache needs ``tree.num_nodes`` scratch slots at
    the end of its logical capacity (``init_tree_decode_state``, or a
    strategy's ``cache_seq_len``); the caches are updated in place.
    node_tokens_override: (B, N) oracle node tokens (tests, benchmarks);
    the root keeps the last token. qw: optional quantized-weight bundle —
    the gate's features and predictors and the B*N-row verify read it, the
    draft's top-b expansion reads ``params``' fp head (as in JAX).
    """
    assert model.supports_tree(), \
        "T3 tree mode requires a pure-attention stack"
    spec = model.run.specee
    thresh = spec.exit_threshold if threshold is None else threshold
    E = model.num_exit_points
    params, lm_w, predictors = _apply_qw(params, sw, qw)
    B = state.last_token.shape[0]
    N, k = tree.num_nodes, spec.num_speculative
    pos0 = state.cache["len"]
    dev = pos0.device
    gate_impl = gate_lib.impl_for_flags(model.flags)
    sh_kernel = model.flags.spec_head_kernel
    # the predictor stage takes the kernel wrapper only when the fused
    # backend resolves to the kernel path (JAX's rule)
    pred_kernel = (model.flags.exit_gate_kernel
                   and gate_lib.resolve_impl(gate_impl, pos0) == "kernel")
    # static scratch offset = logical capacity minus N; with a paged cache
    # the capacity is pages_per_row * page_size
    pages = state.cache.get("page_table")
    any_k = state.cache["segments"][0]["u0"]["k"]
    while isinstance(any_k, list):      # a data row's entry, a shard's part
        any_k = any_k[0]
    capacity = (any_k.shape[2] if pages is None
                else pages.shape[1] * any_k.shape[2])
    scratch_off = capacity - N

    node_tokens, _, draft_cache = build_tree(model, params, sw, state, tree)
    if node_tokens_override is not None:
        node_tokens = node_tokens_override.to(device=dev,
                                              dtype=torch.int32).clone()
        node_tokens[:, 0] = state.last_token

    # children token matrix per node, padded (or cut) to k for the features:
    # a leaf's missing children clamp to the root, the padding repeats the
    # first child
    child = torch.as_tensor(tree.children, device=dev).long().clamp(min=0)
    if tree.branch < k:
        child = torch.cat([child, child[:, :1].expand(N, k - tree.branch)],
                          dim=1)
    child = child[:, :k]                                            # (N, k)
    # node b*N + n's speculative tokens are the step's node tokens at rows
    # b*N + child(n, j): fixed for the step, so with the spec-head kernel
    # their head columns (a quantized head's codes and scales) are gathered
    # once, at the first exit point that runs the gate, and each exit point
    # dots with those rows
    child_rows = (torch.arange(B, device=dev)[:, None, None] * N
                  + child[None]).reshape(B * N, k)
    child_toks = node_tokens.reshape(-1)[child_rows]               # (B*N, k)
    child_rows = child_rows.to(torch.int32)
    node_cols = None

    # ---- layer loop with hyper-token early exit ----
    mask = tree.attention_mask(pos0, scratch_off)          # (B, 1, N, cap)
    positions = tree.positions(pos0).expand(B, N)
    h = model.embed(params, node_tokens)                   # (B, N, D)
    exited = torch.zeros(B, dtype=torch.bool, device=dev)
    exit_pt = torch.full((B,), E, dtype=torch.int32, device=dev)
    prev_probs = torch.full((B, N, k), 1.0 / k, dtype=torch.float32,
                            device=dev)
    units_run = 0
    active = sched_lib.active_mask(state.sched, sw.offline_mask, spec, E)
    path_nodes = torch.as_tensor(tree.path_nodes, device=dev)
    ep_base = 0
    for seg, (_, reps) in enumerate(model.segments):
        seg_cache = state.cache["segments"][seg]
        u = 0
        while u < reps and not bool(exited.all()):
            h_new, seg_cache = model.run_unit_tree(
                params, seg, u, h, seg_cache, mask, positions, scratch_off,
                pages=pages)
            h = torch.where(exited[:, None, None], h, h_new)
            ep = ep_base + u
            act = active[:, ep] & ~exited
            if bool(act.any()):
                hn = model.final_norm(params, h).reshape(B * N, -1)
                if node_cols is None:
                    node_cols = feat_lib.node_columns(lm_w, node_tokens,
                                                      sh_kernel)
                if node_cols is not None:
                    feats, probs = feat_lib.column_features(
                        hn, node_cols, child_rows,
                        prev_probs.reshape(B * N, k))
                else:                          # the plain path
                    feats, probs = feat_lib.extract_features(
                        hn, lm_w, child_toks, prev_probs.reshape(B * N, k))
                # hyper-token merge: one predictor evaluation per path
                pf, _ = feat_lib.merge_path_features(
                    feats.reshape(B, N, -1), probs.reshape(B, N, k),
                    path_nodes)
                p_exit = pred_lib.apply_predictor_banked(
                    predictors, ep, pf, use_kernel=pred_kernel)  # (B, P)
                newly = act & (p_exit.amax(dim=1) > thresh)  # best path
                exit_pt = torch.where(newly, torch.full_like(exit_pt, ep),
                                      exit_pt)
                prev_probs = torch.where(act[:, None, None],
                                         probs.reshape(B, N, k), prev_probs)
                exited = exited | newly
            u += 1
            units_run += 1
        for u_skip in range(u, reps):
            seg_cache = model.propagate_unit_tree(
                params, seg, u_skip, h, seg_cache, positions, scratch_off,
                pages=pages)
        ep_base += reps

    # ---- acceptance walk on global logits at the (per-row) exit layer ----
    # the B*N node rows stream through one verify: no (B, N, V) logits
    hn_nodes = model.final_norm(params, h).reshape(B * N, -1)
    gtok = gate_lib.verify_argmax(hn_nodes, _verify_head(params, lm_w),
                                  impl=gate_impl)[0]
    # the walk is a few integer steps per row: on the host, from one copy
    g = gtok.reshape(B, N).cpu().numpy()
    toks = node_tokens.cpu().numpy()
    ch = tree.children
    cur = np.zeros(B, np.int64)                            # root
    acc_nodes = np.full((B, tree.depth + 1), -1, np.int64)
    acc_nodes[:, 0] = 0
    acc_len = np.ones(B, np.int64)                         # root always in
    out = np.zeros((B, tree.depth + 1), np.int32)
    for r in range(B):
        for d in range(1, tree.depth + 1):
            target = g[r, cur[r]]
            hit = [c for c in ch[cur[r]] if c >= 0 and toks[r, c] == target]
            if not hit:
                break
            out[r, d - 1] = target
            acc_nodes[r, d] = cur[r] = hit[0]
            acc_len[r] += 1
        out[r, acc_len[r] - 1] = g[r, cur[r]]              # bonus token
    n_emit = acc_len.copy()                                # matched + bonus

    # ---- commit: copy accepted K/V into real cache positions ----
    cache = model.accept_tree_kv(
        dict(state.cache), torch.as_tensor(acc_nodes),
        torch.as_tensor(acc_len), pos0, scratch_off)
    acc_len_t = torch.as_tensor(acc_len, device=dev)
    cache["len"] = (pos0 + acc_len_t).to(pos0.dtype)
    rows = torch.arange(B, device=dev)
    cur_t = torch.as_tensor(cur, device=dev)
    out_t = torch.as_tensor(out, device=dev)

    # ---- draft cache catch-up for accepted tokens beyond the root ----
    # rows without a d-th accepted token keep their draft cache: the slot
    # the batched draft step writes is restored for them
    acc_nodes_t = torch.as_tensor(acc_nodes, device=dev)
    S_draft = draft_cache["k"].shape[1]
    for d in range(1, tree.depth + 1):
        if not (acc_len > d).any():
            break
        valid = acc_len_t > d
        pos_d = pos0.long() + d
        slot = pos_d.clamp(max=S_draft - 1)
        kept = {n: draft_cache[n][rows, slot].clone() for n in ("k", "v")}
        emb_d = model.embed(params, out_t[:, d - 1:d])[:, 0, :]
        parent_h = h[rows, acc_nodes_t[:, d - 1].clamp(min=0)]
        _, draft_cache = draft_lib.draft_step(
            model.cfg, sw.draft, emb_d, parent_h, draft_cache, pos_d)
        for n in ("k", "v"):
            draft_cache[n][rows, slot] = torch.where(
                valid[:, None, None], draft_cache[n][rows, slot], kept[n])

    sched = sched_lib.update(state.sched, exit_pt.clamp(max=E - 1))
    bonus = out_t[rows, acc_len_t - 1]
    new_state = DecodeState(cache=cache, draft_cache=draft_cache, sched=sched,
                            last_token=bonus, h_last=h[rows, cur_t],
                            prng=state.prng)
    info = TreeStepInfo(accepted_len=acc_len_t.to(torch.int32) - 1,
                        exit_point=exit_pt, exited=exited,
                        units_run=units_run)
    return out_t, acc_len_t.to(torch.int32), new_state, info


# ---------------------------------------------------------------------------
# multi-tick decode ("megatick")
# ---------------------------------------------------------------------------
class TickEmit(NamedTuple):
    """Raw per-tick emit of one strategy step, as the megatick loop sees it."""
    tokens: torch.Tensor        # (B, W) int32 — left-aligned emitted tokens
    counts: torch.Tensor        # (B,) int32 — valid tokens this tick
    exit_layer: torch.Tensor    # (B,) int32
    accept_len: torch.Tensor    # (B,) int32
    exited: torch.Tensor        # (B,) bool
    units_run: int              # units the layer loop executed


def megatick_decode(tick_fn, state: DecodeState,
                    limits: Dict[str, torch.Tensor], num_ticks: int,
                    emit_width: int, num_exit_points: int
                    ) -> Tuple[Dict[str, Any], DecodeState,
                               Dict[str, torch.Tensor]]:
    """Run up to ``num_ticks`` strategy steps with the per-row token
    budgets, EOS cut-off and done mask kept on the device.

    ``tick_fn(state) -> (TickEmit, new_state)`` is one batched strategy
    step. ``limits`` holds (B,) tensors: ``budget``, ``emitted``, ``eos``
    (-1: none) as int32, ``done`` and ``retired`` as bool. Emits accumulate
    into a (B, K·W) buffer at per-row offsets, per-tick stats land in
    (B, K) columns, and the loop stops once every row is done: JAX's
    ``lax.while_loop`` condition, read on the host once per tick. Rows
    retired mid-flight (``limits["retired"]``) have their cache length
    pinned to zero after every tick.

    The accounting is tick for tick the session's ``_account_row``: budget
    clip first, EOS scan within the clipped window, ``done`` on an EOS hit
    or an exhausted budget. Rows already done keep stepping (their emits
    are dropped), so the state equals that of K single steps.

    The limits passed in are never written: every update makes a new
    tensor, since the async pipeline hands one megatick's output limits to
    the next while the first's handle still holds them. Returns ``(out,
    state, new_limits)``: ``out`` holds ``tokens`` (B, K·W), ``counts``
    (B,), the (B, K) planes ``exit_layer``, ``accept_len``, ``exited``,
    ``tick_counts``, ``tick_live``, the ints ``ticks`` and ``units_run``
    (summed over the ticks run) and ``done``; ``new_limits`` is the carry
    for the next megatick.
    """
    K, W = int(num_ticks), int(emit_width)
    B = state.last_token.shape[0]
    dev = state.last_token.device
    buf_len = K * W
    budget, eos, retired = limits["budget"], limits["eos"], limits["retired"]
    done, emitted = limits["done"], limits["emitted"]
    lanes = torch.arange(W, device=dev)
    # column buf_len takes the lanes a row does not keep (JAX's
    # mode="drop" scatter); a row's kept lanes never reach it
    buf = torch.zeros(B, buf_len + 1, dtype=torch.int32, device=dev)
    counts = torch.zeros(B, dtype=torch.int32, device=dev)
    exit_layer = torch.full((B, K), num_exit_points, dtype=torch.int32,
                            device=dev)
    accept_len = torch.zeros(B, K, dtype=torch.int32, device=dev)
    exited = torch.zeros(B, K, dtype=torch.bool, device=dev)
    tick_counts = torch.zeros(B, K, dtype=torch.int32, device=dev)
    tick_live = torch.zeros(B, K, dtype=torch.bool, device=dev)
    units, t = 0, 0
    while t < K and not bool(done.all()):
        em, state = tick_fn(state)
        live = ~done
        # budget clip, then EOS scan within the clipped window
        kept = torch.clamp(torch.minimum(em.counts, budget - emitted), min=0)
        window = lanes[None, :] < kept[:, None]
        is_eos = ((em.tokens == eos[:, None]) & (eos >= 0)[:, None]
                  & window)
        has_eos = is_eos.any(dim=1)
        first_eos = torch.argmax(is_eos.to(torch.int32), dim=1) + 1
        kept = torch.where(has_eos, first_eos.to(torch.int32), kept)
        kept = torch.where(live, kept, 0)
        emitted = emitted + kept
        done = done | (live & (has_eos | (emitted >= budget)))
        idx = torch.where(lanes[None, :] < kept[:, None],
                          counts[:, None] + lanes[None, :], buf_len)
        buf.scatter_(1, idx.long(), em.tokens.to(torch.int32))
        counts = counts + kept
        exit_layer[:, t] = em.exit_layer
        accept_len[:, t] = em.accept_len
        exited[:, t] = em.exited
        tick_counts[:, t] = kept
        tick_live[:, t] = live
        units += int(em.units_run)
        # the batched tick advances every length: a retired row's stays 0
        cache = state.cache
        state = state._replace(cache=dict(
            cache, len=torch.where(retired, 0, cache["len"])))
        t += 1
    out = {"tokens": buf[:, :buf_len], "counts": counts,
           "exit_layer": exit_layer, "accept_len": accept_len,
           "exited": exited, "tick_counts": tick_counts,
           "tick_live": tick_live, "ticks": t, "units_run": units,
           "done": done}
    new_limits = {"budget": budget, "emitted": emitted, "eos": eos,
                  "done": done, "retired": retired}
    return out, state, new_limits


def init_tree_decode_state(model: Model, params: Params, sw: SpecEEWeights,
                           batch: Dict[str, torch.Tensor], max_seq: int,
                           tree: TreeSpec
                           ) -> Tuple[torch.Tensor, DecodeState]:
    """Like ``init_decode_state`` but reserves N scratch slots in the cache
    (cache lengths are per-row throughout: rows accept ragged counts)."""
    return init_decode_state(model, params, sw, batch,
                             max_seq + tree.num_nodes)


def dense_decode_step(model: Model, params: Params,
                      sw: Optional[SpecEEWeights], state: DecodeState,
                      temperature: float = 0.0, top_k: Optional[int] = None,
                      qw=None) -> Tuple[torch.Tensor, DecodeState, StepInfo]:
    """One dense (full-depth) step.

    Greedy (``temperature <= 0``) emits through ``verify_argmax``, which
    streams the LM head (the quantized one under ``qw``) with the impl the
    model's flags select. ``temperature > 0`` samples from the full logits
    of the fp LM head (the distribution is the product, not its argmax;
    under ``qw`` the projections stay dequantized) with a per-row key of
    (session seed, row position before the step, token fed),
    ``sampler.row_keys``: a row's samples depend on its own history alone,
    not on batch, slot or megatick. ``state.prng`` stays constant."""
    params, lm_w, _ = _apply_qw(params, sw, qw)
    pos_before = state.cache["len"]
    h, cache = model.decode_step_hidden(params, state.last_token, state.cache)
    if temperature > 0.0:
        from repro_torch.serving.sampler import row_keys, sample_rows
        keys = row_keys(state.prng, pos_before, state.last_token)
        token = sample_rows(model.logits(params, h), keys,
                            temperature=temperature, top_k=top_k)
    else:
        token, _ = gate_lib.verify_argmax(
            model.final_norm(params, h), _verify_head(params, lm_w),
            impl=gate_lib.impl_for_flags(model.flags))
    B, E = token.shape[0], model.num_exit_points
    new_state = DecodeState(cache=cache, draft_cache=state.draft_cache,
                            sched=state.sched, last_token=token, h_last=h,
                            prng=state.prng)
    info = StepInfo(
        exit_point=torch.full((B,), E, dtype=torch.int32, device=h.device),
        exited=torch.zeros(B, dtype=torch.bool, device=h.device),
        units_run=E,
        spec_hit=torch.zeros(B, dtype=torch.bool, device=h.device))
    return token, new_state, info
