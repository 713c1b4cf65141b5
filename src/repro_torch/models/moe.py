"""Mixture-of-Experts FFN with top-k routing (counterpart of
``repro/models/moe.py``; dbrx-132b, qwen3-moe-235b-a22b).

Two forms of one function. ``apply_moe`` is JAX's dense einsum: every
expert computes, the activations are weighted by the router before the down
projection, and E and F contract together, a ``token_chunk`` of the
sequence at a time. ``apply_moe_topk`` computes only the selected experts,
grouped by expert: each expert's tokens go through that expert's own
weights, and the outputs are added back weighted by their gates in JAX's k
order. JAX's form gathers the weights per token instead (``wi[topi]``,
(T, k, D, F)), which at dbrx's widths would be 2.1 GB per matrix per layer
at a decode step of four rows. Neither form has a Pallas kernel in the JAX
package, so the products stay ``torch.matmul``.

Top-k ties: ``jax.lax.top_k`` puts the lower expert id first among equal
logits; ``torch.topk`` promises no order, so ``_top_k`` takes a stable
descending sort.

Tensor parallelism (a ``(1, P)`` mesh, JAX ``sharding/policies.py``'s
MoE rules): the router stays whole on the lead device; ``wi``/``wg`` (E, D,
F) and ``wo`` (E, F, D) split F over the shards (``Shards`` leaves). The
router runs once, on the lead; each shard runs the form on its F slice
(the dense form weights its activations by the router before its down
projection, the top-k form takes the lead's (rows, slot) groups, made
once, so the host reads no more ids than unsharded); the shards' (B, S,
D) partials go through ``all_reduce_sum``.

The data rows of a ``(D, P)`` mesh, in training and in serving's decode
and prefill (``apply_moe_rows``, ``apply_moe_topk_rows``; each row's
tokens on its lead device, each row a TP group as above). Expert
parallelism, where the expert stacks are cut over 'data' (JAX's
``fsdp_tp`` spec: E over 'data'): each row routes its own tokens,
the tokens and the combine weights are gathered over the rows
(``gather_rows``), each row runs its E / D local experts on every token,
and the rows' outputs are reduce-scattered back to the rows that own the
tokens. Under ``ep_quant`` (JAX ``_ep_quantized_gather``: only where
``ModelFlags.act_batch_axes`` is set) each token is quantized to int8
with its own scale before that gather and dequantized after it; under
``bf16_reduce`` the E/F contraction's output is rounded to bf16 and its
partial sums (over the TP shards, then over the rows) add in bf16, as
JAX's ``preferred_element_type`` does on one device (one rounding) and
GSPMD's bf16 psum does across devices. Expert stacks replicated over
'data' (E not divisible by D, or the top-k form, which gathers them)
run every expert on the row's own tokens. The aux loss is the whole
batch's: each row's routed counts and router probabilities are summed
over the rows (``all_reduce_rows``) before the product, as JAX's means
run over every data row under GSPMD.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import common
from repro_torch.models.common import Params
from repro_torch.runtime.collectives import (all_reduce_rows, all_reduce_sum,
                                             count_backward_reduce,
                                             dequantize_tokens, each_row,
                                             gather_rows,
                                             quantize_tokens,
                                             reduce_scatter_rows)
from repro_torch.sharding.ctx import local, parts


def init_moe(cfg: ModelConfig, gen, dtype, device) -> Params:
    """Router (D, E), expert banks wi/wg (E, D, F) and wo (E, F, D), the
    JAX init's shapes and scales."""
    assert cfg.moe is not None
    e = cfg.moe
    d, f, E = cfg.d_model, e.expert_d_ff, e.num_experts
    std_in = 1.0 / math.sqrt(d)
    std_out = 1.0 / math.sqrt(f) / math.sqrt(2 * cfg.num_layers)
    p: Params = {
        "router": {"w": common.normal_init(gen, (d, E), std_in, dtype,
                                           device)},
        "wi": common.normal_init(gen, (E, d, f), std_in, dtype, device),
        "wo": common.normal_init(gen, (E, f, d), std_out, dtype, device),
    }
    if cfg.gated_mlp:
        p["wg"] = common.normal_init(gen, (E, d, f), std_in, dtype, device)
    return p


def _top_k(logits: torch.Tensor, k: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest along the last dim, the lower id
    first among equal values (a stable descending sort)."""
    vals, ids = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def _router_logits(p: Params, x: torch.Tensor) -> torch.Tensor:
    return x.float() @ p["router"]["w"].float()


def router_probs(cfg: ModelConfig, p: Params, x: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (..., D) -> (combine weights (..., E) fp32, router logits
    (..., E) fp32): a softmax over the top-k logits, scattered to their
    experts (JAX's one-hot combine; an expert taken once)."""
    logits = _router_logits(p, x)
    topv, topi = _top_k(logits, cfg.moe.num_experts_per_tok)
    gate = torch.softmax(topv, dim=-1)
    combine = torch.zeros_like(logits).scatter_add_(-1, topi, gate)
    return combine, logits


def _routed(cfg: ModelConfig, router_logits: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T, E) routed counts (each token's k picks) and router probs."""
    probs = torch.softmax(router_logits, dim=-1)                # (T, E)
    _, topi = _top_k(router_logits, cfg.moe.num_experts_per_tok)
    counts = torch.zeros_like(probs).scatter_add_(
        -1, topi, torch.ones_like(topi, dtype=probs.dtype))     # (T, E)
    return counts, probs


def load_balancing_loss(cfg: ModelConfig,
                        router_logits: torch.Tensor) -> torch.Tensor:
    """Switch-style aux loss: E * sum_e f_e * p_e * weight (f = fraction of
    the k picks routed to e, p = mean router probability)."""
    e = cfg.moe
    counts, probs = _routed(cfg, router_logits)
    f = counts.mean(dim=0)
    pm = probs.mean(dim=0)
    return e.num_experts * torch.sum(f * pm) * e.router_aux_loss_weight


def _aux_rows(cfg: ModelConfig, logits: Sequence[torch.Tensor]
              ) -> torch.Tensor:
    """``load_balancing_loss`` over the rows' tokens together: one row's
    as it is; over D rows the sums of counts and probs are all-reduced
    over the rows before the means and the product (on row 0's device)."""
    e = cfg.moe
    E = e.num_experts
    if len(logits) == 1:
        return load_balancing_loss(cfg, logits[0].reshape(-1, E))
    sums = [torch.cat([c.sum(dim=0), p.sum(dim=0)])
            for c, p in (_routed(cfg, lg.reshape(-1, E)) for lg in logits)]
    total = all_reduce_rows(sums, [lg.device for lg in logits])[0]
    tokens = sum(lg.numel() // E for lg in logits)
    f, pm = total[:E] / tokens, total[E:] / tokens
    return E * torch.sum(f * pm) * e.router_aux_loss_weight


def _experts(cfg: ModelConfig, pe: Params, xc: torch.Tensor,
             comb: torch.Tensor, dtype: torch.dtype, bf16_reduce: bool
             ) -> torch.Tensor:
    """One TP shard's (or the whole) dense expert FFN over the experts
    ``pe`` holds, weighted by their combine columns ``comb`` (B, Sc, E_pe)
    before the down projection; E and F contract together. Under
    ``bf16_reduce`` the contraction is in bf16 (``common.rounded_einsum``,
    backward too; the partial sums then add in bf16)."""
    act = common.activation_fn(cfg.activation)
    up = torch.einsum("bsd,edf->ebsf", xc, pe["wi"].to(dtype))
    if cfg.gated_mlp:
        gate_h = torch.einsum("bsd,edf->ebsf", xc, pe["wg"].to(dtype))
        up = act(gate_h) * up
    else:
        up = act(up)
    up = up * comb.to(dtype).permute(2, 0, 1)[..., None]
    if bf16_reduce:
        return common.rounded_einsum("ebsf,efd->bsd", up, pe["wo"].to(dtype),
                                     torch.bfloat16)
    return torch.einsum("ebsf,efd->bsd", up, pe["wo"].to(dtype))


def _tp_experts(cfg: ModelConfig, p: Params, x: torch.Tensor,
                comb: torch.Tensor, dtype: torch.dtype, bf16_reduce: bool
                ) -> torch.Tensor:
    """``_experts`` on each TP shard of ``p``, the partials reduced onto
    x's device."""
    if len(parts(p["wi"])) > 1:
        count_backward_reduce(x, comb)
    return all_reduce_sum([
        _experts(cfg, local(p, s), x.to(w.device), comb.to(w.device), dtype,
                 bf16_reduce) for s, w in enumerate(parts(p["wi"]))],
        x.device)


def _ffn_rows(cfg: ModelConfig, ps: Sequence[Params],
              xs: Sequence[torch.Tensor], ep_quant: bool, bf16_reduce: bool
              ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """One token chunk of the dense form over the rows: (each row's out,
    the aux loss)."""
    dtype = xs[0].dtype
    E = cfg.moe.num_experts
    routed = [router_probs(cfg, p, xc) for p, xc in each_row(zip(ps, xs))]
    aux = _aux_rows(cfg, [lg for _, lg in routed])
    if ep_quant:
        codes = [quantize_tokens(xc) for xc in xs]
    e_local = parts(ps[0]["wi"])[0].shape[-3]
    if e_local == E:                # every expert on the row's own tokens
        ins = ([dequantize_tokens(q, sc, dtype) for q, sc in codes]
               if ep_quant else xs)
        outs = [_tp_experts(cfg, p, x, c, dtype, bf16_reduce)
                for p, x, (c, _) in each_row(zip(ps, ins, routed))]
        return [o.to(dtype) for o in outs], aux
    devs = [xc.device for xc in xs]
    if ep_quant:                    # int8 codes and their scales move
        qs = gather_rows([q for q, _ in codes], devs, 0)
        scs = gather_rows([sc for _, sc in codes], devs, 0)
        xgs = [dequantize_tokens(q, sc, dtype) for q, sc in zip(qs, scs)]
    else:
        xgs = gather_rows(xs, devs, 0)
    cgs = gather_rows([c for c, _ in routed], devs, 0)
    partials = [_tp_experts(cfg, p, xg, cg[..., d * e_local:
                                           (d + 1) * e_local],
                            dtype, bf16_reduce)
                for d, (p, xg, cg) in enumerate(each_row(zip(ps, xgs, cgs)))]
    outs = reduce_scatter_rows(partials, devs, 0, [x.shape[0] for x in xs])
    return [o.to(dtype) for o in outs], aux


def apply_moe(cfg: ModelConfig, p: Params, x: torch.Tensor,
              token_chunk: int = 4096, ep_quant: bool = False,
              bf16_reduce: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out (B, S, D), aux loss): every expert computes;
    the (E, B, Sc, F) activations are weighted by the router BEFORE the
    down projection and E and F contract together, so the per-expert
    (E, B, Sc, D) output never exists. Sequences longer than
    ``token_chunk`` run a chunk at a time (the chunk halved until it
    divides S) and the aux loss is the chunks' mean, as JAX's scan.
    ``ep_quant``: the experts read each token through its int8 code and
    scale; ``bf16_reduce``: the contraction's output in bf16."""
    outs, aux = apply_moe_rows(cfg, [p], [x], token_chunk, ep_quant,
                               bf16_reduce)
    return outs[0], aux


def apply_moe_rows(cfg: ModelConfig, ps: Sequence[Params],
                   xs: Sequence[torch.Tensor], token_chunk: int = 4096,
                   ep_quant: bool = False, bf16_reduce: bool = False
                   ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """``apply_moe`` over the data rows of a mesh (the module docstring):
    ``ps[d]`` row d's MoE params (its local experts under expert
    parallelism), ``xs[d]`` its (B_d, S, D) tokens. Returns (each row's
    out, the aux loss on row 0's device)."""
    S = xs[0].shape[1]
    if S <= token_chunk:
        return _ffn_rows(cfg, ps, xs, ep_quant, bf16_reduce)
    chunk = token_chunk
    while S % chunk:
        chunk //= 2
    outs, auxs = zip(*(_ffn_rows(cfg, ps, [x[:, c:c + chunk] for x in xs],
                                 ep_quant, bf16_reduce)
                       for c in range(0, S, chunk)))
    return ([torch.cat([o[d] for o in outs], dim=1)
             for d in range(len(xs))], torch.stack(auxs).mean())


def apply_moe_topk(cfg: ModelConfig, p: Params, x: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same function computing only the selected experts. Tokens are
    grouped by expert: expert e multiplies the rows that picked it by its
    own (D, F) and (F, D) weights, and each row's k outputs are summed
    weighted by their gates in the router's k order (JAX's ``tkd,tk->td``
    sums over k in that order). The one-row form of JAX's function, which
    the tests hold against it; the model calls ``apply_moe_topk_rows``."""
    out, logits = _moe_topk(cfg, p, x)
    return out, load_balancing_loss(cfg, logits)


def apply_moe_topk_rows(cfg: ModelConfig, ps: Sequence[Params],
                        xs: Sequence[torch.Tensor]
                        ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """``apply_moe_topk`` over the data rows of a mesh, each row with
    every expert on its own tokens; the aux loss over all rows' tokens."""
    outs, logits = zip(*(_moe_topk(cfg, p, x)
                         for p, x in each_row(zip(ps, xs))))
    return list(outs), _aux_rows(cfg, logits)


def _moe_topk(cfg: ModelConfig, p: Params, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``apply_moe_topk``'s output and its (T, E) router logits."""
    e = cfg.moe
    B, S, D = x.shape
    act = common.activation_fn(cfg.activation)
    xt = x.reshape(B * S, D)
    logits = _router_logits(p, xt)
    topv, topi = _top_k(logits, e.num_experts_per_tok)
    gate = torch.softmax(topv, dim=-1).to(x.dtype)              # (T, k)
    groups = [(ex, *torch.nonzero(topi == ex, as_tuple=True))
              for ex in torch.unique(topi).tolist()]

    def experts(pe: Params, xs: torch.Tensor, gs: torch.Tensor
                ) -> torch.Tensor:
        dev = xs.device
        down = xs.new_zeros((xs.shape[0], e.num_experts_per_tok, D))
        for ex, rows, slot in groups:
            rows, slot = rows.to(dev), slot.to(dev)
            xe = xs[rows]
            up = xe @ pe["wi"][ex].to(x.dtype)
            if cfg.gated_mlp:
                up = act(xe @ pe["wg"][ex].to(x.dtype)) * up
            else:
                up = act(up)
            down[rows, slot] = up @ pe["wo"][ex].to(x.dtype)
        return torch.einsum("tkd,tk->td", down, gs)

    if len(parts(p["wi"])) > 1:
        count_backward_reduce(xt, gate)
    out = all_reduce_sum([experts(local(p, s), xt.to(w.device),
                                  gate.to(w.device))
                          for s, w in enumerate(parts(p["wi"]))], x.device)
    return out.reshape(B, S, D), logits
