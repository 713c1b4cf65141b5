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
D) partials go through ``all_reduce_sum``. JAX's expert-parallel options
(``_pin_experts``, ``_ep_quantized_gather``, ``bf16_reduce``) act on a
'data' axis the port does not shard (``ModelFlags.moe_ep_quant`` /
``moe_bf16_reduce`` are refused).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import common
from repro_torch.models.common import Params
from repro_torch.runtime.collectives import all_reduce_sum
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


def load_balancing_loss(cfg: ModelConfig,
                        router_logits: torch.Tensor) -> torch.Tensor:
    """Switch-style aux loss: E * sum_e f_e * p_e * weight (f = fraction of
    the k picks routed to e, p = mean router probability)."""
    e = cfg.moe
    probs = torch.softmax(router_logits, dim=-1)                # (T, E)
    _, topi = _top_k(router_logits, e.num_experts_per_tok)
    counts = torch.zeros_like(probs).scatter_add_(
        -1, topi, torch.ones_like(topi, dtype=probs.dtype))     # (T, E)
    f = counts.mean(dim=0)
    pm = probs.mean(dim=0)
    return e.num_experts * torch.sum(f * pm) * e.router_aux_loss_weight


def apply_moe(cfg: ModelConfig, p: Params, x: torch.Tensor,
              token_chunk: int = 4096) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out (B, S, D), aux loss): every expert computes;
    the (E, B, Sc, F) activations are weighted by the router BEFORE the
    down projection and E and F contract together, so the per-expert
    (E, B, Sc, D) output never exists. Sequences longer than
    ``token_chunk`` run a chunk at a time (the chunk halved until it
    divides S) and the aux loss is the chunks' mean, as JAX's scan."""
    B, S, D = x.shape
    act = common.activation_fn(cfg.activation)
    E = cfg.moe.num_experts

    def experts(pe: Params, xc: torch.Tensor, comb: torch.Tensor
                ) -> torch.Tensor:
        up = torch.einsum("bsd,edf->ebsf", xc, pe["wi"].to(x.dtype))
        if cfg.gated_mlp:
            gate_h = torch.einsum("bsd,edf->ebsf", xc, pe["wg"].to(x.dtype))
            up = act(gate_h) * up
        else:
            up = act(up)
        up = up * comb.to(x.dtype).permute(2, 0, 1)[..., None]
        return torch.einsum("ebsf,efd->bsd", up, pe["wo"].to(x.dtype))

    def ffn(xc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        combine, logits = router_probs(cfg, p, xc)              # (B,Sc,E)
        outs = [experts(local(p, s), xc.to(w.device), combine.to(w.device))
                for s, w in enumerate(parts(p["wi"]))]
        return (all_reduce_sum(outs, xc.device),
                load_balancing_loss(cfg, logits.reshape(-1, E)))

    if S <= token_chunk:
        return ffn(x)
    chunk = token_chunk
    while S % chunk:
        chunk //= 2
    outs, auxs = zip(*(ffn(x[:, c:c + chunk]) for c in range(0, S, chunk)))
    return torch.cat(outs, dim=1), torch.stack(auxs).mean()


def apply_moe_topk(cfg: ModelConfig, p: Params, x: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same function computing only the selected experts. Tokens are
    grouped by expert: expert e multiplies the rows that picked it by its
    own (D, F) and (F, D) weights, and each row's k outputs are summed
    weighted by their gates in the router's k order (JAX's ``tkd,tk->td``
    sums over k in that order)."""
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

    out = all_reduce_sum([experts(local(p, s), xt.to(w.device),
                                  gate.to(w.device))
                          for s, w in enumerate(parts(p["wi"]))], x.device)
    return out.reshape(B, S, D), load_balancing_loss(cfg, logits)
