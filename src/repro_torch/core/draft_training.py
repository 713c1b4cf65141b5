"""Draft (DLM) training against the frozen target (counterpart of
``repro/core/draft_training.py``; paper §7.4.3).

Objective, teacher-forced over the frozen target:
  * token loss: CE of the draft hidden (through the target's LM head)
    against the target's own greedy next token, which aligns the draft's
    top-k with the target;
  * feature loss: L2 between the draft hidden and the target hidden of the
    same position (EAGLE's feature-uncertainty recipe).
Only the draft's parameters take gradients: the target's pass runs under
``torch.no_grad()``, and since the target is frozen its outputs for a batch
are computed once and reused on every step that batch comes round (the JAX
step recomputes them inside its jit; the numbers are the same). The update
is the JAX closure's hand-written Adam (no weight decay, no clipping).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from repro_torch.core import draft as draft_lib
from repro_torch.models.common import Params, tree_leaves, tree_unflatten
from repro_torch.models.model import Model
from repro_torch.optim.adamw import adam_step

Teacher = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _teacher(model: Model, params: Params, tokens: torch.Tensor) -> Teacher:
    """Frozen-target quantities: embeds, final hiddens, greedy next
    tokens (argmax ties to the lowest id)."""
    with torch.no_grad():
        B, S = tokens.shape
        h = model.embed(params, tokens)
        positions = torch.arange(S, device=h.device)[None, :].expand(B, S)
        hf, _, _ = model.forward_hidden(params, h, positions)
        greedy = torch.argmax(model.logits(params, hf), dim=-1)
    return h, hf, greedy


def _draft_logits(model: Model, params: Params, dp: Params,
                  teacher: Teacher) -> Tuple[torch.Tensor, torch.Tensor]:
    embeds, hf, _ = teacher
    h_draft = draft_lib.draft_forward_seq(model.cfg, dp, embeds,
                                          draft_lib.shift_hidden(hf))
    return h_draft, model.logits(params, h_draft)        # (B, S, V) fp32


def _loss(model: Model, params: Params, dp: Params, teacher: Teacher,
          feat_weight: float):
    _, hf, greedy = teacher
    h_draft, dlogits = _draft_logits(model, params, dp, teacher)
    lse = torch.log_softmax(dlogits, dim=-1)
    ce = -torch.gather(lse, -1, greedy[..., None]).mean()
    feat = (h_draft.float() - hf.float()).square().mean()
    return ce + feat_weight * feat, (ce, feat)


def draft_loss(model: Model, params: Params, dp: Params,
               tokens: torch.Tensor, feat_weight: float = 0.1):
    """-> (ce + feat_weight * feat, (ce, feat)); differentiable in ``dp``
    only."""
    return _loss(model, params, dp, _teacher(model, params, tokens),
                 feat_weight)


def train_draft(model: Model, params: Params,
                token_batches: List[torch.Tensor], gen: torch.Generator,
                steps: int = 200, lr: float = 1e-3
                ) -> Tuple[Params, Dict[str, float]]:
    """Adam on a fresh draft (``draft.init_draft(model.cfg, gen, ...)``)
    for ``steps`` steps over ``token_batches`` in turn. Returns (draft
    params, {"first_loss", "final_loss", "topk_hit_rate"})."""
    device = params["embed"]["tok"].device
    dp = draft_lib.init_draft(model.cfg, gen, model.dtype, device)
    flat = [x.detach() for x in tree_leaves(dp)]
    m = [torch.zeros_like(x) for x in flat]
    v = [torch.zeros_like(x) for x in flat]
    teachers: Dict[int, Teacher] = {}
    first = loss = None
    for i in range(steps):
        j = i % len(token_batches)
        if j not in teachers:
            teachers[j] = _teacher(model, params, token_batches[j])
        leaves = [x.requires_grad_(True) for x in flat]
        loss, _ = _loss(model, params, tree_unflatten(dp, leaves),
                        teachers[j], 0.1)
        grads = torch.autograd.grad(loss, leaves)
        loss = loss.detach()
        first = loss if first is None else first
        flat, m, v = adam_step(flat, grads, m, v, i, lr)
    dp = tree_unflatten(dp, flat)
    metrics = {"first_loss": float(first), "final_loss": float(loss)}
    metrics.update(topk_hit_rate(model, params, dp, token_batches[0],
                                 model.run.specee.num_speculative))
    return dp, metrics


def topk_hit_rate(model: Model, params: Params, dp: Params,
                  tokens: torch.Tensor, k: int) -> Dict[str, float]:
    """Share of positions where the target's greedy token is inside the
    draft's top-k proposal (ties to ascending id, a stable sort)."""
    with torch.no_grad():
        teacher = _teacher(model, params, tokens)
        _, dlogits = _draft_logits(model, params, dp, teacher)
        topk = torch.sort(dlogits, dim=-1, descending=True,
                          stable=True)[1][..., :k]
        hit = (topk == teacher[2][..., None]).any(dim=-1)
        return {"topk_hit_rate": float(hit.float().mean())}
