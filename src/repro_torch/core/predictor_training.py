"""Offline predictor training (paper §7.4.4) and offline exit statistics
(§5.3) — counterpart of ``repro/core/predictor_training.py``.

The recipe:
  * run the frozen model over prompts, collecting at every exit point the
    3k speculation features and a binary label: does the argmax of the LM
    head at this exit point equal the last layer's?
  * train one small MLP per exit point, all exit points at once (Adam);
  * histogram where exits happen under SpecEE decoding with every
    predictor active: the T2 offline schedule
    (``scheduler.offline_mask_from_counts``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.config import SpecEEConfig
from repro_torch.core import draft as draft_lib
from repro_torch.core import features as feat_lib
from repro_torch.core import predictor as pred_lib
from repro_torch.models.common import (Params, index_tree, lm_head_weight,
                                       tree_leaves, tree_unflatten)
from repro_torch.models.model import Model, _block_seq
from repro_torch.optim.adamw import adam_step


class FeatureDataset(NamedTuple):
    features: torch.Tensor   # (E, T, 3k) fp32
    labels: torch.Tensor     # (E, T) fp32 {0, 1}


def _topk_ids(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Top-k ids, ties to ascending id (a stable descending sort)."""
    return torch.sort(logits, dim=-1, descending=True,
                      stable=True)[1][..., :k].to(torch.int32)


@torch.no_grad()
def _collect_batch(model: Model, params: Params, draft_params: Params,
                   tokens: torch.Tensor) -> FeatureDataset:
    """Teacher-forced feature collection over a token batch (B, S).

    For every position t and exit point e: the features of the hidden state
    after unit e, and label = [argmax(LM head at e) == argmax(LM head at the
    last unit)]. The speculative set is the draft's top-k at each position,
    with the decode-consistent pairing: position t fuses (embed(tokens[t]),
    h[t-1])."""
    k = model.run.specee.num_speculative
    lm_w = lm_head_weight(params)
    B, S = tokens.shape
    h = model.embed(params, tokens)
    positions = torch.arange(S, device=h.device)[None, :].expand(B, S)
    hs: List[torch.Tensor] = []
    for seg, (unit, reps) in enumerate(model.segments):
        for r in range(reps):
            up = index_tree(params["segments"][seg], r)
            for i, kind in enumerate(unit):
                h, _, _ = _block_seq(model.cfg, kind, up[f"u{i}"], h,
                                     positions, model.flags)
            hs.append(h)
    hd = draft_lib.draft_forward_seq(model.cfg, draft_params,
                                     model.embed(params, tokens),
                                     draft_lib.shift_hidden(hs[-1]))
    flat_ids = _topk_ids(model.logits(params, hd), k).reshape(B * S, k)
    final_tok = torch.argmax(model.logits(params, hs[-1]), dim=-1)
    prev = torch.full((B * S, k), 1.0 / k, dtype=torch.float32,
                      device=h.device)
    feats, labels = [], []
    for h_e in hs:
        hn = model.final_norm(params, h_e)
        f, prev = feat_lib.extract_features(hn.reshape(B * S, -1), lm_w,
                                            flat_ids, prev)
        gtok = torch.argmax((hn @ lm_w.to(h_e.dtype)).float(), dim=-1)
        feats.append(f)
        labels.append((gtok == final_tok).reshape(B * S).float())
    return FeatureDataset(features=torch.stack(feats),
                          labels=torch.stack(labels))


def collect_dataset(model: Model, params: Params, draft_params: Params,
                    token_batches: List[torch.Tensor]) -> FeatureDataset:
    parts = [_collect_batch(model, params, draft_params, tb)
             for tb in token_batches]
    return FeatureDataset(
        features=torch.cat([p.features for p in parts], dim=1),
        labels=torch.cat([p.labels for p in parts], dim=1))


# ---------------------------------------------------------------------------
# training (Adam on the stacked predictors: all exit points at once)
# ---------------------------------------------------------------------------
def _apply_stacked(p: Params, feats: torch.Tensor) -> torch.Tensor:
    """The stacked bank on per-exit-point features: feats (E, b, F) ->
    exit probabilities (E, b) (JAX's ``vmap(apply_predictor)``)."""
    x = feats.float()
    layers = p["layers"]
    for i, layer in enumerate(layers):
        x = torch.bmm(x, layer["w"]) + layer["b"][:, None, :]
        if i + 1 < len(layers):
            x = torch.relu(x)
    return torch.sigmoid(x[..., 0])


def train_predictors(spec: SpecEEConfig, data: FeatureDataset,
                     gen: torch.Generator, steps: int = 300,
                     lr: float = 1e-3, batch: int = 256,
                     pos_weight: float = 1.0
                     ) -> Tuple[Params, Dict[str, float]]:
    """Adam on a fresh stacked bank (``predictor.init_predictors``) with a
    BCE loss over minibatches drawn by ``np.random.default_rng(0)``, the
    JAX package's index stream. Returns (bank, {"first_loss",
    "final_loss", "accuracy", "positive_rate"}), the last two over the
    whole dataset at ``spec.exit_threshold``."""
    E, T, F = data.features.shape
    device = data.features.device
    params = pred_lib.init_predictors(spec, E, gen, device)
    flat = [x.detach() for x in tree_leaves(params)]
    m = [torch.zeros_like(x) for x in flat]
    v = [torch.zeros_like(x) for x in flat]
    rng = np.random.default_rng(0)
    first = loss = None
    for i in range(steps):
        idx = torch.as_tensor(rng.integers(0, T, size=(batch,)),
                              device=device)
        feats = data.features[:, idx, :]
        labels = data.labels[:, idx]
        leaves = [x.requires_grad_(True) for x in flat]
        probs = _apply_stacked(tree_unflatten(params, leaves), feats)
        loss = -(pos_weight * labels * torch.log(probs + 1e-6) +
                 (1 - labels) * torch.log(1 - probs + 1e-6)).mean()
        grads = torch.autograd.grad(loss, leaves)
        loss = loss.detach()
        first = loss if first is None else first
        flat, m, v = adam_step(flat, grads, m, v, i, lr)
    params = tree_unflatten(params, flat)
    with torch.no_grad():
        probs = _apply_stacked(params, data.features)
        pred = (probs > spec.exit_threshold).float()
        acc = float((pred == data.labels).float().mean())
        pos_rate = float(data.labels.mean())
    return params, {"accuracy": acc, "positive_rate": pos_rate,
                    "first_loss": float(first), "final_loss": float(loss)}


# ---------------------------------------------------------------------------
# offline exit statistics -> T2 offline schedule
# ---------------------------------------------------------------------------
def offline_exit_counts(model: Model, params: Params, sw, token_batches,
                        max_new: int = 16) -> np.ndarray:
    """Histogram (E + 1,) of the exit points of SpecEE decoding with every
    predictor active (``schedule_enabled=False``; index E = full depth),
    ``max_new`` steps per batch, on a model built with ``model``'s flags
    (the kernels on the card, under the kernel flags)."""
    from repro_torch.api import SpecEEStrategy
    E = model.num_exit_points
    counts = np.zeros(E + 1, np.int64)
    spec_all = dataclasses.replace(model.run.specee, schedule_enabled=False)
    model_all = type(model)(dataclasses.replace(model.run, specee=spec_all),
                            model.flags)
    strat = SpecEEStrategy()
    for tokens in token_batches:
        B, T = tokens.shape
        _, st = strat.init_state(model_all, params, sw, {"tokens": tokens},
                                 T + max_new + 1)
        for _ in range(max_new):
            res, st = strat.step(model_all, params, sw, st)
            pts = np.minimum(res.exit_layer.cpu().numpy(), E)
            np.add.at(counts, pts, 1)
    return counts
