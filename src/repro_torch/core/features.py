"""T1 — speculation features (counterpart of ``repro/core/features.py``).

Three features per speculative token, k=4 tokens -> 12-dim input:
  (1) speculative token logits — h·lm_head[:, spec_ids], a gather-GEMM
  (2) local probabilities      — softmax over the k logits
  (3) probability variation    — local probs minus the previous layer's

The AR engine computes them inside the fused exit gate
(``kernels.exit_gate``); this module is the tree gate's building block,
whose hyper-token min-merge sits between the features and the predictor.
``use_kernel`` selects the spec-head kernel (``kernels.spec_head``); a
quantized head (``QTensor``) takes its quantized sibling, or gathers then
dequantizes on the plain path.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.spec_head import ops as sh_ops
from repro_torch.kernels.spec_head.ref import spec_logits_ref

__all__ = ["spec_logits_ref", "extract_features", "merge_path_features"]


def extract_features(hn: torch.Tensor, lm_head,
                     spec_ids: torch.Tensor, prev_probs: torch.Tensor,
                     use_kernel: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 3k feature vector at one exit point. hn: (R, D) final-normed
    hidden; spec_ids: (R, k) int32; prev_probs: (R, k) local probabilities
    at the previous exit point. Returns (features (R, 3k) fp32,
    local_probs (R, k) fp32)."""
    if use_kernel:
        logits, probs = sh_ops.spec_head(hn, lm_head, spec_ids)
    else:
        logits = spec_logits_ref(hn, lm_head, spec_ids)
        probs = torch.softmax(logits, dim=-1)
    feats = torch.cat([logits, probs, probs - prev_probs.float()], dim=-1)
    return feats, probs


def merge_path_features(node_feats: torch.Tensor, node_probs: torch.Tensor,
                        path_nodes: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """T3 — hyper-token feature merge (Cannikin law).

    node_feats: (B, N, 3k); node_probs: (B, N, k); path_nodes: (P, Dmax)
    int node indices per path (-1 padded). A path exits only when its
    weakest node would, so the merged feature is the elementwise minimum
    over the path's nodes: one predictor evaluation per path. Returns
    (path_feats (B, P, 3k), path_probs (B, P, k))."""
    path_nodes = torch.as_tensor(path_nodes, device=node_feats.device).long()
    safe = path_nodes.clamp(min=0)
    valid = (path_nodes >= 0)[None, :, :, None]
    big = torch.tensor(1e30, dtype=torch.float32, device=node_feats.device)
    merged = torch.where(valid, node_feats[:, safe], big).amin(dim=2)
    merged_p = torch.where(valid, node_probs[:, safe], big).amin(dim=2)
    return merged, merged_p
