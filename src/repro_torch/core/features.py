"""T1 — speculation features (counterpart of ``repro/core/features.py``).

Three features per speculative token, k=4 tokens -> 12-dim input:
  (1) speculative token logits — h·lm_head[:, spec_ids], a gather-GEMM
  (2) local probabilities      — softmax over the k logits
  (3) probability variation    — local probs minus the previous layer's

The AR engine computes them inside the fused exit gate
(``kernels.exit_gate``); this module is the tree gate's building block,
whose hyper-token min-merge sits between the features and the predictor.
``extract_features`` is the plain route (a quantized head, ``QTensor``,
gathers then dequantizes). The tree gate takes the spec-head kernel
(``kernels.spec_head``) in two stages, for an fp head and a quantized one
alike: the node tokens' columns (or code columns and scales) gathered once
per step (``node_columns``), then ``column_features`` at each exit point.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from repro_torch.kernels.spec_head import spec_head as sh_kern
from repro_torch.kernels.spec_head.ref import QCols, spec_logits_ref
from repro_torch.quant import QTensor

__all__ = ["spec_logits_ref", "extract_features", "node_columns",
           "column_features", "merge_path_features"]


def _features(logits: torch.Tensor, probs: torch.Tensor,
              prev_probs: torch.Tensor) -> torch.Tensor:
    return torch.cat([logits, probs, probs - prev_probs.float()], dim=-1)


def extract_features(hn: torch.Tensor, lm_head,
                     spec_ids: torch.Tensor, prev_probs: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 3k feature vector at one exit point, on the plain route. hn:
    (R, D) final-normed hidden; spec_ids: (R, k) int32; prev_probs: (R, k)
    local probabilities at the previous exit point. Returns (features
    (R, 3k) fp32, local_probs (R, k) fp32)."""
    logits = spec_logits_ref(hn, lm_head, spec_ids)
    probs = torch.softmax(logits, dim=-1)
    return _features(logits, probs, prev_probs), probs


def node_columns(lm_head, node_tokens: torch.Tensor, use_kernel: bool
                 ) -> Optional[Union[torch.Tensor, QCols]]:
    """The spec-head kernel's first stage for a tree step: the head's
    columns of every node token, ``node_tokens`` (B, N) int32 — for a
    (D, V) fp head a (B*N, D) buffer in the head's dtype
    (``spec_head_gather``), for a ``QTensor`` head the columns' stored
    codes and scales (``spec_head_gather_q``). None on the plain path:
    there ``extract_features`` gathers at each call."""
    if not use_kernel:
        return None
    ids = node_tokens.reshape(-1)
    if isinstance(lm_head, QTensor):
        return sh_kern.spec_head_gather_q(lm_head, ids)
    return sh_kern.spec_head_gather(lm_head, ids)


def column_features(hn: torch.Tensor, cols: Union[torch.Tensor, QCols],
                    col_idx: torch.Tensor, prev_probs: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``extract_features`` over gathered columns: row r's k speculative
    tokens are the rows ``col_idx[r]`` (R, k) of ``cols`` (``node_columns``'
    output, fp or quantized). Returns (features (R, 3k) fp32, local_probs
    (R, k) fp32)."""
    if isinstance(cols, QCols):
        logits = sh_kern.spec_head_dot_q(hn, cols, col_idx)
    else:
        logits = sh_kern.spec_head_dot(hn, cols, col_idx)
    probs = torch.softmax(logits, dim=-1)
    return _features(logits, probs, prev_probs), probs


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
