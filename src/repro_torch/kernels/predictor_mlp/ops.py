"""Entry points of the fused predictor MLP (counterpart of
``repro/kernels/predictor_mlp/ops.py``), for 2-layer predictors in the
``repro_torch.core.predictor`` layout; a bank whose ``w`` leaves are
``QTensor``s takes the quantized kernel."""
from __future__ import annotations

import torch

from repro_torch.kernels.predictor_mlp.predictor_mlp import (
    predictor_mlp_fused, predictor_mlp_fused_q)
from repro_torch.models.common import tree_map
from repro_torch.quant import QTensor


def predictor_mlp(x: torch.Tensor, params) -> torch.Tensor:
    """x: (R, F); params: {"layers": [{w, b}, {w, b}]} -> (R,) exit
    probabilities."""
    l1, l2 = params["layers"]
    fused = (predictor_mlp_fused_q if isinstance(l1["w"], QTensor)
             else predictor_mlp_fused)
    return fused(x.float().contiguous(), l1["w"], l1["b"], l2["w"], l2["b"])


def predictor_mlp_at(x: torch.Tensor, stacked, ep: int) -> torch.Tensor:
    """Stacked-bank entry: predictor ``ep`` of the (E, ...)-stacked bank
    (contiguous views, no copy; a quantized bank's codes and scales both
    carry the leading E dim) through the fused MLP. x: (R, F)."""
    return predictor_mlp(x, tree_map(lambda a: a[ep], stacked))
