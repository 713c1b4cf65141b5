"""Plain PyTorch fused predictor MLP (counterpart of
``repro/kernels/predictor_mlp/ref.py``)."""
from __future__ import annotations

import torch


def predictor_mlp_ref(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                      w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """x: (R, F); w1: (F, H); b1: (H,); w2: (H, 1); b2: (1,) -> (R,) prob."""
    h = torch.relu(x.float() @ w1.float() + b1.float())
    return torch.sigmoid((h @ w2.float() + b2.float())[..., 0])
