"""Plain PyTorch fused predictor MLP (counterpart of
``repro/kernels/predictor_mlp/ref.py``), and the plain version of the
quantized kernel (JAX ``predictor_mlp.py::_kernel_q``: each scale after its
dot)."""
from __future__ import annotations

import torch

from repro_torch.quant import QTensor, matmul_codes


def predictor_mlp_ref(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                      w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """x: (R, F); w1: (F, H); b1: (H,); w2: (H, 1); b2: (1,) -> (R,) prob."""
    h = torch.relu(x.float() @ w1.float() + b1.float())
    return torch.sigmoid((h @ w2.float() + b2.float())[..., 0])


def predictor_mlp_q_ref(x: torch.Tensor, qw1: QTensor, b1: torch.Tensor,
                        qw2: QTensor, b2: torch.Tensor) -> torch.Tensor:
    """x: (R, F); qw1: QTensor (F, H); b1: (H,); qw2: QTensor (H, 1);
    b2: (1,) -> (R,) prob."""
    h = torch.relu(matmul_codes(x, qw1) + b1.float())
    return torch.sigmoid((matmul_codes(h, qw2) + b2.float())[..., 0])
