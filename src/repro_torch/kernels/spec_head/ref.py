"""Plain PyTorch speculative LM head (counterpart of
``repro/kernels/spec_head/ref.py``): gather + k-GEMM + softmax."""
from __future__ import annotations

from typing import Tuple

import torch


def spec_head_ref(hn: torch.Tensor, lm_head: torch.Tensor,
                  spec_ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """hn: (B, D); lm_head: (D, V); spec_ids: (B, k) int.
    Returns (logits (B, k) fp32, local_probs (B, k) fp32)."""
    cols = lm_head[:, spec_ids.long()].permute(1, 0, 2)      # (B, D, k)
    logits = torch.einsum("bd,bdk->bk", hn.float(), cols.float())
    return logits, torch.softmax(logits, dim=-1)
