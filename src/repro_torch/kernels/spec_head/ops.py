"""Entry point of the speculative LM head (counterpart of
``repro/kernels/spec_head/ops.py``): the kernel's gathered logits, then the
softmax over the k of them, as in the JAX package."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.spec_head.spec_head import spec_head_logits


def spec_head(hn: torch.Tensor, lm_head: torch.Tensor,
              spec_ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """hn (R, D) final-normed hidden; lm_head (D, V); spec_ids (R, k) int32.
    Returns (logits (R, k) fp32, local_probs (R, k) fp32)."""
    logits = spec_head_logits(hn, lm_head, spec_ids)
    return logits, torch.softmax(logits, dim=-1)
