"""Entry point of the speculative LM head (counterpart of
``repro/kernels/spec_head/ops.py``): the kernel's gathered logits (the
quantized kernel for a ``QTensor`` head), then the softmax over the k of
them, as in the JAX package."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.spec_head.spec_head import (spec_head_logits,
                                                     spec_head_logits_q)
from repro_torch.quant import QTensor


def spec_head(hn: torch.Tensor, lm_head,
              spec_ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """hn (R, D) final-normed hidden; lm_head (D, V) tensor or QTensor;
    spec_ids (R, k) int32. Returns (logits (R, k) fp32, local_probs (R, k)
    fp32)."""
    if isinstance(lm_head, QTensor):
        logits = spec_head_logits_q(hn, lm_head, spec_ids)
    else:
        logits = spec_head_logits(hn, lm_head, spec_ids)
    return logits, torch.softmax(logits, dim=-1)
