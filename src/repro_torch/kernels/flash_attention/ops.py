"""Model-layer entry point for prefill flash attention (counterpart of
``repro/kernels/flash_attention/ops.py``)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention_fwd)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q: (B, S, H, hd); k, v: (B, S, KVH, hd) -> (B, S, H, hd)."""
    return flash_attention_fwd(q, k, v, causal=causal, window=window)
