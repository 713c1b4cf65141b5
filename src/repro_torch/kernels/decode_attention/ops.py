"""Model-layer entry point for decode attention (counterpart of
``repro/kernels/decode_attention/ops.py``)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.decode_attention.decode_attention import (
    decode_attention_fwd)


def decode_attention(cfg, q, k_cache, v_cache, cache_len,
                     window: Optional[int] = None) -> torch.Tensor:
    """Same signature as ``models.attention.attend_decode``."""
    return decode_attention_fwd(q, k_cache, v_cache, cache_len,
                                window=window)
