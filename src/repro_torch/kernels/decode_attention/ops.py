"""Model-layer entry points for decode attention (counterpart of
``repro/kernels/decode_attention/ops.py``)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.decode_attention.decode_attention import (
    decode_attention_fwd, paged_decode_attention_fwd)


def decode_attention(cfg, q, k_cache, v_cache, cache_len,
                     window: Optional[int] = None) -> torch.Tensor:
    """Same signature as ``models.attention.attend_decode``."""
    return decode_attention_fwd(q, k_cache, v_cache, cache_len,
                                window=window)


def paged_decode_attention(cfg, q, k_pool, v_pool, page_table, cache_len,
                           window: Optional[int] = None,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Page-table-aware variant read by the paged decode path
    (``model._block_step`` under ``flags.decode_kernel``).
    ``k_scale``/``v_scale`` carry the fp32 scale pools of int8 K/V pools
    under ``flags.kv_quant``."""
    return paged_decode_attention_fwd(q, k_pool, v_pool, page_table,
                                      cache_len, window=window,
                                      k_scale=k_scale, v_scale=v_scale)
