"""Plain PyTorch decode attention (counterpart of
``repro/kernels/decode_attention/ref.py::decode_attention_ref``)."""
from __future__ import annotations

import math
from typing import Optional

import torch


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, cache_len,
                         window: Optional[int] = None) -> torch.Tensor:
    """q: (B, 1, H, hd); k_cache/v_cache: (B, S, KVH, hd); cache_len:
    (B,) int. Returns (B, 1, H, hd)."""
    B, S, KVH, hd = k_cache.shape
    n_rep = q.shape[2] // KVH
    if n_rep > 1:
        k_cache = k_cache.repeat_interleave(n_rep, dim=2)
        v_cache = v_cache.repeat_interleave(n_rep, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k_cache).float()
    logits = logits * (1.0 / math.sqrt(hd))
    kpos = torch.arange(S, device=q.device)[None, :]
    clen = torch.as_tensor(cache_len, device=q.device).reshape(-1, 1)
    valid = kpos < clen
    if window is not None:
        valid = valid & (kpos >= clen - window)
    logits = torch.where(valid[:, None, None, :], logits,
                         torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v_cache.dtype), v_cache)


def paged_decode_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                               v_pool: torch.Tensor, page_table: torch.Tensor,
                               cache_len,
                               window: Optional[int] = None,
                               k_scale: Optional[torch.Tensor] = None,
                               v_scale: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """Plain version of the paged kernel (counterpart of ``repro/kernels/
    decode_attention/ref.py::paged_decode_attention_ref``): gather the
    logical view, then run the dense version. k_pool/v_pool: (n_pages, ps,
    KVH, hd); page_table: (B, P) int32.

    With ``k_scale``/``v_scale`` ((n_pages, ps, KVH) fp32) the pools hold
    int8 codes: the gathered codes are dequantized in fp32 and attended in
    fp32, as the Pallas tile of ``_paged_kernel_q`` does, and the output
    is cast to q's dtype."""
    from repro_torch.core import paged as paged_lib
    k_cache = paged_lib.gather_view(k_pool, page_table)
    v_cache = paged_lib.gather_view(v_pool, page_table)
    if k_scale is None:
        return decode_attention_ref(q, k_cache, v_cache, cache_len,
                                    window=window)
    k_cache = (k_cache.float()
               * paged_lib.gather_view(k_scale, page_table)[..., None])
    v_cache = (v_cache.float()
               * paged_lib.gather_view(v_scale, page_table)[..., None])
    return decode_attention_ref(q.float(), k_cache, v_cache, cache_len,
                                window=window).to(q.dtype)
