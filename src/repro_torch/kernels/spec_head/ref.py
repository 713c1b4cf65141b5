"""Plain PyTorch speculative LM head (counterpart of
``repro/kernels/spec_head/ref.py``): gather + k-GEMM + softmax. A
quantized head (``QTensor``) is gathered first and then dequantized
(``take_columns``): with per-column scales that equals gathering the
dequantized head. ``spec_gather_ref`` and ``spec_dot_ref`` are the plain
versions of the fp kernel's two stages (the column gather and the dot over
the gathered columns)."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.quant import QTensor, take_columns


def spec_logits_ref(hn: torch.Tensor, lm_head,
                    spec_ids: torch.Tensor) -> torch.Tensor:
    """hn: (R, D); lm_head: (D, V) tensor or QTensor; spec_ids: (R, k) int.
    Returns (R, k) fp32 logits — the k head columns gathered per row."""
    if isinstance(lm_head, QTensor):
        cols = take_columns(lm_head, spec_ids)                # (D, R, k)
    else:
        cols = lm_head[:, spec_ids.long()]
    cols = cols.permute(1, 0, 2)                              # (R, D, k)
    return torch.einsum("bd,bdk->bk", hn.float(), cols.float())


def spec_gather_ref(lm_head: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """lm_head: (D, V); ids: (C,) int. Returns the (C, D) columns
    ``lm_head[:, ids[c]]`` in the head's dtype, ids clamped to [0, V) as
    the kernel clamps them."""
    V = lm_head.shape[1]
    return lm_head[:, ids.long().clamp(0, V - 1)].t().contiguous()


def spec_dot_ref(hn: torch.Tensor, cols: torch.Tensor,
                 idx: torch.Tensor) -> torch.Tensor:
    """hn: (R, D); cols: (C, D); idx: (R, k) int rows of ``cols``, clamped
    to [0, C). Returns (R, k) fp32 logits ``hn[r] . cols[idx[r, j]]``."""
    rows = cols[idx.long().clamp(0, cols.shape[0] - 1)]       # (R, k, D)
    return torch.einsum("bd,bkd->bk", hn.float(), rows.float())


def spec_head_ref(hn: torch.Tensor, lm_head,
                  spec_ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (R, k) fp32, local_probs (R, k) fp32)."""
    logits = spec_logits_ref(hn, lm_head, spec_ids)
    return logits, torch.softmax(logits, dim=-1)
