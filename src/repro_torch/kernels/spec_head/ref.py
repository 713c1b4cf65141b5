"""Plain PyTorch speculative LM head (counterpart of
``repro/kernels/spec_head/ref.py``): gather + k-GEMM + softmax. A
quantized head (``QTensor``) is gathered first and then dequantized
(``take_columns``): with per-column scales that equals gathering the
dequantized head. ``spec_gather_ref`` and ``spec_dot_ref`` are the plain
versions of the fp kernel's two stages (the column gather and the dot over
the gathered columns), ``spec_gather_q_ref`` and ``spec_dot_q_ref`` those
of the quantized kernel's (the code columns and their scales gathered,
then the dot over the widened codes and the scale)."""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.quant import QTensor, take_columns, unpack_int4


class QCols(NamedTuple):
    """Gathered columns of a quantized head: ``codes`` (C, Dp) int8, the
    stored bytes of each column (Dp = D for int8, D/2 for plane-packed
    int4), ``scales`` (C,) fp32, and the codes' ``bits``."""
    codes: torch.Tensor
    scales: torch.Tensor
    bits: int


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


def spec_gather_q_ref(qt: QTensor, ids: torch.Tensor) -> QCols:
    """qt: QTensor of logical shape (D, V); ids: (C,) int. Returns the
    (C, Dp) stored code columns ``qt.q[:, ids[c]]`` and their (C,) scales,
    ids clamped to [0, V) as the kernel clamps them."""
    V = qt.q.shape[-1]
    i = ids.long().clamp(0, V - 1)
    return QCols(qt.q[:, i].t().contiguous(), qt.scale[i].contiguous(),
                 qt.bits)


def spec_dot_q_ref(hn: torch.Tensor, cols: QCols,
                   idx: torch.Tensor) -> torch.Tensor:
    """hn: (R, D); cols: ``spec_gather_q_ref``'s output; idx: (R, k) int
    rows of the gathered columns, clamped to [0, C). Returns (R, k) fp32
    logits ``(hn[r] . codes[c]) * scales[c]``, c = idx[r, j]: the codes
    widened (an int4 byte at stored row d to hidden rows d and d + D/2),
    the fp32 dot, then the scale."""
    i = idx.long().clamp(0, cols.codes.shape[0] - 1)
    codes = cols.codes[i]                                     # (R, k, Dp)
    if cols.bits == 4:
        codes = torch.cat(unpack_int4(codes), dim=-1)         # (R, k, D)
    dots = torch.einsum("bd,bkd->bk", hn.float(), codes.float())
    return dots * cols.scales[i]


def spec_head_ref(hn: torch.Tensor, lm_head,
                  spec_ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (R, k) fp32, local_probs (R, k) fp32)."""
    logits = spec_logits_ref(hn, lm_head, spec_ids)
    return logits, torch.softmax(logits, dim=-1)
