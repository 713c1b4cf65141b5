"""Entry point of the SSD intra-chunk kernel (counterpart of
``repro/kernels/ssd_chunk/ops.py``)."""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd_chunk.ssd_chunk import ssd_chunk_fwd


def ssd_chunk(xdt: torch.Tensor, cum: torch.Tensor, Bc: torch.Tensor,
              Cc: torch.Tensor) -> torch.Tensor:
    """xdt (B, c, nh, hd); cum (B, c, nh); Bc, Cc (B, c, ds) -> y_diag
    (B, c, nh, hd) fp32. The kernel takes contiguous fp32 ``xdt`` and
    ``cum`` and B/C of one dtype; the inputs are brought to that here (a
    no-op for ``ssd_chunked``'s own tensors)."""
    return ssd_chunk_fwd(xdt.float().contiguous(), cum.float().contiguous(),
                         Bc.contiguous(), Cc.to(Bc.dtype).contiguous())
