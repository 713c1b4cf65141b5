"""Plain PyTorch SSD intra-chunk term (counterpart of
``repro/kernels/ssd_chunk/ref.py::ssd_chunk_ref``)."""
from __future__ import annotations

import torch


def ssd_chunk_ref(xdt: torch.Tensor, cum: torch.Tensor, Bc: torch.Tensor,
                  Cc: torch.Tensor) -> torch.Tensor:
    """One chunk's causal decay-attention.

    xdt: (B, c, nh, hd) — dt-weighted inputs
    cum: (B, c, nh)     — inclusive cumsum of A·dt
    Bc:  (B, c, ds); Cc: (B, c, ds) — input/output matrices (head-shared)
    Returns y_diag: (B, c, nh, hd) fp32:
        y[t] = Σ_{s≤t} (C_t·B_s) · exp(cum[t]−cum[s]) · xdt[s]
    """
    c = xdt.shape[1]
    cum = cum.float()
    rel = cum[:, :, None, :] - cum[:, None, :, :]            # (B,c,c,nh)
    causal = torch.ones(c, c, dtype=torch.bool, device=xdt.device).tril()
    # masked before the exp: above the diagonal rel > 0 can overflow, and
    # exp's backward would multiply the masked zero gradient by inf (NaN;
    # JAX's where-after-exp does so). The forward is the same.
    M = torch.exp(torch.where(causal[None, :, :, None], rel,
                              torch.full((), float("-inf"),
                                         device=xdt.device)))
    CB = torch.einsum("bqd,bsd->bqs", Cc.float(), Bc.float())
    W = CB[..., None] * M                                    # (B,c,c,nh)
    return torch.einsum("bqsh,bshp->bqhp", W, xdt.float())
