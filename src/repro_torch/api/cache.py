"""KV cache managers (counterpart of ``repro/api/cache.py``). This slice
ports the dense layout only; the paged layout is a later slice."""
from __future__ import annotations

from typing import Any

import torch


class DenseKVCache:
    """The slot-masked dense ``(reps, B, max_seq, KVH, hd)`` layout."""

    kind = "dense"

    def __init__(self, model, batch: int, seq_len: int, device):
        self.model = model
        self.batch = batch
        self.seq_len = seq_len
        self.device = torch.device(device)

    def empty_cache(self) -> Any:
        return self.model.empty_cache(self.batch, self.seq_len, self.device)

    def from_prefill(self, dense_cache: Any) -> Any:
        """Adopt a whole-batch prefill cache (already in this layout)."""
        return dense_cache

