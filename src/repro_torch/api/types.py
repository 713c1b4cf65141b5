"""Canonical result type of the decode API (counterpart of
``repro/api/types.py``), single-tick fields only."""
from __future__ import annotations

from typing import Any, List, NamedTuple


class StepResult(NamedTuple):
    """One decode tick for every row of the session batch (host arrays).

    The token buffer is fixed-width (``W = strategy.emit_width``: 1 for
    dense and SpecEE, tree depth + 1 for the tree) with a per-row valid
    count."""
    tokens: Any        # (B, W) int32 — left-aligned emitted tokens
    counts: Any        # (B,)   int32 — valid tokens this tick
    done: Any          # (B,)   bool  — row finished (eos / budget)
    exit_layer: Any    # (B,)   int32 — exit point taken (E if full depth)
    accept_len: Any    # (B,)   int32 — accepted draft tokens (tree only)
    exited: Any        # (B,)   bool  — predictor-driven early exit
    units_run: Any     # int          — units the layer loop executed

    @property
    def batch(self) -> int:
        return self.tokens.shape[0]

    def row_tokens(self, row: int) -> List[int]:
        """The valid tokens of one row as a list."""
        return [int(t) for t in self.tokens[row, :int(self.counts[row])]]
