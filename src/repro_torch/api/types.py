"""Canonical result type of the decode API (counterpart of
``repro/api/types.py``), in its single-tick form: the megatick planes
(``tick_counts``, ``tick_live``) stay None until megaticks are ported."""
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
    ticks: Any = 1     # int          — device ticks folded into the result
    tick_counts: Any = None   # (B, K) kept tokens per tick (megatick only)
    tick_live: Any = None     # (B, K) row live entering each tick (megatick)

    @property
    def batch(self) -> int:
        return self.tokens.shape[0]

    @property
    def width(self) -> int:
        return self.tokens.shape[1]

    @property
    def is_megatick(self) -> bool:
        """Whether the per-tick stat fields are (B, K) planes."""
        return self.tick_live is not None

    def row_tokens(self, row: int) -> List[int]:
        """The valid tokens of one row as a list."""
        return [int(t) for t in self.tokens[row, :int(self.counts[row])]]

    def row_exit_points(self, row: int) -> List[int]:
        """Exit layer per live tick of one row (one element for a
        single-tick result)."""
        if not self.is_megatick:
            return [int(self.exit_layer[row])]
        return [int(self.exit_layer[row, t]) for t in range(int(self.ticks))
                if bool(self.tick_live[row, t])]

    def row_accept_lens(self, row: int) -> List[int]:
        """Accepted draft length per live tick of one row (see
        ``row_exit_points``)."""
        if not self.is_megatick:
            return [int(self.accept_len[row])]
        return [int(self.accept_len[row, t]) for t in range(int(self.ticks))
                if bool(self.tick_live[row, t])]
