"""Canonical result type of the decode API (counterpart of
``repro/api/types.py``): one tick, or a megatick of K ticks whose per-tick
fields are (B, K) planes (``tick_counts``, ``tick_live`` mark them)."""
from __future__ import annotations

from typing import Any, List, NamedTuple


class StepResult(NamedTuple):
    """One decode tick for every row of the session batch (host arrays).

    The token buffer is fixed-width (``W = strategy.emit_width``: 1 for
    dense and SpecEE, tree depth + 1 for the tree) with a per-row valid
    count.

    A megatick result (``DecodeSession.step(num_ticks=K)`` with K > 1, or
    any ``finish_step``) widens the contract to K ticks: ``tokens`` is
    (B, K·W), left-aligned per row, with ``counts`` the row's total; the
    per-tick stat fields are (B, K) planes, ``tick_live`` marks the ticks
    each row was live for, and ``ticks`` is how many ticks ran (the loop
    stops once every row is done). ``row_exit_points`` and
    ``row_accept_lens`` read both shapes."""
    tokens: Any        # (B, W) int32 — left-aligned emitted tokens
    #                     (megatick: (B, K*W))
    counts: Any        # (B,)   int32 — valid tokens this tick
    done: Any          # (B,)   bool  — row finished (eos / budget)
    exit_layer: Any    # (B,)   int32 — exit point taken (E if full depth)
    #                     (megatick: (B, K))
    accept_len: Any    # (B,)   int32 — accepted draft tokens (tree only)
    #                     (megatick: (B, K))
    exited: Any        # (B,)   bool  — predictor-driven early exit
    #                     (megatick: (B, K))
    units_run: Any     # int          — units the layer loop executed
    #                     (megatick: summed over the ticks that ran)
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
