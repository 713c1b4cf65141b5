"""Engine / DecodeSession (counterpart of ``repro/api/session.py``),
whole-batch style with single ticks:

    engine = Engine.create(model, params, sw, strategy="specee")
    session = engine.new_session()
    first = session.prefill(prompts, max_new_tokens=64)
    while not session.all_done():
        res = session.step()

``Engine`` binds (model, params, SpecEE weights, strategy); a session owns
one batched ``DecodeState`` plus per-row token budgets, EOS cut-off and the
``done`` mask, kept on the host. The state's KV cache is updated in place
every tick. Slot-based admission, megaticks and snapshots are later slices.
"""
from __future__ import annotations

from typing import List, Optional, Union

import numpy as np
import torch

from repro_torch.api.cache import DenseKVCache
from repro_torch.api.strategies import DecodeStrategy, get_strategy
from repro_torch.api.types import StepResult
from repro_torch.core import engine as eng
from repro_torch.models.common import lm_head_weight
from repro_torch.models.model import Model

_NO_BUDGET = np.iinfo(np.int64).max


class Engine:
    """Binds a model + weights to a decode strategy; factory for sessions.
    The engine runs on the device its weights live on."""

    def __init__(self, model: Model, params, sw=None,
                 strategy: Union[str, DecodeStrategy, None] = None):
        self.model = model
        self.params = params
        self.sw = sw
        self.strategy = get_strategy(strategy)
        self.strategy.validate(model, sw)
        self.device = lm_head_weight(params).device

    @classmethod
    def create(cls, model: Model, params, sw=None,
               strategy: Union[str, DecodeStrategy, None] = None
               ) -> "Engine":
        """``Engine.create(model, params, sw, strategy="dense"|"specee")``."""
        return cls(model, params, sw=sw, strategy=strategy)

    @property
    def emit_width(self) -> int:
        return self.strategy.emit_width(self.model)

    def new_session(self, max_seq: Optional[int] = None
                    ) -> "DecodeSession":
        """A whole-batch session over the dense KV cache (the paged layout
        is a later slice)."""
        return DecodeSession(self, max_seq=max_seq)


class DecodeSession:
    def __init__(self, engine: Engine, max_seq: Optional[int] = None):
        self.engine = engine
        self._max_seq = max_seq
        self._state: Optional[eng.DecodeState] = None
        self.cache_mgr = None
        self.batch: Optional[int] = None

    # ----- host-side bookkeeping -----
    def _alloc_bookkeeping(self, batch: int) -> None:
        self.batch = batch
        self._emitted = np.zeros(batch, np.int64)
        self._budget = np.full(batch, _NO_BUDGET, np.int64)
        self._eos: List[Optional[int]] = [None] * batch
        self._done = np.zeros(batch, bool)

    def _account_row(self, row: int, toks: np.ndarray, count: int) -> int:
        """Apply budget + EOS to one row's raw emit; returns the kept count
        and updates ``done``/``emitted``."""
        if self._done[row]:
            return 0
        count = int(min(count, self._budget[row] - self._emitted[row]))
        eos = self._eos[row]
        if eos is not None:
            hits = np.nonzero(toks[:count] == eos)[0]
            if hits.size:
                count = int(hits[0]) + 1
                self._done[row] = True
        self._emitted[row] += count
        if self._emitted[row] >= self._budget[row]:
            self._done[row] = True
        return count

    def _wrap(self, raw: StepResult) -> StepResult:
        """Device → host + per-row budget/EOS accounting."""
        tokens = raw.tokens.cpu().numpy()
        counts = raw.counts.cpu().numpy().copy()
        for row in range(tokens.shape[0]):
            counts[row] = self._account_row(row, tokens[row], counts[row])
        return StepResult(tokens=tokens, counts=counts,
                          done=self._done.copy(),
                          exit_layer=raw.exit_layer.cpu().numpy(),
                          accept_len=raw.accept_len.cpu().numpy(),
                          exited=raw.exited.cpu().numpy(),
                          units_run=int(raw.units_run))

    def all_done(self) -> bool:
        return self._state is None or bool(self._done.all())

    # ----- whole-batch entry -----
    def prefill(self, prompts, max_new_tokens: Optional[int] = None,
                eos_token: Optional[int] = None,
                max_seq: Optional[int] = None) -> StepResult:
        """Prefill the whole batch. ``prompts``: (B, T) int tokens (array,
        tensor or list) or a ``{"tokens": ...}`` dict. Returns the
        first-token StepResult (the prefill's greedy argmax counts against
        the budget)."""
        e = self.engine
        tokens = prompts["tokens"] if isinstance(prompts, dict) else prompts
        if not isinstance(tokens, torch.Tensor):
            tokens = torch.as_tensor(np.asarray(tokens))
        tokens = tokens.to(device=e.device, dtype=torch.int32)
        B, T = tokens.shape
        if max_seq is None:
            max_seq = self._max_seq
        if max_seq is None:
            new = (max_new_tokens if max_new_tokens is not None
                   else e.model.run.serve.max_new_tokens)
            max_seq = T + new + e.emit_width + 1
        self._max_seq = max_seq
        first, state = e.strategy.init_state(e.model, e.params, e.sw,
                                             {"tokens": tokens}, max_seq)
        self.cache_mgr = DenseKVCache(
            e.model, B, e.strategy.cache_seq_len(e.model, max_seq), e.device)
        self._state = state._replace(
            cache=self.cache_mgr.from_prefill(state.cache))
        self._alloc_bookkeeping(B)
        # the cache has max_seq slots: bound the budget by the remaining
        # capacity so a budgetless session still terminates
        cap = max(max_seq - T - 1, 1)
        budget = cap if max_new_tokens is None else min(max_new_tokens, cap)
        self._budget[:] = budget
        self._eos = [eos_token] * B
        W, E = e.emit_width, e.model.num_exit_points
        zeros = torch.zeros(B, dtype=torch.int32, device=e.device)
        tok = torch.zeros(B, W, dtype=torch.int32, device=e.device)
        tok[:, 0] = first
        raw = StepResult(tokens=tok, counts=zeros + 1, done=zeros.bool(),
                         exit_layer=zeros + E, accept_len=zeros,
                         exited=zeros.bool(), units_run=0)
        return self._wrap(raw)

    # ----- decode tick -----
    def step(self) -> StepResult:
        """One batched decode tick through the strategy's step."""
        assert self._state is not None, "prefill first"
        e = self.engine
        raw, self._state = e.strategy.step(e.model, e.params, e.sw,
                                           self._state)
        return self._wrap(raw)
