"""Chunked-prefill admission scheduler (counterpart of
``repro/api/scheduler.py``; Sarathi-style iteration scheduling).

Arriving requests queue here, and every decode tick the scheduler runs a
bounded amount of prefill work before the batched strategy step:

* **chunked** (``chunk_tokens=N``): prompts are split into N-token chunks
  behind ``DecodeSession.prefill_chunk``. While any decode row is live, a
  tick runs AT MOST one chunk, so live rows are never stalled for more than
  one chunk budget per tick. With no live rows the scheduler drains freely.
* **blocking** (``chunk_tokens=None``): each free slot admits with one
  whole-prompt prefill inside the tick.

Admission is also gated by the session's ``KVCacheManager``
(``session.can_admit``): a paged pool without a free row reservation defers
the queue head instead of overcommitting memory. ``remove`` withdraws a
queued request and ``abort_active`` requeues the in-flight admission at the
queue's front (the serving engine's ``cancel``).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Deque, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.api.session import Admission, DecodeSession


@dataclass
class Admitted:
    """One admission completed this tick: the row is live (or already done
    — budget 0 or the first token hit EOS; the caller checks
    ``session.row_done``)."""
    uid: int
    row: int
    first_token: int


@dataclass
class _Pending:
    uid: int
    prompt: np.ndarray
    max_new_tokens: Optional[int]
    eos_token: Optional[int]


class ChunkedPrefillScheduler:
    """Owns the pending queue + the (single) in-flight chunked admission."""

    def __init__(self, session: DecodeSession,
                 chunk_tokens: Optional[int] = None):
        if chunk_tokens is not None and chunk_tokens <= 0:
            raise ValueError(
                f"chunk_tokens must be > 0 or None (blocking), got "
                f"{chunk_tokens}")
        self.session = session
        self.chunk_tokens = chunk_tokens
        self.queue: Deque[_Pending] = deque()
        self._active: Optional[Tuple[int, Admission]] = None
        self.last_tick_tokens = 0       # prefill tokens run by the last tick
        # consecutive ticks the queue head sat blocked on ``can_admit`` while
        # a slot was free (the pool-pressure signal)
        self.deferred_ticks = 0

    # ----- intake -----
    def submit(self, uid: int, prompt, max_new_tokens: Optional[int] = None,
               eos_token: Optional[int] = None) -> None:
        self.queue.append(_Pending(uid, np.asarray(prompt),
                                   max_new_tokens, eos_token))

    # ----- introspection -----
    def busy_rows(self) -> Set[int]:
        """Rows reserved by an in-flight (multi-tick) admission."""
        return set() if self._active is None else {self._active[1].row}

    def has_work(self) -> bool:
        return bool(self.queue) or self._active is not None

    @property
    def queued(self) -> List[int]:
        return [p.uid for p in self.queue]

    @property
    def admitting(self) -> List[int]:
        """Uid of the in-flight (multi-tick) admission, if any."""
        return [] if self._active is None else [self._active[0]]

    # ----- one tick of admission work -----
    def tick(self, free_rows: Sequence[int],
             live_decode: bool = True) -> List[Admitted]:
        """Run admission work for one engine tick.

        ``free_rows``: slots available for new admissions (rows of an
        in-flight admission are excluded here). ``live_decode``: whether any
        decode row is live — if so, chunked mode runs at most ONE chunk.
        """
        events: List[Admitted] = []
        free = [r for r in free_rows if r not in self.busy_rows()]
        self.last_tick_tokens = 0
        deferred = False
        while True:
            if self._active is None:
                if not self.queue or not free:
                    break
                head = self.queue[0]
                if not self.session.can_admit(len(head.prompt)):
                    deferred = True
                    break               # paged pool full: defer admission
                self.queue.popleft()
                row = free.pop(0)
                adm = self.session.begin_admission(
                    row, head.prompt, max_new_tokens=head.max_new_tokens,
                    eos_token=head.eos_token)
                self._active = (head.uid, adm)
            uid, adm = self._active
            n = self.session.prefill_chunk(adm, self.chunk_tokens)
            self.last_tick_tokens += n
            if adm.complete:
                events.append(Admitted(uid=uid, row=adm.row,
                                       first_token=adm.first_token))
                self._active = None
            if live_decode and self.chunk_tokens is not None:
                break                   # one chunk per live tick, max
        if deferred and not events:
            self.deferred_ticks += 1
        else:
            self.deferred_ticks = 0
        return events

    # ----- withdrawal -----
    def remove(self, uid: int) -> bool:
        """Withdraw a queued request (cancel). Only the queue is searched:
        abort the in-flight admission first if it holds the uid
        (``abort_active`` requeues it here). Returns True when the uid was
        queued."""
        for p in list(self.queue):
            if p.uid == uid:
                self.queue.remove(p)
                return True
        return False

    def abort_active(self) -> Optional[int]:
        """Abort the in-flight chunked admission, requeueing its request at
        the queue's FRONT (it keeps its turn). Safe at any point mid-prefill:
        no session row or page is claimed until the admission's last chunk
        inserts the row, so the partial prefill is dropped and a later tick
        runs it again from the start. Returns the requeued uid, or None if
        nothing was in flight."""
        if self._active is None:
            return None
        uid, adm = self._active
        self._active = None
        self.queue.appendleft(_Pending(uid, np.asarray(adm.tokens),
                                       adm.max_new_tokens, adm.eos_token))
        return uid
