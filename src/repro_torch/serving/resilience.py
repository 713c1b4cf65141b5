"""Serving-layer fault-tolerance primitives (counterpart of
``repro/serving/resilience.py``). ``ServingEngine`` builds its recovery
from them:

  * **structured faults** — ``ServingFault`` carries the site, the retry
    count and the cause, so a caller branches on *where* serving failed.
    ``Preempted`` is the clean-shutdown case: the engine checkpointed and
    the process should exit and restart with ``--restore``.
  * **victim selection** — ``VictimPolicy`` picks which live row to evict
    under pool pressure: least decode progress first (loses the least
    work), then fewest pages, then the lowest row (determinism). A request
    evicted ``max_evictions`` times is never picked again, which bounds the
    replay work and guarantees progress.
  * **backoff** — ``Backoff`` yields the sleeps between megatick dispatch
    retries (exponential, capped attempts).
  * **fault log** — ``FaultEvent`` records each recovery action the engine
    took, in a bounded ``FaultLog`` ring with a JSONL export.
  * **degraded serving** — ``LoadShedPolicy`` and ``PoolHealth`` are the
    replica pool's (ROADMAP: multi-GPU); they are here so the pool can be
    ported onto them.
"""
from __future__ import annotations

import json
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Iterable, Iterator, List, Optional, Tuple, Union


class ServingFault(RuntimeError):
    """A serving failure the engine could not absorb.

    ``site`` is the named failure point ("dispatch", "finish_timeout",
    "nan_logits", "replay", "stall", ...), ``attempts`` the number of
    retries burned before surfacing, ``cause`` the underlying exception
    (also chained as ``__cause__`` where raised with ``raise ... from``).
    """

    def __init__(self, site: str, message: str, attempts: int = 0,
                 cause: Optional[BaseException] = None):
        super().__init__(f"[{site}] {message}")
        self.site = site
        self.attempts = attempts
        self.cause = cause


class Preempted(ServingFault):
    """SIGTERM drained + checkpointed: restart with ``--restore``.

    Not an error — the state the process is abandoning is fully captured in
    the checkpoint at ``path`` (tick ``step``)."""

    def __init__(self, step: int, path: str):
        super().__init__("sigterm",
                         f"preempted at tick {step}; checkpoint in {path} "
                         "(restart with --restore)")
        self.step = step
        self.path = path


@dataclass
class FaultEvent:
    """One recovery action taken by the serving engine."""
    site: str                   # which named site (or "evict" / "watchdog")
    tick: int                   # engine tick when it happened
    action: str                 # "retry" | "evict" | "sync_fallback" | ...
    detail: str = ""


class FaultLog:
    """Bounded ring of ``FaultEvent``s with a list-compatible surface.

    Engines append every recovery action here; the ring keeps only the last
    ``cap`` events (a long soak run would otherwise grow the log without
    bound) while ``total``/``dropped`` keep the true counts. Iteration,
    ``len``, indexing and truthiness behave like a list. ``dump_jsonl``
    writes the retained window as one JSON object per line, the trail
    behind ``launch/serve.py --fault-log``."""

    def __init__(self, cap: int = 256):
        if cap < 1:
            raise ValueError(f"FaultLog cap must be >= 1, got {cap}")
        self.cap = int(cap)
        self._events: Deque[FaultEvent] = deque(maxlen=self.cap)
        self.total = 0              # events ever appended

    @property
    def dropped(self) -> int:
        """Events evicted from the ring (oldest-first)."""
        return self.total - len(self._events)

    def append(self, event: FaultEvent) -> None:
        self._events.append(event)
        self.total += 1

    def extend(self, events: Iterable[FaultEvent]) -> None:
        for e in events:
            self.append(e)

    def __iter__(self) -> Iterator[FaultEvent]:
        return iter(self._events)

    def __len__(self) -> int:
        return len(self._events)

    def __bool__(self) -> bool:
        return bool(self._events)

    def __getitem__(self, i: Union[int, slice]):
        return list(self._events)[i]

    def dump_jsonl(self, path: str, source: str = "engine",
                   append: bool = False) -> int:
        """Write the retained events to ``path`` as JSONL. ``seq`` is the
        event's global index (dropped events leave a visible gap at the
        front); ``source`` labels the emitting engine/pool so one file can
        hold a whole fleet's trail. Returns the number of lines written."""
        base = self.dropped
        with open(path, "a" if append else "w") as f:
            for i, e in enumerate(self._events):
                f.write(json.dumps({
                    "seq": base + i, "source": source, "site": e.site,
                    "tick": e.tick, "action": e.action,
                    "detail": e.detail}) + "\n")
        return len(self._events)


@dataclass(frozen=True)
class LoadShedPolicy:
    """Queue bound for degraded-mode serving.

    When a remesh (or a replica death) drops pool capacity below demand,
    unbounded queueing just converts overload into unbounded latency — the
    pool instead REJECTS intake (``ServingFault(site="load_shed")``) once
    ``max_queue`` requests are already waiting. ``only_degraded`` (default)
    applies the bound only while the pool is degraded; set it False to bound
    the queue unconditionally. ``max_queue=None`` never sheds."""

    max_queue: Optional[int] = None
    only_degraded: bool = True

    def admits(self, queued: int, degraded: bool) -> bool:
        if self.max_queue is None:
            return True
        if self.only_degraded and not degraded:
            return True
        return queued < self.max_queue


@dataclass(frozen=True)
class PoolHealth:
    """``ReplicaPool.health``: the pool's degradation state, one snapshot.

    ``degraded`` is True when any replica is dead OR any live replica runs
    below its as-built TP degree (it remeshed after a device loss) — the
    signal ``LoadShedPolicy`` keys on."""

    replicas_total: int
    replicas_live: int
    tp_degrees: Tuple[int, ...]         # live replicas' CURRENT degrees
    built_tp_degrees: Tuple[int, ...]   # same replicas' as-built degrees
    queued: int
    degraded: bool


@dataclass(frozen=True)
class VictimInfo:
    """One eviction candidate, as the policy sees it."""
    row: int
    progress: int               # tokens emitted so far (work lost on evict)
    pages: int                  # KV pages held (work to replay)
    evictions: int              # times this request was already evicted


@dataclass(frozen=True)
class VictimPolicy:
    """LRU-by-progress, then fewest-pages, then row id (deterministic)."""

    max_evictions: int = 3      # then the request is protected

    def select(self, candidates: List[VictimInfo]) -> Optional[int]:
        eligible = [c for c in candidates if c.evictions < self.max_evictions]
        if not eligible:
            return None
        best = min(eligible, key=lambda c: (c.progress, c.pages, c.row))
        return best.row


@dataclass(frozen=True)
class Backoff:
    """Exponential retry schedule for megatick dispatch failures."""

    base_s: float = 0.05
    factor: float = 2.0
    max_attempts: int = 4

    def delays(self) -> Iterator[float]:
        """Sleep to apply AFTER each failed attempt (the first attempt is
        free; ``max_attempts`` total attempts are made)."""
        for i in range(self.max_attempts - 1):
            yield self.base_s * (self.factor ** i)

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            time.sleep(seconds)
