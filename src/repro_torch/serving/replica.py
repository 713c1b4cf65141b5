"""Data-parallel replica pool — N ``ServingEngine``s behind one queue
(counterpart of ``repro/serving/replica.py``, case for case).

Within a replica, tensor parallelism over its mesh's 'model' axis
(``ServingEngine(mesh=...)``) keeps decode token-identical to one device;
across replicas the pool scales throughput with no collective at all:
replicas share one params tree (each engine shards its own copy under its
mesh, places one on a degree-1 mesh's device, or reads the tree itself
without a mesh) and requests are whole units, so
the only shared state is the admission queue.

When a replica dies (``Preempted`` / ``ServingFault`` out of its ``step``)
or is evicted as a straggler (``runtime.fault.StragglerMonitor`` over the
replicas' step times), its in-flight requests requeue onto survivors via
``ServingEngine.adopt``: the survivor prefills each again and *verifies*
the tokens the dead replica emitted against the record, so a migration
costs recompute and never changes output. ``plan_remesh`` annotates each
kill with the mesh the fleet could rebuild to.

Elastic degraded mode: a ``device_lost`` fault inside a replica REMESHES it
in place (``ServingEngine.remesh``); the pool observes the degree drop and
records it. Only when no degree remains does the engine's
``ServingFault(site="device_lost")`` fall back to kill-and-requeue.
Requests carry optional ``deadline_ticks`` (expired ones are SHED with a
structured ``ServingFault(site="deadline")``), a ``LoadShedPolicy`` can
bound the intake queue (``ServingFault(site="load_shed")``), and
``pool.health`` reports the degradation.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.runtime.fault import StragglerMonitor, plan_remesh
from repro_torch.serving.resilience import (FaultEvent, FaultLog,
                                            LoadShedPolicy, PoolHealth,
                                            Preempted, ServingFault)
from repro_torch.serving.server import Request, ServingEngine


@dataclass
class PoolRequest:
    """One request as the pool sees it.

    ``handle`` is the engine-level ``Request`` on the owning replica; the
    pool's own ``output``/stats fields are the migration-safe record —
    snapshotted from the handle when the owner dies, fed back as the replay
    prefix (``adopt(recorded=...)``) on reassignment."""
    uid: int
    prompt: np.ndarray
    max_new_tokens: int = 32
    eos_token: Optional[int] = None
    replica: Optional[int] = None
    handle: Optional[Request] = None
    output: List[int] = field(default_factory=list)
    exit_points: List[int] = field(default_factory=list)
    accept_lens: List[int] = field(default_factory=list)
    done: bool = False
    migrations: int = 0
    # degraded-mode serving: ``deadline_ticks`` pool ticks after
    # ``submitted_tick`` an unfinished request is SHED (``failed`` set,
    # ``fault`` carries the structured ServingFault) instead of queueing
    # forever against capacity the pool no longer has
    deadline_ticks: Optional[int] = None
    submitted_tick: int = 0
    failed: bool = False
    fault: Optional[ServingFault] = None


class ReplicaPool:
    """Shared admission queue over N independent ``ServingEngine`` replicas.

    ``step()`` drives every live replica one engine tick, timing each for
    the straggler monitor; replica death (or straggler eviction) requeues
    its unfinished requests onto survivors with verified replay. Killing
    the LAST live replica raises — there is nowhere left to migrate.
    """

    def __init__(self, replicas: Sequence[ServingEngine],
                 monitor: Optional[StragglerMonitor] = None,
                 evict_stragglers: bool = True,
                 shed: Optional[LoadShedPolicy] = None,
                 fault_log_cap: int = 256):
        if not replicas:
            raise ValueError("ReplicaPool needs at least one replica")
        self.replicas: List[ServingEngine] = list(replicas)
        self.alive: List[bool] = [True] * len(self.replicas)
        self.monitor = (monitor if monitor is not None
                        else StragglerMonitor())
        self.evict_stragglers = bool(evict_stragglers)
        self.shed = shed if shed is not None else LoadShedPolicy()
        self.queue: List[PoolRequest] = []
        self.requests: Dict[int, PoolRequest] = {}
        self.completed: List[PoolRequest] = []
        self.failed: List[PoolRequest] = []     # deadline-shed requests
        self.fault_log = FaultLog(cap=fault_log_cap)
        self._next_uid = 0
        self._tick = 0
        # degradation tracking: as-built vs current per-replica TP degree
        # (an in-engine remesh drops the current one), plus the last health
        # verdict so state TRANSITIONS land in the fault log exactly once
        self._built_tp = tuple(e.tp_degree for e in self.replicas)
        self._tp_now = list(self._built_tp)
        self._was_degraded = False

    # ----- intake / placement -----
    def submit(self, prompt, max_new_tokens: int = 32,
               eos_token: Optional[int] = None,
               deadline_ticks: Optional[int] = None) -> PoolRequest:
        """Queue a request. ``deadline_ticks``: pool ticks this request may
        wait+run before being shed. Raises ``ServingFault(site="load_shed")``
        when the shed policy's queue bound rejects the intake (degraded pool
        at capacity — the caller should retry later or elsewhere)."""
        if not self.shed.admits(len(self.queue), self.degraded):
            self.fault_log.append(FaultEvent(
                site="load_shed", tick=self._tick, action="reject",
                detail=f"queue={len(self.queue)} >= "
                       f"{self.shed.max_queue} (degraded={self.degraded})"))
            raise ServingFault(
                "load_shed",
                f"intake rejected: {len(self.queue)} queued >= bound "
                f"{self.shed.max_queue} while degraded")
        pr = PoolRequest(uid=self._next_uid,
                         prompt=np.asarray(prompt, np.int32),
                         max_new_tokens=max_new_tokens, eos_token=eos_token,
                         deadline_ticks=deadline_ticks,
                         submitted_tick=self._tick)
        self._next_uid += 1
        self.requests[pr.uid] = pr
        self.queue.append(pr)
        return pr

    def live_replicas(self) -> List[int]:
        return [i for i, a in enumerate(self.alive) if a]

    # ----- health / degradation -----
    @property
    def health(self) -> PoolHealth:
        live = self.live_replicas()
        tp_now = tuple(self._tp_now[i] for i in live)
        built = tuple(self._built_tp[i] for i in live)
        return PoolHealth(
            replicas_total=len(self.replicas), replicas_live=len(live),
            tp_degrees=tp_now, built_tp_degrees=built,
            queued=len(self.queue),
            degraded=(len(live) < len(self.replicas)
                      or any(n < b for n, b in zip(tp_now, built))))

    @property
    def degraded(self) -> bool:
        return self.health.degraded

    def _note_health(self) -> None:
        """Log degradation-state TRANSITIONS (not every tick's state)."""
        h = self.health
        if h.degraded != self._was_degraded:
            self._was_degraded = h.degraded
            self.fault_log.append(FaultEvent(
                site="health", tick=self._tick,
                action="degraded" if h.degraded else "recovered",
                detail=f"live={h.replicas_live}/{h.replicas_total} "
                       f"tp={list(h.tp_degrees)} built="
                       f"{list(h.built_tp_degrees)} queued={h.queued}"))

    def _note_remeshes(self) -> None:
        """Record per-replica TP drops (an engine remeshed inside its own
        ``step``) at pool level — the FaultEvent(action="remesh") the
        acceptance tests look for rides on the engine's own log too."""
        for i in self.live_replicas():
            now = self.replicas[i].tp_degree
            if now < self._tp_now[i]:
                self.fault_log.append(FaultEvent(
                    site="device_lost", tick=self._tick, action="remesh",
                    detail=f"replica={i} tp {self._tp_now[i]}->{now} "
                           f"(built {self._built_tp[i]})"))
                self._tp_now[i] = now

    def _capacity(self, i: int) -> int:
        """Free slots minus admission backlog — the placement score."""
        eng = self.replicas[i]
        free = sum(1 for s in eng.slots if s is None)
        backlog = len(eng.scheduler.queued) + len(eng.scheduler.admitting)
        return free - backlog

    def _assign(self) -> None:
        """Drain the shared queue onto the emptiest live replicas. A
        re-queued (migrated) request carries its recorded tokens as the
        replay prefix — ``adopt`` with an empty record is a plain submit."""
        live = self.live_replicas()
        if not live:
            return
        while self.queue:
            pr = self.queue.pop(0)
            i = max(live, key=self._capacity)
            pr.replica = i
            pr.handle = self.replicas[i].adopt(
                pr.prompt, max_new_tokens=pr.max_new_tokens,
                eos_token=pr.eos_token, recorded=pr.output,
                stats=(pr.exit_points, pr.accept_lens))

    # ----- failure / migration -----
    def _snapshot_handle(self, pr: PoolRequest) -> None:
        h = pr.handle
        if h is None:
            return
        pr.output = [int(t) for t in h.output]
        pr.exit_points = [int(x) for x in h.exit_points]
        pr.accept_lens = [int(x) for x in h.accept_lens]

    def _tp_degree(self) -> int:
        return self.replicas[0].tp_degree

    def kill_replica(self, i: int, reason: str = "killed",
                     detail: str = "") -> None:
        """Mark replica ``i`` dead and requeue its unfinished requests.

        Each migrated request keeps everything the dead replica emitted
        (snapshotted off its handle) and will replay-verify those tokens on
        the survivor. Requests whose handle already finished complete
        normally. Raises when the pool's last live replica dies."""
        if not self.alive[i]:
            return
        self.alive[i] = False
        requeued = 0
        for pr in self.requests.values():
            if pr.done or pr.replica != i:
                continue
            self._snapshot_handle(pr)
            if pr.handle is not None and pr.handle.done:
                pr.done = True
                self.completed.append(pr)
                continue
            pr.replica = None
            pr.handle = None
            pr.migrations += 1
            self.queue.append(pr)
            requeued += 1
        try:
            self.replicas[i].close()
        except Exception:
            pass
        tp = self._tp_degree()
        plan = plan_remesh(len(self.live_replicas()) * tp, tp)
        self.fault_log.append(FaultEvent(
            site=reason, tick=self._tick, action="kill_replica",
            detail=f"replica={i} requeued={requeued} remesh={plan}; "
                   f"{detail}"))
        if not any(self.alive):
            raise ServingFault(
                "replica_pool",
                f"last replica ({i}) died ({reason}); "
                f"{requeued} requests stranded")

    def _maybe_evict_straggler(self) -> None:
        """Evict the slowest monitor-flagged live replica (never the last):
        its requests migrate to faster survivors instead of pacing the whole
        pool at the straggler's EWMA."""
        if not self.evict_stragglers:
            return
        live = self.live_replicas()
        if len(live) < 2:
            return
        flagged = [h for h in self.monitor.stragglers()
                   if h in live]
        if not flagged:
            return
        worst = max(flagged, key=lambda h: self.monitor.hosts[h].ewma)
        self.kill_replica(worst, reason="straggler",
                          detail=f"ewma={self.monitor.hosts[worst].ewma:.4f}")

    # ----- deadlines (degraded-mode load shedding) -----
    def _shed_expired(self, finished: List["PoolRequest"]) -> None:
        """Shed unfinished requests past their deadline: queued ones drop
        out of the queue, slotted ones cancel on their engine (the engine
        drains its megatick first — a request the drain FINISHES made the
        deadline after all and completes normally). A shed request is
        terminal: ``failed`` with a structured ServingFault, never requeued."""
        for pr in list(self.requests.values()):
            if (pr.done or pr.failed or pr.deadline_ticks is None
                    or self._tick - pr.submitted_tick < pr.deadline_ticks):
                continue
            if pr in self.queue:
                self.queue.remove(pr)
            elif pr.handle is not None and pr.replica is not None \
                    and self.alive[pr.replica]:
                self.replicas[pr.replica].cancel(pr.handle.uid)
                if pr.handle.done:      # drained over the finish line
                    self._snapshot_handle(pr)
                    pr.done = True
                    self.completed.append(pr)
                    finished.append(pr)
                    continue
                self._snapshot_handle(pr)
            pr.failed = True
            pr.done = True
            pr.fault = ServingFault(
                "deadline",
                f"uid={pr.uid} shed after {self._tick - pr.submitted_tick} "
                f"ticks (deadline {pr.deadline_ticks}); "
                f"progress={len(pr.output)}/{pr.max_new_tokens}")
            pr.replica = None
            pr.handle = None
            self.failed.append(pr)
            self.fault_log.append(FaultEvent(
                site="deadline", tick=self._tick, action="shed",
                detail=f"uid={pr.uid} progress={len(pr.output)} "
                       f"deadline={pr.deadline_ticks}"))

    # ----- drive -----
    def step(self) -> List[PoolRequest]:
        """One pool tick: place queued work, step every live busy replica
        (timed for the straggler monitor; death → migrate), collect
        completions, then straggler eviction. Returns the requests that
        completed this call."""
        self._tick += 1
        self._assign()
        for i in list(self.live_replicas()):
            eng = self.replicas[i]
            if not eng.busy:
                continue
            t0 = time.monotonic()
            try:
                eng.step()
            except Preempted as err:
                self.kill_replica(i, reason="preempted", detail=str(err))
                continue
            except ServingFault as err:
                self.kill_replica(i, reason=err.site, detail=str(err))
                continue
            self.monitor.record(i, time.monotonic() - t0)
        self._note_remeshes()
        finished: List[PoolRequest] = []
        for pr in self.requests.values():
            if pr.done or pr.handle is None or not pr.handle.done:
                continue
            self._snapshot_handle(pr)
            pr.done = True
            self.completed.append(pr)
            finished.append(pr)
        self._shed_expired(finished)
        self._maybe_evict_straggler()
        self._note_health()
        self._assign()          # migrated work lands without an extra tick
        return finished

    @property
    def busy(self) -> bool:
        return (bool(self.queue)
                or any(not pr.done for pr in self.requests.values()))

    def run_to_completion(self, max_ticks: int = 10_000
                          ) -> List[PoolRequest]:
        done: List[PoolRequest] = []
        for _ in range(max_ticks):
            done.extend(self.step())
            if not self.busy:
                return done
        raise ServingFault(
            "stall",
            f"pool still busy after {max_ticks} ticks: "
            f"queued={len(self.queue)} "
            f"live={len(self.live_replicas())}/{len(self.replicas)}")

    def close(self) -> None:
        for i in self.live_replicas():
            try:
                self.replicas[i].close()
            except Exception:
                pass
