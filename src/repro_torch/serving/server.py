"""Continuous-batching serving engine (counterpart of
``repro/serving/server.py``): a slot loop over ``DecodeSession``.

  * ``max_batch`` slots share one batched session whose memory is owned by
    a ``KVCacheManager`` (``api.cache``): paged KV by default
    (``ServeConfig.page_size`` pages, per-row page tables, free-page
    admission control), the dense layout as the reference
    (``cache="dense"``);
  * admission runs through the ``ChunkedPrefillScheduler``
    (``api.scheduler``): prompts split into ``ServeConfig.prefill_chunk``
    -token chunks interleaved with decode ticks; ``prefill_chunk=0`` is
    blocking whole-prompt admission;
  * every engine tick runs ONE batched strategy step for all live slots
    (dense, AR SpecEE, or ``strategy="tree"``, whose tick emits up to
    depth + 1 tokens per row and records its accept length per tick);
    finished rows retire and compact (``session.retire_row``): their pages
    return to the pool and their length drops to zero, and later requests
    are admitted into the freed slots;
  * ``megatick=K`` folds K ticks into one megatick (the budget/EOS/done
    accounting in a device carry, results read once per K ticks), and
    ``async_ticks`` (on by default when K > 1) pipelines it: ``step()``
    dispatches megatick N+1 before it reads megatick N's results, so
    results and admissions arrive one ``step()`` call later; the done mask
    in the carry keeps that correct. ``run_to_completion`` and ``drain``
    finish the in-flight megatick.

  * ``cancel(uid)`` withdraws an unfinished request (queued, mid chunked
    admission, or slotted, after the in-flight megatick drains), and
    ``completed`` keeps every finished request in finish order;
  * ``serve.greedy=False`` (no SpecEE) serves ``DenseStrategy(temperature=
    serve.temperature)``, sampled per row from ``prng_seed``.

Fault tolerance, four mechanisms as in the JAX engine:
  * **checkpoint/restore** — ``checkpoint_now()`` drains the in-flight
    megatick, snapshots the session (state, host mirrors, page allocator)
    and the engine's request, queue and slot bookkeeping through
    ``CheckpointManager``; a fresh engine's ``restore_checkpoint()`` resumes
    token-identically. With ``checkpoint_dir`` a ``PreemptionGuard`` turns
    SIGTERM into a checkpoint at the next ``step()``, which then raises
    ``Preempted``.
  * **pool-pressure eviction** — when the queue's head has waited on
    ``can_admit`` for ``evict_patience`` ticks with a slot free,
    ``VictimPolicy`` picks a live row to evict: its pages are freed and the
    request requeues with its original prompt. After re-admission the row
    emits its recorded tokens again, and the engine *verifies* them instead
    of appending them; a difference raises ``ServingFault("replay")``. This
    is what lets a pool hold fewer pages than ``max_batch`` full rows.
  * **watchdog and backoff** — a failed dispatch retries through
    ``Backoff`` before ``ServingFault("dispatch")``; a wedged or poisoned
    finish (the ``finish_timeout`` / ``nan_logits`` sites, tokens out of the
    vocabulary) drops the async pipeline, evicts the live rows (replay
    regenerates their lost tokens) and runs ``cooldown_ticks`` ticks
    synchronously; a finish slower than ``watchdog_s`` keeps its results
    and also falls back to synchronous ticks.
  * **fault log** — each recovery action lands in ``fault_log``.

Replay needs a row's tokens to be independent of its slot and of the rows
beside it; the batch shape is fixed by ``max_batch``, so every GEMM and
attention call has one shape whoever occupies the slots.

On a paged cache on a CUDA card the engine turns on the paged
decode-attention kernel (``ModelFlags.decode_kernel``), as the JAX engine
does on a TPU. The constructor takes the JAX engine's arguments in its
order.

Tensor-parallel serving: ``mesh`` (a ``(D, P)``
``repro_torch.launch.mesh.Mesh``) shards this engine's decode over P
shards and, with D > 1, splits its batch over D data rows
(``api.Engine``, ``policy`` tp_dp, tp2d or fsdp_tp); independent engines
are one level up, in ``serving.replica.ReplicaPool``. ``tp_degree`` is
the model extent. Elastic degraded mode: the ``device_lost``
site drops the mesh's highest device between ticks and, when
``plan_replica_remesh`` finds a degree over the survivors, ``remesh``
rebuilds the engine in place on a ``(1, new_tp)`` mesh, as JAX's does,
from the engine's ``source`` (the whole params, kept once on the host
under a mesh) and re-admits every unfinished request with verified
replay; with no degree left (unsharded, or no device) it drains and
raises ``ServingFault(site="device_lost")``, which a pool turns into
kill-and-requeue.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from repro_torch.api import (CacheSpec, DecodeStrategy, DenseStrategy,
                             Engine, get_strategy)
from repro_torch.api.scheduler import ChunkedPrefillScheduler
from repro_torch.checkpoint import CheckpointManager
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.common import lm_head_weight
from repro_torch.models.model import Model, build_model
from repro_torch.runtime import faultinject
from repro_torch.runtime.fault import PreemptionGuard, plan_replica_remesh
from repro_torch.serving.resilience import (Backoff, FaultEvent, FaultLog,
                                            Preempted, ServingFault,
                                            VictimInfo, VictimPolicy)


@dataclass
class Request:
    uid: int
    prompt: np.ndarray                  # (T,) int32
    max_new_tokens: int = 32
    eos_token: Optional[int] = None
    # filled by the engine
    output: List[int] = field(default_factory=list)
    exit_points: List[int] = field(default_factory=list)
    accept_lens: List[int] = field(default_factory=list)
    done: bool = False
    # eviction bookkeeping: after an eviction the first ``replay_total``
    # tokens the re-admitted row emits are verified against ``output``
    # instead of appended; ``replayed`` is the verification cursor and
    # ``evictions`` feeds VictimPolicy's protection
    replay_total: int = 0
    replayed: int = 0
    evictions: int = 0

    @property
    def replaying(self) -> bool:
        return self.replayed < self.replay_total


class ServingEngine:
    def __init__(self, model: Model, params, sw=None, specee: bool = True,
                 strategy: Union[str, DecodeStrategy, None] = None,
                 prng_seed: int = 0, fused_gate: bool = True,
                 cache: Union[None, str, CacheSpec] = "paged",
                 page_size: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 megatick: int = 1,
                 async_ticks: Optional[bool] = None,
                 checkpoint_dir: Optional[str] = None,
                 guard: Optional[PreemptionGuard] = None,
                 victim: Optional[VictimPolicy] = None,
                 evict_patience: int = 2,
                 watchdog_s: Optional[float] = None,
                 backoff: Optional[Backoff] = None,
                 cooldown_ticks: int = 8, quant=None, mesh=None,
                 policy: str = "tp_dp", fault_log_cap: int = 256):
        if megatick < 1:
            raise ValueError(f"megatick must be >= 1, got {megatick}")
        self.megatick = int(megatick)
        # pipelined ticks by default whenever megaticks are on: the point
        # of folding K ticks into one dispatch is to overlap the host work
        # with device compute
        self.async_ticks = (self.megatick > 1 if async_ticks is None
                            else bool(async_ticks))
        self._handle: Optional[Tuple] = None   # in-flight async megatick
        spec = CacheSpec.resolve(cache, model.run.serve)
        if page_size is not None:
            # the override obeys the rule ServeConfig validates (pages tile
            # the cache exactly)
            if page_size <= 0 or model.run.serve.max_seq_len % page_size:
                raise ValueError(
                    f"page_size ({page_size}) must be > 0 and divide "
                    f"max_seq_len ({model.run.serve.max_seq_len})")
            spec = dataclasses.replace(spec, page_size=page_size)
        self.cache_spec = spec
        flags = model.flags
        if bool(fused_gate) != flags.exit_gate_kernel:
            flags = dataclasses.replace(flags,
                                        exit_gate_kernel=bool(fused_gate))
        # paged serving pairs with the page-table decode kernel on the card;
        # on the CPU the wrapper would run its plain version anyway
        on_card = (mesh.flat[0] if mesh is not None
                   else lm_head_weight(params).device).type == "cuda"
        if spec.kind == "paged" and not flags.decode_kernel and on_card:
            flags = dataclasses.replace(flags, decode_kernel=True)
        if flags is not model.flags:
            model = build_model(model.run, flags)
        self.model = model
        self.serve_cfg = model.run.serve
        if strategy is None:        # the JAX engine's default
            if specee and model.run.specee.enabled:
                strategy = "specee"
            elif self.serve_cfg.greedy:
                strategy = "dense"
            else:
                strategy = DenseStrategy(
                    temperature=self.serve_cfg.temperature)
        self.strategy = get_strategy(strategy)
        # ``quant``: None | "int8" | "int4" | QuantSpec — weight-only
        # compression applied once at engine build (a parallel bundle; the
        # fp params are untouched)
        # ``mesh``: tensor-parallel decode for THIS engine
        self.engine = Engine.create(model, params, sw=sw,
                                    strategy=self.strategy, quant=quant,
                                    mesh=mesh, policy=policy)
        # a device-loss rebuild cuts its weights from the engine's
        # ``source`` (the whole tree, on the host under a mesh) — no
        # checkpoint round trip
        self._src_quant, self._src_policy = quant, policy
        self._src_seed = prng_seed
        B = self.serve_cfg.max_batch
        S = self.serve_cfg.max_seq_len
        self.B, self.S = B, S
        self.session = self.engine.new_session(batch=B, max_seq=S,
                                               prng_seed=prng_seed,
                                               cache=self.cache_spec)
        chunk = (self.serve_cfg.prefill_chunk if prefill_chunk is None
                 else prefill_chunk)
        self.scheduler = ChunkedPrefillScheduler(
            self.session, chunk_tokens=chunk or None)
        self.slots: List[Optional[Request]] = [None] * B
        self._inflight: Dict[int, Request] = {}
        self._next_uid = 0
        # ----- fault tolerance -----
        self.checkpoint_dir = checkpoint_dir
        # synchronous saves: a preemption checkpoint must be on disk before
        # the process exits
        self.ckpt = (CheckpointManager(checkpoint_dir, keep=2,
                                       async_save=False)
                     if checkpoint_dir else None)
        self._own_guard = guard is None and checkpoint_dir is not None
        self.guard = (guard if guard is not None
                      else (PreemptionGuard() if checkpoint_dir else None))
        if self._own_guard and self.guard is not None:
            self.guard.install()
        self.victim = victim if victim is not None else VictimPolicy()
        self.evict_patience = int(evict_patience)
        self.watchdog_s = watchdog_s
        self.backoff = backoff if backoff is not None else Backoff()
        self.cooldown_ticks = int(cooldown_ticks)
        self._sync_cooldown = 0         # ticks left on the sync fallback
        self._tick = 0
        self.fault_log = FaultLog(cap=fault_log_cap)
        self.completed: List[Request] = []   # finish order, survives restore

    @property
    def tp_degree(self) -> int:
        """Current tensor-parallel degree (1 = unsharded; drops on
        remesh)."""
        shard = self.engine.shard
        return shard.degree if shard is not None else 1

    # ----- request intake -----
    def submit(self, prompt: np.ndarray, max_new_tokens: int = 32,
               eos_token: Optional[int] = None) -> Request:
        return self.adopt(prompt, max_new_tokens, eos_token)

    def adopt(self, prompt: np.ndarray, max_new_tokens: int = 32,
              eos_token: Optional[int] = None, recorded=(),
              stats=None) -> Request:
        """Admit a request that already emitted ``recorded`` tokens on
        another engine (a replica's failover). It prefills here and its
        first ``len(recorded)`` tokens run as verified replay before new
        tokens append; ``stats`` optionally seeds the (exit_points,
        accept_lens) recorded so far, so the finished request's stats match
        an uninterrupted run. Empty ``recorded`` is ``submit``."""
        req = Request(uid=self._next_uid,
                      prompt=np.asarray(prompt, np.int32),
                      max_new_tokens=max_new_tokens, eos_token=eos_token,
                      output=[int(t) for t in recorded],
                      replay_total=len(recorded))
        if stats is not None:
            req.exit_points = [int(x) for x in stats[0]]
            req.accept_lens = [int(x) for x in stats[1]]
        self._next_uid += 1
        self._enqueue(req)
        return req

    def _enqueue(self, req: Request) -> None:
        self._inflight[req.uid] = req
        self.scheduler.submit(req.uid, req.prompt,
                              max_new_tokens=req.max_new_tokens,
                              eos_token=req.eos_token)

    @property
    def pending(self) -> List[Request]:
        """Requests not yet slotted: queued + the in-flight chunked
        admission."""
        return [self._inflight[uid] for uid in
                self.scheduler.admitting + self.scheduler.queued]

    def _retire(self, row: int, req: Request,
                finished: List[Request]) -> None:
        req.done = True
        finished.append(req)
        self.slots[row] = None
        self.session.retire_row(row)    # compaction: free pages, zero span

    # ----- token accounting (replay-aware) -----
    def _admit_token(self, req: Request, tok: int) -> None:
        """Record a request's first token (admission). A re-admitted
        evicted request is in replay: the token is verified, not
        appended."""
        if req.replaying:
            want = int(req.output[req.replayed])
            if int(tok) != want:
                raise ServingFault(
                    "replay", f"uid={req.uid} diverged at token "
                    f"{req.replayed}: re-admission produced {int(tok)}, "
                    f"recorded {want}")
            req.replayed += 1
        else:
            req.output.append(int(tok))

    def _fold_tick(self, req: Request, toks: List[int], exit_point: int,
                   accept_len: int) -> None:
        """Fold one live device tick of one row into the request.

        Replay ticks (tokens emitted before an eviction) are verified
        against the recorded output and add no stats: those were recorded
        the first time, so the finished stats equal an uninterrupted run's.
        A tick across the replay's end verifies its head and appends the
        rest (evictions sit on tick boundaries, but a tree tick may emit
        several tokens)."""
        i = 0
        if req.replaying:
            n = min(len(toks), req.replay_total - req.replayed)
            want = [int(t) for t in req.output[req.replayed:req.replayed + n]]
            got = [int(t) for t in toks[:n]]
            if got != want:
                raise ServingFault(
                    "replay", f"uid={req.uid} diverged at token "
                    f"{req.replayed}: replay produced {got}, recorded {want}")
            req.replayed += n
            i = n
            if req.replaying or i == len(toks):
                return                  # a replayed tick: stats recorded
        req.output.extend(int(t) for t in toks[i:])
        req.exit_points.append(int(exit_point))
        req.accept_lens.append(int(accept_len))

    def _collect(self, res, slots: List[Optional[Request]],
                 finished: List[Request]) -> None:
        """Fold one (possibly multi-tick) StepResult into the requests that
        occupied the slots when it was dispatched, then retire and compact
        the rows that finished. The snapshot matters in the async pipeline:
        a slot can be re-admitted between a megatick's dispatch and its
        finish, and the old result must not go to (or retire) the new
        occupant. A request already retired by an earlier finish is
        skipped (later megaticks report it done again and emit nothing for
        it)."""
        for slot in range(self.B):
            req = slots[slot]
            if req is None or req.done:
                continue
            toks = res.row_tokens(slot)
            if res.is_megatick:
                # the row's tokens are packed in tick order: tick_counts
                # splits them back into per-tick runs
                off = 0
                for t in range(int(res.ticks)):
                    if not bool(res.tick_live[slot, t]):
                        continue
                    n = int(res.tick_counts[slot, t])
                    self._fold_tick(req, toks[off:off + n],
                                    int(res.exit_layer[slot, t]),
                                    int(res.accept_len[slot, t]))
                    off += n
            else:
                self._fold_tick(req, toks, int(res.exit_layer[slot]),
                                int(res.accept_len[slot]))
            if res.done[slot]:
                # req not done => its slot was not re-admitted (slots free
                # only at retirement), so slots[slot] is still req
                self._retire(slot, req, finished)

    # ----- dispatch / finish with recovery -----
    def _attempt(self, site: str, fn):
        """Run ``fn`` under the backoff schedule; when the retries run out,
        raise ``ServingFault`` with the site, the attempt count and the last
        error. Any ``Exception`` is retried, as in the JAX engine: the
        ``dispatch`` site fires before any write to the state, so its
        retry is safe. A CUDA error is sticky, so retrying one cannot
        succeed; it surfaces after the last attempt."""
        delays = list(self.backoff.delays())
        last: Optional[BaseException] = None
        for i in range(len(delays) + 1):
            try:
                return fn()
            except (ServingFault, KeyboardInterrupt):
                raise
            except Exception as err:
                last = err
                retrying = i < len(delays)
                self.fault_log.append(FaultEvent(
                    site=site, tick=self._tick,
                    action="retry" if retrying else "give_up",
                    detail=repr(err)))
                if retrying:
                    self.backoff.sleep(delays[i])
        raise ServingFault(site,
                           f"failed after {len(delays) + 1} attempts: "
                           f"{last!r}",
                           attempts=len(delays) + 1, cause=last) from last

    def _dispatch(self) -> Optional[Tuple]:
        """Dispatch one megatick, with the slot snapshot its results go
        to, if any row may still be live. The host view can trail the
        device by one in-flight megatick, but only toward liveness, so a
        stale dispatch at worst runs zero ticks. A failed dispatch retries
        through the backoff schedule."""
        if np.any(self.session.live_rows()):
            handle = self._attempt(
                "dispatch", lambda: self.session.step_async(self.megatick))
            return handle, list(self.slots)
        return None

    def _checked(self, res) -> Tuple[object, bool]:
        """Check a step result's tokens against the vocabulary (the cheap
        host-side canary for corrupted logits). The ``nan_logits`` site
        poisons the result here to exercise the recovery."""
        tokens = np.asarray(res.tokens)
        if faultinject.fire("nan_logits"):
            tokens = np.full_like(tokens, -(1 << 30))
            res = res._replace(tokens=tokens)
        V = self.model.run.model.vocab_size
        counts = np.asarray(res.counts)
        for row in range(tokens.shape[0]):
            n = int(counts[row])
            if n and (np.any(tokens[row, :n] < 0)
                      or np.any(tokens[row, :n] >= V)):
                return res, False
        return res, True

    def _recover_lost(self, site: str, detail: str) -> None:
        """A megatick's results are lost or untrustworthy: drop the async
        pipeline unread (``abort_async`` waits on nothing of it) and evict
        every live slotted request. The evictions free the rows' pages and
        requeue the requests with their original prompts; replay
        regenerates the lost tokens. The one stream orders the lost
        megatick's writes before any re-admission's. Then the engine cools
        down on synchronous ticks."""
        self.session.abort_async()
        self._handle = None
        evicted = 0
        for row in range(self.B):
            req = self.slots[row]
            if req is not None and not req.done:
                self._evict(row, req, reason=site)
                evicted += 1
        self._sync_cooldown = self.cooldown_ticks
        self.fault_log.append(FaultEvent(
            site=site, tick=self._tick, action="recover",
            detail=f"{detail}; evicted={evicted} rows, sync cooldown "
                   f"{self.cooldown_ticks} ticks"))

    def _finish_handle(self, prev: Tuple, finished: List[Request]) -> None:
        """Read a dispatched megatick and fold its results in, guarding
        three failures: an injected wedge (``finish_timeout``: the results
        never arrive), poisoned tokens (``nan_logits`` or the vocabulary
        check), and a slow finish (over ``watchdog_s``: the results are
        kept, and the engine runs synchronous ticks for
        ``cooldown_ticks``)."""
        handle, slots_at_dispatch = prev
        if faultinject.fire("finish_timeout"):
            self._recover_lost("finish_timeout",
                               "megatick finish wedged past watchdog")
            return
        t0 = time.monotonic()
        res = self.session.finish_step(handle)
        dt = time.monotonic() - t0
        res, ok = self._checked(res)
        if not ok:
            self._recover_lost("nan_logits",
                               "out-of-vocab tokens in megatick result")
            return
        if self.watchdog_s is not None and dt > self.watchdog_s:
            self._sync_cooldown = self.cooldown_ticks
            self.fault_log.append(FaultEvent(
                site="watchdog", tick=self._tick, action="sync_fallback",
                detail=f"finish blocked {dt * 1e3:.1f}ms > "
                       f"{self.watchdog_s * 1e3:.1f}ms"))
        self._collect(res, slots_at_dispatch, finished)

    def _drain(self, finished: List[Request]) -> None:
        """Finish the in-flight async megatick, if any, without dispatching
        another (the checkpoint and eviction barrier)."""
        prev, self._handle = self._handle, None
        if prev is not None:
            self._finish_handle(prev, finished)

    def _sync_step(self, finished: List[Request]) -> None:
        res = self._attempt(
            "dispatch", lambda: self.session.step(num_ticks=self.megatick))
        res, ok = self._checked(res)
        if not ok:
            self._recover_lost("nan_logits",
                               "out-of-vocab tokens in step result")
            return
        self._collect(res, self.slots, finished)

    # ----- pool-pressure eviction -----
    def _evict(self, row: int, req: Request, reason: str) -> None:
        """Evict a live row: free its pages, requeue the request with its
        original prompt. After re-admission the replay re-emits the
        recorded tokens and the engine verifies them."""
        req.evictions += 1
        req.replay_total = len(req.output)
        req.replayed = 0
        self.slots[row] = None
        self.session.retire_row(row)    # pages back to the pool
        self._enqueue(req)
        self.fault_log.append(FaultEvent(
            site=reason, tick=self._tick, action="evict",
            detail=f"uid={req.uid} row={row} progress={len(req.output)} "
                   f"evictions={req.evictions}"))

    def _maybe_evict(self, finished: List[Request]) -> None:
        """The queue's head has waited on ``can_admit`` for
        ``evict_patience`` ticks while a slot sat free: evict the policy's
        victim so admission can go on. The in-flight megatick drains first,
        so its tokens land in the victim's record before ``replay_total``
        is fixed."""
        if self.scheduler.deferred_ticks < self.evict_patience:
            return
        self._drain(finished)
        cands = []
        for row in range(self.B):
            req = self.slots[row]
            if req is None or req.done:
                continue
            cands.append(VictimInfo(row=row, progress=len(req.output),
                                    pages=self.session.row_span(row),
                                    evictions=req.evictions))
        row = self.victim.select(cands)
        if row is None:
            return                      # every candidate is protected
        self._evict(row, self.slots[row], reason="pool_pressure")
        self.scheduler.deferred_ticks = 0

    # ----- elastic remesh on device loss -----
    def remesh(self, mesh, site: str = "device_lost",
               detail: str = "") -> None:
        """Rebuild the decode stack on ``mesh`` (None = unsharded, on the
        current lead device) and re-admit every unfinished request with
        verified replay.

        The in-flight megatick drains first, so its tokens land in each
        request's record before ``replay_total`` freezes; the chunked
        admission aborts back to the queue; a fresh ``Engine`` cuts the
        old one's ``source`` (the whole tree, kept on the host under a
        mesh) for the new mesh and a fresh session builds its pools per
        shard. Decode is deterministic and sharded equals
        unsharded, so replay verifies the recorded tokens and the degraded
        engine's output equals the healthy run's; stats recorded before
        the remesh stay on the request and replay ticks add none."""
        finished: List[Request] = []
        self._drain(finished)
        self.completed.extend(finished)
        self.scheduler.abort_active()
        chunk = self.scheduler.chunk_tokens
        pending: List[Request] = [
            req for req in self.slots if req is not None and not req.done]
        pending.extend(self._inflight[uid] for uid in self.scheduler.queued)
        # re-admission in uid order, whichever rows held them at the loss
        pending.sort(key=lambda r: r.uid)
        old_tp = self.tp_degree
        params, sw = self.engine.source
        if mesh is None:
            mesh = make_mesh([self.engine.device], 1, 1)
        # the old engine's shards and pools go before the new ones exist
        self.engine = self.session = self.scheduler = None
        self.engine = Engine.create(self.model, params, sw=sw,
                                    strategy=self.strategy,
                                    quant=self._src_quant, mesh=mesh,
                                    policy=self._src_policy)
        self.session = self.engine.new_session(batch=self.B, max_seq=self.S,
                                               prng_seed=self._src_seed,
                                               cache=self.cache_spec)
        self.scheduler = ChunkedPrefillScheduler(self.session,
                                                 chunk_tokens=chunk)
        self.slots = [None] * self.B
        self._inflight = {}
        self._handle = None
        for req in pending:
            req.replay_total = len(req.output)
            req.replayed = 0
            self._inflight[req.uid] = req
            self.scheduler.submit(req.uid, req.prompt,
                                  max_new_tokens=req.max_new_tokens,
                                  eos_token=req.eos_token)
        self.fault_log.append(FaultEvent(
            site=site, tick=self._tick, action="remesh",
            detail=f"tp {old_tp}->{self.tp_degree} "
                   f"readmitted={len(pending)}"
                   + (f"; {detail}" if detail else "")))

    def _maybe_device_loss(self) -> None:
        """The ``device_lost`` site: drop the HIGHEST device of this
        engine's mesh between ticks. With a degree over the survivors
        (``plan_replica_remesh``) the engine remeshes in place; with none
        (already unsharded, or no device left) it drains what it can and
        raises ``ServingFault(site="device_lost")`` — terminal alone, the
        kill-and-requeue fallback under a ``ReplicaPool``."""
        if not faultinject.fire("device_lost"):
            return
        mesh = self.engine.mesh
        devices = (mesh.flat if mesh is not None
                   and self.engine.shard is not None else [])
        lost = devices[-1] if devices else None
        surviving = devices[:-1]
        new_tp = plan_replica_remesh(len(surviving), self.tp_degree)
        if new_tp is None:
            self.drain()
            self.fault_log.append(FaultEvent(
                site="device_lost", tick=self._tick, action="give_up",
                detail=f"no factorization over {len(surviving)} surviving "
                       f"devices (tp={self.tp_degree})"))
            raise ServingFault(
                "device_lost",
                f"device lost with no valid remesh (tp={self.tp_degree}, "
                f"surviving={len(surviving)})")
        self.remesh(make_mesh(surviving[:new_tp], 1, new_tp),
                    detail=f"lost={lost}")

    def cancel(self, uid: int) -> bool:
        """Withdraw an unfinished request: drop it from the queue or the
        in-flight chunked admission, or free its slot and pages. The
        in-flight megatick drains first, so a slotted cancel retires a
        coherent row; if that drain finishes the request, it stays
        finished. Returns True when the uid was found live."""
        if uid in self._inflight:
            if uid in self.scheduler.admitting:
                self.scheduler.abort_active()
            self.scheduler.remove(uid)
            del self._inflight[uid]
            return True
        for row in range(self.B):
            req = self.slots[row]
            if req is not None and req.uid == uid and not req.done:
                self.drain()
                if self.slots[row] is req and not req.done:
                    self.slots[row] = None
                    self.session.retire_row(row)
                return True
        return False

    # ----- checkpoint / restore (SIGTERM preemption) -----
    def _req_meta(self, req: Request) -> dict:
        return {"uid": int(req.uid),
                "prompt": [int(t) for t in req.prompt],
                "max_new": int(req.max_new_tokens),
                "eos": (None if req.eos_token is None
                        else int(req.eos_token)),
                "output": [int(t) for t in req.output],
                "exit_points": [int(x) for x in req.exit_points],
                "accept_lens": [int(x) for x in req.accept_lens],
                "done": bool(req.done),
                "replay_total": int(req.replay_total),
                "replayed": int(req.replayed),
                "evictions": int(req.evictions)}

    def _all_requests(self) -> Dict[int, Request]:
        reqs: Dict[int, Request] = {r.uid: r for r in self.completed}
        for r in self.slots:
            if r is not None:
                reqs[r.uid] = r
        reqs.update(self._inflight)
        return reqs

    def checkpoint_now(self) -> int:
        """Drain the in-flight megatick, snapshot the session and the
        engine's bookkeeping, and write a step-atomic checkpoint (the save
        copies the state to the host first). Returns the tick it captures.
        The in-flight chunked admission goes back to the queue's front (it
        holds no pages before its last chunk, so a restored run prefills it
        again)."""
        assert self.ckpt is not None, \
            "checkpoint_now() needs checkpoint_dir"
        self.drain()
        self.scheduler.abort_active()
        state, session_meta = self.session.snapshot()
        meta = {
            "session": session_meta,
            "serve": {
                "tick": int(self._tick),
                "uid_next": int(self._next_uid),
                "requests": [self._req_meta(r)
                             for r in self._all_requests().values()],
                "completed": [int(r.uid) for r in self.completed],
                "slots": [None if r is None else int(r.uid)
                          for r in self.slots],
                "queue": [int(u) for u in self.scheduler.queued],
            },
        }
        self.ckpt.save(self._tick, {"state": state}, extra=meta)
        self.fault_log.append(FaultEvent(
            site="sigterm", tick=self._tick, action="checkpoint",
            detail=f"saved tick {self._tick} to {self.ckpt.root}"))
        return self._tick

    def restore_checkpoint(self) -> bool:
        """Adopt the latest checkpoint into this freshly built engine (same
        config). Returns False when the directory holds no committed
        checkpoint (first boot): the engine then starts clean. After True
        the next ``step()`` continues the saved run token-identically."""
        assert self.ckpt is not None, \
            "restore_checkpoint() needs checkpoint_dir"
        hit = self.ckpt.restore_latest(
            like={"state": self.engine.unshard_state(self.session._state)})
        if hit is None:
            return False
        step, tree, extra = hit
        self.session.restore(tree["state"], extra["session"])
        sv = extra["serve"]
        self._tick = int(sv["tick"])
        self._next_uid = int(sv["uid_next"])
        reqs: Dict[int, Request] = {}
        for rm in sv["requests"]:
            reqs[int(rm["uid"])] = Request(
                uid=int(rm["uid"]),
                prompt=np.asarray(rm["prompt"], np.int32),
                max_new_tokens=int(rm["max_new"]),
                eos_token=(None if rm["eos"] is None else int(rm["eos"])),
                output=[int(t) for t in rm["output"]],
                exit_points=[int(x) for x in rm["exit_points"]],
                accept_lens=[int(x) for x in rm["accept_lens"]],
                done=bool(rm["done"]),
                replay_total=int(rm["replay_total"]),
                replayed=int(rm["replayed"]),
                evictions=int(rm["evictions"]))
        self.completed = [reqs[int(u)] for u in sv["completed"]]
        self.slots = [None if u is None else reqs[int(u)]
                      for u in sv["slots"]]
        self._inflight = {}
        for uid in sv["queue"]:
            self._enqueue(reqs[int(uid)])
        self._handle = None
        self.fault_log.append(FaultEvent(
            site="sigterm", tick=self._tick, action="restore",
            detail=f"resumed from tick {step} in {self.ckpt.root}"))
        return True

    def _maybe_preempt(self) -> None:
        """SIGTERM (real, through ``PreemptionGuard``, or the ``sigterm``
        site) between ticks: drain, checkpoint if configured, and raise
        ``Preempted``, the launcher's signal to exit and be restarted with
        ``--restore``."""
        hit = faultinject.fire("sigterm")
        if self.guard is not None and self.guard.should_save():
            hit = True
        if not hit:
            return
        if self.ckpt is not None:
            step = self.checkpoint_now()
            raise Preempted(step=step, path=self.ckpt.root)
        self.drain()
        raise Preempted(step=self._tick, path="")

    def close(self) -> None:
        """Release process-global hooks (the SIGTERM handler, if this
        engine installed its own guard)."""
        if self._own_guard and self.guard is not None:
            self.guard.uninstall()

    # ----- one batched engine tick -----
    def step(self) -> List[Request]:
        """Scheduled admission (at most one prefill chunk while decode is
        live), one strategy megatick for all live slots, retire + compact
        the finished. Returns the requests completed this call.

        With ``async_ticks`` the call is one pipeline stage: megatick N+1
        is dispatched before megatick N's results are read, so the host
        work below (folding results, retirement, admission) follows
        device work already queued; results arrive one call later than on
        the blocking path. During a recovery cooldown ticks run
        synchronously."""
        self._maybe_preempt()
        self._maybe_device_loss()
        self._tick += 1
        finished: List[Request] = []
        async_enabled = self.async_ticks and self._sync_cooldown == 0
        if self._sync_cooldown > 0:
            self._sync_cooldown -= 1
        prev, self._handle = self._handle, None
        if prev is not None:
            if async_enabled:
                # the next megatick goes out before this one is read
                self._handle = self._dispatch()
            self._finish_handle(prev, finished)
        live = bool(np.any(self.session.live_rows()))
        free = [s for s in range(self.B) if self.slots[s] is None]
        for ev in self.scheduler.tick(free, live_decode=live):
            req = self._inflight.pop(ev.uid)
            if req.max_new_tokens > 0:
                self._admit_token(req, ev.first_token)
            if self.session.row_done(ev.row):
                self._retire(ev.row, req, finished)
            else:
                self.slots[ev.row] = req
        self._maybe_evict(finished)
        if self._handle is None and np.any(self.session.live_rows()):
            if async_enabled:
                self._handle = self._dispatch()
            else:
                self._sync_step(finished)
        self.completed.extend(finished)
        return finished

    @property
    def in_flight(self) -> bool:
        """An async megatick is dispatched but its results are unread."""
        return self._handle is not None

    @property
    def busy(self) -> bool:
        """Work outstanding: queued or in-flight admission, live rows, or
        an in-flight async megatick awaiting its results."""
        return (self._handle is not None or self.scheduler.has_work()
                or bool(np.any(self.session.live_rows())))

    def drain(self) -> List[Request]:
        """Finish (without replacing) the in-flight async megatick, if any;
        returns the requests it completes."""
        finished: List[Request] = []
        self._drain(finished)
        self.completed.extend(finished)
        return finished

    def run_to_completion(self, max_ticks: int = 10_000) -> List[Request]:
        done: List[Request] = []
        for _ in range(max_ticks):
            done.extend(self.step())
            if not self.busy:
                return done
        raise ServingFault(
            "stall",
            f"still busy after {max_ticks} ticks: "
            f"queued={len(self.scheduler.queued)} "
            f"admitting={len(self.scheduler.admitting)} "
            f"live={int(np.sum(self.session.live_rows()))} "
            f"in_flight={self.in_flight}")
