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

On a paged cache on a CUDA card the engine turns on the paged
decode-attention kernel (``ModelFlags.decode_kernel``), as the JAX engine
does on a TPU. The constructor takes the JAX engine's arguments in its
order. Eviction, checkpoints, dispatch retries, watchdogs and fault
injection, and the mesh, are not ported; asking for them raises
``ValueError`` naming their ROADMAP item.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from repro_torch.api import (CacheSpec, DecodeStrategy, DenseStrategy,
                             Engine, get_strategy)
from repro_torch.api.cache import PagedKVCache
from repro_torch.api.scheduler import ChunkedPrefillScheduler
from repro_torch.models.common import lm_head_weight
from repro_torch.models.model import Model, build_model


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


_FAULTS = "ROADMAP: fault tolerance"


def _refuse_unported(**given) -> None:
    """Raise for each argument of the JAX engine whose feature the port
    does not have, when it asks for that feature; ``given`` maps the
    argument to (value, the value that asks for nothing, ROADMAP item)."""
    for name, (value, idle, item) in given.items():
        if value != idle:
            raise ValueError(f"{name}={value!r} is not ported yet ({item})")


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
                 guard=None, victim=None, evict_patience: int = 2,
                 watchdog_s: Optional[float] = None, backoff=None,
                 cooldown_ticks: int = 8, quant=None, mesh=None,
                 policy: str = "tp_dp", fault_log_cap: int = 256):
        _refuse_unported(
            checkpoint_dir=(checkpoint_dir, None, _FAULTS),
            guard=(guard, None, _FAULTS), victim=(victim, None, _FAULTS),
            evict_patience=(evict_patience, 2, _FAULTS),
            watchdog_s=(watchdog_s, None, _FAULTS),
            backoff=(backoff, None, _FAULTS),
            cooldown_ticks=(cooldown_ticks, 8, _FAULTS),
            fault_log_cap=(fault_log_cap, 256, _FAULTS),
            mesh=(mesh, None, "ROADMAP: multi-GPU"),
            policy=(policy, "tp_dp", "ROADMAP: multi-GPU"))
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
        if (spec.kind == "paged" and not flags.decode_kernel
                and lm_head_weight(params).device.type == "cuda"):
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
        self.engine = Engine.create(model, params, sw=sw,
                                    strategy=self.strategy, quant=quant)
        B = self.serve_cfg.max_batch
        S = self.serve_cfg.max_seq_len
        self.B, self.S = B, S
        self.session = self.engine.new_session(batch=B, max_seq=S,
                                               prng_seed=prng_seed,
                                               cache=self.cache_spec)
        mgr = self.session.cache_mgr
        if (isinstance(mgr, PagedKVCache)
                and mgr.num_pages < B * mgr.pages_per_row):
            raise ValueError(
                f"paged pool of {mgr.num_pages} pages is smaller than "
                f"max_batch x pages_per_row = {B * mgr.pages_per_row}: "
                "serving an oversubscribed pool needs eviction, which is "
                f"not ported yet ({_FAULTS})")
        chunk = (self.serve_cfg.prefill_chunk if prefill_chunk is None
                 else prefill_chunk)
        self.scheduler = ChunkedPrefillScheduler(
            self.session, chunk_tokens=chunk or None)
        self.slots: List[Optional[Request]] = [None] * B
        self._inflight: Dict[int, Request] = {}
        self._next_uid = 0
        self.completed: List[Request] = []      # in finish order

    # ----- request intake -----
    def submit(self, prompt: np.ndarray, max_new_tokens: int = 32,
               eos_token: Optional[int] = None) -> Request:
        req = Request(uid=self._next_uid,
                      prompt=np.asarray(prompt, np.int32),
                      max_new_tokens=max_new_tokens, eos_token=eos_token)
        self._next_uid += 1
        self._inflight[req.uid] = req
        self.scheduler.submit(req.uid, req.prompt,
                              max_new_tokens=req.max_new_tokens,
                              eos_token=req.eos_token)
        return req

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

    # ----- token accounting -----
    def _admit_token(self, req: Request, tok: int) -> None:
        """Record a request's first token (admission)."""
        req.output.append(int(tok))

    def _fold_tick(self, req: Request, toks: List[int], exit_point: int,
                   accept_len: int) -> None:
        """Fold one live device tick of one row into the request."""
        req.output.extend(int(t) for t in toks)
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

    # ----- dispatch / finish -----
    def _dispatch(self) -> Optional[Tuple]:
        """Dispatch one megatick, with the slot snapshot its results go
        to, if any row may still be live. The host view can trail the
        device by one in-flight megatick, but only toward liveness, so a
        stale dispatch at worst runs zero ticks."""
        if np.any(self.session.live_rows()):
            return (self.session.step_async(self.megatick),
                    list(self.slots))
        return None

    def _finish_handle(self, prev: Tuple, finished: List[Request]) -> None:
        """Read a dispatched megatick and fold its results in."""
        handle, slots_at_dispatch = prev
        self._collect(self.session.finish_step(handle), slots_at_dispatch,
                      finished)

    def _sync_step(self, finished: List[Request]) -> None:
        self._collect(self.session.step(num_ticks=self.megatick),
                      self.slots, finished)

    # ----- one batched engine tick -----
    def step(self) -> List[Request]:
        """Scheduled admission (at most one prefill chunk while decode is
        live), one strategy megatick for all live slots, retire + compact
        the finished. Returns the requests completed this call.

        With ``async_ticks`` the call is one pipeline stage: megatick N+1
        is dispatched before megatick N's results are read, so the host
        work below (folding results, retirement, admission) follows
        device work already queued; results arrive one call later than on
        the blocking path."""
        finished: List[Request] = []
        prev, self._handle = self._handle, None
        if prev is not None:
            if self.async_ticks:
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
        if self._handle is None and np.any(self.session.live_rows()):
            if self.async_ticks:
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
        prev, self._handle = self._handle, None
        if prev is not None:
            self._finish_handle(prev, finished)
        self.completed.extend(finished)
        return finished

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

    def run_to_completion(self, max_ticks: int = 10_000) -> List[Request]:
        done: List[Request] = []
        for _ in range(max_ticks):
            done.extend(self.step())
            if not self.busy:
                return done
        raise RuntimeError(
            f"still busy after {max_ticks} ticks: "
            f"queued={len(self.scheduler.queued)} "
            f"admitting={len(self.scheduler.admitting)} "
            f"live={int(np.sum(self.session.live_rows()))} "
            f"in_flight={self.in_flight}")
