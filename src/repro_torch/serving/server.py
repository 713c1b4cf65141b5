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
    are admitted into the freed slots.

On a paged cache on a CUDA card the engine turns on the paged
decode-attention kernel (``ModelFlags.decode_kernel``), as the JAX engine
does on a TPU. The constructor takes the JAX engine's arguments in its
order. This is the core loop: megaticks and async ticks, sampling, and
eviction, checkpoints, watchdogs and fault injection, and the mesh, are not
ported; asking for them raises ``ValueError`` naming their ROADMAP item.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Union

import numpy as np

from repro_torch.api import CacheSpec, DecodeStrategy, Engine, get_strategy
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


_MEGATICKS = "ROADMAP: megaticks and a device-resident tick"
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
        # async ticks pipeline megaticks; False is the port's one mode
        _refuse_unported(
            megatick=(megatick, 1, _MEGATICKS),
            async_ticks=(bool(async_ticks), False, _MEGATICKS),
            checkpoint_dir=(checkpoint_dir, None, _FAULTS),
            guard=(guard, None, _FAULTS), victim=(victim, None, _FAULTS),
            evict_patience=(evict_patience, 2, _FAULTS),
            watchdog_s=(watchdog_s, None, _FAULTS),
            backoff=(backoff, None, _FAULTS),
            cooldown_ticks=(cooldown_ticks, 8, _FAULTS),
            fault_log_cap=(fault_log_cap, 256, _FAULTS),
            mesh=(mesh, None, "ROADMAP: multi-GPU"),
            policy=(policy, "tp_dp", "ROADMAP: multi-GPU"))
        if strategy is None and not (specee and model.run.specee.enabled) \
                and not model.run.serve.greedy:
            raise ValueError(
                "serve.greedy=False: sampling is not ported yet (ROADMAP: "
                "the rest of serving, serving/sampler.py)")
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
            strategy = ("specee" if specee and model.run.specee.enabled
                        else "dense")
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
        """Fold one tick's StepResult into the slotted requests, then retire
        and compact the rows that finished."""
        for slot in range(self.B):
            req = slots[slot]
            if req is None or req.done:
                continue
            self._fold_tick(req, res.row_tokens(slot),
                            int(res.exit_layer[slot]),
                            int(res.accept_len[slot]))
            if res.done[slot]:
                self._retire(slot, req, finished)

    def _sync_step(self, finished: List[Request]) -> None:
        self._collect(self.session.step(), self.slots, finished)

    # ----- one batched engine tick -----
    def step(self) -> List[Request]:
        """Scheduled admission (at most one prefill chunk while decode is
        live), one strategy step for all live slots, retire + compact the
        finished. Returns the requests completed this call."""
        finished: List[Request] = []
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
        if np.any(self.session.live_rows()):
            self._sync_step(finished)
        return finished

    @property
    def busy(self) -> bool:
        """Work outstanding: queued or in-flight admission, or live rows."""
        return (self.scheduler.has_work()
                or bool(np.any(self.session.live_rows())))

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
            f"live={int(np.sum(self.session.live_rows()))}")
