"""Engine / DecodeSession (counterpart of ``repro/api/session.py``; a tree
tick emits up to ``depth + 1`` tokens per row):

    engine = Engine.create(model, params, sw, strategy="specee")
    session = engine.new_session()
    first = session.prefill(prompts, max_new_tokens=64)
    while not session.all_done():
        res = session.step()            # or session.step(num_ticks=4)

``Engine`` binds (model, params, SpecEE weights, strategy); a session owns
one batched ``DecodeState`` plus per-row token budgets, EOS cut-off and the
``done`` mask. For single steps that bookkeeping runs on the host; for
``step(num_ticks=K)`` it moves into a carry of (B,) tensors on the device,
and K ticks run as one megatick (``engine.megatick_decode``) whose results
are read once, at its end. Its KV memory is owned by a ``KVCacheManager``
(``api.cache``): ``new_session(cache="paged")`` swaps the dense layout for
page pools + a page table with no change to the step, and ``retire_row``
compacts a finished row. The KV cache is updated in place every tick.

``step_async`` is the serving engine's pipelined variant: it runs a
megatick and returns a handle whose results are read by ``finish_step``,
so the next megatick can be dispatched first. The carry stays on the
device across megaticks; admission and retirement between a finish and
the next dispatch mirror their row edits onto it. The KV cache being
updated in place stays safe: one stream orders megatick N+1 after N, and a
handle owns its output and carry tensors, which no later megatick or
mirror writes.

Weight-only quantization (``Engine.create(..., quant="int8"|"int4"|
QuantSpec)``): the engine builds the parallel bundle ``engine.qw``
(``repro_torch.quant.quantize_params``); the caller's params are never
touched. The decode step reads the quantized LM head and predictor bank
(the ``*_q`` kernels). Every prefill site — ``prefill``, ``prefill_row``,
``prefill_chunk`` and the end of a chunked admission — reads
``engine.prefill_weights()``, the cached ``dequantized_reference`` view,
so the prompt's K/V and first token come from the weights the decode step
uses. The decode step's projections are that view's dequantized
projections too. The JAX engine dequantizes them inside its jitted step,
where XLA fuses the dequantization into each matmul; eager PyTorch has no
such fusion, and dequantizing every step would move about 13 GB per step at
llama2-7b's width for the same numbers. The JAX engine holds the same view
for prefill, so memory is no worse than the reference's: the fp params,
the codes, and one dequantized copy of the projections.

Two session styles:
  * whole-batch: ``prefill(prompts)`` then ``step()``;
  * slot-based (continuous batching): ``new_session(batch=B, max_seq=S)``
    pre-allocates empty rows; admission is one-shot (``prefill_row(slot,
    prompt)``) or chunked (``begin_admission`` + ``prefill_chunk``), which
    splits the prompt forward into fixed-token chunks so the serving loop
    can interleave them with decode ticks.

A session carries its sampling seed (``new_session(prng_seed=)``) in its
state; only a sampling ``DenseStrategy`` reads it, and the prefill's first
token stays greedy.

``snapshot()`` returns the session's state and host bookkeeping, and
``restore`` adopts one into a session built the same way (the serving
engine's checkpoints). The snapshot's tensors are the live ones, which the
next step writes in place: ``CheckpointManager.save`` copies them to the
host before it returns. Under a mesh the snapshot is the whole-tensor
layout, each shard's part gathered onto the lead device (a copy), and
``restore`` places a snapshot on its own engine's mesh: a snapshot
restores into an engine of another degree.

Tensor-parallel decode (``Engine.create(..., mesh=make_host_mesh(1, P))``):
the engine holds its model's sharded view and the params' slices
(``sharding.serving``); every session, megatick, ``step_async``,
``snapshot`` and ``restore`` runs under it unchanged, the replicated state
on the mesh's lead device. A ``(D, P)`` mesh with D > 1 (``policy=
"tp_dp"|"tp2d"|"fsdp_tp"``) places the weights over the data rows as
well (``sharding.serving.shard_params``) and the model splits each block
call's batch over the rows (``Model.with_rows``); the decode caches split
their batch over the rows, and everything else of the state stays whole
on the lead, so the sessions, the strategies and the engine's host loop
are the same code. A snapshot joins a paged pool's per-row copies page by
page (``sharding.serving.unplace_cache``). Under a mesh the whole tree is kept once, on
the host (``Engine.source``): the device copies, and a remesh's, are cut
from it, so no card holds it beside its shards.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional, Union

import numpy as np
import torch

from repro_torch.api.cache import (CacheSpec, KVCacheManager,
                                   insert_row_pytree, make_cache_manager)
from repro_torch.api.strategies import DecodeStrategy, get_strategy
from repro_torch.api.types import StepResult
from repro_torch.core import draft as draft_lib
from repro_torch.core import engine as eng
from repro_torch.core import scheduler as sched_lib
from repro_torch.models.common import (lm_head_weight, tree_map,
                                       with_contiguous_head)
from repro_torch.models.model import Model
from repro_torch.quant import (QuantSpec, dequantized_reference,
                               quantize_params)
from repro_torch.runtime import faultinject
from repro_torch.sharding import serving as shard_serving
from repro_torch.sharding.ctx import ShardCtx
from repro_torch.sharding.rows import RowMesh

_NO_BUDGET = np.iinfo(np.int64).max
_DEV_NO_BUDGET = np.iinfo(np.int32).max     # device-carry budget cap


@dataclass
class MegatickHandle:
    """One dispatched-but-unread megatick (``DecodeSession.step_async``).

    ``out``/``carry`` hold device tensors that ``finish_step`` reads. The
    carry captured here is the megatick's OUTPUT limits — the tensors the
    next megatick consumes as input. ``dirty`` collects rows whose host
    bookkeeping advanced after this dispatch (retire / re-admit mirror
    edits): for those rows the captured carry is stale, so ``finish_step``
    keeps the host values instead of syncing from it.
    """
    out: Any
    carry: Any
    num_ticks: int
    dirty: set = field(default_factory=set)


class Engine:
    """Binds a model + weights to a decode strategy; factory for sessions.
    The engine runs on the device its weights live on, or under a mesh on
    the mesh's lead device with each shard's slices on its own."""

    def __init__(self, model: Model, params, sw=None,
                 strategy: Union[str, DecodeStrategy, None] = None,
                 quant=None, mesh=None, policy: str = "tp_dp"):
        # tensor-parallel serving: a (1, P) mesh places the weights by the
        # policy's Megatron roles (``sharding.serving.shard_params``) and
        # the model builds its KV caches per shard; a mesh of model extent
        # 1 is the unsharded path. DATA > 1 places over the data rows too
        # (``self.rows``), the model splitting each batch over them
        self.mesh = mesh
        self.policy = policy
        self.shard = ShardCtx.from_mesh(mesh)
        self.rows = (RowMesh(model, mesh) if mesh is not None
                     and int(mesh.shape["data"]) > 1 else None)
        self.placed = self.shard is not None or self.rows is not None
        if mesh is not None:
            shard_serving.check_servable(model, mesh, policy)
        # a tied head (Mamba2) as one contiguous copy for the kernels
        params = with_contiguous_head(params)
        if mesh is not None:
            # under a mesh the whole tree is kept once, on the host: it is
            # what the device copies and a remesh's are cut from, and no
            # card holds it beside its shard (no copy if already there)
            params = shard_serving.to_host(params)
            sw = shard_serving.to_host(sw)
        self.source = (params, sw)
        self.strategy = get_strategy(strategy)
        self.strategy.validate(model, sw)
        # weight-only quantization: a parallel bundle of codes + scales,
        # built from the whole tree; under a mesh it is made on the lead
        # device, a tensor at a time from the host copy, and stays whole
        # there (JAX replicates the quantized tiles)
        self.quant_spec = QuantSpec.resolve(quant)
        self.qw = quantize_params(
            params, sw, self.quant_spec,
            device=None if mesh is None else mesh.devices[0][0])
        if not self.placed:
            # unsharded: on the degree-1 mesh's device, else where the
            # weights are
            self.model = model
            self.device = (mesh.flat[0] if mesh is not None
                           else lm_head_weight(params).device)
            self.params = shard_serving.unplace(params, self.device)
            self.sw = shard_serving.unplace(sw, self.device)
            if self.qw is not None:
                self.qw = shard_serving.unplace(self.qw, self.device)
        else:
            self.model = (model.with_rows(self.rows) if self.rows is not None
                          else model.with_shard(self.shard))
            self.params, self.sw = shard_serving.shard_params(
                params, sw, mesh, policy, model)
            self.device = mesh.devices[0][0]
            if self.qw is not None:
                self.qw = shard_serving.unplace(self.qw, self.device)
        self._prefill_view = None
        self._decode_view = None

    @classmethod
    def create(cls, model: Model, params, sw=None,
               strategy: Union[str, DecodeStrategy, None] = None,
               quant=None, mesh=None, policy: str = "tp_dp") -> "Engine":
        """``Engine.create(model, params, sw,
        strategy="dense"|"specee"|"tree",
        quant=None|"int8"|"int4"|QuantSpec(...),
        mesh=None|repro_torch.launch.mesh.Mesh,
        policy="tp_dp"|"tp2d"|"fsdp_tp")``. A mesh with a 'model' axis of
        extent > 1 turns on tensor-parallel decode, one with a 'data' axis
        of extent > 1 splits the batch over the data rows."""
        return cls(model, params, sw=sw, strategy=strategy, quant=quant,
                   mesh=mesh, policy=policy)

    def shard_state(self, state, like):
        """Place a whole-layout ``DecodeState`` on the engine's mesh (no-op
        unsharded) in the layout of ``like``, a state of this engine (each
        cache leaf cut as ``like``'s ``Shards`` is, the rest on the lead
        device). ``restore`` calls it, so a snapshot taken at one degree
        restores at another."""
        if not self.placed:
            return state
        return shard_serving.place_like(state, like, self.device)

    def unshard_state(self, state):
        """The whole-tensor layout of a ``DecodeState`` (no-op unsharded):
        every shard's KV heads gathered onto the lead device, the data
        rows' batches joined, a paged pool's per-row copies joined page by
        page (``unplace_cache``)."""
        if not self.placed:
            return state
        whole = shard_serving.unplace(state._replace(cache=None), self.device)
        return whole._replace(cache=shard_serving.unplace_cache(
            state.cache, self.device))

    @property
    def emit_width(self) -> int:
        return self.strategy.emit_width(self.model)

    def prefill_weights(self):
        """(params, sw) every prefill and admission path reads: the
        originals, or under quantization the ``dequantized_reference``
        view (its LM head fp32; ``Model.logits`` casts it to the
        activation dtype), made once and cached."""
        if self.qw is None:
            return self.params, self.sw
        if self._prefill_view is None:
            params, sw = self.source
            view = dequantized_reference(params, sw, self.qw)
            if self.mesh is not None and not self.placed:
                view = (shard_serving.unplace(view[0], self.device),
                        shard_serving.unplace(view[1], self.device))
            elif self.placed:
                view = shard_serving.shard_params(*view, self.mesh,
                                                  self.policy, self.model)
            self._prefill_view = view
        return self._prefill_view

    def decode_weights(self):
        """(params, sw, qw) the decode step reads. Under quantization with
        quantized projections, ``params`` takes the prefill view's
        dequantized segments (shared, not copied) beside the original LM
        head and embeddings, and ``qw`` drops its ``proj`` entry, which
        those segments already hold (see the module docstring)."""
        if self.qw is None or self.qw.get("proj") is None:
            return self.params, self.sw, self.qw
        if self._decode_view is None:
            view, _ = self.prefill_weights()
            self._decode_view = (dict(self.params,
                                      segments=view["segments"]),
                                 self.sw, dict(self.qw, proj=None))
        return self._decode_view

    def megatick(self, state: eng.DecodeState, limits, num_ticks: int):
        """The K-tick step on ``decode_weights()`` (JAX's
        ``Engine.megatick_jit``, which compiles it once per K). The state's
        caches are updated in place; the limits passed in are not written.
        Returns ``(out, state, new_limits)``."""
        params, sw, qw = self.decode_weights()
        return self.strategy.megatick(self.model, params, sw, state, limits,
                                      num_ticks, qw=qw)

    def new_session(self, batch: Optional[int] = None,
                    max_seq: Optional[int] = None, prng_seed: int = 0,
                    cache: Union[None, str, CacheSpec] = None
                    ) -> "DecodeSession":
        """``batch=None``: an empty shell, filled by ``prefill(prompts)``.
        ``batch=B``: B pre-allocated empty rows for slot-based serving
        (``max_seq`` defaults to the run's ``serve.max_seq_len``).
        ``prng_seed``: the seed of a sampling strategy, carried in the
        session's state; the greedy strategies ignore it.
        ``cache``: "dense" (default) | "paged" | a ``CacheSpec``."""
        return DecodeSession(self, batch=batch, max_seq=max_seq,
                             prng_seed=prng_seed, cache=cache)


@dataclass
class Admission:
    """One in-flight chunked prefill (host-side handle).

    Created by ``DecodeSession.begin_admission``; each ``prefill_chunk``
    call advances ``consumed`` by at most one chunk of prompt tokens. When
    the prompt is exhausted the session inserts the finished batch-1 state
    into ``row`` and sets ``first_token``.
    """
    row: int
    tokens: np.ndarray
    max_new_tokens: Optional[int] = None
    eos_token: Optional[int] = None
    consumed: int = 0
    cache: Any = None               # batch-1 dense extend cache
    h_parts: List[Any] = field(default_factory=list)
    first_token: Optional[int] = None

    @property
    def prompt_len(self) -> int:
        return int(self.tokens.shape[0])

    @property
    def complete(self) -> bool:
        return self.first_token is not None

    @property
    def remaining(self) -> int:
        return self.prompt_len - self.consumed


class DecodeSession:
    def __init__(self, engine: Engine, batch: Optional[int] = None,
                 max_seq: Optional[int] = None, prng_seed: int = 0,
                 cache: Union[None, str, CacheSpec] = None):
        self.engine = engine
        self._prng_seed = int(prng_seed)
        self._max_seq = max_seq
        self._cache_spec = CacheSpec.resolve(cache, engine.model.run.serve)
        self._state: Optional[eng.DecodeState] = None
        self.cache_mgr: Optional[KVCacheManager] = None
        self.batch: Optional[int] = None
        # device-side decode limits (budget/emitted/eos/done/retired): None
        # = the host bookkeeping is authoritative, rebuilt at the next
        # megatick dispatch; else the carry threading megatick to megatick
        self._dev_carry: Optional[dict] = None
        # dispatched-but-unread megaticks, oldest first (the async pipeline
        # dispatches N+1 before finishing N)
        self._async_handles: List[MegatickHandle] = []
        if batch is not None:
            if max_seq is None:
                max_seq = engine.model.run.serve.max_seq_len
                self._max_seq = max_seq
            self.cache_mgr = self._make_manager(batch, max_seq)
            self._state = engine.strategy.empty_state(
                engine.model, engine.sw, batch, max_seq,
                cache=self.cache_mgr.empty_cache(), device=engine.device,
                prng=self._prng_seed)
            self._alloc_bookkeeping(batch, live=False)

    def _make_manager(self, batch: int, max_seq: int) -> KVCacheManager:
        e = self.engine
        seq = e.strategy.cache_seq_len(e.model, max_seq)
        return make_cache_manager(e.model, batch, seq, self._cache_spec,
                                  e.device)

    # ----- host-side bookkeeping -----
    def _alloc_bookkeeping(self, batch: int, live: bool) -> None:
        self.batch = batch
        self._emitted = np.zeros(batch, np.int64)
        self._budget = np.full(batch, _NO_BUDGET, np.int64)
        self._eos: List[Optional[int]] = [None] * batch
        # empty slots count as done until a request is admitted
        self._done = np.full(batch, not live, bool)
        # rows compacted by retire_row: their logical length is pinned to 0
        # after every tick (the batched step advances len uniformly).
        # Never-admitted slots start retired too ("retired from birth"):
        # without the pin their length would creep up every tick until it
        # saturates the row's capacity, and the degenerate attention there
        # would touch live rows through the batch-shared kernels
        self._retired: set = set() if live else set(range(batch))
        self._dev_carry = None

    # ----- device-side decode-limit carry (megatick path) -----
    def _carry_from_host(self) -> dict:
        """The device-side limits built from the host bookkeeping (at a
        dispatch that finds no carry)."""
        retired = np.zeros(self.batch, bool)
        retired[sorted(self._retired)] = True

        def dev(x, dtype):      # a copy: the host mirrors change later
            return torch.tensor(np.asarray(x), dtype=dtype,
                                device=self.engine.device)

        return {
            "budget": dev(np.minimum(self._budget, _DEV_NO_BUDGET),
                          torch.int32),
            "emitted": dev(np.minimum(self._emitted, _DEV_NO_BUDGET),
                           torch.int32),
            "eos": dev([-1 if e is None else int(e) for e in self._eos],
                       torch.int32),
            "done": dev(self._done, torch.bool),
            "retired": dev(retired, torch.bool),
        }

    def _mirror_row_to_dev(self, row: int) -> None:
        """Apply one row's host bookkeeping onto the device carry —
        admission/retirement between a megatick's dispatch and the next
        must edit the carried tensors, not just the host mirrors the carry
        overwrites at the next finish. Each tensor is cloned first: an
        outstanding handle holds the current ones."""
        c = self._dev_carry
        if c is None:
            return
        eos = self._eos[row]
        values = {"budget": int(min(self._budget[row], _DEV_NO_BUDGET)),
                  "emitted": int(min(self._emitted[row], _DEV_NO_BUDGET)),
                  "eos": -1 if eos is None else int(eos),
                  "done": bool(self._done[row]),
                  "retired": row in self._retired}
        carry = {}
        for name, value in values.items():
            carry[name] = c[name].clone()
            carry[name][row] = value
        self._dev_carry = carry
        # outstanding megaticks were dispatched with a carry that predates
        # this edit: their finish must not roll the row's host mirrors back
        for h in self._async_handles:
            h.dirty.add(row)

    def _set_row_limits(self, row: int, max_new_tokens: Optional[int],
                        eos_token: Optional[int]) -> None:
        self._emitted[row] = 0
        self._budget[row] = (_NO_BUDGET if max_new_tokens is None
                             else max_new_tokens)
        self._eos[row] = eos_token
        self._done[row] = False

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
        """Device → host + per-row budget/EOS accounting. The accounting
        runs on the host, so a device carry is stale afterwards: drop it
        (the next megatick rebuilds it from the host)."""
        self._dev_carry = None
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

    def row_done(self, row: int) -> bool:
        return bool(self._done[row])

    def live_rows(self) -> np.ndarray:
        return ~self._done

    # ----- cache management -----
    def can_admit(self, prompt_len: int = 0) -> bool:
        """Does the cache manager have room for one more request (paged: a
        full row reservation of free pages)?"""
        return self.cache_mgr is None or self.cache_mgr.can_admit(prompt_len)

    def retire_row(self, row: int) -> None:
        """Per-row compaction: release the finished row's cache footprint
        (paged: pages back to the free list; dense: length to zero). Safe
        after a dispatched megatick: the row's done/retired bits are
        mirrored onto the carry, so the next megatick skips it."""
        assert self._state is not None and self.cache_mgr is not None
        self._done[row] = True
        self._retired.add(row)
        self._state = self._state._replace(
            cache=self.cache_mgr.retire_row(self._state.cache, row))
        self._mirror_row_to_dev(row)

    def row_span(self, row: int) -> int:
        """Attention span the row currently pays."""
        assert self._state is not None and self.cache_mgr is not None
        return self.cache_mgr.row_span(self._state.cache, row)

    @property
    def in_flight(self) -> int:
        """Dispatched-but-unread async megaticks outstanding."""
        return len(self._async_handles)

    def abort_async(self) -> None:
        """Forget every dispatched-but-unread megatick. The host mirrors
        stay at their last synced values, which are authoritative because
        the aborted megaticks' results were never read, and the device
        carry is dropped, so the next dispatch rebuilds it from the host.
        Nothing of the dropped handles is read or waited on. The state
        keeps the aborted megaticks' writes: a caller that distrusts them
        evicts the affected rows, whose replay rebuilds them."""
        self._async_handles.clear()
        self._dev_carry = None

    # ----- checkpoint / restore -----
    def snapshot(self) -> tuple:
        """-> ``(state_tree, meta)``: the whole decode state of the session.

        ``state_tree`` is the ``DecodeState`` (page pools or dense caches,
        page table, draft cache, scheduler state, the sampling seed);
        ``meta`` is the host bookkeeping as JSON values (budgets, emitted
        counts, EOS, done and retired mirrors, the cache manager's
        allocator state). Together they let ``restore`` resume decoding
        token-identically. The tensors are the live ones (see the module
        docstring). Outstanding async megaticks must be finished or aborted
        first: the host mirrors would trail the state they wrote."""
        assert self._state is not None and self.batch is not None, \
            "nothing to snapshot: session has no state"
        assert not self._async_handles, \
            "finish_step()/abort_async() outstanding megaticks before " \
            "snapshot()"
        meta = {
            "batch": int(self.batch),
            "max_seq": int(self._max_seq),
            "strategy": self.engine.strategy.name,
            "emitted": [int(x) for x in self._emitted],
            "budget": [None if int(b) >= _NO_BUDGET else int(b)
                       for b in self._budget],
            "eos": [None if e is None else int(e) for e in self._eos],
            "done": [bool(d) for d in self._done],
            "retired": sorted(int(r) for r in self._retired),
            "cache": self.cache_mgr.export_state(),
        }
        return self.engine.unshard_state(self._state), meta

    def restore(self, state_tree, meta: dict) -> None:
        """Adopt a ``snapshot`` into this pre-allocated session, which must
        be built as the snapshotting one was (batch, max_seq, strategy and
        cache layout, checked before anything is touched). The state's
        tensors move to the session's device. The next ``step`` or
        ``step_async`` continues where the saved session stopped."""
        assert self._state is not None and self.batch is not None, \
            "restore needs a pre-allocated session (new_session(batch=B))"
        for key, have in (("batch", self.batch), ("max_seq", self._max_seq),
                          ("strategy", self.engine.strategy.name)):
            if meta[key] != have:
                raise ValueError(
                    f"snapshot {key}={meta[key]!r} does not match this "
                    f"session's {key}={have!r}")
        self.cache_mgr.import_state(meta["cache"])
        device = self.engine.device
        self._state = self.engine.shard_state(tree_map(
            lambda x: (x.to(device) if isinstance(x, torch.Tensor) else x),
            state_tree), self._state)
        self._emitted = np.asarray(meta["emitted"], np.int64)
        self._budget = np.asarray(
            [_NO_BUDGET if b is None else int(b) for b in meta["budget"]],
            np.int64)
        self._eos = [None if e is None else int(e) for e in meta["eos"]]
        self._done = np.asarray(meta["done"], bool)
        self._retired = set(int(r) for r in meta["retired"])
        self._dev_carry = None
        self._async_handles = []

    # ----- whole-batch entry -----
    def prefill(self, prompts, max_new_tokens: Optional[int] = None,
                eos_token: Optional[int] = None,
                max_seq: Optional[int] = None) -> StepResult:
        """Prefill the whole batch. ``prompts``: (B, T) int tokens (array,
        tensor or list) or a batch dict with ``"tokens"`` and, for a vision
        config, ``"patches"``, carried to the model as JAX's session does.
        As there, the default ``max_seq`` counts the text alone: a prompt
        with prepended patches needs an explicit one. Returns the
        first-token StepResult (the prefill's greedy argmax counts against
        the budget)."""
        e = self.engine
        batch = {}
        for name, x in (prompts.items() if isinstance(prompts, dict)
                        else [("tokens", prompts)]):
            if not isinstance(x, torch.Tensor):
                x = torch.as_tensor(np.asarray(x))
            batch[name] = x.to(device=e.device, dtype=torch.int32
                               if name == "tokens" else None)
        tokens = batch["tokens"]
        B, T = tokens.shape
        if max_seq is None:
            max_seq = self._max_seq
        if max_seq is None:
            new = (max_new_tokens if max_new_tokens is not None
                   else e.model.run.serve.max_new_tokens)
            max_seq = T + new + e.emit_width + 1
        self._max_seq = max_seq
        params, sw = e.prefill_weights()
        first, state = e.strategy.init_state(e.model, params, sw, batch,
                                             max_seq, prng=self._prng_seed)
        self.cache_mgr = self._make_manager(B, max_seq)
        self._state = state._replace(
            cache=self.cache_mgr.from_prefill(state.cache))
        self._alloc_bookkeeping(B, live=True)
        # the cache has max_seq slots: bound the budget by the remaining
        # capacity so a budgetless session still terminates
        cap = max(max_seq - T - 1, 1)
        budget = cap if max_new_tokens is None else min(max_new_tokens, cap)
        for row in range(B):
            self._set_row_limits(row, budget, eos_token)
        W, E = e.emit_width, e.model.num_exit_points
        zeros = torch.zeros(B, dtype=torch.int32, device=e.device)
        tok = torch.zeros(B, W, dtype=torch.int32, device=e.device)
        tok[:, 0] = first
        raw = StepResult(tokens=tok, counts=zeros + 1, done=zeros.bool(),
                         exit_layer=zeros + E, accept_len=zeros,
                         exited=zeros.bool(), units_run=0)
        return self._wrap(raw)

    # ----- slot-based admission (continuous batching) -----
    def _insert_state1(self, row: int, st1: eng.DecodeState, prompt_len: int,
                       max_new_tokens: Optional[int],
                       eos_token: Optional[int]) -> int:
        """Insert a finished batch-1 state into slot ``row`` (cache through
        the manager, the rest leaf-wise) + budget/EOS accounting. Returns
        the first token."""
        st = self._state
        self._retired.discard(row)
        B = self.batch
        self._state = eng.DecodeState(
            cache=self.cache_mgr.insert_row(st.cache, row, st1.cache),
            draft_cache=insert_row_pytree(st.draft_cache, st1.draft_cache,
                                          row, B),
            sched=insert_row_pytree(st.sched, st1.sched, row, B),
            last_token=insert_row_pytree(st.last_token, st1.last_token,
                                         row, B),
            h_last=insert_row_pytree(st.h_last, st1.h_last, row, B),
            prng=st.prng)
        cap = max(self._max_seq - prompt_len - 1, 1)
        budget = cap if max_new_tokens is None else min(max_new_tokens, cap)
        self._set_row_limits(row, budget, eos_token)
        tok = int(st1.last_token[0])
        n = self._account_row(row, np.asarray([tok]), 1)
        assert n <= 1
        self._mirror_row_to_dev(row)
        return tok

    def prefill_row(self, row: int, prompt,
                    max_new_tokens: Optional[int] = None,
                    eos_token: Optional[int] = None) -> int:
        """Admit one request into slot ``row``: blocking batch-1 prefill,
        then insert its state into the batch. Returns the first token."""
        assert self._state is not None and self.batch is not None, \
            "prefill_row needs a pre-allocated session (new_session(batch=B))"
        e = self.engine
        tokens = torch.as_tensor(np.asarray(prompt), dtype=torch.int32,
                                 device=e.device)[None, :]
        params, sw = e.prefill_weights()
        _, st1 = e.strategy.init_state(e.model, params, sw,
                                       {"tokens": tokens}, self._max_seq)
        return self._insert_state1(row, st1, tokens.shape[1],
                                   max_new_tokens, eos_token)

    # ----- chunked admission (Sarathi-style) -----
    def begin_admission(self, row: int, prompt,
                        max_new_tokens: Optional[int] = None,
                        eos_token: Optional[int] = None) -> Admission:
        """Start admitting one request into slot ``row``; ``prefill_chunk``
        runs its prompt forward a chunk per call."""
        assert self._state is not None and self.batch is not None, \
            "begin_admission needs a pre-allocated session"
        return Admission(row=row, tokens=np.asarray(prompt, np.int64),
                         max_new_tokens=max_new_tokens, eos_token=eos_token)

    def prefill_chunk(self, adm: Admission,
                      max_tokens: Optional[int] = None) -> int:
        """Run at most ``max_tokens`` prompt tokens of ``adm``'s prefill.

        ``max_tokens=None`` (or a model without chunked-prefill support)
        takes the blocking one-shot path and completes the admission in one
        call. Returns the number of prompt tokens processed; when the prompt
        is exhausted the row is inserted and ``adm.first_token`` is set.
        """
        if adm.complete:
            return 0
        e = self.engine
        T = adm.prompt_len
        if max_tokens is None or not e.model.supports_chunked_prefill():
            assert adm.consumed == 0, \
                "cannot fall back to blocking admission mid-chunk"
            adm.first_token = self.prefill_row(
                adm.row, adm.tokens, max_new_tokens=adm.max_new_tokens,
                eos_token=adm.eos_token)
            adm.consumed = T
            return T
        # a fixed-width chunk, padded as the JAX package pads it
        C = int(max_tokens)
        if adm.cache is None:
            seq = e.strategy.cache_seq_len(e.model, self._max_seq)
            adm.cache = e.model.empty_cache(1, seq, e.device)
        n = min(C, adm.remaining)
        chunk = np.zeros((1, C), np.int32)
        chunk[0, :n] = adm.tokens[adm.consumed:adm.consumed + n]
        h, adm.cache = e.model.prefill_extend(
            e.prefill_weights()[0], torch.as_tensor(chunk, device=e.device),
            adm.cache, n)
        adm.h_parts.append(h[:, :n])
        adm.consumed += n
        if adm.remaining == 0:
            self._finish_admission(adm)
        return n

    def _finish_admission(self, adm: Admission) -> None:
        """Last chunk done: first token, draft prefill over the accumulated
        hiddens, batch-1 state assembly, row insert."""
        e = self.engine
        model = e.model
        params, sw = e.prefill_weights()
        tokens = torch.as_tensor(adm.tokens, dtype=torch.int32,
                                 device=e.device)[None, :]
        h_all = torch.cat(adm.h_parts, dim=1)                 # (1, T, D)
        logits = model.logits(params, h_all[:, -1, :])
        first = torch.argmax(logits, dim=-1).to(torch.int32)
        if sw is not None:
            seq = e.strategy.cache_seq_len(model, self._max_seq)
            dcache = draft_lib.draft_prefill(model.cfg, sw.draft,
                                             model.embed(params, tokens),
                                             h_all, seq)
        else:
            dcache = {}
        st1 = eng.DecodeState(
            cache=adm.cache, draft_cache=dcache,
            sched=sched_lib.init_state(1, model.run.specee, e.device),
            last_token=first, h_last=h_all[:, -1, :],
            prng=self._state.prng)
        adm.first_token = self._insert_state1(
            adm.row, st1, adm.prompt_len, adm.max_new_tokens, adm.eos_token)
        adm.cache = None
        adm.h_parts = []

    # ----- decode tick -----
    def step(self, num_ticks: Optional[int] = None) -> StepResult:
        """Batched decode through the strategy's step.

        ``num_ticks=None``/``1``: one tick with host-side budget/EOS
        accounting; retired rows' lengths are pinned back to 0 after it
        (the step advances every row's length). ``num_ticks=K > 1``: one
        megatick (``step_async`` then ``finish_step``), token-identical to
        K single steps, whose StepResult widens to the (B, K·W) contract
        (``api.types``)."""
        assert self._state is not None, "prefill first"
        assert not self._async_handles, \
            "async megaticks are in flight; finish_step() them first"
        if num_ticks is not None and int(num_ticks) != 1:
            return self.finish_step(self.step_async(num_ticks))
        e = self.engine
        # fault site: fires before the step writes anything to the state,
        # so the caller may retry
        faultinject.check("dispatch")
        params, sw, qw = e.decode_weights()
        raw, self._state = e.strategy.step(e.model, params, sw, self._state,
                                           qw=qw)
        if self._retired:
            cache = self._state.cache
            length = cache["len"].clone()
            length[sorted(self._retired)] = 0
            self._state = self._state._replace(cache=dict(cache, len=length))
        return self._wrap(raw)

    def step_async(self, num_ticks: int = 1) -> MegatickHandle:
        """Dispatch one megatick and return its handle; ``finish_step``
        reads its results. The budget/EOS/done carry stays on the device
        across megaticks, so megatick N+1 may be dispatched before N's
        results are read (the serving engine's pipeline): the done mask
        travels in the carry, not on the host. Handles finish in dispatch
        order."""
        assert self._state is not None, "prefill first"
        K = int(num_ticks)
        assert K >= 1, f"num_ticks must be >= 1, got {K}"
        # fault site: fires before the megatick writes anything to the
        # state, so the caller may retry the dispatch
        faultinject.check("dispatch")
        carry = (self._dev_carry if self._dev_carry is not None
                 else self._carry_from_host())
        out, self._state, carry = self.engine.megatick(self._state, carry, K)
        self._dev_carry = carry
        handle = MegatickHandle(out=out, carry=carry, num_ticks=K)
        self._async_handles.append(handle)
        return handle

    def finish_step(self, handle: MegatickHandle) -> StepResult:
        """Read a dispatched megatick's results, sync the host mirrors from
        its carry, and wrap the (widened) StepResult. Handles finish oldest
        first, and a finish must precede any admission or retirement that
        reacts to its results."""
        assert self._async_handles and self._async_handles[0] is handle, \
            "megaticks finish in dispatch order (oldest handle first)"
        self._async_handles.pop(0)
        out = {k: v.cpu().numpy() if isinstance(v, torch.Tensor) else v
               for k, v in handle.out.items()}
        done = out["done"].copy()
        emitted = handle.carry["emitted"].cpu().numpy().astype(np.int64)
        # rows retired / re-admitted after this dispatch: the host
        # bookkeeping advanced past the dispatch-time carry — keep it (the
        # edit was mirrored onto the next megatick's input)
        for row in handle.dirty:
            done[row] = self._done[row]
            emitted[row] = self._emitted[row]
        self._done = done
        self._emitted = emitted
        return StepResult(
            tokens=out["tokens"], counts=out["counts"],
            # the megatick's own view (what the serving engine attributes
            # to the dispatch-time slots), not the merged host view: they
            # differ only on dirty rows
            done=out["done"], exit_layer=out["exit_layer"],
            accept_len=out["accept_len"], exited=out["exited"],
            units_run=out["units_run"], ticks=out["ticks"],
            tick_counts=out["tick_counts"], tick_live=out["tick_live"])
