"""Decode strategies (counterpart of ``repro/api/strategies.py``): adapters
from the engine step functions to the canonical ``StepResult``: the dense
baseline (greedy or sampled), AR SpecEE and T3 tree decoding. A strategy
owns what is mode-specific: how wide a step's emit can be, how many cache
slots a session of ``max_seq`` needs (the tree reserves its node scratch),
and which engine step runs per tick."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.api.types import StepResult
from repro_torch.core import engine as eng
from repro_torch.core.tree import TreeSpec
from repro_torch.models.model import Model


def _single_token_result(token: torch.Tensor, info: eng.StepInfo
                         ) -> StepResult:
    """Pack a 1-token-per-tick engine emit as a (device) StepResult."""
    B = token.shape[0]
    zeros = torch.zeros(B, dtype=torch.int32, device=token.device)
    return StepResult(tokens=token[:, None], counts=zeros + 1,
                      done=zeros.bool(), exit_layer=info.exit_point,
                      accept_len=zeros, exited=info.exited,
                      units_run=info.units_run)


@dataclass(frozen=True)
class DecodeStrategy:
    """Base: one decode mode behind the Engine/DecodeSession surface."""
    name = "base"
    requires_sw = True

    def emit_width(self, model: Model) -> int:
        return 1

    def cache_seq_len(self, model: Model, max_seq: int) -> int:
        return max_seq

    def validate(self, model: Model, sw) -> None:
        if self.requires_sw and sw is None:
            raise ValueError(f"{type(self).__name__} needs SpecEE weights "
                             "(draft + predictors); pass sw=")

    def init_state(self, model: Model, params, sw,
                   batch: Dict[str, torch.Tensor], max_seq: int,
                   prng: int = 0) -> Tuple[torch.Tensor, eng.DecodeState]:
        """Prefill → (first greedy token (B,), state); ``prng``: the
        session's sampling seed."""
        return eng.init_decode_state(model, params, sw, batch,
                                     self.cache_seq_len(model, max_seq),
                                     prng=prng)

    def empty_state(self, model: Model, sw, batch: int, max_seq: int,
                    cache=None, device="cuda",
                    prng: int = 0) -> eng.DecodeState:
        """``batch`` empty slots. ``cache``: a cache built by the session's
        ``KVCacheManager`` (dense or paged); None allocates the dense
        layout. The step functions read the layout off the state
        (``cache["page_table"]``), so one step serves both."""
        return eng.empty_decode_state(model, sw, batch,
                                      self.cache_seq_len(model, max_seq),
                                      device=device, cache=cache, prng=prng)

    def step(self, model: Model, params, sw, state: eng.DecodeState,
             qw=None) -> Tuple[StepResult, eng.DecodeState]:
        """One tick. ``qw``: optional quantized-weight bundle
        (``repro_torch.quant.quantize_params``) threaded into the engine
        step."""
        raise NotImplementedError

    def megatick(self, model: Model, params, sw, state: eng.DecodeState,
                 limits, num_ticks: int, qw=None):
        """Up to ``num_ticks`` steps in one call
        (``engine.megatick_decode``): the per-row budgets, EOS cut-off and
        done mask ride in ``limits`` on the device. The one adapter for
        every strategy. Returns ``(out dict, new_state, new_limits)``."""
        def tick(st):
            res, new_st = self.step(model, params, sw, st, qw=qw)
            return eng.TickEmit(tokens=res.tokens, counts=res.counts,
                                exit_layer=res.exit_layer,
                                accept_len=res.accept_len,
                                exited=res.exited,
                                units_run=res.units_run), new_st
        return eng.megatick_decode(tick, state, limits, num_ticks,
                                   self.emit_width(model),
                                   model.num_exit_points)


@dataclass(frozen=True)
class DenseStrategy(DecodeStrategy):
    """Full-depth baseline. Greedy by default; ``temperature > 0`` samples
    from the full logits (``top_k``: only the k largest), keyed per row
    from the session's seed (``Engine.new_session(prng_seed=...)`` /
    ``ServingEngine(prng_seed=...)``)."""
    temperature: float = 0.0
    top_k: Optional[int] = None
    name = "dense"
    requires_sw = False

    def step(self, model, params, sw, state, qw=None):
        token, new_state, info = eng.dense_decode_step(
            model, params, sw, state, temperature=self.temperature,
            top_k=self.top_k, qw=qw)
        return _single_token_result(token, info), new_state


@dataclass(frozen=True)
class SpecEEStrategy(DecodeStrategy):
    """Autoregressive speculative early exiting (paper T1+T2).
    ``threshold=None`` takes ``run.specee.exit_threshold``; a threshold > 1
    disables exits (equal to dense greedy)."""
    threshold: Optional[float] = None
    name = "specee"

    def step(self, model, params, sw, state, qw=None):
        token, new_state, info = eng.ar_decode_step(
            model, params, sw, state, threshold=self.threshold, qw=qw)
        return _single_token_result(token, info), new_state


@dataclass(frozen=True)
class TreeStrategy(DecodeStrategy):
    """T3: tree speculative decoding with the hyper-token merged mapping.
    Emits up to ``tree.depth + 1`` tokens per tick (accepted chain + bonus).
    ``tree=None`` builds the TreeSpec from ``run.specee.tree_depth`` /
    ``tree_branch``."""
    tree: Optional[TreeSpec] = None
    threshold: Optional[float] = None
    name = "tree"

    def tree_for(self, model: Model) -> TreeSpec:
        if self.tree is not None:
            return self.tree
        spec = model.run.specee
        return TreeSpec(depth=spec.tree_depth, branch=spec.tree_branch)

    def emit_width(self, model):
        return self.tree_for(model).depth + 1

    def cache_seq_len(self, model, max_seq):
        return max_seq + self.tree_for(model).num_nodes

    def validate(self, model, sw):
        super().validate(model, sw)
        if not model.supports_tree():
            # JAX's message, word for word
            raise ValueError(
                "tree strategy requires a pure-attention stack (DESIGN.md "
                f"§4); {model.cfg.name} is {model.cfg.family}")
        if model.flags.kv_quant:
            # JAX's message, word for word
            raise ValueError(
                "tree strategy does not support kv_quant: tree scratch "
                "writes are full-precision (the node K/V is re-read within "
                "the same step, where int8 round-tripping would corrupt "
                "verification); decode with the AR engine instead "
                "(DESIGN.md §4)")

    def step(self, model, params, sw, state, qw=None):
        out, n_emit, new_state, info = eng.tree_decode_step(
            model, params, sw, state, self.tree_for(model),
            threshold=self.threshold, qw=qw)
        B = out.shape[0]
        res = StepResult(tokens=out, counts=n_emit,
                         done=torch.zeros(B, dtype=torch.bool,
                                          device=out.device),
                         exit_layer=info.exit_point,
                         accept_len=info.accepted_len, exited=info.exited,
                         units_run=info.units_run)
        return res, new_state


_BY_NAME = {"dense": DenseStrategy, "specee": SpecEEStrategy,
            "ar": SpecEEStrategy, "tree": TreeStrategy}


def get_strategy(spec: Union[str, DecodeStrategy, None]) -> DecodeStrategy:
    """Resolve a strategy name ("dense" | "specee" | "ar" | "tree") or pass
    an instance through."""
    if spec is None:
        return SpecEEStrategy()
    if isinstance(spec, DecodeStrategy):
        return spec
    try:
        return _BY_NAME[spec]()
    except KeyError:
        raise ValueError(
            f"unknown strategy {spec!r}; expected one of {sorted(_BY_NAME)} "
            "or a DecodeStrategy instance") from None
