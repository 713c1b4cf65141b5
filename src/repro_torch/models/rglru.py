"""RG-LRU recurrent block (counterpart of ``repro/models/rglru.py``;
RecurrentGemma / Griffin). [arXiv:2402.19427]

Block: {gate branch: Linear + GeLU} x {x branch: Linear -> causal conv ->
RG-LRU} -> out proj. The recurrence:

    r_t = sigmoid(W_a x_t + b_a)            recurrence gate
    i_t = sigmoid(W_x x_t + b_x)            input gate
    log a_t = -c * softplus(lam) * r_t      (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The sequence path runs the linear recurrence h_t = a_t h_{t-1} + b_t as
JAX's ``lax.associative_scan`` does: log2(S) levels of whole-tensor
combines (odd/even reduction, then the even elements from the odd ones),
in JAX's order of operations, never a loop over the S positions. The
decode path is the O(1) update.

Tensor parallelism (a ``(1, P)`` mesh, JAX ``sharding/policies.py``'s
RG-LRU rules): the lru width W splits over the shards for ``wx``, ``wy``,
the conv, ``lam`` and the gates' biases; ``wa``/``wi`` (W, W) are
column-parallel and ``wo`` row-parallel. The conv and the recurrence are
elementwise in W, so each shard runs them on its slice; the gates read the
whole post-conv activation, so each shard first gathers it
(``all_gather``, which GSPMD inserts in JAX). ``wo``'s partials go through
``all_reduce_sum``; the state and the conv window are ``Shards`` of each
shard's W slice.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch

from repro_torch.config import ModelConfig, RGLRUConfig
from repro_torch.models import common
from repro_torch.models.common import Params
from repro_torch.runtime.collectives import (all_gather, all_reduce_sum,
                                             count_backward_reduce)
from repro_torch.sharding.ctx import from_parts, local, parts

_C = 8.0


def lru_width(cfg: ModelConfig) -> int:
    r = cfg.rglru or RGLRUConfig()
    return r.lru_width or cfg.d_model


def init_rglru(cfg: ModelConfig, gen, dtype, device) -> Params:
    """Seeded block weights: the JAX init's shapes and scales (other
    numbers); lam such that a^c lies in (0.9, 0.999)."""
    r = cfg.rglru or RGLRUConfig()
    d, w = cfg.d_model, lru_width(cfg)
    std_d = 1.0 / math.sqrt(d)
    std_w = 1.0 / math.sqrt(w)
    out_std = std_w / math.sqrt(2 * cfg.num_layers)
    lo, hi = 0.9 ** 2, 0.999 ** 2
    u = torch.rand(w, generator=gen, device=device) * (hi - lo) + lo
    lam = torch.log(torch.expm1(-torch.log(u) / (2 * _C)))   # softplus^-1

    def n(shape, std):
        return common.normal_init(gen, shape, std, dtype, device)

    def zeros(k):
        return torch.zeros(k, dtype=dtype, device=device)

    return {
        "wx": {"w": n((d, w), std_d)},                 # x branch
        "wy": {"w": n((d, w), std_d)},                 # gate branch
        "conv_w": n((r.conv_kernel, w), 1.0 / math.sqrt(r.conv_kernel)),
        "conv_b": zeros(w),
        "wa": {"w": n((w, w), std_w), "b": zeros(w)},
        "wi": {"w": n((w, w), std_w), "b": zeros(w)},
        "lam": lam.to(dtype),
        "wo": {"w": n((w, d), out_std)},
    }


def state_segs(cfg: ModelConfig):
    """Shard layouts (``sharding.ctx`` segments) of an RG-LRU cache
    entry's leaves, as (dim from the end, segments): both split W."""
    w = lru_width(cfg)
    return {"h": (-1, ((w, 1, True),)), "conv": (-1, ((w, 1, True),))}


def _gates(p: Params, x: torch.Tensor,
           x_own: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (..., W) post-conv activations -> (log_a, b) of the recurrence,
    fp32. Softplus as ``jax.nn.softplus`` (log(1 + e^x), no threshold).
    ``x_own``: a shard's slice of x, the columns its gate weights give
    (``x`` is then the gathered whole)."""
    x_own = x if x_own is None else x_own
    r = torch.sigmoid(common.apply_linear(p["wa"], x).float())
    i = torch.sigmoid(common.apply_linear(p["wi"], x).float())
    sp = torch.logaddexp(p["lam"].float(),
                         torch.zeros((), device=x_own.device))
    log_a = -_C * sp * r
    a2 = torch.exp(2 * log_a)
    b = torch.sqrt(torch.clamp(1.0 - a2, min=1e-12)) * i * x_own.float()
    return log_a, b


def _combine(c1: List[torch.Tensor], c2: List[torch.Tensor]
             ) -> List[torch.Tensor]:
    a1, b1 = c1
    a2, b2 = c2
    return [a1 * a2, b1 * a2 + b2]


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """Positions 0, 2, 4, ... from ``even`` and 1, 3, ... from ``odd``
    along dim 1 (``even`` has as many or one more)."""
    n = even.shape[1] + odd.shape[1]
    out = even.new_empty((even.shape[0], n) + tuple(even.shape[2:]))
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def _assoc_scan(elems: List[torch.Tensor]) -> List[torch.Tensor]:
    """Inclusive scan of (a, b) pairs along dim 1 under ``_combine``, by
    ``lax.associative_scan``'s recursion: combine adjacent pairs, scan the
    half-length result (its elements are the odd positions), then combine
    each odd result with the next even input."""
    n = elems[0].shape[1]
    if n < 2:
        return elems
    reduced = _combine([e[:, 0:n - 1:2] for e in elems],
                       [e[:, 1::2] for e in elems])
    odd = _assoc_scan(reduced)
    if n % 2 == 0:
        even = _combine([e[:, :-1] for e in odd], [e[:, 2::2] for e in elems])
    else:
        even = _combine(odd, [e[:, 2::2] for e in elems])
    even = [torch.cat([e[:, :1], r], dim=1) for e, r in zip(elems, even)]
    return [_interleave(e, o) for e, o in zip(even, odd)]


def rglru_scan(p: Params, x: torch.Tensor,
               h0: Optional[torch.Tensor] = None,
               x_own: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, W) -> (h (B, S, W) in x's dtype, h_final (B, W) fp32);
    on a shard's slice ``x_own`` of the whole ``x`` (``_gates``), its
    slice of h."""
    log_a, b = _gates(p, x, x_own)                             # (B,S,W) fp32
    a = torch.exp(log_a)
    if h0 is not None:
        # fold the initial state into the first input
        b = torch.cat([b[:, :1] + a[:, :1] * h0.float()[:, None], b[:, 1:]],
                      dim=1)
    _, hh = _assoc_scan([a, b])
    return hh.to(x.dtype), hh[:, -1, :]


def rglru_step(p: Params, x_t: torch.Tensor, h: torch.Tensor,
               x_own: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x_t: (B, W); h: (B, W) fp32 -> (out in x_t's dtype, new_h fp32);
    ``x_own`` as in ``rglru_scan``."""
    log_a, b = _gates(p, x_t, x_own)
    new_h = torch.exp(log_a) * h.float() + b
    return new_h.to(x_t.dtype), new_h


def _conv_seq(p: Params, xb: torch.Tensor,
              carry: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal depthwise conv over (B, S, W): taps summed in JAX's order."""
    K = p["conv_w"].shape[0]
    S = xb.shape[1]
    if carry is None:
        pad = torch.nn.functional.pad(xb, (0, 0, K - 1, 0))
    else:
        pad = torch.cat([carry.to(xb.dtype), xb], dim=1)
    w = p["conv_w"].to(xb.dtype)
    out = pad[:, 0:S] * w[0]
    for i in range(1, K):
        out = out + pad[:, i:i + S] * w[i]
    return out + p["conv_b"].to(xb.dtype)


def rglru_block_seq(cfg: ModelConfig, p: Params, x: torch.Tensor,
                    h0: Optional[torch.Tensor] = None,
                    conv_carry_in: Optional[torch.Tensor] = None):
    """The recurrent block over a sequence. x: (B, S, D) pre-normed.
    Returns (out (B, S, D), h_final (B, W) fp32, conv_tail (B, K-1, W), or
    None for a sequence shorter than K-1, as in the JAX package); under
    sharded params, the state and the tail as ``Shards`` of W slices."""
    r = cfg.rglru or RGLRUConfig()
    gelu = common.activation_fn("gelu")
    K = r.conv_kernel
    segs = state_segs(cfg)
    ps = [local(p, s) for s in range(len(parts(p["lam"])))]
    if len(ps) > 1:
        count_backward_reduce(x)
    xs = [x.to(lam.device) for lam in parts(p["lam"])]
    xbs = [common.apply_linear(pp["wx"], xi) for pp, xi in zip(ps, xs)]
    xcs = [_conv_seq(pp, xb, local(conv_carry_in, s))
           for s, (pp, xb) in enumerate(zip(ps, xbs))]
    outs, hs = [], []
    for s, (pp, xi, xc) in enumerate(zip(ps, xs, xcs)):
        h_seq, h_fin = rglru_scan(pp, all_gather(xcs, xc.device,
                                                 lead=s == 0),
                                  local(h0, s), x_own=xc)
        gate = gelu(common.apply_linear(pp["wy"], xi))
        outs.append(common.apply_linear(pp["wo"], h_seq * gate))
        hs.append(h_fin)
    tail = (from_parts([xb[:, -(K - 1):, :] for xb in xbs], *segs["conv"])
            if x.shape[1] >= K - 1 else None)
    return all_reduce_sum(outs, x.device), from_parts(hs, *segs["h"]), tail


def _step_conv(p: Params, xb: torch.Tensor, conv_state: torch.Tensor):
    """The conv over the window and the new input: (xc, the window)."""
    window = torch.cat([conv_state.to(xb.dtype), xb[:, None, :]], dim=1)
    xc = (torch.einsum("bkc,kc->bc", window, p["conv_w"].to(xb.dtype))
          + p["conv_b"].to(xb.dtype))
    return xc, window


def rglru_block_step(cfg: ModelConfig, p: Params, x_t: torch.Tensor,
                     h: torch.Tensor, conv_state: torch.Tensor):
    """One token. x_t: (B, D) pre-normed; h: (B, W) fp32; conv_state:
    (B, K-1, W). Returns (out (B, D), new_h, new conv window); under
    sharded params ``h`` and ``conv_state`` are ``Shards`` and so are the
    new ones."""
    gelu = common.activation_fn("gelu")
    segs = state_segs(cfg)
    ps = [local(p, s) for s in range(len(parts(p["lam"])))]
    xs = [x_t.to(lam.device) for lam in parts(p["lam"])]
    convs = [_step_conv(pp, common.apply_linear(pp["wx"], xi), cs)
             for pp, xi, cs in zip(ps, xs, parts(conv_state))]
    xcs = [xc for xc, _ in convs]
    outs, hs = [], []
    for s, (pp, xi, xc, hp) in enumerate(zip(ps, xs, xcs, parts(h))):
        h_out, new_h = rglru_step(pp, all_gather(xcs, xc.device,
                                                 lead=s == 0), hp,
                                  x_own=xc)
        gate = gelu(common.apply_linear(pp["wy"], xi))
        outs.append(common.apply_linear(pp["wo"], h_out * gate))
        hs.append(new_h)
    return (all_reduce_sum(outs, x_t.device), from_parts(hs, *segs["h"]),
            from_parts([w[:, 1:, :] for _, w in convs], *segs["conv"]))
