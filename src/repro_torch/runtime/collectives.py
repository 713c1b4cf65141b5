"""Collectives over a single controller's shards (counterpart of
``repro/runtime/collectives.py``).

The port drives every shard of a mesh from one process, so a collective
is a function over the list of per-shard tensors, in shard order: a psum
is a sum over the list, a pmax a max, and JAX's ``ppermute`` ring a
rotation of the list. Each result lands on ``dst`` (the lead device,
where the replicated state lives) or, for the per-shard outputs, on each
shard's own device.

* ``all_reduce_sum`` — the tensor-parallel layers' reduction (row-parallel
  wo and mlp-down, the vocab-parallel embedding, MoE's expert-down, the
  SSD gated norm's sum of squares). It adds in shard order 0..P-1, so the
  result is deterministic and equal on every call.
* ``all_gather`` — the shards' parts concatenated in shard order (the
  RG-LRU gates read the whole post-conv activation; GSPMD inserts this
  gather in JAX).
* ``compressed_psum`` — int8 all-reduce with error feedback: one shared
  scale (a pmax), an int8 payload summed in int32, each shard's
  quantization residual kept for its next step.
* ``collective_matmul_ag`` — all-gather(x) @ w as a ring: each hop's
  transfer overlaps the partial GEMM of the block in hand.

Serving calls ``all_reduce_sum`` and ``all_gather``; the other two are
JAX's training collectives, held equal to JAX's by the tests, and wait
for training under a mesh (ROADMAP "multi-GPU").
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch


def all_reduce_sum(parts: Sequence[torch.Tensor],
                   dst: torch.device) -> torch.Tensor:
    """Sum of the per-shard ``parts`` on ``dst``, added in shard order."""
    total = parts[0].to(dst)
    for p in parts[1:]:
        total = total + p.to(dst)
    return total


def all_gather(parts: Sequence[torch.Tensor], dst: torch.device,
               dim: int = -1) -> torch.Tensor:
    """The per-shard ``parts`` concatenated along ``dim`` on ``dst``, in
    shard order; one part is itself, on ``dst``."""
    if len(parts) == 1:
        return parts[0].to(dst)
    return torch.cat([p.to(dst) for p in parts], dim=dim)


def _per_127(amax: torch.Tensor) -> torch.Tensor:
    """``amax / 127`` correctly rounded on every device: a CUDA tensor
    divided by a Python number is multiplied by its reciprocal instead,
    one rounding off JAX's division."""
    return amax / amax.new_tensor(127.0)


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization. Returns (q, scale)."""
    amax = x.abs().amax() + 1e-12
    scale = _per_127(amax)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_psum(xs: Sequence[torch.Tensor],
                    errors: Sequence[torch.Tensor]
                    ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Error-feedback int8 all-reduce over the shards' ``xs``: the shards
    agree on one scale (the pmax of |x + error|), quantize, sum the int8
    payloads in int32, and keep each residual for the next step. Returns
    (the reduced fp32 sum on every shard's device, the new errors)."""
    targets = [x.float() + e for x, e in zip(xs, errors)]
    gmax = torch.stack([t.abs().amax().to(targets[0].device)
                        for t in targets]).amax() + 1e-12
    scale = _per_127(gmax)
    qs, new_errors = [], []
    for t in targets:
        s = scale.to(t.device)
        q = torch.clamp(torch.round(t / s), -127, 127).to(torch.int8)
        new_errors.append(t - q.float() * s)
        qs.append(q)
    total = all_reduce_sum([q.to(torch.int32) for q in qs], qs[0].device)
    return ([(total.float() * scale).to(t.device) for t in targets],
            new_errors)


def collective_matmul_ag(x_shards: Sequence[torch.Tensor],
                         ws: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """all_gather(x) @ w on every shard, as JAX's ``ppermute`` ring: at hop
    i shard j multiplies the block it holds (source rank (j - i) mod P)
    and passes it to shard j + 1. ``x_shards``: P (rows, K) blocks;
    ``ws``: each shard's (K, N) weight. Returns each shard's (rows·P, N),
    rows in source-rank order, in x's dtype."""
    P = len(x_shards)
    rows = x_shards[0].shape[0]
    bufs = list(x_shards)
    outs = [torch.zeros(rows * P, w.shape[1], dtype=x.dtype,
                        device=w.device) for x, w in zip(x_shards, ws)]
    for i in range(P):
        for j in range(P):
            part = torch.matmul(bufs[j].float(), ws[j].float())
            src = (j - i) % P
            outs[j][src * rows:(src + 1) * rows] = part.to(outs[j].dtype)
        # ring hop: shard j's block moves to shard j + 1
        bufs = [bufs[(j - 1) % P].to(ws[j].device) for j in range(P)]
    return outs
