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
  RG-LRU gates read the whole post-conv activation, the sharded verify
  pools its slices' candidates; GSPMD inserts these gathers in JAX).
* ``compressed_psum`` — int8 all-reduce with error feedback: one shared
  scale (a pmax), an int8 payload summed in int32, each shard's
  quantization residual kept for its next step.
* ``collective_matmul_ag`` — all-gather(x) @ w as a ring: each hop's
  transfer overlaps the partial GEMM of the block in hand.

Serving and training call ``all_reduce_sum`` and ``all_gather`` over the
'model' axis. ``compressed_psum`` and ``collective_matmul_ag`` are JAX's,
held equal to JAX's by the tests; no JAX path calls them either.

Over the 'data' axis of a training mesh (``sharding/training.py``), one
call moves one tensor between the D data rows, each row's part on that
row's device, and is differentiable (``torch.autograd.Function``):

* ``gather_rows`` — all-gather: every row gets the rows' parts
  concatenated in row order (ZeRO-3's parameter gather, MoE's token
  gather under expert parallelism). Its backward is a reduce-scatter:
  each part's gradient is the sum over the rows of its slice, added in
  row order.
* ``reduce_scatter_rows`` — row d gets the sum over the rows of their
  partials' slice d (MoE's expert outputs); its backward an all-gather.
* ``all_reduce_rows`` — every row gets the sum over the rows, added in
  row order on row 0 and copied, so the rows' results are bit-equal (the
  MoE aux loss's statistics, the loss's sums, the gradients of leaves
  replicated over 'data'); its backward an all-reduce.

Each counts its calls and bytes in ``COUNTS`` by kind, the backward's
collective under its own kind: every call, whichever rows and shards it
joins (``tests/test_torch_dp_serving.py`` reads it). The bytes are one
row's result; under remat a unit's gathers run again in the recompute
and count again.

``PER_DEVICE`` holds, per mesh axis, ``{kind: {"calls", "bytes"}}`` of
the collectives one device takes part in: the mesh's lead slot (data
row 0, model shard 0), each collective once, its bytes the lead's own
result, as JAX's ``launch/dryrun.py::collective_bytes`` reads a
collective's per-device result shape from the HLO of one device's
program. The single controller runs the same collective once per line of
the mesh, so a call counts there only where the lead takes part:

* 'model' (``all_reduce_sum``, ``all_gather`` over two or more parts,
  and ``count_backward_reduce``): only on data row 0. The model's loops
  over the rows iterate through ``each_row``, which marks every row but
  the first; a collective outside such a loop (the embedding, the LM
  head's verify on the lead) is the lead's. A gather that each shard
  makes of its own copy (the RG-LRU's) passes ``lead=`` for shard 0.
* 'data' (``gather_rows``, ``reduce_scatter_rows``, ``all_reduce_rows``):
  a caller that repeats one per model shard passes ``lead=`` for shard 0.

``count_backward_reduce`` counts the 'model' all-reduce that a tensor's
gradient takes where a tensor-parallel layer feeds it to every shard:
autograd sums the shards' gradients, JAX's transpose of the replication
is an all-reduce. The backward of ``all_reduce_sum`` (the gradient sent
to each shard) and of ``all_gather`` (cut back into its parts) moves no
sum and is not counted. The port's relayouts (``sharding/rows.py``
regathering a row's view whole to cut it into serving's compute layout,
training's LM head gathered whole per row) have no counterpart in JAX's
program and are not counted. ``reset_counts`` zeroes both records. The
dry run (``launch/dryrun.py``) reads ``PER_DEVICE`` per step, in the
place of JAX's collective totals over the compiled HLO.
"""
from __future__ import annotations

from typing import Dict, Iterable, Iterator, List, Sequence, Tuple, TypeVar

import torch

KINDS = ("all-gather", "reduce-scatter", "all-reduce")
COUNTS: Dict[str, Dict[str, int]] = {k: {"calls": 0, "bytes": 0}
                                     for k in KINDS}
PER_DEVICE: Dict[str, Dict[str, Dict[str, int]]] = {
    axis: {k: {"calls": 0, "bytes": 0} for k in KINDS}
    for axis in ("data", "model")}
_LEAD_ROW = [True]      # the running code is data row 0's (or no row's)
T = TypeVar("T")


def reset_counts() -> None:
    for record in (COUNTS, *PER_DEVICE.values()):
        for c in record.values():
            c["calls"] = c["bytes"] = 0


def _count(kind: str, t: torch.Tensor, axis: str = "data",
           lead: bool = True) -> None:
    n = t.numel() * t.element_size()
    records = [COUNTS[kind]] if axis == "data" else []
    if lead and (axis == "data" or _LEAD_ROW[0]):
        records.append(PER_DEVICE[axis][kind])
    for c in records:
        c["calls"] += 1
        c["bytes"] += n


def each_row(items: Iterable[T]) -> Iterator[T]:
    """``items`` in order, the i-th one's consumer run as data row i:
    from the second on, its 'model' collectives are not the lead's
    (``PER_DEVICE``). Nested, a row is the lead's only where every
    enclosing row is."""
    outer = _LEAD_ROW[0]
    try:
        for i, item in enumerate(items):
            _LEAD_ROW[0] = outer and i == 0
            yield item
    finally:
        _LEAD_ROW[0] = outer


def count_backward_reduce(*xs: torch.Tensor) -> None:
    """Count, for the lead, the 'model' all-reduce that each ``x``'s
    gradient takes in the backward pass (``x`` fed to every shard of a
    tensor-parallel layer): a hook counts the summed gradient when
    autograd has it. Nothing without a gradient."""
    if not (_LEAD_ROW[0] and torch.is_grad_enabled()):
        return
    for x in xs:
        if x.requires_grad:
            x.register_hook(_count_reduced)


def _count_reduced(g: torch.Tensor) -> None:
    _count("all-reduce", g, "model")


def _offsets(sizes: Sequence[int]) -> List[int]:
    return [sum(sizes[:i]) for i in range(len(sizes))]


def _sum_to(xs: Sequence[torch.Tensor], dst: torch.device) -> torch.Tensor:
    """The sum of ``xs`` on ``dst``, added in row order."""
    total = xs[0].to(dst)
    for x in xs[1:]:
        total = total + x.to(dst)
    return total


def _gather(xs, dsts, dim, lead) -> Tuple[torch.Tensor, ...]:
    outs = tuple(torch.cat([x.to(d) for x in xs], dim=dim) for d in dsts)
    _count("all-gather", outs[0], lead=lead)
    return outs


def _scatter_sum(xs, dsts, dim, sizes, lead) -> Tuple[torch.Tensor, ...]:
    outs = tuple(_sum_to([x.narrow(dim, o, n) for x in xs], d)
                 for d, o, n in zip(dsts, _offsets(sizes), sizes))
    _count("reduce-scatter", outs[0], lead=lead)
    return outs


def _reduce(xs, dsts, lead) -> Tuple[torch.Tensor, ...]:
    total = _sum_to(xs, dsts[0])
    _count("all-reduce", total, lead=lead)
    return (total,) + tuple(total.to(d, copy=True) for d in dsts[1:])


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dim, dsts, lead, *xs):
        ctx.dim, ctx.srcs, ctx.lead = dim, [x.device for x in xs], lead
        ctx.sizes = [x.shape[dim] for x in xs]
        return _gather(xs, dsts, dim, lead)

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, None) + _scatter_sum(
            grads, ctx.srcs, ctx.dim, ctx.sizes, ctx.lead)


class _ReduceScatterRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dim, dsts, sizes, lead, *xs):
        ctx.dim, ctx.srcs, ctx.lead = dim, [x.device for x in xs], lead
        return _scatter_sum(xs, dsts, dim, sizes, lead)

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, None, None) + _gather(grads, ctx.srcs, ctx.dim,
                                                  ctx.lead)


class _AllReduceRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dsts, lead, *xs):
        ctx.srcs, ctx.lead = [x.device for x in xs], lead
        return _reduce(xs, dsts, lead)

    @staticmethod
    def backward(ctx, *grads):
        return (None, None) + _reduce(grads, ctx.srcs, ctx.lead)


def gather_rows(xs: Sequence[torch.Tensor], dsts: Sequence[torch.device],
                dim: int, lead: bool = True) -> List[torch.Tensor]:
    """All-gather over the data rows: row d's result, on ``dsts[d]``, is
    the rows' ``xs`` concatenated along ``dim`` in row order. ``lead``:
    whether the mesh's lead slot takes part (``PER_DEVICE``)."""
    return list(_GatherRows.apply(dim, tuple(dsts), lead, *xs))


def reduce_scatter_rows(xs: Sequence[torch.Tensor],
                        dsts: Sequence[torch.device], dim: int,
                        sizes: Sequence[int], lead: bool = True
                        ) -> List[torch.Tensor]:
    """Reduce-scatter over the data rows: row d's result, on ``dsts[d]``,
    is the sum over the rows' ``xs`` (each whole along ``dim``) of slice
    d, ``sizes[d]`` wide, added in row order."""
    return list(_ReduceScatterRows.apply(dim, tuple(dsts), tuple(sizes),
                                         lead, *xs))


def all_reduce_rows(xs: Sequence[torch.Tensor],
                    dsts: Sequence[torch.device], lead: bool = True
                    ) -> List[torch.Tensor]:
    """All-reduce over the data rows: each row's result, on ``dsts[d]``,
    is the same sum of ``xs`` (added in row order)."""
    return list(_AllReduceRows.apply(tuple(dsts), lead, *xs))


def all_reduce_sum(parts: Sequence[torch.Tensor],
                   dst: torch.device) -> torch.Tensor:
    """Sum of the per-shard ``parts`` on ``dst``, added in shard order
    (counted over 'model' when there are two or more)."""
    total = parts[0].to(dst)
    for p in parts[1:]:
        total = total + p.to(dst)
    if len(parts) > 1:
        _count("all-reduce", total, "model")
    return total


def all_gather(parts: Sequence[torch.Tensor], dst: torch.device,
               dim: int = -1, lead: bool = True) -> torch.Tensor:
    """The per-shard ``parts`` concatenated along ``dim`` on ``dst``, in
    shard order; one part is itself, on ``dst``. ``lead``: False where
    each shard gathers its own copy and this is not shard 0's."""
    if len(parts) == 1:
        return parts[0].to(dst)
    out = torch.cat([p.to(dst) for p in parts], dim=dim)
    _count("all-gather", out, "model", lead)
    return out


def _per_127(amax: torch.Tensor) -> torch.Tensor:
    """``amax / 127`` correctly rounded on every device: a CUDA tensor
    divided by a Python number is multiplied by its reciprocal instead,
    one rounding off JAX's division."""
    return amax / amax.new_tensor(127.0)


def quantize_tokens(x: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token symmetric int8 (JAX ``moe._ep_quantized_gather``): x
    (..., D) -> (codes int8 (..., D), scales fp32 (...)), the codes
    rounded half to even. JAX writes the scale ``amax / 127.0`` with
    ``amax = max|x| + 1e-8``; its jitted step computes that as ``amax *
    fp32(1 / 127)`` (XLA rewrites a division by a constant: on 10^5
    values all equal the product, 95.5 % the quotient), so the port
    multiplies by that reciprocal, as a tensor: the same on the CPU and
    on a card. The codes carry no gradient; the scales do (JAX
    differentiates the round to 0)."""
    xf = x.float()
    scale = (xf.abs().amax(dim=-1) + 1e-8) * xf.new_tensor(1 / 127.0)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_tokens(q: torch.Tensor, scale: torch.Tensor,
                      dtype: torch.dtype) -> torch.Tensor:
    return (q.float() * scale[..., None]).to(dtype)


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
