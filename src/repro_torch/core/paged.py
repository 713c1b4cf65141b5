"""Page-table indirection for the paged KV cache (counterpart of
``repro/core/paged.py``).

A paged attention cache entry keeps K/V in a *page pool* ``(n_pages,
page_size, ...)`` shared by every row; a per-session ``page_table (B,
pages_per_row)`` int32 maps each row's logical pages onto physical page ids.
Logical position ``p`` of row ``b`` lives at flat pool slot

    table[b, p // page_size] * page_size + p % page_size

These helpers are the only place that math lives: the model's decode paths
and the cache manager (``repro_torch.api.cache``) read and write pools
through them, so the gathered logical view equals the dense ``(B, S, ...)``
layout at every live position.

The scatters write the pool IN PLACE (the JAX package returns an updated
copy) and return it, so call sites read like the JAX ones. Retired rows all
alias the trash page, so their writes may collide; nothing live reads it.
Slot ids are int64 (torch indexes with int64; a large pool overflows int32).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def page_size_of(pool: torch.Tensor) -> int:
    """Page size of an (unstacked) pool leaf ``(n_pages, ps, ...)``."""
    return pool.shape[1]


def logical_capacity(table: torch.Tensor, page_size: int) -> int:
    """Logical sequence capacity per row: pages_per_row * page_size."""
    return table.shape[1] * page_size


def flat_slots(table: torch.Tensor, page_size: int,
               pos: torch.Tensor) -> torch.Tensor:
    """Flat pool slot ids of logical positions. table: (B, P) int;
    pos: (B,) or (B, L) int. Returns int64 of ``pos``'s shape."""
    pos = torch.as_tensor(pos, device=table.device).long()
    squeeze = pos.dim() == 1
    pm = pos[:, None] if squeeze else pos                      # (B, L)
    page = torch.gather(table.long(), 1, pm // page_size)
    slots = page * page_size + pm % page_size
    return slots[:, 0] if squeeze else slots


def view_slots(table: torch.Tensor, page_size: int) -> torch.Tensor:
    """(B, P*page_size) flat slot id of every logical position of every
    row."""
    B, P = table.shape
    slots = (table.long()[:, :, None] * page_size
             + torch.arange(page_size, device=table.device)[None, None, :])
    return slots.reshape(B, P * page_size)


def _flat(pool: torch.Tensor) -> torch.Tensor:
    """(n_pages, ps, ...) -> (n_pages*ps, ...), a view of the pool."""
    return pool.view((pool.shape[0] * pool.shape[1],) + tuple(pool.shape[2:]))


def gather_view(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The logical per-row view of a pool leaf. pool: (n_pages, ps, ...);
    table: (B, P). Returns a new (B, P*ps, ...) tensor — the dense cache's
    layout, so the attention math downstream is unchanged."""
    return _flat(pool)[view_slots(table, page_size_of(pool))]


def scatter_token(pool: torch.Tensor, table: torch.Tensor, pos: torch.Tensor,
                  vals: torch.Tensor) -> torch.Tensor:
    """Write one value per row at logical position ``pos`` (B,), in place.
    vals: (B, ...). Returns ``pool``."""
    slots = flat_slots(table, page_size_of(pool), pos)          # (B,)
    _flat(pool)[slots] = vals.to(pool.dtype)
    return pool


def scatter_slab(pool: torch.Tensor, table: torch.Tensor, pos: torch.Tensor,
                 vals: torch.Tensor) -> torch.Tensor:
    """Write a (B, L, ...) slab at logical positions ``pos`` (B, L), in
    place. Returns ``pool``."""
    slots = flat_slots(table, page_size_of(pool), pos)          # (B, L)
    _flat(pool)[slots] = vals.to(pool.dtype)
    return pool


def gather_positions(pool: torch.Tensor, table: torch.Tensor,
                     pos: torch.Tensor) -> torch.Tensor:
    """Values at per-row logical positions. pos: (B,) -> (B, ...)."""
    return _flat(pool)[flat_slots(table, page_size_of(pool), pos)]


def paged_shape(dense_shape: Tuple[int, ...], num_pages: int,
                page_size: int) -> Tuple[int, ...]:
    """Pool shape ``(num_pages, page_size, ...)`` of a dense cache leaf
    shape ``(B, S, ...)``."""
    return (num_pages, page_size) + tuple(dense_shape[2:])


def pool_partition_dims(shape: Tuple[int, ...],
                        model_extent: int) -> Tuple[Optional[str], ...]:
    """Which dim of a pool leaf shards over the tensor-parallel ('model')
    axis (JAX ``core/paged.py:113``). Page ids index the leading pool dims
    (reps?, n_pages, page_size), so those stay whole and every shard
    resolves the same page table; the KV-head dim shards when it divides
    the degree, else head_dim, else nothing. Returns a spec tuple."""
    dims: list = [None] * len(shape)
    if model_extent > 1:
        for cand in (len(shape) - 2, len(shape) - 1):
            # cand >= 3 keeps (reps, n_pages, page_size) whole even for
            # low-rank leaves (the 4-D scale planes)
            if cand >= 3 and shape[cand] % model_extent == 0:
                dims[cand] = "model"
                break
    return tuple(dims)
