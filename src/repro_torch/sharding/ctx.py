"""Shard context and sharded leaves (counterpart of
``repro/sharding/ctx.py``).

``ShardCtx`` names the mesh and its tensor-parallel axis. The decode path
runs in a single controller: replicated state (the residual stream, the
scheduler, the draft, the exit gates, the last token) lives once, on the
mesh's lead device; shard-local state lives on each shard's device as a
``Shards`` leaf, one contiguous part per shard, in shard order. A ``Shards``
is a list, so the tree helpers (``tree_map``, ``index_tree``) map over its
parts and keep it a ``Shards`` (``Shards.like``).

A ``Shards`` follows a layout of segments (``segs``) along its split dim
(the even Megatron split is one split segment of width 1), or, for the
vocabulary's uneven slices alone, holds consecutive slices of that dim
(``segs`` None). Segments are ``(units, width, split)`` triples,
``units`` blocks of ``width`` elements each. A split segment's blocks are
divided among the P shards, shard s taking ``max(1, units // P)`` blocks
from block ``s * units // P``, so a segment of fewer blocks than shards
holds each block on ``P / units`` consecutive shards (a KV head read by
several shards' query heads); a whole segment (``split`` False) is held by
every shard (Mamba2's B and C columns). ``cut`` makes a part, ``gather``
joins the parts back, taking a repeated block from its first holder.

The 'data' axis (a ``(D, P)`` mesh, ``sharding/rows``):
a ``DataShards`` holds one entry per data row, each a tensor on the row's
lead device or a ``Shards`` over the row's model devices. Its ``dim``
names the dim cut over 'data' (ZeRO-3: entry d is slice d of that dim),
or is None for a leaf replicated over 'data' (every entry a copy).

Leaf module on purpose: imports torch only.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple

import torch

Segs = Tuple[Tuple[int, int, bool], ...]     # (units, width, split) each


class Shards(list):
    """One sharded leaf: part ``s`` lives on shard ``s``'s device. ``dim``
    is the split dim counted from the END (-1 the last), so it holds for
    every view that indexes leading dims away (a unit out of a stacked
    segment, a row out of a batch)."""

    def __init__(self, parts=(), dim: Optional[int] = None,
                 segs: Optional[Segs] = None):
        super().__init__(parts)
        if dim is not None and dim >= 0:
            raise ValueError(f"Shards.dim counts from the end, got {dim}")
        self.dim = dim
        self.segs = segs

    def like(self, parts) -> "Shards":
        """Other parts in this leaf's layout (same dim and segments)."""
        return Shards(parts, dim=self.dim, segs=self.segs)

    def __repr__(self) -> str:
        return f"Shards({[tuple(p.shape) for p in self]}, dim={self.dim})"


class DataShards(list):
    """One leaf of a tree placed on a ``(D, P)`` mesh: entry ``d``
    lives on data row ``d``. ``dim`` is the dim cut over 'data', counted
    from the end as ``Shards.dim``, or None when each entry is a whole
    copy (a leaf replicated over 'data')."""

    def __init__(self, entries=(), dim: Optional[int] = None):
        super().__init__(entries)
        if dim is not None and dim >= 0:
            raise ValueError(f"DataShards.dim counts from the end, got {dim}")
        self.dim = dim

    def like(self, entries) -> "DataShards":
        return DataShards(entries, dim=self.dim)

    def __repr__(self) -> str:
        return f"DataShards({list.__repr__(self)}, dim={self.dim})"


def _blocks(units: int, s: int, P: int) -> Tuple[int, int]:
    """(first block, blocks) of a split segment on shard ``s`` of ``P``."""
    return s * units // P, max(1, units // P)


def part_size(segs: Segs, P: int) -> int:
    """Size of one part along the split dim."""
    return sum((_blocks(n, 0, P)[1] if split else n) * w
               for n, w, split in segs)


def whole_size(segs: Segs) -> int:
    return sum(n * w for n, w, _ in segs)


def cut(x: torch.Tensor, dim: int, segs: Segs, s: int, P: int
        ) -> torch.Tensor:
    """Shard ``s``'s part of the whole tensor ``x`` under ``segs`` along
    ``dim`` (contiguous)."""
    pieces, c0 = [], 0
    for n, w, split in segs:
        b0, nb = _blocks(n, s, P) if split else (0, n)
        pieces.append(x.narrow(dim, c0 + b0 * w, nb * w))
        c0 += n * w
    out = pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=dim)
    return out.contiguous()


def _join(parts: Sequence[torch.Tensor], dim: int, segs: Segs
          ) -> List[torch.Tensor]:
    """The whole tensor's pieces along ``dim``, in order, from the parts:
    each block of a split segment from the first shard that holds it,
    a whole segment from shard 0."""
    P, pieces, c0 = len(parts), [], 0
    for n, w, split in segs:
        size = (_blocks(n, 0, P)[1] if split else n) * w
        if split:
            seen = set()
            for s, part in enumerate(parts):
                b0 = _blocks(n, s, P)[0]
                if b0 not in seen:
                    seen.add(b0)
                    pieces.append(part.narrow(dim, c0, size))
        else:
            pieces.append(parts[0].narrow(dim, c0, size))
        c0 += size
    return pieces


def gather(x: Any, device: torch.device) -> Any:
    """The whole tensor of a ``Shards`` leaf on ``device`` (the parts
    concatenated along ``dim``, or joined by its segments); any other leaf
    moved to ``device``."""
    if isinstance(x, Shards):
        parts = [p.to(device) for p in x]
        if x.segs is not None:
            parts = _join(parts, x.dim, x.segs)
        return torch.cat(parts, dim=x.dim)
    return x.to(device) if isinstance(x, torch.Tensor) else x


def _shape(x: Any) -> List[int]:
    """The whole shape of a tensor or a ``Shards`` leaf."""
    if not isinstance(x, Shards):
        return list(x.shape)
    s = list(x[0].shape)
    s[x.dim] = (whole_size(x.segs) if x.segs is not None else
                sum(p.shape[x.dim] for p in x))
    return s


def whole_shape(x: DataShards) -> List[int]:
    """The shape of the tensor a ``DataShards`` leaf holds."""
    s = _shape(x[0])
    if x.dim is not None:
        s[x.dim] = sum(_shape(e)[x.dim] for e in x)
    return s


def join(x: DataShards, device: torch.device) -> torch.Tensor:
    """The whole tensor of a ``DataShards`` leaf on ``device``: its rows'
    slices concatenated along ``dim`` (each gathered from its shards), or
    its first copy."""
    ws = [gather(e, device) for e in (x[:1] if x.dim is None else x)]
    return ws[0] if len(ws) == 1 else torch.cat(ws, dim=x.dim)


def parts(x: Any) -> list:
    """A leaf's per-shard parts; an unsharded leaf is its one part."""
    return list(x) if isinstance(x, Shards) else [x]


def from_parts(xs: Sequence[Any], dim: int, segs: Optional[Segs]) -> Any:
    """The inverse of ``parts`` for a block's per-shard outputs: one part
    is the unsharded leaf itself, more are a ``Shards`` in the layout
    (``dim``, ``segs``). A mesh of one shard is never sharded
    (``ShardCtx.from_mesh``), so one part means unsharded."""
    return xs[0] if len(xs) == 1 else Shards(xs, dim, segs)


def local(tree: Any, s: int) -> Any:
    """Shard ``s``'s view of a tree: each ``Shards`` leaf gives its part
    ``s``; every other leaf is returned as it is."""
    if isinstance(tree, Shards):
        return tree[s]
    if isinstance(tree, dict):
        return {k: local(v, s) for k, v in tree.items()}
    return tree


@dataclass(frozen=True, eq=False)
class ShardCtx:
    """Tensor-parallel context of one engine. ``mesh``: a
    ``repro_torch.launch.mesh.Mesh``; ``axis`` the dimension heads and
    vocabulary split over. Shard ``s`` is model index ``s`` of data row 0
    (the other rows of a ``(D, P)`` mesh: ``sharding.rows.RowMesh``)."""
    mesh: Any
    axis: str = "model"

    @property
    def degree(self) -> int:
        return int(self.mesh.shape[self.axis])

    @property
    def devices(self) -> List[torch.device]:
        return list(self.mesh.devices[0])

    @property
    def lead(self) -> torch.device:
        """The device that holds the replicated state."""
        return self.devices[0]

    @staticmethod
    def from_mesh(mesh, axis: str = "model") -> Optional["ShardCtx"]:
        """None / missing axis / degree-1 mesh -> None (sharding inactive),
        so every caller treats ``shard is None`` as the single-device
        path."""
        if mesh is None or axis not in mesh.shape or mesh.shape[axis] <= 1:
            return None
        return ShardCtx(mesh=mesh, axis=axis)
