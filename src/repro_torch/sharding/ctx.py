"""Shard context and sharded leaves (counterpart of
``repro/sharding/ctx.py``).

``ShardCtx`` names the mesh and its tensor-parallel axis. The decode path
runs in a single controller: replicated state (the residual stream, the
scheduler, the draft, the exit gates, the last token) lives once, on the
mesh's lead device; shard-local state lives on each shard's device as a
``Shards`` leaf, one contiguous part per shard, in shard order. A ``Shards``
is a list, so the tree helpers (``tree_map``, ``index_tree``) map over its
parts and keep it a ``Shards``.

Leaf module on purpose: imports torch only.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional

import torch


class Shards(list):
    """One sharded leaf: part ``s`` lives on shard ``s``'s device. ``dim``
    is the split dim counted from the END (-1 the last), so it holds for
    every view that indexes leading dims away (a unit out of a stacked
    segment, a row out of a batch)."""

    def __init__(self, parts=(), dim: Optional[int] = None):
        super().__init__(parts)
        if dim is not None and dim >= 0:
            raise ValueError(f"Shards.dim counts from the end, got {dim}")
        self.dim = dim

    def __repr__(self) -> str:
        return f"Shards({[tuple(p.shape) for p in self]}, dim={self.dim})"


def gather(x: Any, device: torch.device) -> Any:
    """The whole tensor of a ``Shards`` leaf on ``device`` (the parts
    concatenated along ``dim``); any other leaf moved to ``device``."""
    if isinstance(x, Shards):
        return torch.cat([p.to(device) for p in x], dim=x.dim)
    return x.to(device) if isinstance(x, torch.Tensor) else x


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
    (``DATA > 1`` is refused)."""
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
