"""T3 — static token tree for speculative decoding + hyper-token paths
(counterpart of ``repro/core/tree.py``).

A full ``branch``-ary tree of ``depth`` draft levels under a root node:
node 0 is the root (the last accepted token, the target's input at the
current position); level-ℓ nodes (ℓ ≥ 1) are draft candidates for position
pos0+ℓ. BFS (level-major) node numbering.

The hyper-token mapping merges every root→leaf path into one predictor
search space; ``path_nodes`` enumerates them for
``features.merge_path_features``.

The structure is static numpy; ``attention_mask`` and ``positions`` build
torch tensors on the device of the lengths they are given.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import List

import numpy as np
import torch


@dataclass(frozen=True)
class TreeSpec:
    depth: int = 2     # draft levels under the root
    branch: int = 3    # children per node

    @cached_property
    def level_sizes(self) -> List[int]:
        return [1] + [self.branch ** l for l in range(1, self.depth + 1)]

    @cached_property
    def num_nodes(self) -> int:
        return sum(self.level_sizes)

    @cached_property
    def level_offsets(self) -> List[int]:
        return [int(x) for x in np.cumsum([0] + self.level_sizes[:-1])]

    @cached_property
    def levels(self) -> np.ndarray:
        """(N,) level of each node (root = 0)."""
        return np.repeat(np.arange(self.depth + 1, dtype=np.int32),
                         self.level_sizes)

    @cached_property
    def parents(self) -> np.ndarray:
        """(N,) parent node index; root's parent = -1."""
        par = np.full(self.num_nodes, -1, np.int32)
        for l in range(1, self.depth + 1):
            off, size = self.level_offsets[l], self.level_sizes[l]
            par[off:off + size] = (self.level_offsets[l - 1]
                                   + np.arange(size) // self.branch)
        return par

    @cached_property
    def ancestor_mask(self) -> np.ndarray:
        """(N, N) bool: M[i, j] = node i attends node j (j ancestor-or-self)."""
        m = np.eye(self.num_nodes, dtype=bool)
        for i in range(self.num_nodes):
            p = self.parents[i]
            while p >= 0:
                m[i, p] = True
                p = self.parents[p]
        return m

    @cached_property
    def path_nodes(self) -> np.ndarray:
        """(P, depth+1) node indices of each root→leaf path."""
        off = self.level_offsets[self.depth]
        leaves = np.arange(off, off + self.level_sizes[self.depth])
        out = np.zeros((len(leaves), self.depth + 1), np.int32)
        for pi, n in enumerate(leaves):
            for d in range(self.depth, -1, -1):
                out[pi, d] = n
                n = self.parents[n]
        return out

    @cached_property
    def children(self) -> np.ndarray:
        """(N, branch) child node indices (-1 where none — leaves)."""
        ch = np.full((self.num_nodes, self.branch), -1, np.int32)
        for i in range(1, self.num_nodes):
            p = self.parents[i]
            ch[p, np.argmax(ch[p] < 0)] = i
        return ch

    def attention_mask(self, cache_len: torch.Tensor,
                       max_seq: int) -> torch.Tensor:
        """(B|1, 1, N, max_seq + N) bool mask for the tree-verification
        step: node queries attend the valid cache slots (< cache_len, per
        row) plus their tree ancestors (self included), which sit at slots
        [max_seq, max_seq + N)."""
        clen = torch.as_tensor(cache_len).reshape(-1, 1)          # (B|1, 1)
        dev, N = clen.device, self.num_nodes
        ctx = torch.arange(max_seq, device=dev)[None, :] < clen  # (B|1, S)
        tree = torch.as_tensor(self.ancestor_mask, device=dev)
        return torch.cat([ctx[:, None, :].expand(-1, N, max_seq),
                          tree[None].expand(ctx.shape[0], N, N)],
                         dim=2)[:, None]

    def positions(self, pos0: torch.Tensor) -> torch.Tensor:
        """(B|1, N) absolute position of each node: pos0 + level."""
        p0 = torch.as_tensor(pos0).reshape(-1, 1).long()
        return p0 + torch.as_tensor(self.levels, device=p0.device)[None, :]
