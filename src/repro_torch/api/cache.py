"""KV cache managers (counterpart of ``repro/api/cache.py``): a session's KV
memory as an object that builds the cache, admits rows into it and retires
them out of it.

* ``DenseKVCache`` — the slot-masked ``(reps, B, max_seq, KVH, hd)`` layout,
  the reference the paged layout is held against.
* ``PagedKVCache`` — every attention entry keeps K/V in a per-layer page
  pool ``(reps, num_pages + 1, page_size, KVH, hd)`` (under ``kv_quant``
  int8 codes, beside fp32 scale pools without the ``hd`` dim); one
  ``page_table (B, pages_per_row)`` int32, shared by all layers, maps each
  row's logical pages to physical ids. The ``+1`` page is a write-only
  trash page that empty and retired rows alias. A host-side free list
  gates admission (``can_admit``); ``retire_row`` returns a finished row's
  pages and zeroes its length, so an idle slot stops paying attention
  span.

Under a mesh (a sharded model, ``Model.with_shard``) every entry's leaves
are ``Shards``: an attention entry's of each shard's KV heads (a KV head
on several shards where the degree exceeds the KV heads) — the paged
pools split on their KV-head dim, one pool per shard, and so do the int8
pools and their scales — an SSD entry's of each shard's heads and conv
channels and an RG-LRU entry's of its W slice, per row as unsharded;
the page table and the lengths stay whole on the lead device, so
admission and retirement edit rows without knowing the layout.
``partition_specs`` gives JAX's specs of the layout (JAX
``api/cache.py:164``, ``:297``); the port's placement of replicated KV
heads and SSD heads differs from them (``sharding/serving.py``).

Over the data rows of a ``(D, P)`` mesh (``Model.with_rows``) a leaf is
a ``DataShards`` of the rows' entries: a dense entry and a per-row
(SSD, RG-LRU) entry split their batch over the rows, and each page pool
is a copy per row (JAX's paged specs replicate the pools over 'data').
One allocator and one page table on the lead serve every row, so
``free_pages``, ``row_pages`` and every eviction decision are the
unsharded manager's; a row's K/V is written into the copy of the data
row that owns its slot (``_owner``), and a join of the pools takes each
page from that row (``sharding.serving.unplace_cache``). Where D does not
divide the batch the cache is whole on row 0.

Allocation is by reservation: a row claims its full ``pages_per_row`` at
admission and returns them at retirement, in the JAX package's order, so
page ids come out equal to the JAX manager's for the same calls. Only
attention entries are paged: an SSD entry (per-row state) stays dense per
row in both layouts. The pools are written in place.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Union

import numpy as np
import torch

from repro_torch.config import ATTN, LOCAL_ATTN
from repro_torch.core import paged as paged_lib
from repro_torch.models.common import tree_map
from repro_torch.runtime import faultinject
from repro_torch.sharding.ctx import DataShards, Shards, parts, whole_size


@dataclass(frozen=True)
class CacheSpec:
    """How a session's KV memory is laid out.

    kind: "dense" (slot-masked reference) | "paged" (page pool + table).
    page_size: tokens per page (paged only).
    num_pages: physical pages per layer pool. None = ``batch *
        pages_per_row`` (the dense layout's capacity).
    """
    kind: str = "dense"
    page_size: int = 128
    num_pages: Optional[int] = None

    def __post_init__(self) -> None:
        if self.kind not in ("dense", "paged"):
            raise ValueError(
                f"CacheSpec.kind must be 'dense' or 'paged', got {self.kind!r}")
        if self.page_size <= 0:
            raise ValueError(
                f"CacheSpec.page_size must be > 0, got {self.page_size}")

    @staticmethod
    def resolve(spec: Union[None, str, "CacheSpec"],
                serve_cfg=None) -> "CacheSpec":
        """None -> dense; "dense"/"paged" -> a spec with the run's
        ``ServeConfig.page_size``; a CacheSpec passes through."""
        if isinstance(spec, CacheSpec):
            return spec
        if spec is None:
            spec = "dense"
        page = serve_cfg.page_size if serve_cfg is not None else 128
        return CacheSpec(kind=spec, page_size=page)


def insert_row_pytree(big: Any, small: Any, row: int, batch: int) -> Any:
    """Write batch-1 tree ``small`` into row ``row`` of batched ``big``, in
    place, and return ``big``. The batch axis of each leaf is the first dim
    where ``big`` has ``batch`` and ``small`` has 1 (the JAX rule); a leaf
    split over data rows (``DataShards``) takes it into the entry of the
    row that owns ``row``."""
    if isinstance(big, dict):
        return {k: insert_row_pytree(big[k], small[k], row, batch)
                for k in big}
    if isinstance(big, DataShards):     # the batch over the data rows
        b = batch // len(big)
        d, r = divmod(row, b)
        one = insert_row_pytree(big[d], small, r, b)
        return big.like(one if i == d else e for i, e in enumerate(big))
    if isinstance(big, Shards):
        return big.like(insert_row_pytree(b, s, row, batch)
                        for b, s in zip(big, small))
    if isinstance(big, (list, tuple)):
        return type(big)(insert_row_pytree(b, s, row, batch)
                         for b, s in zip(big, small))
    axis = None
    for i, (db, ds) in enumerate(zip(big.shape, small.shape)):
        if db == batch and ds == 1:
            axis = i
            break
    assert axis is not None, f"no batch axis: {big.shape} vs {small.shape}"
    big.select(axis, row).copy_(small.select(axis, 0))
    return big


class KVCacheManager:
    """Owner of one session's KV memory: layout, admission, compaction."""

    kind = "base"

    def __init__(self, model, batch: int, seq_len: int, spec: CacheSpec,
                 device):
        self.model = model
        self.batch = batch
        self.seq_len = seq_len          # requested logical capacity per row
        self.spec = spec
        self.device = torch.device(device)

    # ----- layout -----
    def empty_cache(self) -> Any:
        raise NotImplementedError

    def from_prefill(self, dense_cache: Any) -> Any:
        """Adopt a whole-batch dense prefill cache (``model.prefill``'s
        output) into this manager's layout."""
        raise NotImplementedError

    # ----- admission / retirement -----
    def insert_row(self, cache: Any, row: int, row_cache: Any) -> Any:
        """Admit a batch-1 dense cache (one prefilled request) into ``row``."""
        raise NotImplementedError

    def retire_row(self, cache: Any, row: int) -> Any:
        """Per-row compaction: drop the row's logical length (and, when
        paged, return its pages to the free list)."""
        raise NotImplementedError

    def can_admit(self, prompt_len: int = 0) -> bool:
        """Admission gate (paged: a full row reservation of free pages).
        The ``pool_exhausted`` fault site lives here, so a schedule can
        simulate a dry pool on either layout and drive the serving
        engine's victim eviction (``runtime.faultinject``)."""
        if faultinject.fire("pool_exhausted"):
            return False
        return self._can_admit(prompt_len)

    def _can_admit(self, prompt_len: int = 0) -> bool:
        return True

    # ----- allocator state -----
    def export_state(self) -> dict:
        """Host-side allocator state (the device tensors travel in the
        DecodeState)."""
        return {"kind": self.kind}

    def import_state(self, st: dict) -> None:
        """Adopt exported allocator state of the same layout."""
        if st.get("kind") != self.kind:
            raise ValueError(
                f"cache state is {st.get('kind')!r}, manager is "
                f"{self.kind!r}: restore needs the same cache layout")

    # ----- mesh layout -----
    def partition_specs(self, cache: Any, mesh, policy: str = "tp_dp"
                        ) -> Any:
        """Spec tree of this manager's cache on ``mesh``: JAX's
        Megatron-role cache rules with the sequence split off (decode
        scatters positions one at a time). Where JAX's generic rule would
        split a dense int8 cache's scale planes along S, the port keeps
        each KV head's scales beside its codes: a scale plane takes its
        codes' spec without the head_dim entry."""
        from repro_torch.sharding import policies as pol
        specs = pol.cache_specs(self.model, mesh, policy,
                                _shape_tree(cache), kv_seq_shard=False)
        for seg, key, _, is_attn in self._attention_units():
            entry = specs["segments"][seg][key]
            for scale, codes in (("ks", "k"), ("vs", "v")):
                if is_attn and scale in entry:
                    entry[scale] = pol.Spec(*entry[codes][:-1])
        return specs

    # ----- introspection -----
    def row_span(self, cache: Any, row: int) -> int:
        """Attention span the row currently pays (valid cache positions)."""
        return int(cache["len"][row])

    def row_pages(self, row: int) -> int:
        """Pages the row holds (0 in the dense layout)."""
        return 0

    @property
    def free_pages(self) -> int:
        return 0

    @property
    def capacity(self) -> int:
        return self.seq_len

    def _attention_units(self):
        """(segment, unit key, kind, is attention) of every cache entry."""
        for seg, (unit, _reps) in enumerate(self.model.segments):
            for i, kind in enumerate(unit):
                yield seg, f"u{i}", kind, kind in (ATTN, LOCAL_ATTN)


def _whole_shape(x):
    """The whole tensor's shape of a leaf (a ``Shards``' parts joined by
    its segments, which every cache leaf carries; a ``DataShards``' rows
    joined, or one copy)."""
    if isinstance(x, DataShards):
        shape = list(_whole_shape(x[0]))
        if x.dim is not None:
            shape[x.dim] *= len(x)
        return tuple(shape)
    if not isinstance(x, Shards):
        return tuple(x.shape)
    shape = list(x[0].shape)
    shape[x.dim] = whole_size(x.segs)
    return tuple(shape)


def _shape_tree(cache: Any) -> Any:
    """The cache tree with each tensor leaf replaced by a meta tensor of
    its whole shape (the spec rules read shapes alone)."""
    if isinstance(cache, dict):
        return {k: _shape_tree(v) for k, v in cache.items()}
    if isinstance(cache, (DataShards, Shards, torch.Tensor)):
        return torch.empty(_whole_shape(cache), device="meta")
    if isinstance(cache, (list, tuple)):
        return type(cache)(_shape_tree(v) for v in cache)
    return cache


class DenseKVCache(KVCacheManager):
    """The slot-masked dense layout (the reference)."""

    kind = "dense"

    def empty_cache(self) -> Any:
        return self.model.empty_cache(self.batch, self.seq_len, self.device)

    def from_prefill(self, dense_cache: Any) -> Any:
        return dense_cache

    def insert_row(self, cache: Any, row: int, row_cache: Any) -> Any:
        segs = insert_row_pytree(cache["segments"], row_cache["segments"],
                                 row, self.batch)
        length = cache["len"].clone()
        length[row] = row_cache["len"][0]
        return dict(cache, segments=segs, len=length)

    def retire_row(self, cache: Any, row: int) -> Any:
        length = cache["len"].clone()
        length[row] = 0
        return dict(cache, len=length)


class PagedKVCache(KVCacheManager):
    """Paged layout: per-layer page pools + one shared page table."""

    kind = "paged"

    def __init__(self, model, batch: int, seq_len: int, spec: CacheSpec,
                 device):
        super().__init__(model, batch, seq_len, spec, device)
        ps = spec.page_size
        self.page_size = ps
        self.pages_per_row = -(-seq_len // ps)
        self.num_pages = (spec.num_pages if spec.num_pages is not None
                          else batch * self.pages_per_row)
        if self.num_pages < self.pages_per_row:
            raise ValueError(
                f"paged cache pool of {self.num_pages} pages cannot hold even "
                f"one row ({self.pages_per_row} pages/row)")
        self.trash_page = self.num_pages        # extra write-only page
        self._free: List[int] = list(range(self.num_pages - 1, -1, -1))
        self._row_pages: List[List[int]] = [[] for _ in range(batch)]

    @property
    def capacity(self) -> int:
        """Logical per-row capacity (rounded up to whole pages)."""
        return self.pages_per_row * self.page_size

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def row_pages(self, row: int) -> int:
        return len(self._row_pages[row])

    def _can_admit(self, prompt_len: int = 0) -> bool:
        return len(self._free) >= self.pages_per_row

    def export_state(self) -> dict:
        return {"kind": self.kind, "page_size": self.page_size,
                "num_pages": self.num_pages,
                "free": [int(p) for p in self._free],
                "row_pages": [[int(p) for p in r] for r in self._row_pages]}

    def import_state(self, st: dict) -> None:
        super().import_state(st)
        if (st["page_size"] != self.page_size
                or st["num_pages"] != self.num_pages):
            raise ValueError(
                f"paged state geometry (page_size={st['page_size']}, "
                f"num_pages={st['num_pages']}) does not match manager "
                f"(page_size={self.page_size}, num_pages={self.num_pages})")
        self._free = [int(p) for p in st["free"]]
        self._row_pages = [[int(p) for p in r] for r in st["row_pages"]]

    # ----- layout -----
    def empty_cache(self) -> Any:
        # pool leaves (num_pages + 1, page_size, ...): the last page is the
        # trash page; zeroed, so a retired row reads finite K/V and scales.
        # Per-row (SSD) entries keep the batch layout.
        reps = [r for _, r in self.model.segments]
        segs = [{} for _ in reps]
        for seg, key, kind, is_attn in self._attention_units():
            segs[seg][key] = self.model.empty_cache_entry(
                reps[seg], self.num_pages + 1 if is_attn else self.batch,
                self.page_size, self.device, kind,
                pool_rows=self.batch if is_attn else None)
        table = torch.full((self.batch, self.pages_per_row), self.trash_page,
                           dtype=torch.int32, device=self.device)
        return {"segments": segs,
                "len": torch.zeros(self.batch, dtype=torch.int32,
                                   device=self.device),
                "page_table": table}

    def partition_specs(self, cache: Any, mesh, policy: str = "tp_dp"
                        ) -> Any:
        """Head-sharded paged layout: attention pool leaves shard their
        KV-head dim over 'model' (``core.paged.pool_partition_dims``: page
        ids index the leading dims, so pages stay whole); the page table,
        lengths and non-attention entries are replicated, so every shard
        resolves the same page indirection."""
        from repro_torch.sharding import policies as pol
        M = int(dict(mesh.shape).get("model", 1))
        attn = {(seg, key): is_attn
                for seg, key, _, is_attn in self._attention_units()}
        segs = []
        for seg, entry in enumerate(cache["segments"]):
            out = {}
            for key, sub in entry.items():
                if attn.get((seg, key)):
                    out[key] = {n: pol.Spec(*paged_lib.pool_partition_dims(
                        _whole_shape(x), M)) for n, x in sub.items()}
                else:
                    out[key] = pol.replicated_specs(_shape_tree(sub))
            segs.append(out)
        return {"segments": segs, "len": pol.Spec(),
                "page_table": pol.Spec()}

    def _alloc_row(self, row: int) -> np.ndarray:
        if not self._row_pages[row]:
            if len(self._free) < self.pages_per_row:
                raise RuntimeError(
                    f"paged KV pool exhausted: row {row} needs "
                    f"{self.pages_per_row} pages, {len(self._free)} free "
                    "(gate admission with can_admit())")
            self._row_pages[row] = [self._free.pop()
                                    for _ in range(self.pages_per_row)]
        return np.asarray(self._row_pages[row], np.int32)

    def _owner(self, row: int) -> int:
        """The data row whose pool copies hold slot ``row``'s pages (0
        without data rows or where they do not divide the batch)."""
        rows = self.model.rows
        if rows is None or self.batch % rows.D:
            return 0
        return row // (self.batch // rows.D)

    @staticmethod
    def _scatter_entry(pool_entry: Any, dense_entry: Any,
                       slots: torch.Tensor, d: int = 0) -> None:
        """Copy a dense attention entry's first logical slots into its
        pools (data row ``d``'s copy of pools held per row), in place.
        slots: flat pool slot ids, (B, S) for whole-batch dense leaves
        (reps, B, S, ...) or (S,) for one row's leaves (reps, S, ...)."""
        for name, pools in pool_entry.items():
            if isinstance(pools, DataShards):
                pools = pools[d]
            for pool, dense in zip(parts(pools), parts(dense_entry[name])):
                flat = pool.view((pool.shape[0],
                                  pool.shape[1] * pool.shape[2])
                                 + tuple(pool.shape[3:]))
                flat[:, slots.to(pool.device)] = dense.to(pool.dtype)

    def from_prefill(self, dense_cache: Any) -> Any:
        table = torch.as_tensor(
            np.stack([self._alloc_row(r) for r in range(self.batch)]),
            device=self.device)
        segs = self.empty_cache()["segments"]
        view = paged_lib.view_slots(table, self.page_size)       # (B, cap)
        for seg, key, _, is_attn in self._attention_units():
            dense = dense_cache["segments"][seg][key]
            if not is_attn:
                segs[seg][key] = dense        # per-row state: unchanged
                continue
            S = _whole_shape(dense["k"])[2]
            if not isinstance(dense["k"], DataShards):
                self._scatter_entry(segs[seg][key], dense, view[:, :S])
                continue
            b = self.batch // len(dense["k"])
            for d in range(len(dense["k"])):    # each row into its copy
                self._scatter_entry(segs[seg][key],
                                    {n: x[d] for n, x in dense.items()},
                                    view[d * b:(d + 1) * b, :S], d)
        return {"segments": segs, "len": dense_cache["len"],
                "page_table": table}

    def insert_row(self, cache: Any, row: int, row_cache: Any) -> Any:
        pages = self._alloc_row(row)
        table = cache["page_table"].clone()
        table[row] = torch.as_tensor(pages, device=self.device)
        row_slots = torch.as_tensor(
            (pages[:, None].astype(np.int64) * self.page_size
             + np.arange(self.page_size)[None, :]).reshape(-1),
            device=self.device)
        for seg, key, _, is_attn in self._attention_units():
            src = row_cache["segments"][seg][key]
            dst = cache["segments"][seg][key]
            if not is_attn:
                insert_row_pytree(dst, src, row, self.batch)
                continue
            S = _whole_shape(src["k"])[2]
            self._scatter_entry(dst, tree_map(lambda x: x[:, 0], src),
                                row_slots[:S], self._owner(row))
        length = cache["len"].clone()
        length[row] = row_cache["len"][0]
        return dict(cache, len=length, page_table=table)

    def retire_row(self, cache: Any, row: int) -> Any:
        self._free.extend(self._row_pages[row])
        self._row_pages[row] = []
        table = cache["page_table"].clone()
        table[row] = self.trash_page
        length = cache["len"].clone()
        length[row] = 0
        return dict(cache, len=length, page_table=table)


def make_cache_manager(model, batch: int, seq_len: int,
                       spec: Union[None, str, CacheSpec],
                       device) -> KVCacheManager:
    spec = CacheSpec.resolve(spec, model.run.serve)
    cls = PagedKVCache if spec.kind == "paged" else DenseKVCache
    return cls(model, batch, seq_len, spec, device)
