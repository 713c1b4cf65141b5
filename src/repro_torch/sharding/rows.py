"""The data rows of a ``(DATA, MODEL)`` mesh: placement of a tree by specs
that name 'data', and each row's view of it (shared by serving,
``sharding/serving.py``, and training, ``sharding/training.py``).

Layout (``RowMesh.place``): every tensor leaf becomes a ``DataShards`` of
D entries. A leaf whose spec names 'data' is cut along that dim (entry d
holds slice d); any other leaf is held once per row (a copy). Within an
entry a leaf whose spec names 'model' is a ``Shards`` over the row's
model devices, JAX's even split; any other leaf sits on the row's lead
device. With ``layouts`` (serving) a leaf that a module's table names is
cut by its segments instead (whole KV heads, Mamba2's head-aligned SSD
leaves: ``layouts``), unless its spec cuts the same dim over 'data'; the
row's view then re-cuts it. Serving places every mesh so, ``(1, P)`` too,
where each leaf is its one entry (no ``DataShards``).

Each row's view (``RowMesh.views``), taken per use: a leaf cut over 'data'
is all-gathered over the rows (``collectives.gather_rows``, counted in
``collectives.COUNTS``, shard 0's also in ``PER_DEVICE``; differentiable,
its backward a reduce-scatter); a
copy is the row's own. The view is then put in the layout the blocks
compute with (``layouts``): a leaf placed in another layout is joined on
the row's lead and cut by its segments. Under expert parallelism
(``local_experts``) the MoE expert stacks cut over 'data' are not
gathered: each row keeps its own experts (``moe.apply_moe_rows``).

One process drives every row, one after another, as it drives every
shard. Devices may repeat (``launch.mesh.make_host_mesh``): with every
slot on one card a gathered view is a copy beside the slices.

Imports torch, ``sharding.ctx``, ``runtime.collectives``, ``QTensor``
(``quant.core``) and ``models.common.is_namedtuple`` (the models'
``param_segs`` lazily); neither serving's nor training's module.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Sequence

import torch

from repro_torch.models.common import is_namedtuple
from repro_torch.quant.core import QTensor
from repro_torch.runtime.collectives import gather_rows
from repro_torch.sharding.ctx import DataShards, Shards, cut, gather

EXPERTS = ("wi", "wg", "wo")        # MoE expert stacks (E over 'data')


def axis_dim(spec, axis: str) -> Optional[int]:
    """The dim a spec splits over ``axis`` (None: whole over it)."""
    for d, ax in enumerate(spec):
        if ax == axis or (isinstance(ax, tuple) and axis in ax):
            return d
    return None


def layouts(model) -> dict:
    """The placements that differ from JAX's specs, by the module that
    owns the leaves: {module key: that module's ``param_segs``}, the KV
    heads' (``attention``) and Mamba2's head-aligned SSD leaves
    (``ssd``); ``sharding/serving.py``'s docstring says why."""
    from repro_torch.models import attention, ssd
    out = {"attn": attention.param_segs(model.cfg)}
    if model.cfg.ssm is not None:
        out["ssd"] = ssd.param_segs(model.cfg)
    return out


def fresh(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A contiguous copy of ``x`` on ``device`` that shares no storage."""
    out = torch.empty(x.shape, dtype=x.dtype, device=device)
    return out.copy_(x)


_BLOCK_BYTES = 64 << 20     # a host leaf crosses in blocks of this size


def place_parts(x: torch.Tensor, parts) -> List[torch.Tensor]:
    """A contiguous copy of ``x`` cut by each part's ops on the part's
    device; ``parts``: (device, ops), each op a (dim, function) that cuts
    that dim. A host tensor crosses each device once, in blocks of
    leading rows that every part on that device cuts there, so no device
    holds the whole leaf and no strided host slice is staged through a
    pageable copy; a part that cuts dim 0 takes its rows (a contiguous
    view) where ``x`` is and crosses alone."""
    out: List[Any] = [None] * len(parts)
    shared: Dict[torch.device, list] = {}
    for i, (dev, ops) in enumerate(parts):
        src, rest = x, []
        for dim, f in ops:
            if dim == 0:
                src = f(src)
            else:
                rest.append(f)
        if src.device.type != "cpu" or src.dim() == 0:
            t = src.to(dev)
            for f in rest:
                t = f(t)
            out[i] = fresh(t, dev)
        elif src is not x:
            out[i] = place_parts(src, [(dev, [(1, f) for f in rest])])[0]
        else:
            shared.setdefault(dev, []).append((i, rest))
    rows = max(1, _BLOCK_BYTES // max(1, x[0].numel() * x.element_size()))
    for dev, group in shared.items():
        for r0 in range(0, x.shape[0], rows):
            blk = x[r0:r0 + rows].to(dev, non_blocking=x.is_pinned())
            for i, fs in group:
                piece = blk
                for f in fs:
                    piece = f(piece)
                if out[i] is None:
                    out[i] = torch.empty((x.shape[0],) + tuple(
                        piece.shape[1:]), dtype=piece.dtype, device=dev)
                out[i][r0:r0 + rows].copy_(piece)
    return out


def map_leaves(fn, tree) -> Any:
    """``fn`` over the ``DataShards`` and other leaves of a nest."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v) for k, v in tree.items()}
    if is_namedtuple(tree):
        return type(tree)(*(map_leaves(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)) and not isinstance(tree, DataShards):
        return type(tree)(map_leaves(fn, v) for v in tree)
    return fn(tree)


def _in_layout(layout, P: int, view) -> bool:
    """A ``Shards`` view already lies in ``layout`` (dim, segments): the
    same segments, or an even split equal to them (one split segment of
    whole blocks per shard)."""
    dim, segs = layout
    if not isinstance(view, Shards) or view.dim != dim:
        return False
    return view.segs == segs or (len(segs) == 1 and segs[0][2]
                                 and segs[0][0] % P == 0)


class RowMesh:
    """Placement and per-row views of a tree on a ``(D, P)`` mesh
    (``launch.mesh.Mesh``) for ``model`` (the module docstring)."""

    def __init__(self, model, mesh):
        self.model, self.mesh = model, mesh
        self.D = int(mesh.shape["data"])
        self.P = int(mesh.shape["model"])
        self.leads = [row[0] for row in mesh.devices]
        self.layouts = layouts(model) if self.P > 1 else {}

    # ----- placement -----
    def place(self, tree, spec_tree, by_layout: bool = False) -> Any:
        """``tree`` (whole tensors, anywhere) on the mesh by ``spec_tree``
        (a ``NamedSharding`` or ``Spec`` per leaf). ``by_layout`` is
        serving's placement: the leaves ``layouts`` names are cut by their
        segments, a mesh of model extent 1 holds whole tensors (no
        one-part ``Shards``) and one of data extent 1 each leaf's one
        entry (no ``DataShards``). Raises if a module lacks a leaf its
        table names."""
        table = self.layouts if by_layout else {}
        seen: Dict[str, set] = {k: set() for k in table}

        def walk(t, sp, module, path):
            if isinstance(t, dict):
                out = {}
                for k, v in t.items():
                    if module is None and k in table:
                        out[k] = walk(v, sp[k], k, "")
                    else:
                        out[k] = walk(v, sp[k], module,
                                      f"{path}/{k}" if path else k)
                return out
            if is_namedtuple(t):
                return type(t)(*(walk(v, s, module, path)
                                 for v, s in zip(t, sp)))
            if isinstance(t, (list, tuple)):
                return type(t)(walk(v, s, module, path)
                               for v, s in zip(t, sp))
            if module is not None:
                seen[module].add(path)
            layout = None if module is None else table[module].get(path)
            return self._place_leaf(t, getattr(sp, "spec", sp), layout,
                                    by_layout)

        out = walk(tree, spec_tree, None, "")
        for k, paths in seen.items():
            missing = sorted(set(table[k]) - paths)
            if paths and missing:
                raise KeyError(f"{k}: no leaf {missing} to lay out")
        return out

    def _place_leaf(self, x, spec, layout, serving: bool = False) -> Any:
        one = serving and self.D == 1       # the entry alone
        if isinstance(x, QTensor):
            out = DataShards([QTensor(fresh(x.q, lead),
                                      fresh(x.scale, lead), x.bits)
                              for lead in self.leads])
            return out[0] if one else out
        if not isinstance(x, torch.Tensor):
            return x
        if x.dim() == 0:
            return fresh(x, self.leads[0])
        D, P, nd = self.D, self.P, x.dim()
        kd = None if one else axis_dim(spec, "data")
        km = None if serving and P == 1 else axis_dim(spec, "model")
        if layout is not None and kd is not None and kd - nd == layout[0]:
            layout = None               # the view re-cuts it
        n = 0 if kd is None else x.shape[kd] // D
        parts, entries = [], []
        for d, devs in enumerate(self.mesh.devices):
            ops = [] if kd is None else [(kd, functools.partial(
                torch.narrow, dim=kd, start=d * n, length=n))]
            if layout is not None:
                dim, segs = layout
                parts += [(dev, ops + [(nd + dim, functools.partial(
                    cut, dim=dim, segs=segs, s=m, P=P))])
                    for m, dev in enumerate(devs)]
            elif km is None:
                parts.append((devs[0], ops))
            else:
                w = x.shape[km] // P
                parts += [(dev, ops + [(km, functools.partial(
                    torch.narrow, dim=km, start=m * w, length=w))])
                    for m, dev in enumerate(devs)]
        placed = iter(place_parts(x, parts))
        for devs in self.mesh.devices:
            if layout is not None:
                entries.append(Shards([next(placed) for _ in devs],
                                      layout[0], layout[1]))
            elif km is None:
                entries.append(next(placed))
            else:
                entries.append(Shards([next(placed) for _ in devs],
                                      dim=km - nd,
                                      segs=((x.shape[km], 1, True),)))
        if one:
            return entries[0]
        return DataShards(entries, None if kd is None else kd - nd)

    # ----- per-row views -----
    def views(self, tree, rows: Optional[Sequence[int]] = None,
              local_experts: bool = False) -> List[Any]:
        """The views of a placed subtree (dicts of leaves) for ``rows``
        (default every row), in the layout the blocks compute with; with
        ``local_experts`` the MoE expert stacks cut over 'data' stay each
        row's own (only with every row)."""
        rows = list(range(self.D)) if rows is None else list(rows)
        return self._rows(tree, local_experts, None, "", False, rows)

    __call__ = views

    def _rows(self, tree, local_experts, table, path, in_moe, rows
              ) -> List[Any]:
        if isinstance(tree, dict):
            out: List[Dict[str, Any]] = [{} for _ in rows]
            for k, v in tree.items():
                if table is None and k in self.layouts:
                    sub = self._rows(v, local_experts, self.layouts[k], "",
                                     in_moe, rows)
                else:
                    sub = self._rows(v, local_experts, table,
                                     f"{path}/{k}" if path else k,
                                     in_moe or k == "moe", rows)
                for o, s in zip(out, sub):
                    o[k] = s
            return out
        keep = (local_experts and in_moe
                and path.rsplit("/", 1)[-1] in EXPERTS)
        layout = None if table is None else table.get(path)
        return self._leaf_rows(tree, layout, keep, rows)

    def _leaf_rows(self, x, layout, keep_local: bool, rows) -> List[Any]:
        if not isinstance(x, DataShards):
            return [x] * len(rows)
        views = ([x[d] for d in rows]
                 if x.dim is None or keep_local or self.D == 1
                 else self._gather(x, rows))
        if layout is None or _in_layout(layout, self.P, views[0]):
            return views
        dim, segs = layout
        out = []
        for d, v in zip(rows, views):
            whole = gather(v, self.leads[d])
            out.append(Shards([cut(whole.to(dev), dim, segs, m, self.P)
                               for m, dev in enumerate(self.mesh.devices[d])],
                              dim, segs))
        return out

    def _gather(self, x: DataShards, rows) -> List[Any]:
        if not isinstance(x[0], Shards):
            return gather_rows(list(x), [self.leads[d] for d in rows], x.dim)
        per_m = [gather_rows([e[m] for e in x],
                             [self.mesh.devices[d][m] for d in rows], x.dim,
                             lead=m == 0)
                 for m in range(self.P)]
        return [x[0].like([g[i] for g in per_m]) for i in range(len(rows))]

    def whole(self, x: DataShards) -> List[torch.Tensor]:
        """Each row's whole copy of a placed leaf, on its lead."""
        return [gather(v, lead) for v, lead in
                zip(self._leaf_rows(x, None, False, range(self.D)),
                    self.leads)]
