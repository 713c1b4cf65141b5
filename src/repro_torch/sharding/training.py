"""Training under a ``(DATA, MODEL)`` mesh at ``policy="fsdp_tp"`` (JAX
leaves this to ``jit(in_shardings=launch/specs.py::input_specs(...))``
over ``make_train_step``; torch has no GSPMD, so this module places the
trees and gives each data row its view of them).

Layout: JAX's specs (``policies.param_specs(model, mesh, "fsdp_tp",
params)``). Every tensor leaf becomes a ``DataShards`` of D entries. A
leaf whose spec names 'data' is cut along that dim (ZeRO-3: entry d holds
slice d); any other leaf is held once per row (a copy). Within an entry a
leaf whose spec names 'model' is a ``Shards``, JAX's even split over the
row's model devices; any other leaf sits on the row's lead device. So
device (d, m) holds what JAX's device (d, m) holds, except that a leaf
replicated over 'model' is held once per row, on its lead, as serving
holds it. AdamW's m and v and the gradient accumulators take the same
layout (``state_specs``: the parameter specs), since they are made leaf
by leaf from the placed params; a 0-d leaf (AdamW's step) stays one
tensor on row 0's lead.

Each row's view (``TrainMesh.__call__``), taken per unit inside the
forward: a leaf cut over 'data' is all-gathered over the rows
(``collectives.gather_rows``, whose backward reduce-scatters the
gradient: the sum over the rows); a copy is the row's own. The view is
then put in the layout the blocks compute with, serving's
(``serving._layouts``): wk/wv by whole KV heads where the degree exceeds
the KV heads, Mamba2's block by whole heads with B and C whole. Those
leaves are joined on the row's lead and cut by their segments inside the
autograd graph, so a block held by several shards gets the sum of its
copies' gradients. The LM head is joined whole on each row's lead
(``head``; a tied model's from the embedding, whose two readers' gradients
add), where that row's logits are computed. Under expert parallelism
(``local_experts``) expert stacks cut over 'data' are not gathered: each
row runs its own experts on every row's tokens (``moe.apply_moe_rows``).

The gradients come back in the placed layout. The copies' gradients (the
leaves replicated over 'data') are all-reduced over the rows
(``reduce_grads``), so each copy takes the same update and the copies stay
bit-equal; ``optim.adamw.global_norm`` counts one copy. ``unplace`` joins
a placed tree into whole tensors (``ctx.join``; the checkpoint manager
writes a placed tree so, JAX's layout of global arrays).

The batch (``split_batch``, JAX's ``batch_specs``): contiguous rows over
'data'. ``batch_specs`` also splits a sequence of 1024 tokens or more over
'model' (Megatron sequence parallelism); the port's TP blocks hold each
row's activations whole, which changes no number.

One process drives every row, one after another, as serving drives every
shard. Devices may repeat (``launch.mesh.make_host_mesh``): with every
slot on one card, ZeRO-3 saves no memory and the gathered copies add to
the peak.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from repro_torch.models.common import _is_namedtuple
from repro_torch.runtime.collectives import all_reduce_rows, gather_rows
from repro_torch.sharding import policies as pol
from repro_torch.sharding import serving
from repro_torch.sharding.ctx import (DataShards, Shards, cut, gather,
                                     join)

_EXPERTS = ("wi", "wg", "wo")       # MoE expert stacks (E over 'data')


def _axis_dim(spec, axis: str) -> Optional[int]:
    for d, ax in enumerate(spec):
        if ax == axis or (isinstance(ax, tuple) and axis in ax):
            return d
    return None


def _fresh(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A contiguous copy of ``x`` on ``device`` that shares no storage."""
    out = torch.empty(x.shape, dtype=x.dtype, device=device)
    return out.copy_(x)


def _map(fn, tree) -> Any:
    """``fn`` over the ``DataShards`` and other tensor leaves of a nest."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)) and not isinstance(tree, DataShards):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _even(layout, P: int, view) -> bool:
    """The segments ``layout`` cut a ``Shards`` view's dim as its even
    split does (one split segment of whole blocks per shard)."""
    dim, segs = layout
    return (isinstance(view, Shards) and view.dim == dim and len(segs) == 1
            and segs[0][2] and segs[0][0] % P == 0)


class TrainMesh:
    """Placement and per-row views of a training tree on a ``(D, P)``
    mesh (``launch.mesh.Mesh``) for ``model`` (the module docstring)."""

    def __init__(self, model, mesh):
        self.model, self.mesh = model, mesh
        self.D = int(mesh.shape["data"])
        self.P = int(mesh.shape["model"])
        serving.check_degree(model, self.P)
        self.leads = [row[0] for row in mesh.devices]
        self.layouts = serving._layouts(model) if self.P > 1 else {}

    def specs(self, params) -> Any:
        """JAX's ``fsdp_tp`` spec tree of ``params``."""
        return pol.param_specs(self.model, self.mesh, "fsdp_tp", params)

    # ----- placement -----
    def place(self, tree, spec_tree) -> Any:
        """``tree`` (whole tensors, anywhere) on the mesh by ``spec_tree``
        (a ``NamedSharding`` or ``Spec`` per leaf)."""
        if isinstance(tree, dict):
            return {k: self.place(v, spec_tree[k]) for k, v in tree.items()}
        if _is_namedtuple(tree):
            return type(tree)(*(self.place(v, s)
                                for v, s in zip(tree, spec_tree)))
        if isinstance(tree, (list, tuple)):
            return type(tree)(self.place(v, s)
                              for v, s in zip(tree, spec_tree))
        if not isinstance(tree, torch.Tensor):
            return tree
        spec = getattr(spec_tree, "spec", spec_tree)
        return self._place_leaf(tree, spec)

    def _place_leaf(self, x: torch.Tensor, spec) -> Any:
        if x.dim() == 0:
            return _fresh(x, self.leads[0])
        D, P, nd = self.D, self.P, x.dim()
        kd, km = _axis_dim(spec, "data"), serving.model_dim(spec)
        entries = []
        for d in range(D):
            piece = x
            if kd is not None:
                n = x.shape[kd] // D
                piece = x.narrow(kd, d * n, n)
            if km is None:
                entries.append(_fresh(piece, self.leads[d]))
                continue
            w = x.shape[km] // P
            entries.append(Shards(
                [_fresh(piece.narrow(km, m * w, w), dev)
                 for m, dev in enumerate(self.mesh.devices[d])],
                dim=km - nd, segs=((x.shape[km], 1, True),)))
        return DataShards(entries, None if kd is None else kd - nd)

    def unplace(self, tree, device) -> Any:
        """The whole tensors of a placed tree, on ``device``."""
        return _map(lambda x: join(x, device) if isinstance(x, DataShards)
                    else x.to(device) if isinstance(x, torch.Tensor) else x,
                    tree)

    def split_batch(self, batch: Dict[str, torch.Tensor]
                    ) -> List[Dict[str, torch.Tensor]]:
        """Row d's contiguous rows of every batch leaf, on its lead."""
        B = next(iter(batch.values())).shape[0]
        if B % self.D:
            raise ValueError(f"a batch of {B} rows does not split over "
                             f"{self.D} data rows")
        b = B // self.D
        return [{k: x[d * b:(d + 1) * b].to(self.leads[d])
                 for k, x in batch.items()} for d in range(self.D)]

    # ----- per-row views -----
    def __call__(self, tree, local_experts: bool = False) -> List[Any]:
        """Each row's view of a placed subtree (dicts of leaves), in the
        layout its blocks compute with; with ``local_experts`` the MoE
        expert stacks cut over 'data' stay each row's own."""
        return self._rows(tree, local_experts, None, "", False)

    def _rows(self, tree, local_experts, table, path, in_moe) -> List[Any]:
        if isinstance(tree, dict):
            out: List[Dict[str, Any]] = [{} for _ in range(self.D)]
            for k, v in tree.items():
                if table is None and k in self.layouts:
                    sub = self._rows(v, local_experts, self.layouts[k], "",
                                     in_moe)
                else:
                    sub = self._rows(v, local_experts, table,
                                     f"{path}/{k}" if path else k,
                                     in_moe or k == "moe")
                for o, s in zip(out, sub):
                    o[k] = s
            return out
        keep = (local_experts and in_moe
                and path.rsplit("/", 1)[-1] in _EXPERTS)
        layout = None if table is None else table.get(path)
        return self._leaf_rows(tree, layout, keep)

    def _leaf_rows(self, x, layout, keep_local: bool) -> List[Any]:
        if not isinstance(x, DataShards):
            return [x] * self.D
        views = (list(x) if x.dim is None or keep_local or self.D == 1
                 else self._gather(x))
        if layout is None or _even(layout, self.P, views[0]):
            return views
        dim, segs = layout
        out = []
        for d, v in enumerate(views):
            whole = gather(v, self.leads[d])
            out.append(Shards([cut(whole.to(dev), dim, segs, m, self.P)
                               for m, dev in enumerate(self.mesh.devices[d])],
                              dim, segs))
        return out

    def _gather(self, x: DataShards) -> List[Any]:
        if not isinstance(x[0], Shards):
            return gather_rows(list(x), self.leads, x.dim)
        per_m = [gather_rows([e[m] for e in x],
                             [row[m] for row in self.mesh.devices], x.dim)
                 for m in range(self.P)]
        return [x[0].like([g[d] for g in per_m]) for d in range(self.D)]

    def whole(self, x: DataShards) -> List[torch.Tensor]:
        """Each row's whole copy of a placed leaf, on its lead."""
        return [gather(v, lead) for v, lead in
                zip(self._leaf_rows(x, None, False), self.leads)]

    def head(self, params) -> List[Dict[str, Any]]:
        """Each row's final norm and whole LM head (``lm_head.w`` (D, V);
        a tied model's from its embedding)."""
        norms = self({"final_norm": params["final_norm"]})
        if "lm_head" in params:
            ws = self.whole(params["lm_head"]["w"])
        else:
            ws = [t.T for t in self.whole(params["embed"]["tok"])]
        return [dict(n, lm_head={"w": w}) for n, w in zip(norms, ws)]

    # ----- gradients -----
    def reduce_grads(self, grads) -> Any:
        """The placed gradient tree with each copy's gradient (leaves
        replicated over 'data') replaced by the sum over the rows."""
        def reduce(g):
            if not isinstance(g, DataShards) or g.dim is not None or \
                    self.D == 1:
                return g
            if not isinstance(g[0], Shards):
                return g.like(all_reduce_rows(list(g), [e.device for e in g]))
            per_m = [all_reduce_rows([e[m] for e in g],
                                     [e[m].device for e in g])
                     for m in range(len(g[0]))]
            return g.like([e.like([r[d] for r in per_m])
                           for d, e in enumerate(g)])
        with torch.no_grad():
            return _map(reduce, grads)


def mesh_of(param_pspec) -> Optional[Any]:
    """The mesh of a ``NamedSharding`` tree (``policies.named``), or None
    for a tree of bare specs or none."""
    meshes: List[Any] = []
    if param_pspec is not None:
        pol.map_with_paths(param_pspec, lambda _, s: meshes.append(
            getattr(s, "mesh", None)))
    return next((m for m in meshes if m is not None), None)
