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
(``rows.layouts``): wk/wv by whole KV heads where the degree exceeds
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
bit-equal; ``optim.adamw.global_norm`` counts one copy. ``unplace``
(``serving.unplace``) joins a placed tree into whole tensors (the
checkpoint manager writes a placed tree so, JAX's layout of global
arrays).

The batch (``split_batch``, JAX's ``batch_specs``): contiguous rows over
'data'. ``batch_specs`` also splits a sequence of 1024 tokens or more over
'model' (Megatron sequence parallelism); the port's TP blocks hold each
row's activations whole, which changes no number.

The placement and the views are ``sharding.rows.RowMesh``'s, which
serving's ``(D, P)`` engines share. One process drives every row, one
after another, as serving drives every shard. Devices may repeat
(``launch.mesh.make_host_mesh``): with every slot on one card, ZeRO-3
saves no memory and the gathered copies add to the peak.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from repro_torch.runtime.collectives import all_reduce_rows
from repro_torch.sharding import policies as pol
from repro_torch.sharding import serving
from repro_torch.sharding.ctx import DataShards, Shards
from repro_torch.sharding.rows import RowMesh, map_leaves


class TrainMesh(RowMesh):
    """Placement and per-row views of a training tree on a ``(D, P)``
    mesh (``launch.mesh.Mesh``) for ``model`` (the module docstring;
    ``sharding.rows.RowMesh`` places and gives the views)."""

    def __init__(self, model, mesh):
        super().__init__(model, mesh)
        serving.check_degree(model, self.P)

    def specs(self, params) -> Any:
        """JAX's ``fsdp_tp`` spec tree of ``params``."""
        return pol.param_specs(self.model, self.mesh, "fsdp_tp", params)

    unplace = staticmethod(serving.unplace)   # whole tensors on a device

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
                                     [e[m].device for e in g], lead=m == 0)
                     for m in range(len(g[0]))]
            return g.like([e.like([r[d] for r in per_m])
                           for d, e in enumerate(g)])
        with torch.no_grad():
            return map_leaves(reduce, grads)


def mesh_of(param_pspec) -> Optional[Any]:
    """The mesh of a ``NamedSharding`` tree (``policies.named``), or None
    for a tree of bare specs or none."""
    meshes: List[Any] = []
    if param_pspec is not None:
        pol.map_with_paths(param_pspec, lambda _, s: meshes.append(
            getattr(s, "mesh", None)))
    return next((m for m in meshes if m is not None), None)
