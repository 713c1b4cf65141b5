"""Decode-state specs and the placement of weights and state on a mesh
(counterpart of ``repro/sharding/serving.py``).

JAX places the weights under ``PartitionSpec``s and lets XLA insert the
collectives; torch has no GSPMD, so the port's layers make every split and
every reduction explicit (``models/model.py``). This module decides where
each tensor lives:

* a leaf whose spec names 'model' becomes a ``Shards``: one contiguous part
  per shard, on the shard's device (the verify and attention kernels
  assume dense row strides, so no part is a strided view);
* every other leaf lives once, on the mesh's lead device. JAX's
  "replicated per shard" runs the same computation P times; running it
  once is equivalent.

The LM head is held twice: its vocabulary slices on the shards
(``lm_head/vocab_shards``, the sharded verify's) and one whole copy on the
lead (``lm_head/w``) for the replicated readers — the exit gate's and the
tree gate's column reads, the logits that sampling and the draft's top-b
read. That copy is D·V·2 bytes in bf16 (262 MB at llama2-7b); gathering the
k·B gate columns from the owning shards instead would add a gather and a
copy to every step. An odd vocabulary, which JAX replicates and then pads
inside its verify, splits into uneven slices (the last narrower): a slice
needs no padding in torch, so the kernel verifies every slice and no
column is masked.

SpecEE's weights (draft, predictors, schedule mask) and a quantized bundle
stay whole on the lead, as JAX replicates its quantized tiles; JAX's
``specee_specs`` shards the draft layer, which the port runs once.

Serving places by ``param_specs``, the managers' ``partition_specs`` and
``decode_state_specs`` only. ``engine_shardings`` and the policies'
training layouts (``state_specs``, ``batch_specs``, ``fsdp_tp``, the 'pod'
axis, ``specee_specs``) are JAX's, held equal to it by the tests, and wait
for training under a mesh (ROADMAP "multi-GPU").
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.models.common import (_is_namedtuple, tree_map,
                                       with_contiguous_head)
from repro_torch.quant.core import QTensor
from repro_torch.sharding import policies as pol
from repro_torch.sharding.ctx import ShardCtx, Shards, gather

MULTI = "ROADMAP: multi-GPU"


def decode_state_specs(model, mesh, policy: str, state,
                       cache_mgr=None) -> Any:
    """Spec tree for a ``DecodeState``: the cache by its manager's layout
    (KV heads over 'model', bookkeeping replicated), else the generic
    ``cache_specs`` with the sequence split off; the draft cache,
    scheduler state, last token, last hidden and seed replicated."""
    from repro_torch.core import engine as eng
    if cache_mgr is not None:
        cache_spec = cache_mgr.partition_specs(state.cache, mesh, policy)
    else:
        cache_spec = pol.cache_specs(model, mesh, policy, state.cache,
                                     kv_seq_shard=False)
    rep = pol.replicated_specs
    return eng.DecodeState(
        cache=cache_spec, draft_cache=rep(state.draft_cache),
        sched=rep(state.sched), last_token=rep(state.last_token),
        h_last=rep(state.h_last), prng=pol.Spec())


def engine_shardings(model, mesh, policy: str, params, sw, qw
                     ) -> Tuple[Any, Optional[Any], Optional[Any]]:
    """``NamedSharding`` trees for (params, sw, qw): the Megatron roles
    for params, the draft sharded like a TP block and the predictors
    replicated for sw, and the quantized tiles replicated."""
    p_named = pol.named(mesh, pol.param_specs(model, mesh, policy, params))
    s_named = (pol.named(mesh, pol.specee_specs(model, mesh, policy, sw))
               if sw is not None else None)
    q_named = (pol.named(mesh, pol.replicated_specs(qw))
               if qw is not None else None)
    return p_named, s_named, q_named


def model_dim(spec) -> Optional[int]:
    """The dim a spec splits over 'model' (None: whole)."""
    for d, ax in enumerate(spec):
        if ax == "model" or (isinstance(ax, tuple) and "model" in ax):
            return d
    return None


_BLOCK_BYTES = 64 << 20     # a host tensor crosses in blocks of this size


def split_leaf(x: torch.Tensor, dim: int, shard: ShardCtx,
               widths=None) -> Shards:
    """``x`` cut along ``dim`` into one contiguous part per shard, each on
    its shard's device (``widths``: the parts' sizes, even by default).
    A host tensor split past its leading dim crosses to each distinct
    device once, in contiguous blocks of leading rows, and is cut there:
    a strided host slice would first be staged through a pageable copy."""
    n = x.shape[dim]
    if widths is None:
        widths = [n // shard.degree] * shard.degree
    starts = [sum(widths[:s]) for s in range(len(widths))]
    devices = shard.devices
    if x.device.type != "cpu" or dim == 0:
        parts = [x.narrow(dim, c0, w).to(dev).contiguous()
                 for c0, w, dev in zip(starts, widths, devices)]
        return Shards(parts, dim=dim - x.dim())
    parts = [torch.empty(x.shape[:dim] + (w,) + x.shape[dim + 1:],
                         dtype=x.dtype, device=dev)
             for w, dev in zip(widths, devices)]
    rows = max(1, _BLOCK_BYTES // max(1, x[0].numel() * x.element_size()))
    for dev in dict.fromkeys(devices):
        for r0 in range(0, x.shape[0], rows):
            block = x[r0:r0 + rows].to(dev, non_blocking=x.is_pinned())
            for part, c0, w, d in zip(parts, starts, widths, devices):
                if d == dev:
                    part[r0:r0 + rows].copy_(block.narrow(dim, c0, w))
    return Shards(parts, dim=dim - x.dim())


def vocab_widths(V: int, degree: int):
    """Slice widths of a V-column head over ``degree`` shards: ceil(V/P)
    each, the last what remains (JAX's padded width, without the pad)."""
    width = -(-V // degree)
    return [max(0, min(width, V - s * width)) for s in range(degree)]


def split_vocab(head: torch.Tensor, shard: ShardCtx) -> Shards:
    """The (D, V) head's vocabulary slices, one per shard."""
    widths = vocab_widths(head.shape[1], shard.degree)
    if min(widths) < 1:
        raise ValueError(f"vocabulary of {head.shape[1]} cannot give each "
                         f"of {shard.degree} shards a column")
    return split_leaf(head, 1, shard, widths)


def place(tree, spec_tree, shard: ShardCtx) -> Any:
    """Put ``tree`` on the mesh by ``spec_tree``: 'model'-split leaves
    become ``Shards``, the rest move to the lead device. Non-tensor leaves
    (ints, None) pass through."""
    if isinstance(tree, dict):
        return {k: place(v, spec_tree[k], shard) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(place(v, s, shard)
                            for v, s in zip(tree, spec_tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(place(v, s, shard)
                          for v, s in zip(tree, spec_tree))
    if isinstance(tree, QTensor):
        return QTensor(tree.q.to(shard.lead), tree.scale.to(shard.lead),
                       tree.bits)
    if not isinstance(tree, torch.Tensor):
        return tree
    dim = model_dim(spec_tree)
    if dim is None:
        return tree.to(shard.lead)
    return split_leaf(tree, dim, shard)


def to_host(tree) -> Any:
    """``tree`` with every tensor on the host: a tensor on a card is copied
    into page-locked memory, so each device copy later cut from it runs at
    the link's rate; a tensor already on the host stays as it is."""
    def move(x):
        if not isinstance(x, torch.Tensor) or x.device.type == "cpu":
            return x
        if x.device.type != "cuda":
            return x.to("cpu")
        return torch.empty(x.shape, dtype=x.dtype,
                           pin_memory=True).copy_(x)
    return tree_map(move, tree)


def unplace(tree, device) -> Any:
    """The whole-tensor layout of a placed tree, on ``device``: every
    ``Shards`` gathered (``ctx.gather``), every tensor moved."""
    if isinstance(tree, dict):
        return {k: unplace(v, device) for k, v in tree.items()}
    if isinstance(tree, Shards):
        return gather(tree, device)
    if _is_namedtuple(tree):
        return type(tree)(*(unplace(v, device) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(unplace(v, device) for v in tree)
    if isinstance(tree, QTensor):
        return QTensor(tree.q.to(device), tree.scale.to(device), tree.bits)
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def check_servable(model, mesh, policy: str) -> None:
    """Refuse, naming "multi-GPU", what this slice does not shard: a mesh
    over a MoE, SSD, RG-LRU or frontend model, ``DATA > 1``, the training
    policy, and a degree that does not divide the KV heads (JAX's ``_fit``
    would replicate wk/wv and split head_dim)."""
    from repro_torch.config import ATTN, LOCAL_ATTN
    cfg = model.cfg
    if policy not in ("tp_dp", "tp2d"):
        raise ValueError(f"policy={policy!r}: serving takes 'tp_dp' or "
                         f"'tp2d' (fsdp_tp is training's, {MULTI})")
    data = int(mesh.shape.get("data", 1))
    if data != 1:
        raise ValueError(
            f"mesh DATA must be 1 ({MULTI}): data parallelism is "
            "ReplicaPool (independent engines), not an in-engine mesh axis")
    P = int(mesh.shape["model"])
    kinds = {k for unit, _ in model.segments for k in unit}
    what = ("MoE" if cfg.moe is not None else
            "a frontend" if cfg.frontend != "none" else
            "an encoder" if not cfg.is_decoder() else
            None if kinds <= {ATTN, LOCAL_ATTN} else "SSD / RG-LRU blocks")
    if what is not None:
        raise ValueError(f"{cfg.name}: a mesh over {what} is not ported "
                         f"yet ({MULTI}); this slice shards the attention "
                         "family with a dense MLP")
    if cfg.num_kv_heads % P:
        raise ValueError(
            f"{cfg.name}: tensor-parallel degree {P} does not divide "
            f"{cfg.num_kv_heads} KV heads ({MULTI}: JAX would replicate "
            "wk/wv and split head_dim)")


def shard_params(params, sw, mesh, policy: str, model
                 ) -> Tuple[Any, Any]:
    """Each shard's slices of ``params`` on its device by the policy's
    specs (a tied head first gets its contiguous copy), the LM head's
    vocabulary slices beside its lead copy, and ``sw`` whole on the lead.
    Returns (params, sw); the inputs are not modified."""
    shard = ShardCtx.from_mesh(mesh)
    params = with_contiguous_head(params)
    specs = pol.param_specs(model, mesh, policy, params)
    head = params["lm_head"]["w"]
    out = place(dict(params, lm_head={}), dict(specs, lm_head={}), shard)
    out["lm_head"] = {"w": head.to(shard.lead),
                      "vocab_shards": split_vocab(head, shard)}
    return out, (None if sw is None else unplace(sw, shard.lead))
