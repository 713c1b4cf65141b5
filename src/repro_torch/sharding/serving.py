"""The placement of weights and decode state on a mesh, and what a mesh
serves (counterpart of ``repro/sharding/serving.py``).

JAX places the weights under ``PartitionSpec``s and lets XLA insert the
collectives; torch has no GSPMD, so the port's layers make every split and
every reduction explicit (``models/model.py``, ``moe.py``, ``ssd.py``,
``rglru.py``). This module decides where each tensor lives:

* a leaf whose spec names 'model' becomes a ``Shards``: one contiguous part
  per shard, on the shard's device (the verify and attention kernels
  assume dense row strides, so no part is a strided view);
* every other leaf lives once, on the mesh's lead device. JAX's
  "replicated per shard" runs the same computation P times; running it
  once is equivalent.

Two placements deliberately differ from JAX's specs (``param_specs`` and
the cache specs stay JAX's, held equal by the tests), because JAX lets
GSPMD regroup the data between ops and the port computes each shard's
heads whole, with no regrouping:

* Mamba2's ``in_proj`` (``ssd.param_segs``). JAX splits its output columns
  ``[z (di) | x (di) | B (ds) | C (ds) | dt (nh)]`` evenly, which does not
  fall on head boundaries (mamba2-130m at P = 2: 3352 columns, each half
  holding parts of z and x). The port gives shard s the z, x and dt
  columns of its ``nh / P`` heads and B and C whole (one group, read by
  every head), the conv's weights for the same channels (JAX replicates
  the conv), its heads' A, D, dt_bias and norm scale, and its heads'
  ``out_proj`` rows; the SSM state splits by heads and the conv window by
  those channels (``ssd.state_segs``). A degree that does not divide the
  heads is refused.
* KV heads fewer than the degree (P % KVH == 0, H % P == 0). JAX's
  ``_fit`` splits wk/wv's ``KVH·hd`` columns evenly, within a head, and
  its decode cache splits ``head_dim``. The port replicates whole KV
  heads: shard s holds its ``H / P`` query heads and KV head
  ``s·KVH / P`` whole (wk/wv columns and biases, ``attention.
  param_segs``; K/V cache entries, paged
  pools and int8 scales), so each shard's attention and the kernels are
  unchanged (``attention.shard_cfg`` gives one KV head a shard). The
  cost: each KV head and its cache are stored P / KVH times (at
  recurrentgemma-9b's one KV head and P = 4, four copies of its local
  attention's cache).

Each module states its own layout (``ssd.param_segs``,
``attention.param_segs``; ``_layouts`` keys them by the module that owns
the leaves). Every ``Shards`` carries segments (``sharding.ctx``; an even
split is one split segment) except the vocabulary's uneven slices, so
``unplace`` joins each back to the whole tensor.

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

Serving places the weights by ``param_specs`` and the two layouts above;
a decode state is placed like the session's own state (``place_like``:
a restored snapshot takes each leaf's layout from the state it replaces).
Training under a ``(D, P)`` mesh (``sharding/training.py``) stores the
weights by the ``fsdp_tp`` specs and gives each data row these same
layouts per forward. ``engine_shardings``, the managers'
``partition_specs``, the 'pod' axis and ``specee_specs`` are JAX's, held
equal to it by the tests, and wait for the dry-run slice (ROADMAP
"multi-GPU").
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.models.common import (_is_namedtuple, tree_map,
                                       with_contiguous_head)
from repro_torch.quant.core import QTensor
from repro_torch.sharding import policies as pol
from repro_torch.sharding.ctx import ShardCtx, Shards, cut, gather

MULTI = "ROADMAP: multi-GPU"


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
    its shard's device (``widths``: the parts' sizes, the vocabulary's
    uneven slices; even by default, then laid out as one split segment).
    A host tensor split past its leading dim crosses to each distinct
    device once, in contiguous blocks of leading rows, and is cut there:
    a strided host slice would first be staged through a pageable copy."""
    n = x.shape[dim]
    segs = None
    if widths is None:
        widths = [n // shard.degree] * shard.degree
        segs = ((n, 1, True),)
    starts = [sum(widths[:s]) for s in range(len(widths))]
    devices = shard.devices
    if x.device.type != "cpu" or dim == 0:
        parts = [x.narrow(dim, c0, w).to(dev).contiguous()
                 for c0, w, dev in zip(starts, widths, devices)]
        return Shards(parts, dim=dim - x.dim(), segs=segs)
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
    return Shards(parts, dim=dim - x.dim(), segs=segs)


def cut_leaf(x: torch.Tensor, dim: int, segs, shard: ShardCtx) -> Shards:
    """``x`` cut by ``segs`` along ``dim`` (from the end) into each shard's
    part on its device (``sharding.ctx.cut``); ``x`` crosses to each
    distinct device once."""
    on = {dev: x.to(dev) for dev in dict.fromkeys(shard.devices)}
    return Shards([cut(on[dev], dim, segs, s, shard.degree)
                   for s, dev in enumerate(shard.devices)], dim, segs)


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


def place(tree, spec_tree, shard: ShardCtx,
          layouts: Optional[dict] = None) -> Any:
    """Put ``tree`` on the mesh by ``spec_tree``: 'model'-split leaves
    become ``Shards``, the rest move to the lead device. ``layouts``
    ({module key: {leaf path in the module: (dim, segments)}},
    ``_layouts``) lays those leaves of each such module out by their
    segments instead of their specs. Non-tensor leaves (ints, None) pass
    through."""
    if isinstance(tree, dict):
        return {k: (_place_module(v, spec_tree[k], shard, layouts[k], k)
                    if layouts and k in layouts
                    else place(v, spec_tree[k], shard, layouts))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(place(v, s, shard, layouts)
                            for v, s in zip(tree, spec_tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(place(v, s, shard, layouts)
                          for v, s in zip(tree, spec_tree))
    return _place_leaf(tree, spec_tree, shard, None)


def _place_module(tree, spec_tree, shard: ShardCtx, table: dict,
                  name: str) -> Any:
    """``place`` of one module's params (nested dicts), the leaves that
    ``table`` names by their segments. Raises if the module lacks one of
    them, so a renamed leaf cannot fall back to its spec unseen."""
    seen = set()

    def walk(t, sp, path):
        if isinstance(t, dict):
            return {k: walk(v, sp[k], f"{path}/{k}" if path else k)
                    for k, v in t.items()}
        seen.add(path)
        return _place_leaf(t, sp, shard, table.get(path))

    out = walk(tree, spec_tree, "")
    missing = sorted(set(table) - seen)
    if missing:
        raise KeyError(f"{name}: no leaf {missing} to lay out")
    return out


def _place_leaf(x, spec, shard: ShardCtx, layout) -> Any:
    """One leaf: a quantized tensor whole on the lead, a tensor cut by its
    ``layout`` (dim, segments) or split by its spec, else as it is."""
    if isinstance(x, QTensor):
        return QTensor(x.q.to(shard.lead), x.scale.to(shard.lead), x.bits)
    if not isinstance(x, torch.Tensor):
        return x
    if layout is not None:
        return cut_leaf(x, *layout, shard)
    dim = model_dim(spec)
    if dim is None:
        return x.to(shard.lead)
    return split_leaf(x, dim, shard)


def place_like(tree, like, shard: ShardCtx) -> Any:
    """Put a whole-layout ``tree`` (a snapshot's decode state) on the mesh
    in the layout of ``like`` (the session's own state, of the same
    structure, whose ``Shards`` all carry segments: ``Model.
    empty_cache_entry``): where ``like`` holds a ``Shards``, the whole
    tensor is cut into its layout on its devices; every other tensor goes
    where ``like``'s does (the lead device)."""
    if isinstance(like, Shards) and isinstance(tree, torch.Tensor):
        return cut_leaf(tree, like.dim, like.segs, shard)
    if isinstance(tree, dict):
        return {k: place_like(v, like[k], shard) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(place_like(v, l, shard)
                            for v, l in zip(tree, like)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(place_like(v, l, shard)
                          for v, l in zip(tree, like))
    if isinstance(tree, torch.Tensor):
        return tree.to(like.device if isinstance(like, torch.Tensor)
                       else shard.lead)
    return tree


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
    """Refuse, naming "multi-GPU", what a ``(1, P)`` mesh does not serve:
    ``DATA > 1`` (so also tp2d's second dim over 'data'), the training
    policy ``fsdp_tp``, and the degrees ``check_degree`` refuses. Every
    family of ``configs.ARCHS`` is served: the attention family, MoE
    (both forms, ``moe_bf16_reduce`` too), SSD, the RG-LRU hybrid, the VLM
    frontend and the encoder."""
    if policy not in ("tp_dp", "tp2d"):
        raise ValueError(f"policy={policy!r}: serving takes 'tp_dp' or "
                         f"'tp2d' (fsdp_tp is training's, {MULTI})")
    data = int(mesh.shape.get("data", 1))
    if data != 1:
        raise ValueError(
            f"mesh DATA must be 1 ({MULTI}): data parallelism is "
            "ReplicaPool (independent engines), not an in-engine mesh axis")
    check_degree(model, int(mesh.shape["model"]))


def check_degree(model, P: int) -> None:
    """Refuse, naming "multi-GPU", a tensor-parallel degree the blocks
    cannot split: one that does not divide the query heads, or whose KV
    heads neither divide it nor are divided by it (minicpm-2b's 36 heads
    at P = 8), one that does not divide Mamba2's SSD heads or the RG-LRU
    width. Serving and training (``sharding/training.py``) share it."""
    from repro_torch.config import ATTN, LOCAL_ATTN, RGLRU, SSD
    cfg = model.cfg
    kinds = {k for unit, _ in model.segments for k in unit}
    H, KVH = cfg.num_heads, cfg.num_kv_heads
    if kinds & {ATTN, LOCAL_ATTN} and (H % P or (KVH % P and P % KVH)):
        raise ValueError(
            f"{cfg.name}: tensor-parallel degree {P} over {H} query heads "
            f"and {KVH} KV heads ({MULTI}): the degree must divide the "
            "query heads, and divide the KV heads or be a multiple of them")
    if SSD in kinds:
        from repro_torch.models.ssd import dims
        nh = dims(cfg)[1]
        if nh % P:
            raise ValueError(
                f"{cfg.name}: tensor-parallel degree {P} does not divide "
                f"the {nh} SSD heads ({MULTI}): each shard holds whole "
                "heads")
    if RGLRU in kinds:
        from repro_torch.models.rglru import lru_width
        if lru_width(cfg) % P:
            raise ValueError(
                f"{cfg.name}: tensor-parallel degree {P} does not divide "
                f"the RG-LRU width {lru_width(cfg)} ({MULTI})")


def _layouts(model) -> dict:
    """The placements that differ from JAX's specs (the module
    docstring), by the module that owns the leaves: {module key: that
    module's ``param_segs``}, the KV heads' (``attention``) and Mamba2's
    head-aligned SSD leaves (``ssd``)."""
    from repro_torch.models import attention, ssd
    out = {"attn": attention.param_segs(model.cfg)}
    if model.cfg.ssm is not None:
        out["ssd"] = ssd.param_segs(model.cfg)
    return out


def shard_params(params, sw, mesh, policy: str, model
                 ) -> Tuple[Any, Any]:
    """Each shard's slices of ``params`` on its device by the policy's
    specs and ``_layouts``' segments (a tied head first gets its
    contiguous copy), the LM head's vocabulary slices beside its lead
    copy, and ``sw`` whole on the lead. Returns (params, sw); the inputs
    are not modified."""
    shard = ShardCtx.from_mesh(mesh)
    params = with_contiguous_head(params)
    specs = pol.param_specs(model, mesh, policy, params)
    head = params["lm_head"]["w"]
    out = place(dict(params, lm_head={}), dict(specs, lm_head={}), shard,
                _layouts(model))
    out["lm_head"] = {"w": head.to(shard.lead),
                      "vocab_shards": split_vocab(head, shard)}
    return out, (None if sw is None else unplace(sw, shard.lead))
