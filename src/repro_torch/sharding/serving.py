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
``attention.param_segs``; ``rows.layouts`` keys them by the module that owns
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

Serving places the weights by ``param_specs`` and the two layouts above,
on every mesh through ``sharding.rows.RowMesh`` (``shard_params``), as
training does; a decode state is placed like the session's own state
(``place_like``: a restored snapshot takes each leaf's layout from the
state it replaces).

A ``(DATA, MODEL)`` mesh with DATA > 1 (every policy, ``tp_dp``,
``tp2d`` and ``fsdp_tp``) makes each leaf a ``DataShards`` of D
entries, cut over 'data' where its spec names it (tp2d's second matrix
dim, fsdp_tp's largest remaining dim, the MoE expert stacks under every
policy) and a copy per row otherwise, each entry in the ``(1, P)``
layout above on its row's devices. The model (``Model.with_rows``) splits
every block call's batch over the rows, each row gathering its view of
the unit's weights per call (``RowMesh.views``; under tp_dp without MoE
no leaf is cut over 'data', so nothing is gathered). Everything between
the units stays whole on the mesh lead, as JAX replicates the state
(``decode_state_specs``). The decode cache's batch is split over the rows
(``cache_specs``: a ``DataShards`` along the batch dim); where D does not
divide the batch, JAX's ``_fit`` keeps it whole and the port holds it on
row 0 alone, which then computes every row (JAX's copies are equal).
Three more placements then differ from JAX's:

* the LM head. JAX's spec cuts its D rows over 'data' under tp2d and
  fsdp_tp; every verify reads all D rows, and the gates, the verify and
  the draft run once, on the lead, so the port keeps the ``(1, P)``
  layout: the whole copy on the lead and the vocabulary slices on row
  0's model devices. The cost is the head's whole D·V·bytes on the lead
  beside its slices (1.05 GB in fp32 at llama2-70b's 8192 x 32000), where
  gathering it per step would move (D - 1) / D of that per row per step;
* the paged cache (JAX ``api/cache.py:297``): the pools split their
  KV-head dim over 'model' and are replicated over 'data', as JAX's
  ``partition_specs`` says, with one page allocator and one page table
  for every row; but each row writes only its own slots' K/V into its
  copy, so the copies differ in the pages of the other rows' slots.
  Whatever joins a pool (``unplace_cache``: a snapshot, a remesh's
  source) takes each page from the row that owns the slot that holds it.
  A paged cache's per-row entries (SSD, RG-LRU) split their batch over
  'data' as the dense cache's do (JAX's paged specs replicate them);
* a quantized bundle stays one copy on the lead, where its readers (the
  gates, the verify, the draft's top-k) run; JAX replicates it on every
  device.

``engine_shardings``, the managers' ``partition_specs``, the 'pod' axis
and ``specee_specs`` are JAX's, held equal to it by the tests.
"""
from __future__ import annotations

import functools
from typing import Any, Optional, Tuple

import torch

from repro_torch.models.common import (is_namedtuple, tree_map,
                                       with_contiguous_head)
from repro_torch.quant.core import QTensor
from repro_torch.sharding import policies as pol
from repro_torch.sharding.ctx import (DataShards, ShardCtx, Shards, cut,
                                     gather, join)
from repro_torch.sharding.rows import RowMesh, place_parts

MULTI = "ROADMAP: multi-GPU"
POLICIES = ("tp_dp", "tp2d", "fsdp_tp")


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


def split_leaf(x: torch.Tensor, dim: int, shard: ShardCtx,
               widths=None) -> Shards:
    """``x`` cut along ``dim`` into one contiguous part per shard, each on
    its shard's device (``widths``: the parts' sizes, the vocabulary's
    uneven slices; even by default, then laid out as one split segment).
    A host tensor crosses to each distinct device once, in blocks
    (``rows.place_parts``)."""
    n = x.shape[dim]
    segs = None
    if widths is None:
        widths = [n // shard.degree] * shard.degree
        segs = ((n, 1, True),)
    starts = [sum(widths[:s]) for s in range(len(widths))]
    parts = place_parts(x, [(dev, [(dim, functools.partial(
        torch.narrow, dim=dim, start=c0, length=w))])
        for c0, w, dev in zip(starts, widths, shard.devices)])
    return Shards(parts, dim=dim - x.dim(), segs=segs)


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


def place_like(tree, like, lead) -> Any:
    """Put a whole-layout ``tree`` (a snapshot's decode state) on the mesh
    in the layout of ``like`` (the session's own state, of the same
    structure, whose ``Shards`` all carry segments: ``Model.
    empty_cache_entry``): where ``like`` holds a ``Shards``, the whole
    tensor is cut into its layout on its parts' devices; where it holds a
    ``DataShards``, each row's entry takes its slice along ``dim`` (or the
    whole tensor, a paged pool's copy) in that entry's layout; every
    other tensor goes where ``like``'s does (else to ``lead``)."""
    if isinstance(like, DataShards) and isinstance(tree, torch.Tensor):
        n = 0 if like.dim is None else tree.shape[like.dim] // len(like)
        return like.like(
            place_like(tree if like.dim is None
                       else tree.narrow(like.dim, d * n, n), e, lead)
            for d, e in enumerate(like))
    if isinstance(like, Shards) and isinstance(tree, torch.Tensor):
        on = {p.device: tree.to(p.device) for p in like}
        return like.like(cut(on[p.device], like.dim, like.segs, s, len(like))
                         for s, p in enumerate(like))
    if isinstance(tree, dict):
        return {k: place_like(v, like[k], lead) for k, v in tree.items()}
    if is_namedtuple(tree):
        return type(tree)(*(place_like(v, l, lead)
                            for v, l in zip(tree, like)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(place_like(v, l, lead)
                          for v, l in zip(tree, like))
    if isinstance(tree, torch.Tensor):
        return tree.to(like.device if isinstance(like, torch.Tensor)
                       else lead)
    return tree


def to_host(tree) -> Any:
    """``tree`` with every tensor on the host: a tensor on a card is copied
    into page-locked memory, so each device copy later cut from it runs at
    the link's rate; a tensor already on the host stays as it is, and so
    does a meta tensor (the dry run's, ``launch/dryrun.py``: no data to
    copy)."""
    def move(x):
        if not isinstance(x, torch.Tensor) or x.device.type in ("cpu",
                                                                "meta"):
            return x
        if x.device.type != "cuda":
            return x.to("cpu")
        return torch.empty(x.shape, dtype=x.dtype,
                           pin_memory=True).copy_(x)
    return tree_map(move, tree)


def unplace(tree, device) -> Any:
    """The whole-tensor layout of a placed tree, on ``device``: every
    ``Shards`` gathered (``ctx.gather``), every ``DataShards`` joined
    (``ctx.join``: its rows' slices, or its first copy; a paged pool's
    copies are ``unplace_cache``'s), every tensor moved."""
    if isinstance(tree, dict):
        return {k: unplace(v, device) for k, v in tree.items()}
    if isinstance(tree, DataShards):
        return join(tree, device)
    if isinstance(tree, Shards):
        return gather(tree, device)
    if is_namedtuple(tree):
        return type(tree)(*(unplace(v, device) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(unplace(v, device) for v in tree)
    if isinstance(tree, QTensor):
        return QTensor(tree.q.to(device), tree.scale.to(device), tree.bits)
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def unplace_cache(cache, device) -> Any:
    """The whole-tensor layout of a placed decode cache, on ``device``.
    A paged cache's pools replicated over 'data' (``DataShards`` of
    copies, the module docstring) are joined page by page: each page
    from the row whose slots the page table gives it, every other page
    (free, or the trash page) from row 0's copy."""
    table = cache.get("page_table")
    if table is None:
        return unplace(cache, device)

    def leaf(x):
        if not (isinstance(x, DataShards) and x.dim is None and len(x) > 1):
            return unplace(x, device)
        whole = gather(x[0], device).clone()
        trash = whole.shape[1] - 1
        b = table.shape[0] // len(x)
        for d in range(1, len(x)):
            pages = table[d * b:(d + 1) * b].reshape(-1).long().to(device)
            pages = pages[pages != trash]
            if pages.numel():
                whole[:, pages] = gather(x[d], device)[:, pages]
        return whole

    segs = [{k: {n: leaf(x) for n, x in sub.items()}
             for k, sub in entry.items()} for entry in cache["segments"]]
    return dict(unplace(dict(cache, segments=[]), device), segments=segs)


def check_servable(model, mesh, policy: str) -> None:
    """Refuse what a mesh does not serve: a policy other than JAX's three
    (``tp_dp``, ``tp2d``, ``fsdp_tp``), and, naming "multi-GPU", the
    degrees ``check_degree`` refuses. Every ``(DATA, MODEL)`` mesh is
    served, DATA > 1 too, and every family of ``configs.ARCHS``: the
    attention family, MoE (both forms, ``moe_ep_quant`` and
    ``moe_bf16_reduce`` too), SSD, the RG-LRU hybrid, the VLM frontend and
    the encoder."""
    if policy not in POLICIES:
        raise ValueError(f"policy={policy!r}: serving takes one of "
                         f"{POLICIES}")
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


def shard_params(params, sw, mesh, policy: str, model
                 ) -> Tuple[Any, Any]:
    """The weights on ``mesh`` by the policy's specs (a tied head first
    gets its contiguous copy), through ``RowMesh.place``: each shard's
    slices on its device, laid out by ``rows.layouts``' segments; over
    DATA > 1 a ``DataShards`` per leaf (the module docstring). The LM head
    is held whole on the lead beside its vocabulary slices on row 0's
    model devices, and ``sw`` whole on the lead. Returns (params, sw); the
    inputs are not modified."""
    shard = ShardCtx.from_mesh(mesh)
    params = with_contiguous_head(params)
    specs = pol.param_specs(model, mesh, policy, params)
    head = params["lm_head"]["w"]
    rest, rest_specs = dict(params, lm_head={}), dict(specs, lm_head={})
    lead = mesh.devices[0][0]
    out = RowMesh(model, mesh).place(rest, rest_specs, by_layout=True)
    out["lm_head"] = {"w": head.to(lead)}
    if shard is not None:
        out["lm_head"]["vocab_shards"] = split_vocab(head, shard)
    return out, (None if sw is None else unplace(sw, lead))
