"""Model API over the model zoo (counterpart of ``repro/models/model.py``):
attention stacks with a dense MLP or a MoE FFN, Mamba2, the RG-LRU hybrid,
and the vision and audio frontends.

The layer stack decomposes into segments — runs of a repeating unit of
block kinds — and parameters and caches are stacked over each segment's
repeat count exactly as in the JAX package: ``params["segments"][si]`` and
``cache["segments"][si]`` hold ``u{i}`` entries whose leaves have a leading
(reps,) dim. Exit points sit at unit boundaries.

The KV cache is written IN PLACE (``index_put_`` on views of the stacked
tensors) where the JAX package returns updated copies; every function that
writes returns the cache it was given, so call sites read like the JAX ones.
A cache is dense ``(reps, B, S, KVH, hd)`` or, when the caller passes the
session's ``pages`` table, a paged pool ``(reps, n_pages, page_size, KVH,
hd)`` read and written through ``core.paged``. Under ``ModelFlags.kv_quant``
an entry holds int8 codes ``k``/``v`` of that shape beside fp32 scales
``ks``/``vs`` without the ``hd`` dim (one per position and KV head). An
SSD (Mamba2) entry is per-row state, never paged: the fp32 SSM state
``(reps, B, nh, hd, ds)`` and the conv window ``(reps, B, K-1, di+2ds)``
in the compute dtype, both updated in place; so is an RG-LRU entry: the
fp32 recurrent state ``h`` ``(reps, B, W)`` and the conv window ``(reps,
B, K-1, W)``.

Tensor parallelism (a mesh, ``sharding/``): the params of a sharded model
hold ``Shards`` leaves by the Megatron roles (``sharding/serving.py``) and
every split and reduction is explicit, in one process. Per shard, the
column-parallel wq/wk/wv (and their biases) and mlp wi/wg, and attention
over the shard's KV heads (``attention.shard_cfg``; one KV head, held by
several shards, where the degree exceeds the KV heads); then the
row-parallel wo and mlp-down partials go through ``all_reduce_sum`` onto
the lead device, and a row-parallel bias is added once, after the reduce.
The MoE FFN, the SSD block and the RG-LRU block shard inside their modules
(``moe.py``, ``ssd.py``, ``rglru.py``). The vocab-parallel embedding is a
masked lookup plus a reduce (exact: one shard owns each id). The residual
stream, the norms, a frontend's projection and everything between the
blocks stay whole on the lead. A sharded model (``with_shard``) builds its
cache entries as ``Shards`` in each leaf's shard layout (``_entry_segs``:
KV heads; SSD heads and conv channels; RG-LRU W slices); paged pools split
the same way, the page table and lengths stay on the lead.

Training under a ``(DATA, MODEL)`` mesh (``train_loss_rows``,
``sharding/training.py``): each data row runs these same blocks on its
rows of the batch, over its own TP group of ``Shards``; MoE's experts run
over every row's tokens (``moe.apply_moe_rows``); the loss is the whole
batch's.

Serving under a ``(DATA, MODEL)`` mesh with DATA > 1 (``with_rows``):
every decode, tree, propagation, chunk and prefill call of a unit splits
its batch over the data rows (``_unit``), the groups following the cache
(its batch split over the rows, or whole on row 0). Row d runs the same
``(1, P)`` blocks on its rows, its cache entry (a paged pool: its copy,
its slots' page-table rows) and its view of the unit's weights, gathered
over 'data' for the call; a MoE FFN runs its experts over every row's
tokens (``_ffn_rows``: expert parallelism where the stacks are cut over
'data'). The rows' hiddens join on the mesh lead after the unit, so the
residual stream between units, the gates, the draft and the verify stay
whole there. SSD and RG-LRU states split their batch like the KV cache;
a frontend's patches or frames are split by row in prefill. Every loop
over the rows runs through ``collectives.each_row``, so one device's
'model' collectives (``collectives.PER_DEVICE``) are row 0's; a TP
layer's input counts its gradient's all-reduce
(``collectives.count_backward_reduce``).
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.config import (ATTN, LOCAL_ATTN, RGLRU, SSD, ModelConfig,
                                RGLRUConfig, RunConfig, SSMConfig)
from repro_torch.core import paged as paged_lib
from repro_torch.models import attention as attn_lib
from repro_torch.models import common, frontends
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import ssd as ssd_lib
from repro_torch.models.common import Params, index_tree
from repro_torch.runtime.collectives import (all_reduce_rows, all_reduce_sum,
                                             count_backward_reduce, each_row)
from repro_torch.sharding.ctx import (DataShards, Shards, ShardCtx, local,
                                     part_size, parts)


def segments_of(blocks: Sequence[str], max_unit: int = 4
                ) -> List[Tuple[Tuple[str, ...], int]]:
    """Greedy decomposition of a block pattern into (unit, repeat) segments."""
    blocks = list(blocks)
    segs: List[Tuple[Tuple[str, ...], int]] = []
    i, n = 0, len(blocks)
    while i < n:
        best_unit, best_cov = (blocks[i],), 1
        for ul in range(1, max_unit + 1):
            if i + ul > n:
                break
            unit = blocks[i:i + ul]
            reps = 1
            while (i + (reps + 1) * ul <= n and
                   blocks[i + reps * ul: i + (reps + 1) * ul] == unit):
                reps += 1
            cov = reps * ul
            if cov > best_cov:
                best_unit, best_cov = tuple(unit), cov
        segs.append((best_unit, best_cov // len(best_unit)))
        i += best_cov
    return segs


@dataclass(frozen=True)
class ModelFlags:
    """Kernel selection and the KV cache's storage (the subset of
    ``repro``'s flags the port reads). ``kv_quant`` stores K/V as int8
    codes with a per-(position, KV head) fp32 scale (``_kv_quantize``);
    attention reads them dequantized: the paged kernel in registers, every
    other path as a dequantized copy in the compute dtype. ``moe_impl``
    picks the MoE form: "dense" (every expert, JAX's default) or "topk"
    (only the selected experts). JAX's mesh flags, with its names and
    defaults: ``moe_ep_quant`` quantizes each token to int8 before the
    dense form's expert-parallel gather, only where ``act_batch_axes``
    is set (JAX applies it only then, so also on a ``(1, 1)`` mesh);
    ``moe_bf16_reduce`` rounds the dense form's E/F contraction to bf16
    wherever it runs, serving included; ``matmul_bf16_reduce`` rounds the
    sequence path's row-parallel attention ``out_proj`` and MLP-down to
    bf16 (training and prefill). ``act_batch_axes`` / ``act_batch_extent``
    are otherwise sharding hints with no effect on the numbers. JAX's
    lowering hints ``act_seq_shard`` (pin the residual's sequence dim over
    'model' at unit boundaries), ``act_pin_full`` (pin it to
    ``P(batch, None, None)``) and ``unroll`` (Python-loop layers instead
    of ``lax.scan``) are kept, with JAX's names and defaults, only so that
    code written against JAX's ``ModelFlags`` (the dry run's flags,
    ``launch/dryrun.py``) runs unchanged; they change no number and no
    placement: the single controller places every leaf itself and keeps
    the residual whole on the lead, and the layer loop is already
    Python."""
    moe_impl: str = "dense"         # "dense" | "topk"
    moe_ep_quant: bool = False      # int8 EP token dispatch
    moe_bf16_reduce: bool = False   # bf16 E/F contraction of the dense form
    matmul_bf16_reduce: bool = False  # row-parallel seq projections in bf16
    act_batch_axes: Any = None      # mesh axes of the batch ("data")
    act_batch_extent: int = 1       # their extent
    act_seq_shard: bool = False     # lowering hint (no effect here)
    act_pin_full: bool = False      # lowering hint (no effect here)
    unroll: bool = False            # lowering hint (no effect here)
    flash_attention: bool = False   # CUDA flash-attention prefill kernel
    decode_kernel: bool = False     # CUDA (paged) decode-attention kernel
    spec_head_kernel: bool = False  # spec-head kernel: tree gate features;
    #                                 AR gate features under impl "ref"
    exit_gate_kernel: bool = False  # fused exit gate + streaming verify
    exit_gate_impl: str = "auto"    # "auto" | "kernel" | "ref"
    kv_quant: bool = False          # int8 K/V cache with fp32 scales
    ssd_kernel: bool = False        # CUDA SSD intra-chunk kernel: Mamba2
    #                                 prefill's diagonal-block term
    remat: str = "none"             # "none" | "full": recompute each unit
    #                                 in the backward pass (training)
    ce_chunk: int = 512             # sequence chunk of the chunked CE loss
    chunk_threshold: int = 2048     # chunked exact attention above this
    #                                 prompt length (without flash)
    chunk_size: int = 512           # query chunk of chunked attention
    attn_prune: bool = False        # chunked attention that skips the key
    #                                 chunks above the causal diagonal


def _window(cfg: ModelConfig, kind: str) -> Optional[int]:
    if kind == LOCAL_ATTN:
        return cfg.rglru.window if cfg.rglru else 2048
    return None


def _shard_views(cfg: ModelConfig, p: Params, x: torch.Tensor):
    """(shard index, config, params, x) for each shard of a TP block part
    ``p`` (attention or MLP), ``x`` moved to the shard's device; one
    ``(None, cfg, p, x)`` when ``p`` is not sharded."""
    w = next(iter(p.values()))["w"]
    if not isinstance(w, Shards):
        yield None, cfg, p, x
        return
    cl = attn_lib.shard_cfg(cfg, len(w))
    if len(w) > 1:
        count_backward_reduce(x)
    for s, part in enumerate(w):
        yield s, cl, local(p, s), x.to(part.device)


def _row_parallel(partials, p_out: Params, dst: torch.device,
                  dtype: torch.dtype, pet: Optional[torch.dtype] = None
                  ) -> torch.Tensor:
    """The row-parallel layer's partials reduced onto ``dst``, then its
    bias added once (``apply_linear``'s order: matmul, then bias). Under
    ``pet`` each partial is rounded to it and the sum adds in it (GSPMD's
    psum in the product's dtype), then returns to ``dtype``."""
    if pet is not None:
        partials = [x.to(pet) for x in partials]
    y = all_reduce_sum(partials, dst).to(dtype)
    b = p_out.get("b")
    return y if b is None else y + b.to(y.dtype)


def _attention(cfg: ModelConfig, p_attn: Params, x: torch.Tensor, core,
               pet: Optional[torch.dtype] = None):
    """``out_proj(core(...))`` of an attention block, per shard under TP.
    ``core(cfg, params, shard index, x) -> (o (B, S, H, hd), extra)`` runs
    the block's attention on one shard's heads (index None unsharded).
    ``pet``: ``out_proj``'s product dtype (``_row_parallel``). Returns
    (out (B, S, D) on x's device, extra — a list per shard under TP)."""
    partials, extras = [], []
    for s, c, pa, xs in _shard_views(cfg, p_attn, x):
        o, extra = core(c, pa, s, xs)
        if s is None:
            return attn_lib.out_proj(pa, o, pet), extra
        partials.append(attn_lib.out_proj({"wo": {"w": pa["wo"]["w"]}}, o,
                                          pet))
        extras.append(extra)
    return (_row_parallel(partials, p_attn["wo"], x.device, x.dtype, pet),
            extras)


def _mlp(cfg: ModelConfig, p: Params, x: torch.Tensor,
         pet: Optional[torch.dtype] = None) -> torch.Tensor:
    """``common.apply_mlp``, per shard under TP (a d_ff that the degree
    does not divide stays whole, as JAX's ``_fit`` replicates it); ``pet``
    as ``_attention``'s."""
    partials = []
    for s, c, pm, xs in _shard_views(cfg, p, x):
        if s is None:
            return common.apply_mlp(cfg, pm, xs, pet)
        partials.append(common.apply_mlp(
            cfg, dict(pm, wo={"w": pm["wo"]["w"]}), xs, pet))
    return _row_parallel(partials, p["wo"], x.device, x.dtype, pet)


def _init_block(cfg: ModelConfig, kind: str, gen, dtype, device) -> Params:
    def norm():
        return common.init_norm(cfg, cfg.d_model, dtype, device)

    if kind == SSD:
        return {"ln": norm(), "ssd": ssd_lib.init_ssd(cfg, gen, dtype,
                                                      device)}
    if kind == RGLRU:
        return {"ln1": norm(),
                "rec": rglru_lib.init_rglru(cfg, gen, dtype, device),
                "ln2": norm(),
                "mlp": common.init_mlp(cfg, gen, dtype, device)}
    assert kind in (ATTN, LOCAL_ATTN), kind
    p: Params = {"ln1": norm(),
                 "attn": attn_lib.init_attention(cfg, gen, dtype, device),
                 "ln2": norm()}
    if cfg.moe is not None:
        p["moe"] = moe_lib.init_moe(cfg, gen, dtype, device)
    else:
        p["mlp"] = common.init_mlp(cfg, gen, dtype, device)
    return p


def _ep_quant(flags: "ModelFlags") -> bool:
    """JAX quantizes the EP tokens only where the batch axes are set."""
    return flags.moe_ep_quant and flags.act_batch_axes is not None


def _kv_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(position, head) symmetric int8: x (..., hd) -> (codes int8,
    scale fp32 (...)), bit-equal to JAX's (``torch.round`` rounds half to
    even as ``jnp.round`` does)."""
    xf = x.float()
    scale = (xf.abs().amax(dim=-1) + 1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _kv_dequantize(q: torch.Tensor, scale: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
    return (q.float() * scale[..., None].float()).to(dtype)


def _kv_vals(k: torch.Tensor, v: torch.Tensor, kv_quant: bool
             ) -> Dict[str, torch.Tensor]:
    """The cache leaves that store K/V: as they are, or as codes and
    scales under ``kv_quant``."""
    if not kv_quant:
        return {"k": k, "v": v}
    kq, ks = _kv_quantize(k)
    vq, vs = _kv_quantize(v)
    return {"k": kq, "v": vq, "ks": ks, "vs": vs}


def _entry_write_token(cache_entry: Any, vals: Dict[str, torch.Tensor],
                       pages: Optional[torch.Tensor], rows: torch.Tensor,
                       pvec: torch.Tensor) -> Any:
    """Write one token's K/V into a cache entry, in place (the JAX
    package's ``.at[...].set`` makes a copy). The ONE place the dense
    row-scatter vs paged table-scatter choice is made for single-token
    writes: the decode step and skipped-layer propagation share it."""
    for name, v in vals.items():
        if pages is None:
            cache_entry[name][rows, pvec] = v.to(cache_entry[name].dtype)
        else:
            paged_lib.scatter_token(cache_entry[name], pages, pvec, v)
    return cache_entry


def _block_seq(cfg: ModelConfig, kind: str, p: Params, h: torch.Tensor,
               positions: torch.Tensor, flags: ModelFlags
               ) -> Tuple[torch.Tensor, Any, torch.Tensor]:
    """Prefill and training path. Returns (h_out, cache entry, aux loss):
    {"k", "v"} for attention, under ``flags.flash_attention`` (causal only,
    as in the JAX package: the encoder takes plain attention) through the
    flash kernel, else above ``flags.chunk_threshold`` tokens through
    chunked attention (pruned under ``flags.attn_prune``); the MoE's
    load-balancing loss as aux. {"state", "conv"} for SSD, under
    ``flags.ssd_kernel`` with the intra-chunk term through the SSD kernel,
    and {"h", "conv"} for RG-LRU ("conv" is None for a prompt shorter than
    the conv window, as in the JAX package)."""
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if kind == SSD:
        x = common.apply_norm(cfg, p["ln"], h)
        out, state, conv_tail = ssd_lib.ssd_block_seq(
            cfg, p["ssd"], x, use_kernel=flags.ssd_kernel)
        return h + out, {"state": state, "conv": conv_tail}, aux
    if kind == RGLRU:
        x = common.apply_norm(cfg, p["ln1"], h)
        out, h_rec, conv_tail = rglru_lib.rglru_block_seq(cfg, p["rec"], x)
        h = h + out
        x2 = common.apply_norm(cfg, p["ln2"], h)
        h = h + _mlp(cfg, p["mlp"], x2)
        return h, {"h": h_rec, "conv": conv_tail}, aux
    h, kv, x2, pet = _attn_seq(cfg, kind, p, h, positions, flags)
    (f,), aux = _ffn_rows(cfg, [p], [x2], flags, pet)
    return h + f, kv, aux


def _attn_seq(cfg: ModelConfig, kind: str, p: Params, h: torch.Tensor,
              positions: torch.Tensor, flags: ModelFlags):
    """The attention half of ``_block_seq``: (h + attention, its cache
    entry, the FFN's normed input, the row-parallel product dtype)."""
    x = common.apply_norm(cfg, p["ln1"], h)
    window = _window(cfg, kind)
    pet = torch.bfloat16 if flags.matmul_bf16_reduce else None

    def core(c, pa, s, xs):
        q, k, v = attn_lib.qkv(c, pa, xs, positions.to(xs.device))
        if flags.flash_attention and c.causal:
            from repro_torch.kernels.flash_attention import ops as fa_ops
            o = fa_ops.flash_attention(q, k, v, causal=True, window=window)
        elif xs.shape[1] > flags.chunk_threshold:
            if flags.attn_prune and c.causal:
                o = attn_lib.attend_full_chunked_pruned(
                    c, q, k, v, window, chunk=flags.chunk_size)
            else:
                o = attn_lib.attend_full_chunked(c, q, k, v, window,
                                                 chunk=flags.chunk_size)
        else:
            o = attn_lib.attend_full(c, q, k, v, window)
        return o, (k, v)

    out, kv = _attention(cfg, p["attn"], x, core, pet)
    h = h + out
    if isinstance(kv, list):        # per shard: its KV heads
        segs = attn_lib.kv_segs(cfg)
        kv = (Shards([k for k, _ in kv], -2, segs),
              Shards([v for _, v in kv], -2, segs))
    x2 = common.apply_norm(cfg, p["ln2"], h)
    return h, {"k": kv[0], "v": kv[1]}, x2, pet


def _ffn_rows(cfg: ModelConfig, ps: Sequence[Params],
              xs: Sequence[torch.Tensor], flags: ModelFlags,
              pet: Optional[torch.dtype] = None
              ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """The attention block's FFN over the data rows (``ps[d]``, ``xs[d]``:
    row d's params and normed inputs): a dense MLP per row, a MoE over
    every row's tokens (``moe.apply_moe_rows``: the experts each row holds
    run on all rows' tokens; ``apply_moe_topk_rows``). Returns (each row's
    out, the aux loss on row 0's device)."""
    if "moe" not in ps[0]:
        return ([_mlp(cfg, p["mlp"], x, pet)
                 for p, x in each_row(zip(ps, xs))],
                torch.zeros((), dtype=torch.float32, device=xs[0].device))
    moes = [p["moe"] for p in ps]
    if flags.moe_impl == "dense":
        return moe_lib.apply_moe_rows(cfg, moes, xs,
                                      ep_quant=_ep_quant(flags),
                                      bf16_reduce=flags.moe_bf16_reduce)
    return moe_lib.apply_moe_topk_rows(cfg, moes, xs)


def _block_seq_rows(cfg: ModelConfig, kind: str, ps: Sequence[Params],
                    hs: Sequence[torch.Tensor],
                    positions: Sequence[torch.Tensor], flags: ModelFlags
                    ) -> Tuple[List[torch.Tensor], List[Any], torch.Tensor]:
    """``_block_seq`` over the data rows of a mesh (``ps[d]``, ``hs[d]``:
    row d's params and hiddens): each row alone, except a MoE FFN over
    more than one row, whose experts run over every row's tokens
    (``_ffn_rows``) and whose aux loss is the whole batch's. Returns (each
    row's h, each row's cache entry, aux loss on row 0's device)."""
    if len(hs) == 1 or "moe" not in ps[0]:
        outs = [_block_seq(cfg, kind, p, h, pos, flags)
                for p, h, pos in each_row(zip(ps, hs, positions))]
        return [o[0] for o in outs], [o[1] for o in outs], outs[0][2]
    mids = [_attn_seq(cfg, kind, p, h, pos, flags)
            for p, h, pos in each_row(zip(ps, hs, positions))]
    fs, aux = _ffn_rows(cfg, ps, [m[2] for m in mids], flags)
    return [m[0] + f for m, f in zip(mids, fs)], [m[1] for m in mids], aux


def _recurrent_step(cfg: ModelConfig, kind: str, p: Params,
                    h: torch.Tensor, cache_entry: Any,
                    live_mask: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """One decode token of an SSD or RG-LRU block. h: (B, D). The recurrent
    update of the entry's state and conv window, in place; ``live_mask``
    (B,) bool keeps the state of rows that have exited (SpecEE) while
    their conv window still advances, as in the JAX package. Returns the
    block's output hiddens."""
    name = "state" if kind == SSD else "h"
    x = common.apply_norm(cfg, p["ln" if kind == SSD else "ln1"], h)
    step = (ssd_lib.ssd_block_step if kind == SSD
            else rglru_lib.rglru_block_step)
    out, new_state, new_conv = step(
        cfg, p["ssd" if kind == SSD else "rec"], x, cache_entry[name],
        cache_entry["conv"])
    for st, ns, cv, nc in zip(parts(cache_entry[name]), parts(new_state),
                              parts(cache_entry["conv"]), parts(new_conv)):
        if live_mask is not None:
            keep = live_mask.to(ns.device).reshape(
                (-1,) + (1,) * (ns.dim() - 1))
            ns = torch.where(keep, ns, st)
        st.copy_(ns)
        cv.copy_(nc)
    h = h + out
    if kind == SSD:
        return h
    x2 = common.apply_norm(cfg, p["ln2"], h)
    return h + _mlp(cfg, p["mlp"], x2)


def _attn_step(cfg: ModelConfig, kind: str, p: Params, h: torch.Tensor,
               cache_entry: Any, pos: torch.Tensor, flags: ModelFlags,
               pages: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The attention half of one decode token. h: (B, D); pos: (B,) index
    of the current token. Writes the token's K/V into ``cache_entry`` and
    attends the live prefix. ``pages``: the (B, P) page table when the
    entry is a page pool; then ``flags.decode_kernel`` selects the paged
    kernel, which reads the pool directly, and otherwise the logical view
    is gathered for the plain attention. Dense entries take the dense
    kernel under the flag. Under ``kv_quant`` the token's codes and scales
    are written; the paged kernel dequantizes in registers, every other
    path attends the dequantized view in ``h``'s dtype (as the JAX package
    does; there is no dense int8 kernel). Returns (h + attention, the
    FFN's normed input (B, 1, D))."""
    B = h.shape[0]
    x = common.apply_norm(cfg, p["ln1"], h)[:, None, :]
    window = _window(cfg, kind)

    def core(c, pa, s, xs):
        dev = xs.device
        ce = local(cache_entry, s)
        pg = None if pages is None else pages.to(dev)
        pv = pos.to(dev)
        pvec = pv.long()
        rows = torch.arange(B, device=dev)
        q, k, v = attn_lib.qkv(c, pa, xs, pvec[:, None])
        _entry_write_token(ce, _kv_vals(k[:, 0], v[:, 0], flags.kv_quant),
                           pg, rows, pvec)
        if pg is not None and flags.decode_kernel:
            from repro_torch.kernels.decode_attention import ops as da_ops
            return da_ops.paged_decode_attention(
                c, q, ce["k"], ce["v"], pg, pv + 1, window=window,
                k_scale=ce.get("ks"), v_scale=ce.get("vs")), None
        if pg is None:
            view = ce
        else:
            view = {name: paged_lib.gather_view(pool, pg)
                    for name, pool in ce.items()}
        if flags.kv_quant:
            k_cache = _kv_dequantize(view["k"], view["ks"], h.dtype)
            v_cache = _kv_dequantize(view["v"], view["vs"], h.dtype)
        else:
            k_cache, v_cache = view["k"], view["v"]
        if pg is None and flags.decode_kernel:
            from repro_torch.kernels.decode_attention import ops as da_ops
            return da_ops.decode_attention(c, q, k_cache, v_cache, pv + 1,
                                           window=window), None
        return attn_lib.attend_decode(c, q, k_cache, v_cache, pv + 1,
                                      window), None

    h = h + _attention(cfg, p["attn"], x, core)[0][:, 0, :]
    return h, common.apply_norm(cfg, p["ln2"], h[:, None, :])


def _block_step(cfg: ModelConfig, kind: str, ps: Sequence[Params],
                hs: Sequence[torch.Tensor], ces: Sequence[Any],
                poss: Sequence[torch.Tensor], flags: ModelFlags,
                pages: Sequence[Optional[torch.Tensor]],
                lives: Sequence[Optional[torch.Tensor]]
                ) -> List[torch.Tensor]:
    """One decode token of a block over the data rows (each row's params,
    hiddens (B_d, D), cache entry, positions, page-table rows and live
    mask; one row unsharded): a recurrent block row by row
    (``_recurrent_step``), an attention block's attention row by row
    (``_attn_step``) and its FFN after (``_ffn_after``: a MoE over every
    row's tokens). Returns each row's hiddens."""
    if kind in (SSD, RGLRU):
        return [_recurrent_step(cfg, kind, p, h, ce, lm)
                for p, h, ce, lm in each_row(zip(ps, hs, ces, lives))]
    mids = [_attn_step(cfg, kind, p, h, ce, pos, flags, pg)
            for p, h, ce, pos, pg in each_row(zip(ps, hs, ces, poss, pages))]
    return [h[:, 0, :] for h in _ffn_after(
        cfg, ps, [(h[:, None, :], x2) for h, x2 in mids], flags)]


def _block_propagate(cfg: ModelConfig, kind: str, p: Params, h: torch.Tensor,
                     cache_entry: Any, pos: torch.Tensor, flags: ModelFlags,
                     pages: Optional[torch.Tensor] = None) -> Any:
    """SpecEE skipped-layer state maintenance: write the K/V projections of
    the exit hidden state so later tokens can attend this position. SSD
    and RG-LRU: the state goes stale and the conv window takes the current
    input, so the window stays aligned."""
    if kind in (SSD, RGLRU):
        x = common.apply_norm(cfg, p["ln" if kind == SSD else "ln1"], h)
        pb = p["ssd" if kind == SSD else "rec"]
        for s, conv in enumerate(parts(cache_entry["conv"])):
            ps, xs = local(pb, s), x.to(conv.device)
            if kind == SSD:
                _, xin, _ = ssd_lib._split_proj(
                    cfg, common.apply_linear(ps["in_proj"], xs), ps)
            else:
                xin = common.apply_linear(ps["wx"], xs)
            window = torch.cat([conv.to(xin.dtype), xin[:, None, :]], dim=1)
            conv.copy_(window[:, 1:])
        return cache_entry
    B = h.shape[0]
    x = common.apply_norm(cfg, p["ln1"], h)[:, None, :]
    for s, c, pa, xs in _shard_views(cfg, p["attn"], x):
        dev = xs.device
        pvec = pos.to(dev).long()
        k, v = attn_lib.kv_only(c, pa, xs, pvec[:, None])
        _entry_write_token(local(cache_entry, s),
                           _kv_vals(k[:, 0], v[:, 0], flags.kv_quant),
                           None if pages is None else pages.to(dev),
                           torch.arange(B, device=dev), pvec)
    return cache_entry


def _attn_extend(cfg: ModelConfig, kind: str, p: Params, h: torch.Tensor,
                 cache_entry: Any, pos0: torch.Tensor,
                 positions: torch.Tensor, flags: ModelFlags
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The attention half of a C-token prompt chunk against a DENSE decode
    cache entry: (h + attention, the FFN's normed input; the FFN is
    ``_ffn_after``'s).

    h: (B, C, D); pos0: (B,) prefix length; positions: (B, C) absolute
    positions of the chunk. The chunk's K/V is written (in place, quantized
    under ``kv_quant``; positions past the cache are dropped, as JAX's
    ``mode="drop"``) before attending, so intra-chunk causal attention sees
    its own keys as the decode step does: under ``kv_quant`` the prompt
    attends the dequantized cache, where blocking prefill (``_block_seq``)
    attends full-precision K/V, as in the JAX package. Attention-family
    blocks only."""
    assert kind in (ATTN, LOCAL_ATTN), kind
    B, C, _ = h.shape
    x = common.apply_norm(cfg, p["ln1"], h)

    def core(c, pa, s, xs):
        dev = xs.device
        ce = local(cache_entry, s)
        pos_d = positions.to(dev)
        q, k, v = attn_lib.qkv(c, pa, xs, pos_d)
        keep = pos_d < ce["k"].shape[1]
        rows = torch.arange(B, device=dev)[:, None].expand(B, C)
        for name, val in _kv_vals(k, v, flags.kv_quant).items():
            dst = ce[name]
            dst[rows[keep], pos_d[keep]] = val[keep].to(dst.dtype)
        if flags.kv_quant:
            k_cache = _kv_dequantize(ce["k"], ce["ks"], h.dtype)
            v_cache = _kv_dequantize(ce["v"], ce["vs"], h.dtype)
        else:
            k_cache, v_cache = ce["k"], ce["v"]
        return attn_lib.attend_extend(c, q, k_cache, v_cache, pos0.to(dev),
                                      window=_window(cfg, kind)), None

    h = h + _attention(cfg, p["attn"], x, core)[0]
    return h, common.apply_norm(cfg, p["ln2"], h)


def _write_scratch(cache_entry: Any, vals: Dict[str, torch.Tensor],
                   scratch_off: int, pages: Optional[torch.Tensor]) -> Any:
    """Write the N tree nodes' K/V (B, N, ...) into LOGICAL cache slots
    [scratch_off, scratch_off + N) of every row, in place (through the page
    table when ``pages`` is given)."""
    B, N = next(iter(vals.values())).shape[:2]
    for name, v in vals.items():
        if pages is None:
            cache_entry[name][:, scratch_off:scratch_off + N] = v.to(
                cache_entry[name].dtype)
        else:
            pos = (scratch_off + torch.arange(N, device=v.device))[None, :]
            paged_lib.scatter_slab(cache_entry[name], pages,
                                   pos.expand(B, N), v)
    return cache_entry


def _attn_tree(cfg: ModelConfig, p: Params, h: torch.Tensor,
               cache_entry: Any, mask: torch.Tensor, positions: torch.Tensor,
               scratch_off: int, pages: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The attention half of N tree tokens at once against a cache with N
    scratch slots: (h + attention, the FFN's normed input).

    h: (B, N, D); mask: (B|1, 1, N, scratch_off + N) bool (context +
    ancestors); positions: (B, N) absolute positions. The nodes' K/V land
    at logical slots [scratch_off, scratch_off + N) before attending. Plain
    masked attention, as in the JAX package (it has no Pallas kernel here);
    attention-family blocks only; the FFN is ``_ffn_after``'s."""
    x = common.apply_norm(cfg, p["ln1"], h)

    def core(c, pa, s, xs):
        dev = xs.device
        ce = local(cache_entry, s)
        pg = None if pages is None else pages.to(dev)
        q, k, v = attn_lib.qkv(c, pa, xs, positions.to(dev))
        _write_scratch(ce, {"k": k, "v": v}, scratch_off, pg)
        if pg is None:
            k_cache, v_cache = ce["k"], ce["v"]
        else:
            k_cache = paged_lib.gather_view(ce["k"], pg)
            v_cache = paged_lib.gather_view(ce["v"], pg)
        n_rep = c.num_heads // c.num_kv_heads
        return attn_lib.sdpa(q, attn_lib._repeat_kv(k_cache, n_rep),
                             attn_lib._repeat_kv(v_cache, n_rep),
                             mask.to(dev)), None

    h = h + _attention(cfg, p["attn"], x, core)[0]
    return h, common.apply_norm(cfg, p["ln2"], h)


def _ffn_after(cfg: ModelConfig, ps: Sequence[Params],
               mids: Sequence[Tuple[torch.Tensor, torch.Tensor]],
               flags: ModelFlags) -> List[torch.Tensor]:
    """Each row's ``h + FFN(x2)`` of its attention half's ``(h, x2)``
    (``_ffn_rows``: a MoE over every row's tokens)."""
    fs, _ = _ffn_rows(cfg, ps, [x2 for _, x2 in mids], flags)
    return [h + f for (h, _), f in zip(mids, fs)]


class Model:
    def __init__(self, run: RunConfig, flags: ModelFlags = ModelFlags()):
        self.run = run
        self.cfg = run.model
        if flags.moe_impl not in ("dense", "topk"):
            raise ValueError(f"ModelFlags.moe_impl must be 'dense' or "
                             f"'topk', got {flags.moe_impl!r}")
        self.flags = flags
        self.dtype = common.dtype_of(self.cfg.dtype)
        self.segments = segments_of(list(self.cfg.blocks()))
        self.num_exit_points = sum(reps for _, reps in self.segments)
        self.shard = None               # ShardCtx of a sharded model
        self.rows = None                # RowMesh of a (D > 1, P) mesh

    def with_shard(self, shard) -> "Model":
        """This model over a mesh's shards (``sharding.ctx.ShardCtx``; None
        unsharded): the same config and flags, its cache entries built as
        ``Shards`` (``empty_cache_entry``). The layers read the split from
        the params they are given."""
        m = copy.copy(self)
        m.shard = shard
        return m

    def with_rows(self, rows) -> "Model":
        """This model over the data rows of a ``(D, P)`` mesh with D > 1
        (``sharding.rows.RowMesh``; its params placed by ``RowMesh.place``,
        ``DataShards`` leaves). Every block call splits its batch over the
        rows (``_unit``): row d runs the ``(1, P)`` path on its contiguous
        rows and its view of the unit's weights, gathered over 'data' per
        call and dropped after, and the rows' outputs join on the mesh
        lead after the unit. Its caches split their batch over the rows
        (``empty_cache_entry``). A batch D does not divide (a batch-1
        admission) stays whole on row 0, which computes it all, as JAX's
        ``_fit`` keeps such a batch whole. Embedding, final norm and LM
        head are read on the lead (row 0's view)."""
        m = copy.copy(self)
        m.rows = rows
        m.shard = ShardCtx.from_mesh(rows.mesh)
        return m

    # ----- the data rows of a (D, P) mesh -----
    def _lead_view(self, p: Params) -> Params:
        """Row 0's view of a placed subtree (itself unplaced)."""
        return p if self.rows is None else self.rows.views(p, [0])[0]

    def _groups(self, B: int, split: bool) -> List[Tuple[Any, int, int]]:
        """(data row, first, end) of each row's batch rows: one group
        (row None) without rows, row 0's whole batch unless ``split``."""
        if self.rows is None:
            return [(None, 0, B)]
        if not split:
            return [(0, 0, B)]
        b = B // self.rows.D
        return [(d, d * b, (d + 1) * b) for d in range(self.rows.D)]

    def _cut(self, x: Optional[torch.Tensor], groups) -> List[Any]:
        """Each group's rows of ``x`` (None passes), on its row's lead."""
        if x is None or groups[0][0] is None:
            return [x] * len(groups)
        return [x[lo:hi].to(self.rows.leads[d]) for d, lo, hi in groups]

    @staticmethod
    def _join(xs: Sequence[torch.Tensor], device) -> torch.Tensor:
        """The groups' outputs, in order, on ``device`` (the lead)."""
        if len(xs) == 1:
            return xs[0].to(device)
        return torch.cat([x.to(device) for x in xs])

    def _unit(self, params: Params, seg: int, unit_idx: int, seg_cache: Any,
              B: int, keys=None) -> Tuple[list, list, list]:
        """(groups, each group's unit params, its unit cache) of unit
        ``unit_idx`` of segment ``seg`` for a batch of B rows. Over rows
        the groups follow the cache (its batch split over the rows, or
        whole on row 0), the params are each row's view (``keys``: only
        those block entries, what a skipped unit reads) and the experts
        stay local when every row runs."""
        up = index_tree(params["segments"][seg], unit_idx)
        ce = index_tree(seg_cache, unit_idx)
        if self.rows is None:
            return [(None, 0, B)], [up], [ce]
        if keys is not None:
            up = {u: {k: v for k, v in bp.items() if k in keys}
                  for u, bp in up.items()}
        groups = self._groups(B, _has_rows(ce))
        rows = [d for d, _, _ in groups]
        views = self.rows.views(
            up, rows, local_experts=(self.flags.moe_impl == "dense"
                                     and len(rows) == self.rows.D))
        return groups, views, [_row_of(ce, d) for d in rows]

    # ----- init -----
    def init(self, gen: Union[torch.Generator, int],
             device: Union[str, torch.device] = "cuda") -> Params:
        """Seeded weights in the compute dtype (same shapes and scales as
        the JAX init, different numbers; the vision or audio frontend's
        projection after the embedding, as JAX orders them)."""
        device = torch.device(device)
        if isinstance(gen, int):
            gen = torch.Generator(device=device).manual_seed(gen)
        cfg, dt = self.cfg, self.dtype
        params: Params = {"embed": {"tok": common.normal_init(
            gen, (cfg.vocab_size, cfg.d_model), 0.02, dt, device)}}
        fe = frontends.init_frontend(cfg, gen, dt, device)
        if fe is not None:
            params["frontend"] = fe
        segs = []
        for unit, reps in self.segments:
            stacked = None
            for r in range(reps):
                one = {f"u{i}": _init_block(cfg, kind, gen, dt, device)
                       for i, kind in enumerate(unit)}
                if stacked is None:
                    stacked = common.tree_map(
                        lambda x: x.new_empty((reps,) + tuple(x.shape)), one)
                _fill_rep(stacked, one, r)
                del one
            segs.append(stacked)
        params["segments"] = segs
        params["final_norm"] = common.init_norm(cfg, cfg.d_model, dt,
                                                device)
        if not cfg.tie_embeddings:
            params["lm_head"] = {"w": common.normal_init(
                gen, (cfg.d_model, cfg.vocab_size), cfg.d_model ** -0.5, dt,
                device)}
        return params

    # ----- embedding / head -----
    def embed(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        """Token embeddings; a sharded table is vocab-parallel (a masked
        lookup per vocabulary slice plus a reduce onto the tokens' device:
        one slice owns each id, so the sum is the lookup) or, for an odd
        vocabulary split on D, each slice's columns concatenated."""
        emb = self._lead_view(params["embed"])
        tok = emb["tok"]
        if not isinstance(tok, Shards):
            return common.embed_tokens(emb, tokens, self.dtype)
        if tok.dim == -1:
            return torch.cat([common.embed_tokens(
                {"tok": part}, tokens.to(part.device), self.dtype).to(
                    tokens.device) for part in tok], dim=-1)
        partials, c0 = [], 0
        for part in tok:
            ids = tokens.to(part.device).long() - c0
            owned = (ids >= 0) & (ids < part.shape[0])
            emb = part.to(self.dtype)[ids.clamp(0, part.shape[0] - 1)]
            partials.append(torch.where(owned[..., None], emb,
                                        torch.zeros_like(emb)))
            c0 += part.shape[0]
        return all_reduce_sum(partials, tokens.device)

    def final_norm(self, params: Params, h: torch.Tensor) -> torch.Tensor:
        return common.apply_norm(self.cfg,
                                 self._lead_view(params["final_norm"]), h)

    def logits(self, params: Params, h: torch.Tensor) -> torch.Tensor:
        w = common.lm_head_weight(params)
        return (self.final_norm(params, h) @ w.to(h.dtype)).float()

    # ----- sequence forward (training) -----
    def forward_hidden(self, params: Params, h: torch.Tensor,
                       positions: torch.Tensor
                       ) -> Tuple[torch.Tensor, None, torch.Tensor]:
        """h: (B, S, D) -> (h_final, None, aux_loss): every unit's
        ``_block_seq`` with autograd on, the blocks' aux losses (MoE load
        balancing) summed; under ``flags.remat == "full"``
        each unit is recomputed in the backward pass. The kernels are
        ``ctypes`` calls whose outputs carry no gradient, so with grad
        enabled a kernel flag of the sequence path raises (as ``jax.grad``
        through a ``pallas_call`` without a VJP fails) rather than train
        through a kernel that drops the gradient."""
        flags = self._no_kernel_under_grad("forward_hidden")
        cfg = self.cfg

        def unit_fwd(h_in, up, unit):
            aux_u = torch.zeros((), dtype=torch.float32, device=h_in.device)
            for i, kind in enumerate(unit):
                h_in, _, aux = _block_seq(cfg, kind, up[f"u{i}"], h_in,
                                          positions, flags)
                aux_u = aux_u + aux
            return h_in, aux_u

        h, aux_total = self._units(params, h, unit_fwd, h.device)
        return h, None, aux_total

    def _units(self, params: Params, h: Any, unit_fwd, device
               ) -> Tuple[Any, torch.Tensor]:
        """``unit_fwd(h, unit params, unit) -> (h, aux)`` over every unit of
        every segment, each recomputed in the backward pass under
        ``remat == "full"``. Returns (h, the aux losses summed, on
        ``device``)."""
        aux_total = torch.zeros((), dtype=torch.float32, device=device)
        for si, (unit, reps) in enumerate(self.segments):
            auxs = []
            for r in range(reps):
                up = index_tree(params["segments"][si], r)
                if self.flags.remat == "full":
                    h, aux = checkpoint(unit_fwd, h, up, unit,
                                        use_reentrant=False)
                else:
                    h, aux = unit_fwd(h, up, unit)
                auxs.append(aux)
            aux_total = aux_total + torch.stack(auxs).sum()
        return h, aux_total

    def _no_kernel_under_grad(self, where: str) -> ModelFlags:
        """The flags, unless a sequence-path kernel flag is set with grad
        enabled: the kernels have no backward, so that raises."""
        flags = self.flags
        if torch.is_grad_enabled() and (flags.flash_attention or
                                        flags.ssd_kernel):
            raise ValueError(
                f"{where} with grad enabled: the flash_attention and "
                "ssd_kernel kernels have no backward; build the training "
                "model without them")
        return flags

    def _inputs(self, params: Params, batch: Dict[str, torch.Tensor]
                ) -> torch.Tensor:
        """The (B, S, D) input hiddens of a batch: projected audio frames,
        or token embeddings with projected image patches prepended."""
        cfg = self.cfg
        if cfg.frontend == "audio_frames":
            return frontends.apply_frontend(cfg, params["frontend"],
                                            batch["frames"], self.dtype)
        h = self.embed(params, batch["tokens"])
        if cfg.frontend == "vision_patches":
            fe = frontends.apply_frontend(cfg, params["frontend"],
                                          batch["patches"], self.dtype)
            h = torch.cat([fe, h], dim=1)
        return h

    def train_loss(self, params: Params, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Next-token cross-entropy over ``batch["tokens"]`` (B, S), on the
        text region after any prepended patches; the audio encoder's masked
        frame-unit cross-entropy over ``batch["frames"]``, ``["targets"]``
        and ``["mask"]``. Returns (loss + aux, {"ce", "aux"})."""
        h = self._inputs(params, batch)
        B, S, _ = h.shape
        positions = torch.arange(S, device=h.device)[None, :].expand(B, S)
        h, _, aux = self.forward_hidden(params, h, positions)
        loss, _ = self._loss_parts(params, h, batch)
        return loss + aux, {"ce": loss, "aux": aux}

    def _loss_parts(self, params: Params, h: torch.Tensor,
                    batch: Dict[str, torch.Tensor]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(loss, its weight) of the final hiddens ``h``: the mean
        next-token NLL and the count of targets, or the audio encoder's
        masked frame NLL (its sum over the mask's count) and that count.
        Rows split over 'data' add loss x weight and the weights before
        the one division (``train_loss_rows``)."""
        if self.cfg.frontend == "audio_frames":
            lse = torch.log_softmax(self.logits(params, h), dim=-1)
            ll = torch.gather(lse, -1, batch["targets"].long()[..., None])
            mask = batch["mask"].float()
            return (-(ll[..., 0] * mask).sum() / torch.clamp(mask.sum(),
                                                             min=1.0),
                    mask.sum())
        tokens = batch["tokens"]
        txt0 = h.shape[1] - tokens.shape[1]
        loss = self._ce_loss(params, h[:, txt0:-1, :], tokens[:, 1:],
                             chunk=self.flags.ce_chunk)
        return loss, torch.tensor(
            float(tokens.shape[0] * (tokens.shape[1] - 1)), device=h.device)

    def train_loss_rows(self, params: Params,
                        batches: Sequence[Dict[str, torch.Tensor]], rows
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """``train_loss`` of one batch cut over the data rows of a
        ``(D, P)`` mesh (``sharding/training.py``). ``params``: the placed
        tree (``DataShards`` leaves); ``batches[d]``: row d's contiguous
        rows, on its lead device; ``rows``: the ``TrainMesh`` whose
        ``rows(subtree)`` gives each row's view of a subtree in the TP
        layout the blocks compute with, gathered over 'data' (called
        inside each unit, so under ``remat="full"`` the recompute gathers
        again). Each row runs the blocks on its rows (``_block_seq_rows``:
        MoE's experts over every row's tokens); the rows' summed losses
        and weights are all-reduced, then divided once, so the loss is the
        whole batch's (a row's mean loss weighs by its count of targets,
        or of masked frames). Returns (loss + aux, {"ce", "aux"}) on row 0's
        lead device."""
        flags, cfg = self._no_kernel_under_grad("train_loss_rows"), self.cfg
        ins = rows({k: params[k] for k in ("embed", "frontend")
                    if k in params})
        hs = [self._inputs(p, b) for p, b in each_row(zip(ins, batches))]
        positions = [torch.arange(h.shape[1], device=h.device)[None, :]
                     .expand(h.shape[0], h.shape[1]) for h in hs]
        local_experts = flags.moe_impl == "dense"

        def unit_fwd(hs_in, up, unit):
            views = rows(up, local_experts=local_experts)
            aux_u = torch.zeros((), dtype=torch.float32,
                                device=hs_in[0].device)
            for i, kind in enumerate(unit):
                hs_in, _, aux = _block_seq_rows(
                    cfg, kind, [v[f"u{i}"] for v in views], hs_in,
                    positions, flags)
                aux_u = aux_u + aux
            return hs_in, aux_u

        hs, aux_total = self._units(params, hs, unit_fwd, hs[0].device)
        sums = [torch.stack((loss * w, w)) for loss, w in (
            self._loss_parts(hp, h, b)
            for hp, h, b in each_row(zip(rows.head(params), hs, batches)))]
        if len(sums) > 1:
            sums = all_reduce_rows(sums, [x.device for x in sums])
        loss = sums[0][0] / torch.clamp(sums[0][1], min=1.0)
        return loss + aux_total, {"ce": loss, "aux": aux_total}

    def _ce_loss(self, params: Params, h: torch.Tensor,
                 targets: torch.Tensor, chunk: int = 512) -> torch.Tensor:
        """Mean cross-entropy of ``logits(h)`` against ``targets``. Above
        S·V = 2^24 it runs over sequence chunks, each recomputed in the
        backward pass (``torch.utils.checkpoint``), so the (B, S, V) logits
        never exist at once: peak logits memory is (B, chunk, V)."""
        B, S, D = h.shape
        targets = targets.long()

        def log_lik(h_c, t_c):
            lse = torch.log_softmax(self.logits(params, h_c), dim=-1)
            return torch.gather(lse, -1, t_c[..., None])[..., 0]

        def nll_sum(h_c, t_c, w_c):
            return -(log_lik(h_c, t_c) * w_c).sum()

        if S * self.cfg.vocab_size <= (1 << 24):      # small: direct path
            return -log_lik(h, targets).mean()
        chunk = min(chunk, S)
        pad = (-S) % chunk
        w = F.pad(torch.ones(B, S, dtype=torch.float32, device=h.device),
                  (0, pad))
        hp = F.pad(h, (0, 0, 0, pad))
        tp = F.pad(targets, (0, pad))
        total = torch.zeros((), dtype=torch.float32, device=h.device)
        for c0 in range(0, S + pad, chunk):
            sl = slice(c0, c0 + chunk)
            total = total + checkpoint(nll_sum, hp[:, sl], tp[:, sl],
                                       w[:, sl], use_reentrant=False)
        return total / (B * S)

    # ----- prefill -----
    def prefill(self, params: Params, batch: Dict[str, torch.Tensor],
                max_seq: Optional[int] = None
                ) -> Tuple[torch.Tensor, Any, Dict[str, torch.Tensor]]:
        """Returns (logits of the last position (B, V) fp32, cache with
        ``max_seq`` slots, {"h_final": (B, S, D) pre-final-norm hiddens}).
        S counts prepended image patches (``batch["patches"]``). The prompt
        attends full-precision K/V; under ``kv_quant`` the cache then stores
        its codes and scales (JAX's ``_materialize_cache``). SSD and RG-LRU
        entries are stored as ``_block_seq`` returns them. An encoder
        returns the logits of every frame (B, S, V) and no cache."""
        B = next(iter(batch.values())).shape[0]
        groups = self._groups(B, self.rows is not None
                              and B % self.rows.D == 0)
        rows = [d for d, _, _ in groups]
        outer = {k: params[k] for k in ("embed", "frontend") if k in params}
        ins = ([outer] if self.rows is None else self.rows.views(outer, rows))
        hs = [self._inputs(p, {k: x for k, x in zip(batch, xs)})
              for p, xs in each_row(zip(ins, zip(*(self._cut(x, groups)
                                                   for x in batch.values()))))]
        S = hs[0].shape[1]
        positions = [torch.arange(S, device=h.device)[None, :].expand(
            h.shape[0], S) for h in hs]
        device = hs[0].device if self.rows is None else self.rows.leads[0]
        decoder = self.cfg.is_decoder()
        max_seq = max_seq or (S + 1)
        local = (self.rows is not None and len(rows) == self.rows.D
                 and self.flags.moe_impl == "dense")
        segs = []
        for si, (unit, reps) in enumerate(self.segments):
            seg_cache = {f"u{i}": self.empty_cache_entry(reps, B, max_seq,
                                                         device, kind)
                         for i, kind in enumerate(unit)} if decoder else {}
            for r in range(reps):
                up = index_tree(params["segments"][si], r)
                views = ([up] if self.rows is None else
                         self.rows.views(up, rows, local_experts=local))
                for i, kind in enumerate(unit):
                    hs, ces, _ = _block_seq_rows(
                        self.cfg, kind, [v[f"u{i}"] for v in views], hs,
                        positions, self.flags)
                    if decoder:
                        for (d, _, _), ce in zip(groups, ces):
                            _store_seq(seg_cache[f"u{i}"], ce, kind, r, S,
                                       self.flags.kv_quant, d)
            segs.append(seg_cache)
        h = self._join(hs, device)
        if not decoder:
            return self.logits(params, h), None, {"h_final": h}
        cache = {"segments": segs,
                 "len": torch.full((B,), S, dtype=torch.int32,
                                   device=device)}
        return self.logits(params, h[:, -1, :]), cache, {"h_final": h}

    def empty_cache_entry(self, reps: int, batch: int, max_seq: int,
                          device, kind: str = ATTN,
                          pool_rows: Optional[int] = None) -> Any:
        """One zeroed cache entry of block ``kind`` (counterpart of JAX's
        ``_empty_cache_entry``, stacked over ``reps``). Attention: K/V
        (reps, batch, max_seq, KVH, hd), or under ``kv_quant`` int8 codes
        beside fp32 scales (reps, batch, max_seq, KVH); the paged manager
        builds its pools with ``batch`` = pages and ``max_seq`` = page
        size. SSD: the fp32 state (reps, batch, nh, hd, ds) and the conv
        window (reps, batch, K-1, di+2ds) in the compute dtype; RG-LRU: the
        fp32 state (reps, batch, W) and the conv window (reps, batch, K-1,
        W) (``max_seq`` unused). A sharded model's leaves are ``Shards``,
        each part on its shard's device in the leaf's layout
        (``_entry_segs``). Over data rows (``with_rows``) each leaf is a
        ``DataShards`` of the rows' entries, its batch split over them; a
        page pool (``pool_rows``: the rows of its session) is a copy per
        row; either stays whole on row 0 where D does not divide the
        rows."""
        leaves = self._entry_leaves(reps, batch, max_seq, kind)
        if self.rows is None:
            return self._entry_on(leaves, kind, [device] if self.shard is None
                                  else self.shard.devices)
        D, devs = self.rows.D, self.rows.mesh.devices
        split = (pool_rows if pool_rows is not None else batch) % D == 0
        if not split:                   # whole, on row 0
            return self._entry_on(leaves, kind, devs[0])
        if pool_rows is None:           # the batch over the rows
            leaves = {n: ((sh[0], sh[1] // D) + sh[2:], dt)
                      for n, (sh, dt) in leaves.items()}
        rows = [self._entry_on(leaves, kind, row) for row in devs]
        return {n: DataShards([e[n] for e in rows],
                              None if pool_rows is not None
                              else 1 - len(sh))
                for n, (sh, _) in leaves.items()}

    def _entry_on(self, leaves, kind: str, devices) -> Dict[str, Any]:
        """Zeroed leaves of a cache entry over ``devices`` (one: whole
        tensors; more: ``Shards`` in each leaf's layout)."""
        if len(devices) == 1:
            return {name: torch.zeros(shape, dtype=dt, device=devices[0])
                    for name, (shape, dt) in leaves.items()}
        P, segs, out = len(devices), self._entry_segs(kind), {}
        for name, (shape, dt) in leaves.items():
            dim, sg = segs[name]
            part = list(shape)
            part[dim] = part_size(sg, P)
            out[name] = Shards([torch.zeros(part, dtype=dt, device=dev)
                                for dev in devices], dim, sg)
        return out

    def _entry_leaves(self, reps: int, batch: int, max_seq: int, kind: str
                      ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
        """{leaf name: (whole shape, dtype)} of a cache entry."""
        cfg = self.cfg
        if kind == RGLRU:
            r = cfg.rglru or RGLRUConfig()
            w = rglru_lib.lru_width(cfg)
            return {"h": ((reps, batch, w), torch.float32),
                    "conv": ((reps, batch, r.conv_kernel - 1, w),
                             self.dtype)}
        if kind == SSD:
            s = cfg.ssm or SSMConfig()
            di, nh, hd, ds = ssd_lib.dims(cfg)
            return {"state": ((reps, batch, nh, hd, ds), torch.float32),
                    "conv": ((reps, batch, s.conv_kernel - 1, di + 2 * ds),
                             self.dtype)}
        shape = (reps, batch, max_seq, cfg.num_kv_heads,
                 cfg.resolved_head_dim())
        if not self.flags.kv_quant:
            return {"k": (shape, self.dtype), "v": (shape, self.dtype)}
        return {"k": (shape, torch.int8), "v": (shape, torch.int8),
                "ks": (shape[:-1], torch.float32),
                "vs": (shape[:-1], torch.float32)}

    def _entry_segs(self, kind: str) -> Dict[str, Tuple[int, Any]]:
        """{leaf name: (split dim from the end, ``sharding.ctx``
        segments)} of a sharded cache entry."""
        if kind == SSD:
            return ssd_lib.state_segs(self.cfg)
        if kind == RGLRU:
            return rglru_lib.state_segs(self.cfg)
        kv = attn_lib.kv_segs(self.cfg)
        return {"k": (-2, kv), "v": (-2, kv), "ks": (-1, kv),
                "vs": (-1, kv)}

    def empty_cache(self, batch: int, max_seq: int,
                    device: Union[str, torch.device] = "cuda") -> Any:
        segs = [{f"u{i}": self.empty_cache_entry(reps, batch, max_seq,
                                                 device, kind)
                 for i, kind in enumerate(unit)}
                for unit, reps in self.segments]
        return {"segments": segs,
                "len": torch.zeros(batch, dtype=torch.int32, device=device)}

    # ----- chunked prefill (Sarathi-style admission) -----
    def supports_chunked_prefill(self) -> bool:
        """Chunked prefill needs blocks whose state extension is "write K/V,
        attend the prefix": a causal attention-family stack without a
        frontend (the JAX rule); SSD stacks admit with one whole-prompt
        chunk."""
        return (self.cfg.is_decoder() and self.cfg.frontend == "none" and
                all(k in (ATTN, LOCAL_ATTN)
                    for unit, _ in self.segments for k in unit))

    def prefill_extend(self, params: Params, tokens: torch.Tensor, cache: Any,
                       n_valid: int) -> Tuple[torch.Tensor, Any]:
        """Extend a DENSE decode cache with one prompt chunk, in place.

        tokens: (B, C) int, the first ``n_valid`` real (the tail is padding
        whose K/V lands past the prompt and is later overwritten or masked —
        intra-chunk causality hides it from the real queries). Returns
        (h (B, C, D) pre-final-norm hiddens, cache with ``len +=
        n_valid``)."""
        assert self.supports_chunked_prefill(), \
            f"{self.cfg.name}: chunked prefill needs a pure-attention " \
            "decoder stack"
        h = self.embed(params, tokens)                       # (B, C, D)
        pos0 = cache["len"]
        B, C = tokens.shape
        positions = (pos0.long()[:, None]
                     + torch.arange(C, device=h.device)[None, :])
        for seg, (unit, reps) in enumerate(self.segments):
            for r in range(reps):
                groups, views, ces = self._unit(params, seg, r,
                                                cache["segments"][seg], B)
                hs = self._cut(h, groups)
                p0s, poss = self._cut(pos0, groups), self._cut(positions,
                                                              groups)
                for i, kind in enumerate(unit):
                    ps = [v[f"u{i}"] for v in views]
                    hs = _ffn_after(self.cfg, ps, [
                        _attn_extend(self.cfg, kind, p, hh, c[f"u{i}"], p0,
                                     pp, self.flags)
                        for p, hh, c, p0, pp in each_row(
                            zip(ps, hs, ces, p0s, poss))],
                        self.flags)
                h = self._join(hs, h.device)
        return h, dict(cache, len=pos0 + int(n_valid))

    # ----- layer-granular decode API (SpecEE engine) -----
    def run_unit(self, params: Params, seg: int, unit_idx: int,
                 h: torch.Tensor, seg_cache: Any, pos: torch.Tensor,
                 live_mask: Optional[torch.Tensor] = None,
                 pages: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Any]:
        """Run unit ``unit_idx`` of segment ``seg`` on one token (B, D),
        writing its K/V (or SSD state) into ``seg_cache``. ``live_mask``
        (B,) bool: rows that have exited keep their SSD state. ``pages``:
        the session page table when the cache is paged. Returns (h_out,
        seg_cache)."""
        unit, _ = self.segments[seg]
        groups, views, ces = self._unit(params, seg, unit_idx, seg_cache,
                                        h.shape[0])
        hs = self._cut(h, groups)
        poss, pgs, lives = (self._cut(x, groups)
                            for x in (pos, pages, live_mask))
        for i, kind in enumerate(unit):
            hs = _block_step(self.cfg, kind, [v[f"u{i}"] for v in views],
                             hs, [c[f"u{i}"] for c in ces], poss, self.flags,
                             pgs, lives)
        return self._join(hs, h.device), seg_cache

    def propagate_unit(self, params: Params, seg: int, unit_idx: int,
                       h: torch.Tensor, seg_cache: Any, pos: torch.Tensor,
                       pages: Optional[torch.Tensor] = None) -> Any:
        """KV propagation for a skipped unit (SpecEE early exit)."""
        unit, _ = self.segments[seg]
        groups, views, ces = self._unit(params, seg, unit_idx, seg_cache,
                                        h.shape[0], keys=_PROPAGATE_KEYS)
        for v, c, hh, pp, pg in each_row(zip(
                views, ces, self._cut(h, groups), self._cut(pos, groups),
                self._cut(pages, groups))):
            for i, kind in enumerate(unit):
                _block_propagate(self.cfg, kind, v[f"u{i}"], hh, c[f"u{i}"],
                                 pp, self.flags, pages=pg)
        return seg_cache

    # ----- tree-verification API (T3) -----
    def supports_tree(self) -> bool:
        return all(k == ATTN for unit, _ in self.segments for k in unit)

    def run_unit_tree(self, params: Params, seg: int, unit_idx: int,
                      h: torch.Tensor, seg_cache: Any, mask: torch.Tensor,
                      positions: torch.Tensor, scratch_off: int,
                      pages: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Any]:
        """Tree analogue of ``run_unit``: h is (B, N, D) tree-node hiddens;
        their K/V go to the scratch slots. Returns (h_out, seg_cache)."""
        unit, _ = self.segments[seg]
        groups, views, ces = self._unit(params, seg, unit_idx, seg_cache,
                                        h.shape[0])
        hs = self._cut(h, groups)
        poss, pgs = self._cut(positions, groups), self._cut(pages, groups)
        masks = (self._cut(mask, groups) if mask.shape[0] > 1
                 else [mask] * len(groups))
        for i, kind in enumerate(unit):
            assert kind == ATTN, "tree mode requires pure-attention stacks"
            ps = [v[f"u{i}"] for v in views]
            hs = _ffn_after(self.cfg, ps, [
                _attn_tree(self.cfg, p, hh, c[f"u{i}"], m, pp, scratch_off,
                           pages=pg)
                for p, hh, c, m, pp, pg in each_row(zip(ps, hs, ces, masks,
                                                        poss, pgs))],
                self.flags)
        return self._join(hs, h.device), seg_cache

    def propagate_unit_tree(self, params: Params, seg: int, unit_idx: int,
                            h: torch.Tensor, seg_cache: Any,
                            positions: torch.Tensor, scratch_off: int,
                            pages: Optional[torch.Tensor] = None) -> Any:
        """KV propagation into the tree scratch slots of a skipped unit."""
        unit, _ = self.segments[seg]
        groups, views, ces = self._unit(params, seg, unit_idx, seg_cache,
                                        h.shape[0], keys=_PROPAGATE_KEYS)
        for v, c, hh, pp, pg in each_row(zip(
                views, ces, self._cut(h, groups),
                self._cut(positions, groups), self._cut(pages, groups))):
            for i, _ in enumerate(unit):
                p = v[f"u{i}"]
                x = common.apply_norm(self.cfg, p["ln1"], hh)
                for s, c_, pa, xs in _shard_views(self.cfg, p["attn"], x):
                    dev = xs.device
                    k, vv = attn_lib.kv_only(c_, pa, xs, pp.to(dev))
                    _write_scratch(local(c[f"u{i}"], s), {"k": k, "v": vv},
                                   scratch_off,
                                   None if pg is None else pg.to(dev))
        return seg_cache

    def accept_tree_kv(self, cache: Any, accepted_nodes: torch.Tensor,
                       accepted_len: torch.Tensor, pos0: torch.Tensor,
                       scratch_off: int) -> Any:
        """Copy the K/V of accepted tree nodes from their scratch slots to
        their real positions, in place. accepted_nodes: (B, Dmax) node ids
        (-1 pad); accepted_len: (B,); the node at chain index d lands at
        pos0 + d. Chain index d is copied after d - 1, each read from the
        cache as it stands, as the JAX package does; a destination past the
        cache is dropped. Paged caches route through the table."""
        pages = cache.get("page_table")
        B = accepted_nodes.shape[0]
        for d, lo, hi in self._groups(B, _has_rows(cache["segments"])):
            leaves = [part for seg in cache["segments"]
                      for sub in seg.values() for x in sub.values()
                      for part in parts(_row_of(x, d))]
            _accept_leaves(leaves, accepted_nodes[lo:hi],
                           accepted_len[lo:hi], pos0[lo:hi],
                           None if pages is None else pages[lo:hi],
                           scratch_off)
        return cache

    # ----- dense decode (baseline, no early exit) -----
    def decode_step(self, params: Params, token: torch.Tensor, cache: Any
                    ) -> Tuple[torch.Tensor, Any]:
        """token: (B,) int. Returns (logits (B, V) fp32, new cache)."""
        h, cache = self.decode_step_hidden(params, token, cache)
        return self.logits(params, h), cache

    def decode_step_hidden(self, params: Params, token: torch.Tensor,
                           cache: Any) -> Tuple[torch.Tensor, Any]:
        """Full-depth decode returning the PRE-final-norm hidden (B, D);
        the emit is the caller's. token: (B,) int."""
        h = self.embed(params, token[:, None])[:, 0, :]
        pos = cache["len"]
        pages = cache.get("page_table")
        for seg, (_, reps) in enumerate(self.segments):
            for u in range(reps):
                h, _ = self.run_unit(params, seg, u, h,
                                     cache["segments"][seg], pos, pages=pages)
        return h, dict(cache, len=pos + 1)


_PROPAGATE_KEYS = ("ln", "ln1", "attn", "ssd", "rec")   # a skipped unit's


def _has_rows(tree) -> bool:
    """A cache (sub)tree split over data rows (``DataShards`` leaves)."""
    if isinstance(tree, DataShards):
        return True
    if isinstance(tree, dict):
        return any(_has_rows(v) for v in tree.values())
    if isinstance(tree, (list, tuple)) and not isinstance(tree, Shards):
        return any(_has_rows(v) for v in tree)
    return False


def _row_of(tree, d) -> Any:
    """Data row ``d``'s entry of each ``DataShards`` leaf (``d`` None, or
    another leaf: as it is)."""
    if isinstance(tree, DataShards):
        return tree if d is None else tree[d]
    if isinstance(tree, dict):
        return {k: _row_of(v, d) for k, v in tree.items()}
    return tree


def _store_seq(entry: Any, ce: Any, kind: str, r: int, S: int,
               kv_quant: bool, d=None) -> None:
    """Write a prompt's block output ``ce`` (``_block_seq``'s, one row
    group's) into unit ``r`` of cache entry ``entry`` (its data row ``d``'s
    part): SSD and RG-LRU state as it is (a None conv, a prompt shorter
    than the window, stays None), attention K/V (codes and scales under
    ``kv_quant``) into the first S slots of each shard's KV heads."""
    if kind in (SSD, RGLRU):
        for name, val in ce.items():
            if val is None:
                entry[name] = None
            elif entry[name] is not None:
                for dst, v in zip(parts(_row_of(entry[name], d)),
                                  parts(val)):
                    dst[r] = v
        return
    row = _row_of(entry, d)
    k = ce["k"]
    for s in (range(len(k)) if isinstance(k, Shards) else [None]):
        kv = local(ce, s)
        for name, val in _kv_vals(kv["k"], kv["v"], kv_quant).items():
            local(row, s)[name][r, :, :S] = val


def _accept_leaves(leaves, accepted_nodes: torch.Tensor,
                   accepted_len: torch.Tensor, pos0: torch.Tensor,
                   pages: Optional[torch.Tensor], scratch_off: int) -> None:
    """``Model.accept_tree_kv`` on the cache tensors ``leaves`` (each a
    shard's part on its own device) of one group of rows."""
    B, Dmax = accepted_nodes.shape
    for x in leaves:
        dev = x.device
        rows = torch.arange(B, device=dev)
        nodes = accepted_nodes.to(dev).long()
        acc_len = accepted_len.to(dev)
        p0 = pos0.to(dev).long()
        table = None if pages is None else pages.to(dev)
        if table is None:
            xf, cap = x, x.shape[2]
        else:
            ps = x.shape[2]
            xf = x.view((x.shape[0], x.shape[1] * ps) + tuple(x.shape[3:]))
            cap = table.shape[1] * ps
        for d in range(Dmax):
            node = nodes[:, d]
            dst = p0 + d
            ok = (d < acc_len) & (node >= 0) & (dst < cap)
            src = scratch_off + node.clamp(min=0)
            dst = dst.clamp(max=cap - 1)
            if table is not None:
                src = paged_lib.flat_slots(table, ps, src)
                dst = paged_lib.flat_slots(table, ps, dst)
                new = torch.where(ok[None, :, None, None],
                                  xf[:, src], xf[:, dst])
                xf[:, dst] = new
            else:
                new = torch.where(ok[None, :, None, None],
                                  xf[:, rows, src], xf[:, rows, dst])
                xf[:, rows, dst] = new


def _fill_rep(stacked: Params, one: Params, r: int) -> None:
    """Copy one unit's params into slot ``r`` of the stacked tree, leaf by
    leaf: a segment is built a unit at a time, so the card holds the stack
    and one unit, never every unit twice (DBRX's 8 layers are 51 GB)."""
    for k, v in one.items():
        if isinstance(v, dict):
            _fill_rep(stacked[k], v, r)
        else:
            stacked[k][r].copy_(v)


def build_model(run: RunConfig, flags: ModelFlags = ModelFlags()) -> Model:
    return Model(run, flags)
