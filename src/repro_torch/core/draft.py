"""EAGLE-style one-layer draft model (counterpart of ``repro/core/draft.py``).

One decoder layer at the target's width, fed with the fusion of (embedding
of the current token, target hidden state of the previous position); the
target's embedding and LM head are reused. The draft keeps its own
single-layer KV cache, written in place.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels.exit_gate import ops as gate_lib
from repro_torch.models import attention as attn_lib
from repro_torch.models import common
from repro_torch.models.common import Params


def _draft_cfg(cfg: ModelConfig) -> ModelConfig:
    """The draft layer reuses the target's geometry but is always 1 layer
    of attention with a dense MLP (a MoE target's draft drops the experts):
    a target without attention heads (Mamba2) gives it 4 heads and 4 KV
    heads of ``d_model // 4``."""
    kv = cfg.num_kv_heads if cfg.num_kv_heads > 0 else 4
    heads = cfg.num_heads if cfg.num_heads > 0 else 4
    return dataclasses.replace(
        cfg, num_layers=1, num_heads=heads, num_kv_heads=kv,
        head_dim=cfg.resolved_head_dim() or cfg.d_model // heads,
        block_pattern=(), causal=True, moe=None)


def init_draft(cfg: ModelConfig, gen: torch.Generator, dtype,
               device) -> Params:
    dc = _draft_cfg(cfg)
    d = cfg.d_model
    dc = dataclasses.replace(dc, d_ff=cfg.d_ff if cfg.d_ff > 0 else 4 * d)
    return {
        "fuse": common.init_linear(gen, 2 * d, d, True, dtype, device),
        "ln1": common.init_norm(dc, d, dtype, device),
        "attn": attn_lib.init_attention(dc, gen, dtype, device),
        "ln2": common.init_norm(dc, d, dtype, device),
        "mlp": common.init_mlp(dc, gen, dtype, device),
    }


def draft_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype,
                device) -> Any:
    dc = _draft_cfg(cfg)
    shape = (batch, max_seq, dc.num_kv_heads, dc.resolved_head_dim())
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _fused_input(p: Params, embed_tok: torch.Tensor,
                 h_target: torch.Tensor) -> torch.Tensor:
    x = torch.cat([embed_tok, h_target.to(embed_tok.dtype)], dim=-1)
    return common.apply_linear(p["fuse"], x)


def draft_step(cfg: ModelConfig, p: Params, embed_tok: torch.Tensor,
               h_target: torch.Tensor, cache: Any, pos: torch.Tensor
               ) -> Tuple[torch.Tensor, Any]:
    """One draft forward. embed_tok, h_target: (B, D); pos: (B,) position
    this step writes. The K/V is written into ``cache`` in place; a
    position past the cache is dropped, as JAX's scatter drops it (a row
    the tree path carried past its session length). Returns
    (h_draft (B, D), cache)."""
    dc = _draft_cfg(cfg)
    B = embed_tok.shape[0]
    h = _fused_input(p, embed_tok, h_target)
    x = common.apply_norm(dc, p["ln1"], h)[:, None, :]
    pvec = pos.long()
    q, k, v = attn_lib.qkv(dc, p["attn"], x, pvec[:, None])
    rows = torch.arange(B, device=h.device)
    S = cache["k"].shape[1]
    slot = pvec.clamp(max=S - 1)
    inside = (pvec < S)[:, None, None]
    for name, new in (("k", k), ("v", v)):
        c = cache[name]
        c[rows, slot] = torch.where(inside, new[:, 0].to(c.dtype),
                                    c[rows, slot])
    o = attn_lib.attend_decode(dc, q, cache["k"], cache["v"], pvec + 1)
    h = h + attn_lib.out_proj(p["attn"], o)[:, 0, :]
    x2 = common.apply_norm(dc, p["ln2"], h[:, None, :])
    h = h + common.apply_mlp(dc, p["mlp"], x2)[:, 0, :]
    return h, cache


def draft_step_readonly(cfg: ModelConfig, p: Params, embed_tok: torch.Tensor,
                        h_parent: torch.Tensor, cache: Any, pos,
                        cache_len) -> torch.Tensor:
    """Tree-expansion draft forward that does not write the cache: each node
    attends its row's trunk context (slots < ``cache_len``) plus itself;
    parent information flows through the fused ``h_parent`` input.

    embed_tok, h_parent: (B*G, D), G nodes per cache row, row-major;
    cache: {"k", "v"} of (B, S, KVH, hd); pos, cache_len: (B,) per cache row
    (or scalars). Returns h (B*G, D).

    The JAX version repeats the cache once per node (``jnp.repeat``); here
    the node queries are grouped per cache row and attend the row's cache
    in place, so nothing of the cache size is copied."""
    dc = _draft_cfg(cfg)
    kc, vc = cache["k"], cache["v"]
    B, S, KVH, hd = kc.shape
    Bs = embed_tok.shape[0]
    G = Bs // B
    H = dc.num_heads
    n_rep = H // KVH
    h = _fused_input(p, embed_tok, h_parent)
    x = common.apply_norm(dc, p["ln1"], h)[:, None, :]
    dev = h.device
    pos = torch.as_tensor(pos, device=dev).long().reshape(-1)
    pos = pos.expand(B) if pos.numel() == 1 else pos
    q, k, v = attn_lib.qkv(dc, p["attn"], x,
                           pos.repeat_interleave(G)[:, None])
    scale = 1.0 / math.sqrt(hd)
    qg = q[:, 0].reshape(B, G, KVH, n_rep, hd)
    ks = k[:, 0].reshape(B, G, KVH, hd).to(kc.dtype)
    vs = v[:, 0].reshape(B, G, KVH, hd).to(vc.dtype)
    s_ctx = torch.einsum("bngrd,bsgd->bngrs", qg, kc).float() * scale
    s_self = torch.einsum("bngrd,bngd->bngr", qg, ks).float() * scale
    clen = torch.as_tensor(cache_len, device=dev).reshape(-1, 1)
    valid = torch.arange(S, device=dev)[None, :] < clen          # (B|1, S)
    s_ctx = torch.where(valid[:, None, None, None, :], s_ctx,
                        torch.full_like(s_ctx, attn_lib.NEG_INF))
    probs = torch.softmax(torch.cat([s_ctx, s_self[..., None]], -1),
                          dim=-1).to(vc.dtype)
    o = (torch.einsum("bngrs,bsgd->bngrd", probs[..., :S], vc)
         + probs[..., S:] * vs[:, :, :, None, :])
    h = h + attn_lib.out_proj(p["attn"], o.reshape(Bs, 1, H, hd))[:, 0, :]
    x2 = common.apply_norm(dc, p["ln2"], h[:, None, :])
    return h + common.apply_mlp(dc, p["mlp"], x2)[:, 0, :]


def shift_hidden(h: torch.Tensor) -> torch.Tensor:
    """h[:, t] -> h[:, t-1] with zeros at t=0."""
    return torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)


def draft_forward_seq(cfg: ModelConfig, p: Params, embeds: torch.Tensor,
                      h_prev: torch.Tensor) -> torch.Tensor:
    """Teacher-forced full-sequence draft forward (training and feature
    collection). embeds: (B, S, D) token embeddings at position t; h_prev:
    (B, S, D) target hidden of position t-1 (``shift_hidden``). Returns the
    draft hidden (B, S, D) whose LM-head logits propose the token at
    t+1."""
    dc = _draft_cfg(cfg)
    B, S, D = embeds.shape
    x = torch.cat([embeds, h_prev.to(embeds.dtype)], dim=-1)
    h = common.apply_linear(p["fuse"], x)
    xn = common.apply_norm(dc, p["ln1"], h)
    positions = torch.arange(S, device=h.device)[None, :].expand(B, S)
    q, k, v = attn_lib.qkv(dc, p["attn"], xn, positions)
    h = h + attn_lib.out_proj(p["attn"], attn_lib.attend_full(dc, q, k, v))
    x2 = common.apply_norm(dc, p["ln2"], h)
    return h + common.apply_mlp(dc, p["mlp"], x2)


def draft_param_count(cfg: ModelConfig) -> int:
    """Parameters of the draft for ``cfg``, counted on the meta device (no
    memory is allocated)."""
    p = init_draft(cfg, None, torch.float32, "meta")
    return sum(x.numel() for x in common.tree_leaves(p))


def draft_prefill(cfg: ModelConfig, p: Params, embeds: torch.Tensor,
                  h_targets: torch.Tensor, max_seq: int) -> Any:
    """Build the draft cache over a prompt. embeds/h_targets: (B, S, D),
    same-position hiddens (shifted here)."""
    dc = _draft_cfg(cfg)
    B, S, D = embeds.shape
    x = torch.cat([embeds, shift_hidden(h_targets).to(embeds.dtype)], dim=-1)
    h = common.apply_linear(p["fuse"], x)
    xn = common.apply_norm(dc, p["ln1"], h)
    positions = torch.arange(S, device=h.device)[None, :].expand(B, S)
    _, k, v = attn_lib.qkv(dc, p["attn"], xn, positions)
    cache = draft_cache(cfg, B, max_seq, embeds.dtype, embeds.device)
    cache["k"][:, :S] = k.to(embeds.dtype)
    cache["v"][:, :S] = v.to(embeds.dtype)
    return cache


def propose_topk(model, params: Params, h_draft: torch.Tensor, k: int,
                 lm_w=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Draft hidden -> top-k speculative ids through the streaming LM-head
    top-k (``verify_topk``). ``lm_w`` overrides the LM head; a ``QTensor``
    takes the quantized top-k, a ``Shards`` of vocabulary slices the
    sharded one. Returns (spec_ids (B, k) int32, logits)."""
    hn = model.final_norm(params, h_draft)
    if lm_w is None:
        lm_w = common.lm_head_weight(params)
    return gate_lib.verify_topk(hn, lm_w, k,
                                impl=gate_lib.impl_for_flags(model.flags))
