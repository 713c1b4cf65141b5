"""Attention (counterpart of ``repro/models/attention.py``): GQA, causal or
sliding-window, against a (B, S, KVH, hd) KV cache. Plain torch, masked
fp32 softmax, ``NEG_INF`` for masked scores."""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import common
from repro_torch.models.common import Params

NEG_INF = -1e30


def init_attention(cfg: ModelConfig, gen, dtype, device) -> Params:
    d = cfg.d_model
    hd = cfg.resolved_head_dim()
    out_std = 1.0 / math.sqrt(cfg.num_heads * hd) / math.sqrt(
        2 * cfg.num_layers)
    lin = common.init_linear
    return {
        "wq": lin(gen, d, cfg.num_heads * hd, cfg.use_bias, dtype, device),
        "wk": lin(gen, d, cfg.num_kv_heads * hd, cfg.use_bias, dtype, device),
        "wv": lin(gen, d, cfg.num_kv_heads * hd, cfg.use_bias, dtype, device),
        "wo": lin(gen, cfg.num_heads * hd, d, cfg.use_bias, dtype, device,
                  std=out_std),
    }


def qkv(cfg: ModelConfig, p: Params, x: torch.Tensor, positions: torch.Tensor
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> q (B,S,H,hd), k,v (B,S,KVH,hd), with RoPE applied
    in a decoder (the encoder, hubert, is position-free here, as in the
    JAX package)."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim()
    q = common.apply_linear(p["wq"], x).reshape(B, S, cfg.num_heads, hd)
    k = common.apply_linear(p["wk"], x).reshape(B, S, cfg.num_kv_heads, hd)
    v = common.apply_linear(p["wv"], x).reshape(B, S, cfg.num_kv_heads, hd)
    if cfg.causal:
        tables = common.rope_tables(positions, hd, cfg.rope_theta)
        q = common.apply_rope(q, positions, cfg.rope_theta, tables)
        k = common.apply_rope(k, positions, cfg.rope_theta, tables)
    return q, k, v


def kv_only(cfg: ModelConfig, p: Params, x: torch.Tensor,
            positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K/V projections only — SpecEE KV propagation of skipped layers."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim()
    k = common.apply_linear(p["wk"], x).reshape(B, S, cfg.num_kv_heads, hd)
    v = common.apply_linear(p["wv"], x).reshape(B, S, cfg.num_kv_heads, hd)
    if cfg.causal:
        k = common.apply_rope(k, positions, cfg.rope_theta)
    return k, v


def _repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, KVH, hd) -> (B, S, KVH*n_rep, hd)."""
    if n_rep == 1:
        return x
    B, S, KVH, hd = x.shape
    return x[:, :, :, None, :].expand(B, S, KVH, n_rep, hd).reshape(
        B, S, KVH * n_rep, hd)


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Reference attention. q: (B, Sq, H, hd); k, v: (B, Sk, H, hd); mask
    broadcastable to (B, H, Sq, Sk), True = attend. Softmax in fp32."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if mask is not None:
        logits = torch.where(mask, logits,
                             torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def causal_mask(Sq: int, Sk: int, q_offset: int = 0,
                window: Optional[int] = None, device=None) -> torch.Tensor:
    """(1, 1, Sq, Sk) boolean mask; window = sliding-window size."""
    qpos = torch.arange(Sq, device=device)[:, None] + q_offset
    kpos = torch.arange(Sk, device=device)[None, :]
    m = kpos <= qpos
    if window is not None:
        m = m & (kpos > qpos - window)
    return m[None, None]


def attend_full(cfg: ModelConfig, q, k, v,
                window: Optional[int] = None) -> torch.Tensor:
    """Self-attention over a full sequence (prefill path); bidirectional
    in an encoder."""
    n_rep = cfg.num_heads // cfg.num_kv_heads
    k, v = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
    S = q.shape[1]
    mask = (causal_mask(S, S, 0, window, device=q.device) if cfg.causal
            else None)
    return sdpa(q, k, v, mask)


def _chunk_of(S: int, chunk: int) -> int:
    """The query-chunk size: ``chunk``, halved until it divides S."""
    chunk = min(chunk, S)
    while S % chunk:
        chunk //= 2
    return chunk


def attend_full_chunked(cfg: ModelConfig, q, k, v,
                        window: Optional[int] = None,
                        chunk: int = 512) -> torch.Tensor:
    """Exact attention a query chunk at a time, so the peak logits tensor is
    (B, H, chunk, S) rather than (B, H, S, S) (JAX ``attention.py:107``).
    Every chunk reads every key; the mask does the causal cut."""
    B, S, H, hd = q.shape
    n_rep = cfg.num_heads // cfg.num_kv_heads
    k, v = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
    chunk = _chunk_of(S, chunk)
    kpos = torch.arange(S, device=q.device)[None, :]
    outs = []
    for i in range(S // chunk):
        mask = None
        if cfg.causal:
            qpos = i * chunk + torch.arange(chunk, device=q.device)[:, None]
            m = kpos <= qpos
            if window is not None:
                m = m & (kpos > qpos - window)
            mask = m[None, None]
        outs.append(sdpa(q[:, i * chunk:(i + 1) * chunk], k, v, mask))
    return torch.cat(outs, dim=1)


def attend_full_chunked_pruned(cfg: ModelConfig, q, k, v,
                               window: Optional[int] = None,
                               chunk: int = 512) -> torch.Tensor:
    """Causally pruned chunked attention (JAX ``attention.py:146``): query
    chunk i reads only key chunks ``lo .. i`` (``lo`` from the window), so
    key blocks above the diagonal are never computed. JAX runs an online
    softmax over those key chunks in a ``fori_loop``; here one fp32
    softmax over their concatenation gives the same values (one launch
    chain per query chunk, not per key chunk). Causal only."""
    assert cfg.causal
    B, S, H, hd = q.shape
    n_rep = cfg.num_heads // cfg.num_kv_heads
    k, v = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
    chunk = _chunk_of(S, chunk)
    scale = 1.0 / math.sqrt(hd)
    outs = []
    for i in range(S // chunk):
        lo = 0 if window is None else max(0, (i * chunk - window) // chunk)
        q0, k0, k1 = i * chunk, lo * chunk, (i + 1) * chunk
        qf = q[:, q0:k1].transpose(1, 2).float() * scale      # (B,H,c,hd)
        kf = k[:, k0:k1].transpose(1, 2).float()
        vf = v[:, k0:k1].transpose(1, 2).float()
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kf)
        qpos = torch.arange(q0, k1, device=q.device)[:, None]
        kpos = torch.arange(k0, k1, device=q.device)[None, :]
        mask = kpos <= qpos
        if window is not None:
            mask = mask & (kpos > qpos - window)
        s = torch.where(mask[None, None], s, torch.full_like(s, NEG_INF))
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        l = p.sum(dim=-1, keepdim=True)
        out = torch.einsum("bhqk,bhkd->bhqd", p, vf)
        out = out / torch.where(l == 0.0, torch.ones_like(l), l)
        outs.append(out.transpose(1, 2).to(q.dtype))
    return torch.cat(outs, dim=1)


def attend_decode(cfg: ModelConfig, q, k_cache, v_cache, cache_len,
                  window: Optional[int] = None) -> torch.Tensor:
    """One-step decode attention with grouped einsums.
    q: (B, 1, H, hd); cache_len: (B,) valid slots (the current token's K/V
    already written at cache_len - 1)."""
    B, _, H, hd = q.shape
    KVH = k_cache.shape[2]
    n_rep = H // KVH
    S = k_cache.shape[1]
    scale = 1.0 / math.sqrt(hd)
    qg = q[:, 0].reshape(B, KVH, n_rep, hd)
    logits = torch.einsum("bgrd,bsgd->bgrs", qg, k_cache).float() * scale
    kpos = torch.arange(S, device=q.device)[None, :]
    clen = torch.as_tensor(cache_len, device=q.device).reshape(-1, 1)
    valid = kpos < clen
    if window is not None:
        valid = valid & (kpos >= clen - window)
    logits = torch.where(valid[:, None, None, :], logits,
                         torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bgrs,bsgd->bgrd", probs.to(v_cache.dtype), v_cache)
    return out.reshape(B, 1, H, hd)


def attend_extend(cfg: ModelConfig, q, k_cache, v_cache, start_pos,
                  window: Optional[int] = None) -> torch.Tensor:
    """Chunked-prefill attention: C queries extend a prefix cache.
    q: (B, C, H, hd) at absolute positions start_pos + i; k_cache/v_cache:
    (B, S, KVH, hd) with the chunk's K/V already written there; start_pos:
    (B,) prefix length. Query i attends kpos <= start_pos + i, so one chunk
    at a time reproduces full causal attention (``attend_decode`` is C = 1).
    """
    B, C, H, hd = q.shape
    S, KVH = k_cache.shape[1], k_cache.shape[2]
    n_rep = H // KVH
    kk, vv = _repeat_kv(k_cache, n_rep), _repeat_kv(v_cache, n_rep)
    qpos = (torch.as_tensor(start_pos, device=q.device).reshape(-1, 1).long()
            + torch.arange(C, device=q.device)[None, :])           # (B, C)
    kpos = torch.arange(S, device=q.device)
    valid = kpos[None, None, :] <= qpos[:, :, None]                 # (B,C,S)
    if window is not None:
        valid = valid & (kpos[None, None, :] > qpos[:, :, None] - window)
    return sdpa(q, kk, vv, valid[:, None])


@functools.lru_cache(maxsize=None)
def shard_cfg(cfg: ModelConfig, degree: int) -> ModelConfig:
    """The config one tensor-parallel shard of ``degree`` computes with:
    its own query and KV heads (``num_heads / degree``, ``num_kv_heads /
    degree``, or one whole KV head where the degree exceeds the KV heads:
    ``sharding/serving.py`` gives each shard the KV head its query heads
    read) at the model's head_dim, so ``qkv``, the attention paths and the
    kernels read a shard's slice as a whole model's."""
    return dataclasses.replace(
        cfg, num_heads=cfg.num_heads // degree,
        num_kv_heads=max(1, cfg.num_kv_heads // degree),
        head_dim=cfg.resolved_head_dim())


def kv_segs(cfg: ModelConfig):
    """The KV-head dim's shard layout (``sharding.ctx``): the KV heads
    split among the shards, a head on several shards where the degree
    exceeds the KV heads."""
    return ((cfg.num_kv_heads, 1, True),)


def param_segs(cfg: ModelConfig):
    """Shard layouts of wk/wv (and their biases), by leaf path in the
    block, as (dim from the end, segments): whole KV heads, so a shard of
    a degree above the KV heads holds the one its query heads read (the
    same split as the spec's where the degree divides the KV heads)."""
    kv = ((cfg.num_kv_heads, cfg.resolved_head_dim(), True),)
    leaves = ("w", "b") if cfg.use_bias else ("w",)
    return {f"{n}/{leaf}": (-1, kv) for n in ("wk", "wv") for leaf in leaves}


def out_proj(p: Params, attn_out: torch.Tensor,
             pet: Optional[torch.dtype] = None) -> torch.Tensor:
    B, S, H, hd = attn_out.shape
    return common.apply_linear(p["wo"], attn_out.reshape(B, S, H * hd),
                               pet)
