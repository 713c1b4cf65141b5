"""Wrappers of the decode-attention CUDA kernels (counterparts of
``repro/kernels/decode_attention/decode_attention.py::decode_attention_fwd``
and ``paged_decode_attention_fwd``; the kernels are the split-KV kernels
csrc/decode_attention.cu (dense cache), csrc/paged_decode_attention.cu
and, over int8 pools, csrc/paged_decode_attention_q.cu, all on the body in
csrc/paged_attention_split.cuh).

On a CPU tensor each runs its plain version from ``ref.py``; on a CUDA
tensor it launches its kernel (counted in ``kernels.LAUNCHES``) or raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch import kernels as K
from repro_torch.kernels import build
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref, paged_decode_attention_ref)

_P, _I = ctypes.c_void_p, ctypes.c_int


def decode_attention_fwd(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, cache_len: torch.Tensor,
                         window: Optional[int] = None) -> torch.Tensor:
    """q: (B, 1, H, hd); k_cache/v_cache: (B, S, KVH, hd); cache_len: (B,)
    int32 live length per row (>= 1). Returns (B, 1, H, hd) in q's dtype."""
    if K.runs_plain(q):
        return decode_attention_ref(q, k_cache, v_cache, cache_len, window)
    B, _, H, hd = q.shape
    S, KVH = k_cache.shape[1], k_cache.shape[2]
    dev = q.device
    K.check_arg("q", q, dev, None, (B, 1, H, hd))
    K.check_arg("k_cache", k_cache, dev, q.dtype, (B, S, KVH, hd))
    K.check_arg("v_cache", v_cache, dev, q.dtype, (B, S, KVH, hd))
    K.check_arg("cache_len", cache_len, dev, torch.int32, (B,))
    K.check_kv_aligned("k_cache", k_cache)
    K.check_kv_aligned("v_cache", v_cache)
    if H % KVH:
        raise ValueError(f"decode_attention: {H} heads over {KVH} KV heads")
    split = dense_grid_split(S, hd, q.element_size(), B, KVH, H // KVH)
    tickets, partials = _workspace(dev).get(
        B * H, B * KVH * -(-S // split) * (H // KVH) * (hd + 2))
    fn = build.c_func("decode_attention", "decode_attention_launch",
                      [_P] * 7 + [_I] * 8 + [_P])
    out = torch.empty_like(q)
    rc = fn(K.ptr(q), K.ptr(k_cache), K.ptr(v_cache), K.ptr(cache_len),
            K.ptr(out), K.ptr(partials), K.ptr(tickets), B, S, H, KVH, hd,
            0 if window is None else window, split, K.dtype_code(q),
            K.stream_ptr(dev))
    build.check("decode_attention", rc,
                f"decode_attention (n_rep={H // KVH}, hd={hd}, slots={S})")
    K.LAUNCHES["decode_attention"] += 1
    return out


class _Workspace:
    """Scratch of the split-KV kernels on one device: int32 tickets, one
    per (row, virtual KV head: at most one per query head), and the fp32
    partials of the splits. The
    kernels leave every ticket at 0 (the CTA that merges resets its own),
    so the tickets are zeroed once, at allocation. Both grow and never
    shrink; a buffer that is outgrown stays alive, since a CUDA graph
    captured earlier may still point at it. The port launches on one
    stream: two calls in flight on two streams would share the scratch."""

    def __init__(self, dev: torch.device) -> None:
        self.dev = dev
        self.tickets = torch.zeros(0, dtype=torch.int32, device=dev)
        self.partials = torch.empty(0, dtype=torch.float32, device=dev)
        self.outgrown: List[torch.Tensor] = []

    def get(self, n_tickets: int,
            n_floats: int) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.tickets.numel() < n_tickets:
            self.outgrown.append(self.tickets)
            self.tickets = torch.zeros(max(n_tickets, 1024),
                                       dtype=torch.int32, device=self.dev)
        if self.partials.numel() < n_floats:
            self.outgrown.append(self.partials)
            self.partials = torch.empty(max(n_floats, 1 << 16),
                                        dtype=torch.float32, device=self.dev)
        return self.tickets, self.partials


_WORKSPACES: Dict[torch.device, _Workspace] = {}


def _workspace(dev: torch.device) -> _Workspace:
    if dev not in _WORKSPACES:
        _WORKSPACES[dev] = _Workspace(dev)
    return _WORKSPACES[dev]


@functools.lru_cache(maxsize=None)
def dense_split_keys(S: int, hd: int, esize: int) -> int:
    """Keys per split of the dense kernel over a cache of ``S`` slots of
    head dim ``hd`` in elements of ``esize`` bytes, chosen by the kernel
    source (``pa::dense_split_keys``) from the shapes alone, never from the
    lengths; cached, since the decode step asks for it once per layer."""
    return build.c_func("decode_attention", "decode_attention_split_keys",
                        [_I, _I, _I])(S, hd, esize)


@functools.lru_cache(maxsize=None)
def dense_grid_split(S: int, hd: int, esize: int, B: int, KVH: int,
                     n_rep: int) -> int:
    """The dense kernel's split for a launch over ``B`` rows of ``KVH`` KV
    heads: ``dense_split_keys``, cut shorter where one split index would
    leave SMs idle (``pa::fill_split``)."""
    return build.c_func("decode_attention", "decode_attention_grid_split",
                        [_I] * 6)(S, hd, esize, B, KVH, n_rep)


@functools.lru_cache(maxsize=None)
def grid_split(name: str, P: int, ps: int, hd: int, esize: int, B: int,
               KVH: int, n_rep: int) -> int:
    """The paged kernel ``name``'s split for a launch over ``B`` rows of
    ``KVH`` KV heads: ``split_keys``, cut shorter (in whole pages) where
    one split index would leave SMs idle (``pa::fill_split``)."""
    return build.c_func(name, f"{name}_grid_split", [_I] * 7)(
        P, ps, hd, esize, B, KVH, n_rep)


def split_keys(name: str, P: int, ps: int) -> int:
    """Keys per split of the paged kernel ``name`` for rows of ``P`` pages
    of ``ps`` tokens: a multiple of ``ps``, chosen by the kernel source
    (``pa::split_keys``) from the shapes alone, never from the lengths."""
    return build.c_func(name, f"{name}_split_keys", [_I, _I])(P, ps)


def paged_decode_attention_fwd(q: torch.Tensor, k_pool: torch.Tensor,
                               v_pool: torch.Tensor, page_table: torch.Tensor,
                               cache_len: torch.Tensor,
                               window: Optional[int] = None,
                               k_scale: Optional[torch.Tensor] = None,
                               v_scale: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """Decode attention reading K/V through a page table. q: (B, 1, H, hd);
    k_pool/v_pool: (n_pages, page_size, KVH, hd), the shared pool;
    page_table: (B, P) int32 logical -> physical page; cache_len: (B,)
    int32 live length per row. Returns (B, 1, H, hd) in q's dtype. Only the
    live pages of each row are read.

    ``k_scale``/``v_scale``: (n_pages, page_size, KVH) fp32 scale pools of
    int8 K/V pools (``ModelFlags.kv_quant``), read through the same table;
    the kernel dequantizes in registers, in fp32 (counted under
    ``paged_decode_attention_q``)."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("paged_decode_attention: give both k_scale and "
                         "v_scale, or neither")
    if K.runs_plain(q):
        return paged_decode_attention_ref(q, k_pool, v_pool, page_table,
                                          cache_len, window, k_scale,
                                          v_scale)
    B, _, H, hd = q.shape
    NP, ps, KVH = k_pool.shape[0], k_pool.shape[1], k_pool.shape[2]
    P = page_table.shape[1]
    dev = q.device
    quantized = k_scale is not None
    pool_dtype = torch.int8 if quantized else q.dtype
    K.check_arg("q", q, dev, None, (B, 1, H, hd))
    K.check_arg("k_pool", k_pool, dev, pool_dtype, (NP, ps, KVH, hd))
    K.check_arg("v_pool", v_pool, dev, pool_dtype, (NP, ps, KVH, hd))
    K.check_arg("page_table", page_table, dev, torch.int32, (B, P))
    K.check_arg("cache_len", cache_len, dev, torch.int32, (B,))
    K.check_kv_aligned("k_pool", k_pool)
    K.check_kv_aligned("v_pool", v_pool)
    if H % KVH:
        raise ValueError(
            f"paged_decode_attention: {H} heads over {KVH} KV heads")
    name = "paged_decode_attention" + ("_q" if quantized else "")
    split = grid_split(name, P, ps, hd, k_pool.element_size(), B, KVH,
                       H // KVH)
    n_split = -(-P * ps // split)
    tickets, partials = _workspace(dev).get(
        B * H, B * KVH * n_split * (H // KVH) * (hd + 2))
    out = torch.empty_like(q)
    what = (f"{name} (n_rep={H // KVH}, hd={hd}, pages/row={P}, "
            f"page size={ps})")
    tail = (K.ptr(out), K.ptr(partials), K.ptr(tickets), B, P, ps, H, KVH,
            hd, 0 if window is None else window, split, K.dtype_code(q),
            K.stream_ptr(dev))
    if quantized:
        K.check_arg("k_scale", k_scale, dev, torch.float32, (NP, ps, KVH))
        K.check_arg("v_scale", v_scale, dev, torch.float32, (NP, ps, KVH))
        fn = build.c_func(name, f"{name}_launch",
                          [_P] * 10 + [_I] * 9 + [_P])
        rc = fn(K.ptr(q), K.ptr(k_pool), K.ptr(v_pool), K.ptr(k_scale),
                K.ptr(v_scale), K.ptr(page_table), K.ptr(cache_len), *tail)
    else:
        fn = build.c_func(name, f"{name}_launch", [_P] * 8 + [_I] * 9 + [_P])
        rc = fn(K.ptr(q), K.ptr(k_pool), K.ptr(v_pool), K.ptr(page_table),
                K.ptr(cache_len), *tail)
    build.check(name, rc, what)
    K.LAUNCHES[name] += 1
    return out
