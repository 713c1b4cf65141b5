"""Wrapper of the decode-attention CUDA kernel (counterpart of
``repro/kernels/decode_attention/decode_attention.py::decode_attention_fwd``;
the kernel is csrc/decode_attention.cu).

On a CPU tensor it runs ``ref.decode_attention_ref``; on a CUDA tensor it
launches the kernel (counted in ``kernels.LAUNCHES``) or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch import kernels as K
from repro_torch.kernels import build
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

_P, _I = ctypes.c_void_p, ctypes.c_int


def decode_attention_fwd(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, cache_len: torch.Tensor,
                         window: Optional[int] = None) -> torch.Tensor:
    """q: (B, 1, H, hd); k_cache/v_cache: (B, S, KVH, hd); cache_len: (B,)
    int32 live length per row (>= 1). Returns (B, 1, H, hd) in q's dtype."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, cache_len, window)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    B, _, H, hd = q.shape
    S, KVH = k_cache.shape[1], k_cache.shape[2]
    dev = q.device
    K.check_arg("q", q, dev, None, (B, 1, H, hd))
    K.check_arg("k_cache", k_cache, dev, q.dtype, (B, S, KVH, hd))
    K.check_arg("v_cache", v_cache, dev, q.dtype, (B, S, KVH, hd))
    K.check_arg("cache_len", cache_len, dev, torch.int32, (B,))
    if H % KVH:
        raise ValueError(f"decode_attention: {H} heads over {KVH} KV heads")
    fn = build.c_func("decode_attention", "decode_attention_launch",
                      [_P] * 5 + [_I] * 7 + [_P])
    out = torch.empty_like(q)
    rc = fn(K.ptr(q), K.ptr(k_cache), K.ptr(v_cache), K.ptr(cache_len),
            K.ptr(out), B, S, H, KVH, hd, 0 if window is None else window,
            K.dtype_code(q), K.stream_ptr(dev))
    build.check("decode_attention", rc,
                f"decode_attention (n_rep={H // KVH}, hd={hd})")
    K.LAUNCHES["decode_attention"] += 1
    return out
