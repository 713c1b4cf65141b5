"""Wrapper of the flash-attention CUDA kernel (counterpart of
``repro/kernels/flash_attention/flash_attention.py::flash_attention_fwd``;
the kernel is csrc/flash_attention.cu).

On a CPU tensor it runs ``ref.flash_attention_ref``; on a CUDA tensor it
launches the kernel (counted in ``kernels.LAUNCHES``) or raises. The JAX
wrapper's block halving (``S % block == 0``) is a TPU tiling rule: the
kernel masks the ragged last tile itself, so any S is taken as it is.
bf16 inputs run the tensor-core body of the kernel, which copies K and V
rows 16 bytes at a time: their starts must be 16-byte aligned.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch import kernels as K
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

_P, _I = ctypes.c_void_p, ctypes.c_int


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True,
                        window: Optional[int] = None) -> torch.Tensor:
    """q: (B, S, H, hd); k, v: (B, S, KVH, hd) -> (B, S, H, hd) in q's
    dtype. ``window`` applies under ``causal`` only, as in the JAX kernel."""
    if K.runs_plain(q):
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    B, S, H, hd = q.shape
    KVH = k.shape[2]
    dev = q.device
    K.check_arg("q", q, dev, None, (B, S, H, hd))
    K.check_arg("k", k, dev, q.dtype, (B, S, KVH, hd))
    K.check_arg("v", v, dev, q.dtype, (B, S, KVH, hd))
    if H % KVH:
        raise ValueError(f"flash_attention: {H} heads over {KVH} KV heads")
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16:     # the bf16 kernel copies 16-byte rows
                raise ValueError(f"flash_attention: {name} must be 16-byte "
                                 f"aligned in bf16")
    fn = build.c_func("flash_attention", "flash_attention_launch",
                      [_P] * 4 + [_I] * 8 + [_P])
    out = torch.empty_like(q)
    rc = fn(K.ptr(q), K.ptr(k), K.ptr(v), K.ptr(out), B, S, H, KVH, hd,
            int(bool(causal)),
            0 if (window is None or not causal) else window,
            K.dtype_code(q), K.stream_ptr(dev))
    build.check("flash_attention", rc,
                f"flash_attention (S={S}, n_rep={H // KVH}, hd={hd})")
    K.LAUNCHES["flash_attention"] += 1
    return out
