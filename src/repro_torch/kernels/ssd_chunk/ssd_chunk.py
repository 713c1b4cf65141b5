"""Wrapper of the SSD intra-chunk CUDA kernel (counterpart of
``repro/kernels/ssd_chunk/ssd_chunk.py::ssd_chunk_fwd``; the kernel is
csrc/ssd_chunk.cu).

On a CPU tensor it runs the plain version; on a CUDA tensor it launches the
kernel (counted in ``kernels.LAUNCHES["ssd_chunk"]``) or raises. The JAX
wrapper moves the head axis in front of the chunk axis for its BlockSpecs;
the kernel reads the (B, c, nh, hd) layout with its own strides, so nothing
is transposed or copied here.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels as K
from repro_torch.kernels import build
from repro_torch.kernels.ssd_chunk.ref import ssd_chunk_ref

_P, _I = ctypes.c_void_p, ctypes.c_int


def ssd_chunk_fwd(xdt: torch.Tensor, cum: torch.Tensor, Bc: torch.Tensor,
                  Cc: torch.Tensor) -> torch.Tensor:
    """xdt (B, c, nh, hd) fp32; cum (B, c, nh) fp32; Bc, Cc (B, c, ds) fp32
    or bf16 (one dtype). Returns y_diag (B, c, nh, hd) fp32; c <= 64,
    hd <= 128."""
    if K.runs_plain(xdt):
        return ssd_chunk_ref(xdt, cum, Bc, Cc)
    Bn, c, nh, hd = xdt.shape
    ds = Bc.shape[-1]
    dev = xdt.device
    K.check_arg("xdt", xdt, dev, torch.float32)
    K.check_arg("cum", cum, dev, torch.float32, (Bn, c, nh))
    K.check_arg("Bc", Bc, dev, None, (Bn, c, ds))
    K.check_arg("Cc", Cc, dev, Bc.dtype, (Bn, c, ds))
    max_c = build.c_func("ssd_chunk", "ssd_chunk_max_c", [])()
    max_hd = build.c_func("ssd_chunk", "ssd_chunk_max_hd", [])()
    if not (1 <= c <= max_c and 1 <= hd <= max_hd):
        raise ValueError(f"ssd_chunk kernel: chunk {c} (max {max_c}) or "
                         f"head dim {hd} (max {max_hd}) out of range")
    fn = build.c_func("ssd_chunk", "ssd_chunk_launch", [_P] * 5 + [_I] * 6
                      + [_P])
    y = torch.empty(Bn, c, nh, hd, dtype=torch.float32, device=dev)
    rc = fn(K.ptr(xdt), K.ptr(cum), K.ptr(Bc), K.ptr(Cc), K.ptr(y), Bn, c,
            nh, hd, ds, K.dtype_code(Bc), K.stream_ptr(dev))
    build.check("ssd_chunk", rc)
    K.LAUNCHES["ssd_chunk"] += 1
    return y
