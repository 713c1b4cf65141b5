"""Wrappers of the speculative LM-head CUDA kernels (counterparts of
``repro/kernels/spec_head/spec_head.py::spec_head_logits`` and
``spec_head_logits_q``; the kernels are csrc/spec_head.cu and
csrc/spec_head_q.cu, whose gather-dot body csrc/spec_head.cuh the fused
exit gate shares).

On a CPU tensor it runs the plain version; on a CUDA tensor it launches the
kernel (counted in ``kernels.LAUNCHES``) or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels as K
from repro_torch.kernels import build
from repro_torch.kernels.spec_head.ref import spec_logits_ref
from repro_torch.quant import QTensor

_P, _I = ctypes.c_void_p, ctypes.c_int


def spec_head_logits(hn: torch.Tensor, lm_head: torch.Tensor,
                     spec_ids: torch.Tensor) -> torch.Tensor:
    """hn (R, D); lm_head (D, V) of hn's dtype; spec_ids (R, k) int32 ->
    logits (R, k) fp32, any R >= 1."""
    if K.runs_plain(hn):
        return spec_logits_ref(hn, lm_head, spec_ids)
    R, D = hn.shape
    V = lm_head.shape[1]
    k = spec_ids.shape[1]
    dev = hn.device
    K.check_arg("hn", hn, dev)
    K.check_arg("lm_head", lm_head, dev, hn.dtype, (D, V))
    K.check_arg("spec_ids", spec_ids, dev, torch.int32, (R, k))
    if not 1 <= k <= build.c_func("spec_head", "spec_head_max_k", [])():
        raise ValueError(f"spec_head kernel: unsupported k={k}")
    fn = build.c_func("spec_head", "spec_head_launch", [_P] * 4 + [_I] * 5
                      + [_P])
    logits = torch.empty(R, k, dtype=torch.float32, device=dev)
    rc = fn(K.ptr(hn), K.ptr(lm_head), K.ptr(spec_ids), K.ptr(logits), R, D,
            V, k, K.dtype_code(hn), K.stream_ptr(dev))
    build.check("spec_head", rc)
    K.LAUNCHES["spec_head"] += 1
    return logits


def spec_head_logits_q(hn: torch.Tensor, qt: QTensor,
                       spec_ids: torch.Tensor) -> torch.Tensor:
    """hn (R, D); qt a QTensor of logical shape (D, V); spec_ids (R, k)
    int32 -> logits (R, k) fp32 (each gathered column's sum times its
    scale), any R >= 1."""
    if K.runs_plain(hn):
        return spec_logits_ref(hn, qt, spec_ids)
    R, D = hn.shape
    V = qt.shape[-1]
    k = spec_ids.shape[1]
    dev = hn.device
    K.check_arg("hn", hn, dev)
    K.check_qtensor("lm_head", qt, dev, (D, V))
    K.check_arg("spec_ids", spec_ids, dev, torch.int32, (R, k))
    if not 1 <= k <= build.c_func("spec_head_q", "spec_head_q_max_k", [])():
        raise ValueError(f"spec_head_q kernel: unsupported k={k}")
    fn = build.c_func("spec_head_q", "spec_head_q_launch", [_P] * 5
                      + [_I] * 6 + [_P])
    logits = torch.empty(R, k, dtype=torch.float32, device=dev)
    rc = fn(K.ptr(hn), K.ptr(qt.q), K.ptr(qt.scale), K.ptr(spec_ids),
            K.ptr(logits), R, D, V, k, qt.bits, K.dtype_code(hn),
            K.stream_ptr(dev))
    build.check("spec_head_q", rc)
    K.LAUNCHES["spec_head_q"] += 1
    return logits
