"""Wrappers of the predictor-MLP CUDA kernels (counterparts of
``repro/kernels/predictor_mlp/predictor_mlp.py::predictor_mlp_fused`` and
``predictor_mlp_fused_q``; the kernels are csrc/predictor_mlp.cu and
csrc/predictor_mlp_q.cu).

On a CPU tensor it runs the plain version; on a CUDA tensor it launches the
kernel (counted in ``kernels.LAUNCHES``) or raises. The JAX wrapper pads
rows to its block and F to the 128-lane boundary; the kernels take any R
(the fp one a row a CTA, the quantized one a block of 4 with its ragged
last block masked) and F up to 32, so no padding is made here.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels as K
from repro_torch.kernels import build
from repro_torch.kernels.predictor_mlp.ref import (predictor_mlp_q_ref,
                                                   predictor_mlp_ref)
from repro_torch.quant import QTensor

_P, _I = ctypes.c_void_p, ctypes.c_int


def predictor_mlp_fused(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                        w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """x (R, F) fp32; w1 (F, H), b1 (H,), w2 (H, 1), b2 (1,) fp32 ->
    (R,) exit probabilities, any R >= 1."""
    if K.runs_plain(x):
        return predictor_mlp_ref(x, w1, b1, w2, b2)
    R, F = x.shape
    H = w1.shape[1]
    dev = x.device
    K.check_arg("x", x, dev, torch.float32)
    K.check_arg("w1", w1, dev, torch.float32, (F, H))
    K.check_arg("b1", b1, dev, torch.float32, (H,))
    K.check_arg("w2", w2, dev, torch.float32, (H, 1))
    K.check_arg("b2", b2, dev, torch.float32, (1,))
    if F > build.c_func("predictor_mlp", "predictor_mlp_max_f", [])():
        raise ValueError(f"predictor_mlp kernel: feature dim {F} too large")
    fn = build.c_func("predictor_mlp", "predictor_mlp_launch",
                      [_P] * 6 + [_I] * 3 + [_P])
    out = torch.empty(R, dtype=torch.float32, device=dev)
    rc = fn(K.ptr(x), K.ptr(w1), K.ptr(b1), K.ptr(w2), K.ptr(b2), K.ptr(out),
            R, F, H, K.stream_ptr(dev))
    build.check("predictor_mlp", rc)
    K.LAUNCHES["predictor_mlp"] += 1
    return out


def predictor_mlp_fused_q(x: torch.Tensor, qw1: QTensor, b1: torch.Tensor,
                          qw2: QTensor, b2: torch.Tensor) -> torch.Tensor:
    """x (R, F) fp32; qw1, qw2 QTensors of logical shapes (F, H) and
    (H, 1), each int8 or int4 on its own; b1 (H,), b2 (1,) fp32 ->
    (R,) exit probabilities, any R >= 1."""
    if K.runs_plain(x):
        return predictor_mlp_q_ref(x, qw1, b1, qw2, b2)
    R, F = x.shape
    H = qw1.shape[-1]
    dev = x.device
    K.check_arg("x", x, dev, torch.float32)
    K.check_qtensor("w1", qw1, dev, (F, H))
    K.check_arg("b1", b1, dev, torch.float32, (H,))
    K.check_qtensor("w2", qw2, dev, (H, 1))
    K.check_arg("b2", b2, dev, torch.float32, (1,))
    if F > build.c_func("predictor_mlp_q", "predictor_mlp_q_max_f", [])():
        raise ValueError(f"predictor_mlp_q kernel: feature dim {F} too "
                         "large")
    fn = build.c_func("predictor_mlp_q", "predictor_mlp_q_launch",
                      [_P] * 8 + [_I] * 5 + [_P])
    out = torch.empty(R, dtype=torch.float32, device=dev)
    rc = fn(K.ptr(x), K.ptr(qw1.q), K.ptr(qw1.scale), K.ptr(b1),
            K.ptr(qw2.q), K.ptr(qw2.scale), K.ptr(b2), K.ptr(out), R, F, H,
            qw1.bits, qw2.bits, K.stream_ptr(dev))
    build.check("predictor_mlp_q", rc)
    K.LAUNCHES["predictor_mlp_q"] += 1
    return out
