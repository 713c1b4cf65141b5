"""Wrappers of the speculative LM-head CUDA kernels (counterparts of
``repro/kernels/spec_head/spec_head.py::spec_head_logits`` and
``spec_head_logits_q``).

The spec head runs in two stages: ``spec_head_gather``
(csrc/spec_head_gather.cu) copies the needed head columns into a
contiguous (C, D) buffer, and ``spec_head_dot`` (csrc/spec_head.cu) takes
each row's dots with its columns there. Over a quantized head
``spec_head_gather_q`` (csrc/spec_head_gather_q.cu) copies the columns'
codes and scales (a ``QCols``), and ``spec_head_dot_q``
(csrc/spec_head_q.cu) dots with the codes and scales each sum.
``spec_head_logits`` and ``spec_head_logits_q`` compose the two for any
ids; the tree step calls the stages itself, to gather its node tokens'
columns once per step (``core/engine.py::tree_decode_step``,
``core/features.py``).

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches its kernel (counted in ``kernels.LAUNCHES``) or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels as K
from repro_torch.kernels import build
from repro_torch.kernels.spec_head.ref import (QCols, spec_dot_q_ref,
                                               spec_dot_ref,
                                               spec_gather_q_ref,
                                               spec_gather_ref,
                                               spec_logits_ref)
from repro_torch.quant import QTensor

_P, _I = ctypes.c_void_p, ctypes.c_int


def spec_head_gather(lm_head: torch.Tensor, ids: torch.Tensor
                     ) -> torch.Tensor:
    """lm_head (D, V) fp32 or bf16; ids (C,) int32, C >= 1 -> cols (C, D)
    of the head's dtype, ``cols[c] = lm_head[:, ids[c]]`` (ids clamped to
    [0, V)), an exact copy."""
    if K.runs_plain(lm_head):
        return spec_gather_ref(lm_head, ids)
    D, V = lm_head.shape
    C = ids.shape[0]
    dev = lm_head.device
    K.check_arg("lm_head", lm_head, dev)
    K.check_arg("ids", ids, dev, torch.int32, (C,))
    if C < 1:
        raise ValueError("spec_head_gather kernel: no ids")
    fn = build.c_func("spec_head_gather", "spec_head_gather_launch",
                      [_P] * 3 + [_I] * 4 + [_P])
    cols = torch.empty(C, D, dtype=lm_head.dtype, device=dev)
    rc = fn(K.ptr(lm_head), K.ptr(ids), K.ptr(cols), C, D, V,
            K.dtype_code(lm_head), K.stream_ptr(dev))
    build.check("spec_head_gather", rc)
    K.LAUNCHES["spec_head_gather"] += 1
    return cols


def spec_head_dot(hn: torch.Tensor, cols: torch.Tensor,
                  idx: torch.Tensor) -> torch.Tensor:
    """hn (R, D); cols (C, D) of hn's dtype (``spec_head_gather``'s
    output); idx (R, k) int32 rows of cols (clamped to [0, C)) -> logits
    (R, k) fp32, ``hn[r] . cols[idx[r, j]]``, any R, k >= 1."""
    if K.runs_plain(hn):
        return spec_dot_ref(hn, cols, idx)
    R, D = hn.shape
    C = cols.shape[0]
    k = idx.shape[1]
    dev = hn.device
    K.check_arg("hn", hn, dev)
    K.check_arg("cols", cols, dev, hn.dtype, (C, D))
    K.check_arg("idx", idx, dev, torch.int32, (R, k))
    if R < 1 or C < 1 or k < 1:
        raise ValueError(f"spec_head kernel: empty operand (R={R}, C={C}, "
                         f"k={k})")
    fn = build.c_func("spec_head", "spec_head_launch", [_P] * 4 + [_I] * 5
                      + [_P])
    logits = torch.empty(R, k, dtype=torch.float32, device=dev)
    rc = fn(K.ptr(hn), K.ptr(cols), K.ptr(idx), K.ptr(logits), R, C, D, k,
            K.dtype_code(hn), K.stream_ptr(dev))
    build.check("spec_head", rc)
    K.LAUNCHES["spec_head"] += 1
    return logits


def spec_head_logits(hn: torch.Tensor, lm_head: torch.Tensor,
                     spec_ids: torch.Tensor) -> torch.Tensor:
    """hn (R, D); lm_head (D, V) of hn's dtype; spec_ids (R, k) int32 ->
    logits (R, k) fp32, any R >= 1: the R*k columns gathered, then one dot
    per (row, column)."""
    if K.runs_plain(hn):
        return spec_logits_ref(hn, lm_head, spec_ids)
    R, D = hn.shape
    k = spec_ids.shape[1]
    dev = hn.device
    K.check_arg("lm_head", lm_head, dev, hn.dtype, (D, lm_head.shape[1]))
    K.check_arg("spec_ids", spec_ids, dev, torch.int32, (R, k))
    cols = spec_head_gather(lm_head, spec_ids.reshape(-1))
    idx = torch.arange(R * k, dtype=torch.int32, device=dev).view(R, k)
    return spec_head_dot(hn, cols, idx)


def spec_head_gather_q(qt: QTensor, ids: torch.Tensor) -> QCols:
    """qt a QTensor of logical shape (D, V) (int8 codes (D, V) or packed
    int4 (D/2, V)); ids (C,) int32, C >= 1 -> QCols: codes (C, Dp) int8,
    ``codes[c] = qt.q[:, ids[c]]``, and scales (C,) fp32,
    ``scales[c] = qt.scale[ids[c]]`` (ids clamped to [0, V)), exact
    copies."""
    if K.runs_plain(qt.q):
        return spec_gather_q_ref(qt, ids)
    Dp, V = qt.q.shape
    C = ids.shape[0]
    dev = qt.q.device
    K.check_qtensor("lm_head", qt, dev, qt.shape)
    K.check_arg("ids", ids, dev, torch.int32, (C,))
    if C < 1:
        raise ValueError("spec_head_gather_q kernel: no ids")
    fn = build.c_func("spec_head_gather_q", "spec_head_gather_q_launch",
                      [_P] * 5 + [_I] * 3 + [_P])
    codes = torch.empty(C, Dp, dtype=torch.int8, device=dev)
    scales = torch.empty(C, dtype=torch.float32, device=dev)
    rc = fn(K.ptr(qt.q), K.ptr(qt.scale), K.ptr(ids), K.ptr(codes),
            K.ptr(scales), C, Dp, V, K.stream_ptr(dev))
    build.check("spec_head_gather_q", rc)
    K.LAUNCHES["spec_head_gather_q"] += 1
    return QCols(codes, scales, qt.bits)


def spec_head_dot_q(hn: torch.Tensor, cols: QCols,
                    idx: torch.Tensor) -> torch.Tensor:
    """hn (R, D) fp32 or bf16; cols ``spec_head_gather_q``'s output (codes
    (C, D) for int8, (C, D/2) for int4); idx (R, k) int32 rows of the
    gathered columns (clamped to [0, C)) -> logits (R, k) fp32,
    ``(hn[r] . codes[c]) * scales[c]``, c = idx[r, j], any R, k >= 1."""
    if K.runs_plain(hn):
        return spec_dot_q_ref(hn, cols, idx)
    R, D = hn.shape
    C = cols.codes.shape[0]
    k = idx.shape[1]
    dev = hn.device
    if cols.bits not in (4, 8) or (cols.bits == 4 and D % 2):
        raise ValueError(f"spec_head_q kernel: {cols.bits}-bit codes of "
                         f"{D} hidden entries")
    K.check_arg("hn", hn, dev)
    K.check_arg("codes", cols.codes, dev, torch.int8,
                (C, D // 2 if cols.bits == 4 else D))
    K.check_arg("scales", cols.scales, dev, torch.float32, (C,))
    K.check_arg("idx", idx, dev, torch.int32, (R, k))
    if R < 1 or C < 1 or k < 1:
        raise ValueError(f"spec_head_q kernel: empty operand (R={R}, "
                         f"C={C}, k={k})")
    fn = build.c_func("spec_head_q", "spec_head_q_launch", [_P] * 5
                      + [_I] * 6 + [_P])
    logits = torch.empty(R, k, dtype=torch.float32, device=dev)
    rc = fn(K.ptr(hn), K.ptr(cols.codes), K.ptr(cols.scales), K.ptr(idx),
            K.ptr(logits), R, C, D, k, cols.bits, K.dtype_code(hn),
            K.stream_ptr(dev))
    build.check("spec_head_q", rc)
    K.LAUNCHES["spec_head_q"] += 1
    return logits


def spec_head_logits_q(hn: torch.Tensor, qt: QTensor,
                       spec_ids: torch.Tensor) -> torch.Tensor:
    """hn (R, D); qt a QTensor of logical shape (D, V); spec_ids (R, k)
    int32 -> logits (R, k) fp32 (each gathered column's sum times its
    scale), any R >= 1: the R*k code columns gathered, then one dot per
    (row, column)."""
    if K.runs_plain(hn):
        return spec_logits_ref(hn, qt, spec_ids)
    R, D = hn.shape
    k = spec_ids.shape[1]
    dev = hn.device
    K.check_arg("hn", hn, dev)
    K.check_qtensor("lm_head", qt, dev, (D, qt.shape[-1]))
    K.check_arg("spec_ids", spec_ids, dev, torch.int32, (R, k))
    cols = spec_head_gather_q(qt, spec_ids.reshape(-1))
    idx = torch.arange(R * k, dtype=torch.int32, device=dev).view(R, k)
    return spec_head_dot_q(hn, cols, idx)
