"""Wrappers of the three exit-gate CUDA kernels (counterparts of the Pallas
kernels in ``repro/kernels/exit_gate/exit_gate.py``).

``exit_gate_fused``     — csrc/exit_gate.cu: gather-GEMM + softmax +
                          Δ-features + 2-layer predictor, a thread-block
                          cluster per row (the CTAs split the hidden
                          dimension and the hidden units, and sum their
                          partials in rank order through shared memory).
``exit_gate_fused_q``   — csrc/exit_gate_q.cu: the same gate, one launch,
                          with a quantized head or predictor bank (or
                          both); the body of both gates is
                          csrc/exit_gate.cuh.
``argmax_verify_fused`` — csrc/argmax_verify.cu: LM-head argmax.
``topk_verify_fused``   — csrc/topk_verify.cu: LM-head top-k.
``argmax_verify_fused_q`` / ``topk_verify_fused_q`` — csrc/argmax_verify_q.cu
                          and csrc/topk_verify_q.cu: the same over a
                          quantized head (``repro_torch.quant.QTensor``,
                          int8 or plane-packed int4 codes + column scales).
Every verify takes any row count. With bf16 hidden rows all four run the
tensor-core tile of ``csrc/lm_head_mma.cuh`` (row tiles of up to 256 rows;
they refuse hidden rows that the tile cannot copy 16 bytes at a time);
fp32 hidden rows stream on the CUDA cores (groups of 8 rows per CTA).

On a CPU tensor each wrapper runs its plain version from ``ref.py``; on a
CUDA tensor it launches its kernel (counted in ``kernels.LAUNCHES``) or
raises. Outputs and scratch are allocated here with ``torch.empty``; the
kernels run on the current stream and do not synchronize.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch import kernels as K
from repro_torch.kernels import build
from repro_torch.kernels.exit_gate import ref as gate_ref
from repro_torch.quant import QTensor

_P, _I = ctypes.c_void_p, ctypes.c_int


def exit_gate_fused(hn: torch.Tensor, lm_head: torch.Tensor,
                    spec_ids: torch.Tensor, prev_probs: torch.Tensor,
                    w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                    b2: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """hn (B, D); lm_head (D, V); spec_ids (B, k) int32; prev_probs (B, k)
    fp32; predictor w1 (3k, H), b1 (H,), w2 (H, 1), b2 (1,) fp32.
    Returns (p_exit (B,), probs (B, k), logits (B, k)), all fp32."""
    if K.runs_plain(hn):
        pred = {"layers": [{"w": w1, "b": b1}, {"w": w2, "b": b2}]}
        return gate_ref.exit_gate_ref(hn, lm_head, spec_ids, prev_probs, pred)
    B, D = hn.shape
    V = lm_head.shape[1]
    k = spec_ids.shape[1]
    H = w1.shape[1]
    dev = hn.device
    K.check_arg("hn", hn, dev)
    K.check_arg("lm_head", lm_head, dev, hn.dtype, (D, V))
    K.check_arg("spec_ids", spec_ids, dev, torch.int32, (B, k))
    K.check_arg("prev_probs", prev_probs, dev, torch.float32, (B, k))
    K.check_arg("w1", w1, dev, torch.float32, (3 * k, H))
    K.check_arg("b1", b1, dev, torch.float32, (H,))
    K.check_arg("w2", w2, dev, torch.float32, (H, 1))
    K.check_arg("b2", b2, dev, torch.float32, (1,))
    fn = build.c_func("exit_gate", "exit_gate_launch", [_P] * 11 + [_I] * 6
                      + [_P])
    if k > build.c_func("exit_gate", "exit_gate_max_k", [])():
        raise ValueError(f"exit_gate kernel: k={k} too large")
    p = torch.empty(B, dtype=torch.float32, device=dev)
    probs = torch.empty(B, k, dtype=torch.float32, device=dev)
    logits = torch.empty(B, k, dtype=torch.float32, device=dev)
    rc = fn(K.ptr(hn), K.ptr(lm_head), K.ptr(spec_ids), K.ptr(prev_probs),
            K.ptr(w1), K.ptr(b1), K.ptr(w2), K.ptr(b2), K.ptr(p),
            K.ptr(probs), K.ptr(logits), B, D, V, k, H, K.dtype_code(hn),
            K.stream_ptr(dev))
    build.check("exit_gate", rc)
    K.LAUNCHES["exit_gate"] += 1
    return p, probs, logits


def _bank_args(dev, F: int, l1, l2):
    """(bits1, bits2, w1, s1, w2, s2) of a 2-layer predictor, fp32 or
    quantized (each layer's codes and scales checked, contiguous: a bank
    slice that is not is refused, never copied); bits1 = 0 for fp32."""
    H = l1["b"].shape[-1]
    K.check_arg("b1", l1["b"], dev, torch.float32, (H,))
    K.check_arg("b2", l2["b"], dev, torch.float32, (1,))
    w1, w2 = l1["w"], l2["w"]
    if isinstance(w1, QTensor) != isinstance(w2, QTensor):
        raise ValueError("exit_gate_q kernel: predictor layers must be both "
                         "quantized or both fp")
    if not isinstance(w1, QTensor):
        K.check_arg("w1", w1, dev, torch.float32, (F, H))
        K.check_arg("w2", w2, dev, torch.float32, (H, 1))
        return 0, 0, w1, w1, w2, w2
    K.check_qtensor("w1", w1, dev, (F, H))
    K.check_qtensor("w2", w2, dev, (H, 1))
    return w1.bits, w2.bits, w1.q, w1.scale, w2.q, w2.scale


def exit_gate_fused_q(hn: torch.Tensor, lm_head, spec_ids: torch.Tensor,
                      prev_probs: torch.Tensor, l1, l2
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The exit gate with quantized weights in one launch. hn (B, D);
    lm_head (D, V) of hn's dtype or a QTensor of logical shape (D, V);
    spec_ids (B, k) int32; prev_probs (B, k) fp32; the predictor's layers
    l1 = {"w": (3k, H), "b": (H,)}, l2 = {"w": (H, 1), "b": (1,)}, each
    ``w`` fp32 or a QTensor; the head or the bank (or both) quantized.
    Returns (p_exit (B,), probs (B, k), logits (B, k)), all fp32."""
    if K.runs_plain(hn):
        return gate_ref.exit_gate_q_ref(hn, lm_head, spec_ids, prev_probs,
                                        l1, l2)
    B, D = hn.shape
    k = spec_ids.shape[1]
    dev = hn.device
    K.check_arg("hn", hn, dev)
    if isinstance(lm_head, QTensor):
        V = lm_head.shape[-1]
        K.check_qtensor("lm_head", lm_head, dev, (D, V))
        head_bits, head, head_scale = lm_head.bits, lm_head.q, lm_head.scale
    else:
        V = lm_head.shape[1]
        K.check_arg("lm_head", lm_head, dev, hn.dtype, (D, V))
        head_bits, head, head_scale = 0, lm_head, lm_head
    K.check_arg("spec_ids", spec_ids, dev, torch.int32, (B, k))
    K.check_arg("prev_probs", prev_probs, dev, torch.float32, (B, k))
    bits1, bits2, w1, s1, w2, s2 = _bank_args(dev, 3 * k, l1, l2)
    if head_bits == 0 and bits1 == 0:
        raise ValueError("exit_gate_q kernel: neither the head nor the bank "
                         "is quantized (the fp gate is exit_gate_fused)")
    if not 1 <= k <= build.c_func("exit_gate_q", "exit_gate_q_max_k", [])():
        raise ValueError(f"exit_gate_q kernel: unsupported k={k}")
    fn = build.c_func("exit_gate_q", "exit_gate_q_launch",
                      [_P] * 14 + [_I] * 9 + [_P])
    H = l1["b"].shape[-1]
    p = torch.empty(B, dtype=torch.float32, device=dev)
    probs = torch.empty(B, k, dtype=torch.float32, device=dev)
    logits = torch.empty(B, k, dtype=torch.float32, device=dev)
    rc = fn(K.ptr(hn), K.ptr(head), K.ptr(head_scale), K.ptr(spec_ids),
            K.ptr(prev_probs), K.ptr(w1), K.ptr(s1), K.ptr(l1["b"]),
            K.ptr(w2), K.ptr(s2), K.ptr(l2["b"]), K.ptr(p), K.ptr(probs),
            K.ptr(logits), B, D, V, k, H, head_bits, bits1, bits2,
            K.dtype_code(hn), K.stream_ptr(dev))
    build.check("exit_gate_q", rc)
    K.LAUNCHES["exit_gate_q"] += 1
    return p, probs, logits


def _stream_args(name: str, hn: torch.Tensor, lm_head: torch.Tensor):
    B, D = hn.shape
    V = lm_head.shape[1]
    dev = hn.device
    K.check_arg("hn", hn, dev)
    K.check_arg("lm_head", lm_head, dev, hn.dtype, (D, V))
    nblk = -(-V // build.c_func(name, f"{name}_block_cols", [])())
    return B, D, V, dev, nblk


def _check_tile_rows(name: str, hn: torch.Tensor, d_mult: int) -> None:
    """The tensor-core tile copies bf16 hidden rows 16 bytes at a time (an
    int4 head's high half from D/2 on): D % d_mult == 0 and a 16-byte
    aligned start, or a ValueError before any launch."""
    D = hn.shape[1]
    if hn.dtype == torch.bfloat16 and (D % d_mult or hn.data_ptr() % 16):
        raise ValueError(f"{name} (bf16): hn needs D % {d_mult} == 0 and a "
                         f"16-byte aligned start (D={D})")


def argmax_verify_fused(hn: torch.Tensor, lm_head: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """hn (B, D); lm_head (D, V). Returns (argmax token (B,) int32, max
    logit (B,) fp32), fp32 accumulation, lowest id among equal maxima."""
    if K.runs_plain(hn):
        return gate_ref.verify_argmax_ref(hn, lm_head)
    B, D, V, dev, nblk = _stream_args("argmax_verify", hn, lm_head)
    _check_tile_rows("argmax_verify", hn, 8)
    fn = build.c_func("argmax_verify", "argmax_verify_launch",
                      [_P] * 6 + [_I] * 4 + [_P])
    pval = torch.empty(B, nblk, dtype=torch.float32, device=dev)
    pidx = torch.empty(B, nblk, dtype=torch.int32, device=dev)
    tok = torch.empty(B, dtype=torch.int32, device=dev)
    mx = torch.empty(B, dtype=torch.float32, device=dev)
    rc = fn(K.ptr(hn), K.ptr(lm_head), K.ptr(pval), K.ptr(pidx), K.ptr(tok),
            K.ptr(mx), B, D, V, K.dtype_code(hn), K.stream_ptr(dev))
    build.check("argmax_verify", rc)
    K.LAUNCHES["argmax_verify"] += 1
    return tok, mx


def topk_verify_fused(hn: torch.Tensor, lm_head: torch.Tensor, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """hn (B, D); lm_head (D, V). Returns (ids (B, k) int32, vals (B, k)
    fp32) by descending logit, ties by ascending id, fp32 accumulation."""
    if K.runs_plain(hn):
        return gate_ref.verify_topk_ref(hn, lm_head, k)
    B, D, V, dev, nblk = _stream_args("topk_verify", hn, lm_head)
    _check_tile_rows("topk_verify", hn, 8)
    if not 1 <= k <= min(V, build.c_func("topk_verify", "topk_verify_max_k",
                                         [])()):
        raise ValueError(f"topk_verify kernel: unsupported k={k}")
    fn = build.c_func("topk_verify", "topk_verify_launch",
                      [_P] * 6 + [_I] * 5 + [_P])
    pval = torch.empty(B, nblk, k, dtype=torch.float32, device=dev)
    pidx = torch.empty(B, nblk, k, dtype=torch.int32, device=dev)
    ids = torch.empty(B, k, dtype=torch.int32, device=dev)
    vals = torch.empty(B, k, dtype=torch.float32, device=dev)
    rc = fn(K.ptr(hn), K.ptr(lm_head), K.ptr(pval), K.ptr(pidx), K.ptr(ids),
            K.ptr(vals), B, D, V, k, K.dtype_code(hn), K.stream_ptr(dev))
    build.check("topk_verify", rc)
    K.LAUNCHES["topk_verify"] += 1
    return ids, vals


def _stream_args_q(name: str, hn: torch.Tensor, qt: QTensor):
    B, D = hn.shape
    V = qt.shape[-1]
    dev = hn.device
    K.check_arg("hn", hn, dev)
    K.check_qtensor("lm_head", qt, dev, (D, V))
    nblk = -(-V // build.c_func(name, f"{name}_block_cols", [])())
    return B, D, V, dev, nblk


def argmax_verify_fused_q(hn: torch.Tensor, qt: QTensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """hn (B, D); qt a QTensor of logical shape (D, V). Returns (argmax
    token (B,) int32, max logit (B,) fp32); fp32 products with the codes,
    each column's sum times its scale, lowest id among equal maxima."""
    if K.runs_plain(hn):
        return gate_ref.verify_argmax_q_ref(hn, qt)
    B, D, V, dev, nblk = _stream_args_q("argmax_verify_q", hn, qt)
    _check_tile_rows("argmax_verify_q", hn, 16 if qt.bits == 4 else 8)
    fn = build.c_func("argmax_verify_q", "argmax_verify_q_launch",
                      [_P] * 7 + [_I] * 5 + [_P])
    pval = torch.empty(B, nblk, dtype=torch.float32, device=dev)
    pidx = torch.empty(B, nblk, dtype=torch.int32, device=dev)
    tok = torch.empty(B, dtype=torch.int32, device=dev)
    mx = torch.empty(B, dtype=torch.float32, device=dev)
    rc = fn(K.ptr(hn), K.ptr(qt.q), K.ptr(qt.scale), K.ptr(pval),
            K.ptr(pidx), K.ptr(tok), K.ptr(mx), B, D, V, qt.bits,
            K.dtype_code(hn), K.stream_ptr(dev))
    build.check("argmax_verify_q", rc)
    K.LAUNCHES["argmax_verify_q"] += 1
    return tok, mx


def topk_verify_fused_q(hn: torch.Tensor, qt: QTensor, k: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """hn (B, D); qt a QTensor of logical shape (D, V). Returns (ids (B, k)
    int32, vals (B, k) fp32) by descending logit, ties by ascending id."""
    if K.runs_plain(hn):
        return gate_ref.verify_topk_q_ref(hn, qt, k)
    B, D, V, dev, nblk = _stream_args_q("topk_verify_q", hn, qt)
    _check_tile_rows("topk_verify_q", hn, 16 if qt.bits == 4 else 8)
    if not 1 <= k <= min(V, build.c_func("topk_verify_q",
                                         "topk_verify_q_max_k", [])()):
        raise ValueError(f"topk_verify_q kernel: unsupported k={k}")
    fn = build.c_func("topk_verify_q", "topk_verify_q_launch",
                      [_P] * 7 + [_I] * 6 + [_P])
    pval = torch.empty(B, nblk, k, dtype=torch.float32, device=dev)
    pidx = torch.empty(B, nblk, k, dtype=torch.int32, device=dev)
    ids = torch.empty(B, k, dtype=torch.int32, device=dev)
    vals = torch.empty(B, k, dtype=torch.float32, device=dev)
    rc = fn(K.ptr(hn), K.ptr(qt.q), K.ptr(qt.scale), K.ptr(pval),
            K.ptr(pidx), K.ptr(ids), K.ptr(vals), B, D, V, k, qt.bits,
            K.dtype_code(hn), K.stream_ptr(dev))
    build.check("topk_verify_q", rc)
    K.LAUNCHES["topk_verify_q"] += 1
    return ids, vals
