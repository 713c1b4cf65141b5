"""Plain PyTorch versions of the exit-gate kernels (counterpart of
``repro/kernels/exit_gate/ref.py``).

``exit_gate_ref`` delegates to ``spec_head_ref`` and
``core.predictor.apply_predictor``, as the JAX oracle does.
``exit_gate_q_ref`` is the plain version of the quantized gate kernel:
the JAX package's piecewise quantized gate (the spec head's gather, then
dequantize; the softmax and the features; the predictor MLP with each
scale after its dot).
``verify_argmax_ref`` / ``verify_topk_ref`` materialize the (B, V) logits;
with ``compute_dtype=None`` they accumulate in fp32 (the kernels'
contract), with ``compute_dtype=hn.dtype`` they are the engine's historical
"ref" numerics. A ``QTensor`` head is dequantized to fp32 first and then
cast to the compute dtype, as the JAX oracle does.
``verify_argmax_q_ref`` / ``verify_topk_q_ref`` are the plain versions of
the quantized streaming kernels: fp32 products with the integer codes, the
per-column scale after the dot (JAX ``ops.py::_q_stream_plan``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.predictor import apply_predictor
from repro_torch.kernels.predictor_mlp.ref import (predictor_mlp_q_ref,
                                                   predictor_mlp_ref)
from repro_torch.kernels.spec_head.ref import spec_head_ref
from repro_torch.quant import QTensor, matmul_codes


def exit_gate_ref(hn: torch.Tensor, lm_head: torch.Tensor,
                  spec_ids: torch.Tensor, prev_probs: torch.Tensor,
                  predictor) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Returns (p_exit (B,), probs (B, k), logits (B, k)), all fp32."""
    logits, probs = spec_head_ref(hn, lm_head, spec_ids)
    feats = torch.cat([logits, probs, probs - prev_probs.float()], dim=-1)
    return apply_predictor(predictor, feats), probs, logits


def exit_gate_q_ref(hn: torch.Tensor, lm_head, spec_ids: torch.Tensor,
                    prev_probs: torch.Tensor, l1, l2
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of ``exit_gate_fused_q``: the head (D, V) or a
    QTensor; the predictor's layers ``l1``, ``l2`` ({"w", "b"}, each
    ``w`` fp or a QTensor). Returns (p_exit (B,), probs (B, k),
    logits (B, k)), all fp32."""
    logits, probs = spec_head_ref(hn, lm_head, spec_ids)
    feats = torch.cat([logits, probs, probs - prev_probs.float()], dim=-1)
    mlp = (predictor_mlp_q_ref if isinstance(l1["w"], QTensor)
           else predictor_mlp_ref)
    return mlp(feats, l1["w"], l1["b"], l2["w"], l2["b"]), probs, logits


def _logits(hn, lm_head, compute_dtype):
    if isinstance(lm_head, QTensor):
        lm_head = lm_head.dequantize()
    dt = torch.float32 if compute_dtype is None else compute_dtype
    return (hn.to(dt) @ lm_head.to(dt)).float()


def _argmax(logits: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """First index among equal maxima: (token (B,) int32, max (B,))."""
    return (torch.argmax(logits, dim=-1).to(torch.int32),
            torch.amax(logits, dim=-1))


def _topk(logits: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Value descending then id ascending — a STABLE descending sort
    (``torch.topk`` makes no promise on ties): (ids (B, k) int32, vals)."""
    vals, ids = torch.sort(logits, dim=-1, descending=True, stable=True)
    return ids[:, :k].to(torch.int32), vals[:, :k]


def verify_argmax_ref(hn: torch.Tensor, lm_head,
                      compute_dtype: Optional[torch.dtype] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-head argmax. Returns (token (B,) int32, max logit (B,) fp32)."""
    return _argmax(_logits(hn, lm_head, compute_dtype))


def verify_topk_ref(hn: torch.Tensor, lm_head, k: int,
                    compute_dtype: Optional[torch.dtype] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-head top-k. Returns (ids (B, k) int32, vals (B, k) fp32)."""
    return _topk(_logits(hn, lm_head, compute_dtype), k)


def verify_argmax_q_ref(hn: torch.Tensor, qt: QTensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``argmax_verify_fused_q``: (token, max logit)."""
    return _argmax(matmul_codes(hn, qt))


def verify_topk_q_ref(hn: torch.Tensor, qt: QTensor, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``topk_verify_fused_q``: (ids, vals)."""
    return _topk(matmul_codes(hn, qt), k)
