"""Exit-gate entry points (counterpart of ``repro/kernels/exit_gate/ops.py``).

``exit_gate()`` / ``verify_argmax()`` / ``verify_topk()`` are the decode
engine's single entry points for the per-exit-point decision and the
LM-head reductions. ``impl`` selects the backend:

  "kernel" — the CUDA kernel wrappers (``exit_gate.py``): on a CUDA tensor
             the kernel, on a CPU tensor its plain version. The plain
             versions accumulate in fp32 like the kernels (the JAX "kernel"
             impl, which the CPU tests run in Pallas interpret mode).
  "ref"    — the engine's historical numerics: the gate is
             ``exit_gate_ref``; verification materializes the (B, V)
             logits with the matmul in ``hn.dtype`` (JAX ``ops.py:276-279``).
  None / "auto" — "kernel" on a CUDA tensor, "ref" on a CPU tensor.

The JAX package has a third backend, "xla", which is its CPU default for
the gate; its gate dataflow is ``exit_gate_ref``, so the port's "ref" gate
stands for both. Its CPU default for the verify is "ref", as here.

A quantized LM head or bank (``repro_torch.quant.QTensor``) is dispatched
on its type, as in the JAX package: the verify entry points take the
quantized streaming kernels, and under "kernel" the gate takes the
quantized gate kernel (``exit_gate_fused_q``: the whole gate in one
launch, as the fp gate). The JAX package runs that gate piecewise — the
quantized spec-head kernel, the Δ-features, then the predictor-MLP kernel
— and the port's plain version computes that chain; the tree gate
(``core/features.py``, ``core/predictor.py``) keeps the two pieces, since
the hyper-token merge sits between them.

Tensor-parallel verify (JAX ``ops.py:241-377``): a ``Shards`` head — the
vocabulary slices of a mesh's shards, ``sharding.serving.split_vocab`` —
verifies each slice with the unsharded kernel (or plain version) on the
slice's device, shifts its ids by the slice's first global column, and
merges the (P, B) or (P, B, k) partials on the hidden's device, pooled by
``collectives.all_gather`` (JAX's gather of the shard_map's partials;
counted over 'model'). The D contraction never splits, so every logit a
slice computes is the unsharded one. The merge keeps the global tie-break:
the maximum wins and equal maxima take the lowest global id
(``torch.argmax``'s first occurrence); top-k pools the partials
shard-major and sorts them stably, so equal values keep ascending ids
(``torch.topk`` promises no order for ties). JAX pads the head to P equal
slices and masks the pad; torch slices may differ in width, so an odd
vocabulary's last slice is narrower and nothing is masked. A quantized
head stays on the unsharded path (its tiles are replicated).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.predictor import apply_predictor, predictor_at
from repro_torch.kernels.exit_gate import ref as gate_ref
from repro_torch.kernels.exit_gate.exit_gate import (argmax_verify_fused,
                                                     argmax_verify_fused_q,
                                                     exit_gate_fused,
                                                     exit_gate_fused_q,
                                                     topk_verify_fused,
                                                     topk_verify_fused_q)
from repro_torch.kernels.spec_head import ops as sh_ops
from repro_torch.quant import QTensor
from repro_torch.runtime.collectives import all_gather
from repro_torch.sharding.ctx import Shards

IMPLS = (None, "auto", "kernel", "ref")


def resolve_impl(impl: Optional[str], x: torch.Tensor) -> str:
    """Backend an ``impl`` request resolves to for tensors like ``x``."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl in (None, "auto"):
        return "kernel" if x.is_cuda else "ref"
    return impl


def impl_for_flags(flags) -> str:
    """Exit-gate backend a ``ModelFlags`` bundle selects: the fused impl
    when ``exit_gate_kernel`` is on, else the historical "ref"."""
    if getattr(flags, "exit_gate_kernel", False):
        return getattr(flags, "exit_gate_impl", "auto") or "auto"
    return "ref"


def exit_gate(hn: torch.Tensor, lm_head, spec_ids: torch.Tensor,
              prev_probs: torch.Tensor, predictors, ep: int,
              impl: Optional[str] = None, spec_head_kernel: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exit decision at exit point ``ep``. hn (B, D); lm_head (D, V) or a
    QTensor; spec_ids (B, k) int32; prev_probs (B, k); predictors: the
    stacked bank (fp or quantized). Returns (p_exit (B,), local_probs
    (B, k), logits (B, k)), all fp32.

    As in the JAX package, the choice is made from the bank's depth and the
    weights' types before any launch: the fused kernel holds a 2-layer fp
    predictor on an fp head; a quantized head or bank takes the quantized
    gate kernel (JAX: the piecewise spec head, then predictor MLP); a bank
    of another depth (design-space sweeps) takes the plain chain under
    every impl. ``spec_head_kernel`` under "ref" computes the features with
    the spec-head kernel and the predictor with the plain MLP."""
    impl = resolve_impl(impl, hn)
    pp = predictor_at(predictors, ep)
    layers = pp["layers"]
    quantized = (isinstance(lm_head, QTensor)
                 or any(isinstance(l["w"], QTensor) for l in layers))
    if impl == "kernel" and len(layers) == 2 and quantized:
        return exit_gate_fused_q(hn, lm_head, spec_ids, prev_probs.float(),
                                 layers[0], layers[1])
    if impl == "kernel" and len(layers) == 2:
        return exit_gate_fused(hn, lm_head, spec_ids, prev_probs.float(),
                               layers[0]["w"], layers[0]["b"],
                               layers[1]["w"], layers[1]["b"])
    if impl == "ref" and spec_head_kernel:
        logits, probs = sh_ops.spec_head(hn, lm_head, spec_ids)
        feats = torch.cat([logits, probs, probs - prev_probs.float()], -1)
        return apply_predictor(pp, feats), probs, logits
    return gate_ref.exit_gate_ref(hn, lm_head, spec_ids, prev_probs, pp)


_I32_MAX = torch.iinfo(torch.int32).max


def _partials(hn: torch.Tensor, slices: Shards, fn):
    """``fn(hn on the slice's device, slice)`` per slice -> its (ids,
    vals) with ids shifted to global columns, on hn's device."""
    out, c0 = [], 0
    for part in slices:
        ids, vals = fn(hn.to(part.device), part)
        out.append((ids.to(hn.device) + c0, vals.to(hn.device)))
        c0 += part.shape[1]
    return out


def merge_argmax(parts):
    """The global (token, max) of per-slice (global ids, maxima): the
    maximum wins, equal maxima take the lowest global id."""
    toks = all_gather([t[None] for t, _ in parts], parts[0][0].device,
                      dim=0)                                 # (P, B)
    vals = all_gather([v[None] for _, v in parts], parts[0][1].device,
                      dim=0)
    best = vals.amax(dim=0)
    cand = torch.where(vals == best[None], toks, _I32_MAX)
    return cand.amin(dim=0).to(torch.int32), best


def merge_topk(parts, k: int):
    """The global top-k of per-slice (global ids, values) top-k's: a
    shard-major (B, sum k_s) pool — within a slice equal values come
    id-ascending and slices are id-ascending — sorted stably, descending,
    so equal values keep the lower id first."""
    pool_i = all_gather([i for i, _ in parts], parts[0][0].device, dim=1)
    pool_v = all_gather([v for _, v in parts], parts[0][1].device, dim=1)
    nvals, sel = torch.sort(pool_v, dim=1, descending=True, stable=True)
    nids = torch.gather(pool_i, 1, sel[:, :k])
    return nids.to(torch.int32), nvals[:, :k]


def _verify_argmax_sharded(hn, slices, impl):
    return merge_argmax(_partials(
        hn, slices, lambda h, w: verify_argmax(h, w, impl=impl)))


def _verify_topk_sharded(hn, slices, k, impl):
    width = max(p.shape[1] for p in slices)
    if k > width:
        raise ValueError(
            f"verify_topk: k={k} exceeds the per-shard vocab slice "
            f"({sum(p.shape[1] for p in slices)} cols / {len(slices)} "
            f"shards = {width}); every global top-k entry must be inside "
            "its shard's local top-k")
    return merge_topk(_partials(hn, slices, lambda h, w: verify_topk(
        h, w, min(k, w.shape[1]), impl=impl)), k)


def verify_argmax(hn: torch.Tensor, lm_head,
                  impl: Optional[str] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-LM-head argmax; ``lm_head`` (D, V), a QTensor, or a ``Shards``
    of vocabulary slices. Returns (token (B,) int32, max logit (B,))."""
    if isinstance(lm_head, Shards):
        return _verify_argmax_sharded(hn, lm_head, impl)
    if resolve_impl(impl, hn) == "kernel":
        if isinstance(lm_head, QTensor):
            return argmax_verify_fused_q(hn, lm_head)
        return argmax_verify_fused(hn, lm_head)
    return gate_ref.verify_argmax_ref(hn, lm_head, compute_dtype=hn.dtype)


def verify_topk(hn: torch.Tensor, lm_head, k: int,
                impl: Optional[str] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-LM-head top-k; ``lm_head`` (D, V), a QTensor, or a ``Shards``
    of vocabulary slices. Returns (ids (B, k) int32, vals (B, k) fp32),
    descending by logit, ties by ascending id."""
    if isinstance(lm_head, Shards):
        return _verify_topk_sharded(hn, lm_head, k, impl)
    if resolve_impl(impl, hn) == "kernel":
        if isinstance(lm_head, QTensor):
            return topk_verify_fused_q(hn, lm_head, k)
        return topk_verify_fused(hn, lm_head, k)
    return gate_ref.verify_topk_ref(hn, lm_head, k, compute_dtype=hn.dtype)
