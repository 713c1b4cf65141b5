"""Weights from the JAX package to the port, leaf for leaf.

The caller turns a JAX pytree into numpy arrays (``jax.tree_util.tree_map(
np.asarray, tree)``) and hands it here; the port never imports JAX. The
nesting and every layout are kept:

  params — ``Model.init``: ``embed.tok`` (V, D); ``segments[si]`` with
           ``u{i}`` entries stacked over reps; ``final_norm``;
           ``lm_head.w`` as (D, V);
  SpecEE — ``draft``; ``predictors`` stacked (E, ...); ``offline_mask``;
  quant  — a ``repro.quant.quantize_params`` bundle: every ``QTensor``
           leaf (after the tree_map, a QTensor of numpy ``q`` and
           ``scale``) becomes the port's ``QTensor`` with the same codes,
           scales and bits.

Floating weights move into the compute dtype (``dtype``); the predictor bank
stays fp32, as the JAX package keeps it.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.engine import SpecEEWeights
from repro_torch.quant import QTensor


def to_torch(tree: Any, device, dtype: torch.dtype = torch.float32) -> Any:
    """Numpy leaves of a nest of dicts/lists/tuples -> tensors on
    ``device``; floating leaves in ``dtype``, integer and bool leaves as
    they are."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v, device, dtype) for v in tree)
    arr = np.asarray(tree)
    if arr.dtype.kind in "biu":
        return torch.from_numpy(arr.copy()).to(device)
    # float32, float16 and bfloat16 (an extension dtype) all pass via fp32
    return torch.from_numpy(arr.astype(np.float32)).to(device=device,
                                                       dtype=dtype)


def params_from_numpy(params: Any, device, dtype: torch.dtype) -> Any:
    """A JAX ``Model.init`` pytree (as numpy) -> the port's params."""
    return to_torch(params, device, dtype)


def specee_from_numpy(draft: Any, predictors: Any, offline_mask: Any,
                      device, dtype: torch.dtype) -> SpecEEWeights:
    """The three fields of a JAX ``SpecEEWeights`` (as numpy) -> the port's
    ``SpecEEWeights``."""
    return SpecEEWeights(
        draft=to_torch(draft, device, dtype),
        predictors=to_torch(predictors, device, torch.float32),
        offline_mask=torch.as_tensor(np.array(offline_mask, bool),
                                     device=device))


def qw_from_numpy(qw: Any, device) -> Any:
    """A JAX ``quantize_params`` bundle (as numpy) -> the port's bundle.
    Codes stay int8 and scales fp32, unchanged; the predictor biases stay
    fp32. A quantized leaf is recognised by its ``q``/``scale``/``bits``
    attributes (the port does not import the JAX ``QTensor`` class)."""
    if qw is None:
        return None
    if all(hasattr(qw, a) for a in ("q", "scale", "bits")):
        return QTensor(to_torch(qw.q, device),
                       to_torch(qw.scale, device, torch.float32), qw.bits)
    if isinstance(qw, dict):
        return {k: qw_from_numpy(v, device) for k, v in qw.items()}
    if isinstance(qw, (list, tuple)):
        return type(qw)(qw_from_numpy(v, device) for v in qw)
    return to_torch(qw, device, torch.float32)
