"""T1 — the early-exit predictor (counterpart of ``repro/core/predictor.py``).

A 2-layer MLP (hidden 512, ReLU, sigmoid head) over the 3k speculation
features, one per exit point, stacked over exit points. The AR gate runs it
inside the fused exit gate; the tree gate runs it per root→leaf path
through ``apply_predictor_banked``. The bank stays in
fp32 whatever the model's dtype, as in the JAX package.
"""
from __future__ import annotations

import math

import torch

from repro_torch.config import SpecEEConfig
from repro_torch.kernels.predictor_mlp.ops import predictor_mlp_at
from repro_torch.models.common import Params, normal_init, tree_map
from repro_torch.quant import QTensor


def init_predictor(spec: SpecEEConfig, gen: torch.Generator,
                   device) -> Params:
    """Single predictor MLP: feature_dim -> hidden^(layers-1) -> 1."""
    dims = ([spec.feature_dim()] +
            [spec.predictor_hidden] * (spec.predictor_layers - 1) + [1])
    return {"layers": [
        {"w": normal_init(gen, (dims[i], dims[i + 1]),
                          1.0 / math.sqrt(dims[i]), torch.float32, device),
         "b": torch.zeros(dims[i + 1], dtype=torch.float32, device=device)}
        for i in range(len(dims) - 1)]}


def init_predictors(spec: SpecEEConfig, num_exit_points: int,
                    gen: torch.Generator, device) -> Params:
    """Stacked predictors: every leaf gains a leading (E,) dim."""
    ones = [init_predictor(spec, gen, device) for _ in range(num_exit_points)]
    return {"layers": [
        {name: torch.stack([p["layers"][i][name] for p in ones])
         for name in ("w", "b")}
        for i in range(len(ones[0]["layers"]))]}


def apply_predictor(p: Params, features: torch.Tensor) -> torch.Tensor:
    """features: (..., feature_dim) -> exit probability (...,) in [0, 1].
    A quantized bank (``QTensor`` weight leaves) is dequantized here: the
    plain path the quantized MLP kernel is held against."""
    x = features.float()
    layers = p["layers"]
    for i, layer in enumerate(layers):
        w = layer["w"]
        if isinstance(w, QTensor):
            w = w.dequantize()
        x = x @ w + layer["b"]
        if i + 1 < len(layers):
            x = torch.relu(x)
    return torch.sigmoid(x[..., 0])


def predictor_at(stacked: Params, idx: int) -> Params:
    """One predictor out of the stacked bank (views; a quantized leaf's
    codes and scales are sliced together)."""
    return tree_map(lambda x: x[idx], stacked)


def apply_predictor_banked(stacked: Params, idx: int,
                           features: torch.Tensor,
                           use_kernel: bool = False) -> torch.Tensor:
    """Predictor ``idx`` of the stacked bank on features (..., F) -> exit
    probability (...,). ``use_kernel`` routes a 2-layer bank through the
    fused predictor-MLP wrapper (the kernel on a CUDA tensor); a bank of
    another depth takes the plain chain, chosen from its depth as in the
    JAX package."""
    if use_kernel and len(stacked["layers"]) == 2:
        lead = features.shape[:-1]
        flat = features.reshape(-1, features.shape[-1])
        return predictor_mlp_at(flat, stacked, idx).reshape(lead)
    return apply_predictor(predictor_at(stacked, idx), features)
