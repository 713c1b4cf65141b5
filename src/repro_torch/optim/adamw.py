"""AdamW with decoupled weight decay and global-norm clipping (counterpart
of ``repro/optim/adamw.py``).

Parameters are a nest of dicts/lists of tensors; the optimizer state is a
nest of the same shape. m and v are kept in fp32 whatever the parameters'
dtype, the update is computed in fp32 and each parameter is cast back to
its own dtype. The update is functional, as in the JAX package: it returns
new parameters and a new state and leaves its arguments as they were.

Placed trees (training under a mesh, ``sharding/training.py``) hold their
leaves in pieces on several devices: the update runs piece by piece on
each piece's device (a copy of a leaf replicated over 'data' takes the
same update as the others, from the same all-reduced gradient), and
``global_norm`` counts each logical element once (one copy of such a
leaf), as JAX's norm over global arrays does.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Tuple, Union

import torch

from repro_torch.config import TrainConfig
from repro_torch.models.common import tree_leaves, tree_map, tree_unflatten
from repro_torch.sharding.ctx import DataShards


class AdamWState(NamedTuple):
    step: torch.Tensor       # 0-d int32, on the parameters' device
    m: Any
    v: Any


def _device(tree) -> torch.device:
    return tree_leaves(tree)[0].device


def adamw_init(params) -> AdamWState:
    zeros = lambda: tree_map(  # noqa: E731
        lambda x: torch.zeros(x.shape, dtype=torch.float32, device=x.device),
        params)
    return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                       device=_device(params)),
                      m=zeros(), v=zeros())


def _unique(tree) -> list:
    """The leaves of a nest in ``tree_leaves`` order, each logical element
    once: a leaf replicated over 'data' (a ``DataShards`` of copies)
    gives its first copy's pieces."""
    if isinstance(tree, DataShards):
        return tree_leaves(tree if tree.dim is not None else tree[0])
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _unique(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _unique(v)]
    return tree_leaves(tree)


def global_norm(tree) -> torch.Tensor:
    """The l2 norm over every logical element, on the first leaf's
    device."""
    leaves = _unique(tree)
    dev = leaves[0].device
    return torch.sqrt(torch.stack([x.float().square().sum().to(dev)
                                   for x in leaves]).sum())


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g * scale.to(g.device), grads), norm


def adamw_update(cfg: TrainConfig, params, grads, state: AdamWState,
                 lr: Union[torch.Tensor, float]
                 ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step. The bias correction uses the step after the
    increment; the clip scale multiplies each fp32 gradient leaf as the
    leaf is used, so no clipped copy of the whole gradient is held."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.grad_clip) if cfg.grad_clip > 0 else None
    step = state.step + 1
    b1, b2 = cfg.beta1, cfg.beta2
    stepf = step.float()
    bc1 = 1 - torch.tensor(b1, device=step.device) ** stepf
    bc2 = 1 - torch.tensor(b2, device=step.device) ** stepf
    new_p, new_m, new_v = [], [], []
    on = {}                             # the step's scalars per device
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state.m), tree_leaves(state.v)):
        if p.device not in on:
            on[p.device] = [x.to(p.device) if isinstance(x, torch.Tensor)
                            else x for x in (scale, bc1, bc2, lr)]
        sc, c1, c2, lr_p = on[p.device]
        g = g.float()
        if sc is not None:
            g = g * sc
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        delta = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
        pf = p.float()
        if cfg.weight_decay > 0:
            delta = delta + cfg.weight_decay * pf
        new_p.append((pf - lr_p * delta).to(p.dtype))
        new_m.append(m)
        new_v.append(v)
    return (tree_unflatten(params, new_p),
            AdamWState(step=step, m=tree_unflatten(params, new_m),
                       v=tree_unflatten(params, new_v)),
            {"grad_norm": gnorm})


def adam_step(params: List[torch.Tensor], grads, m: List[torch.Tensor],
              v: List[torch.Tensor], i: int, lr: float, b1: float = 0.9,
              b2: float = 0.999, eps: float = 1e-8):
    """Plain Adam on lists of tensors, as the JAX package's draft and
    predictor trainers write it in their step closures: no weight decay,
    no clipping, m and v in the parameters' dtype, the bias correction at
    step ``i + 1`` in fp32. Returns (params, m, v), new lists."""
    with torch.no_grad():
        step = torch.tensor(float(i + 1), device=params[0].device)
        bc1 = 1 - torch.tensor(b1, device=step.device) ** step
        bc2 = 1 - torch.tensor(b2, device=step.device) ** step
        m = [b1 * a + (1 - b1) * g for a, g in zip(m, grads)]
        v = [b2 * a + (1 - b2) * g * g for a, g in zip(v, grads)]
        params = [p.detach() - lr * (a / bc1) / (torch.sqrt(b / bc2) + eps)
                  for p, a, b in zip(params, m, v)]
    return params, m, v
