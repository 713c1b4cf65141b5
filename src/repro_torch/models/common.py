"""Shared layers (counterpart of ``repro/models/common.py``).

Parameters are plain nested dicts of tensors with the JAX package's nesting
and layouts (linear weights are (d_in, d_out)), so ``repro_torch.bridge``
moves a JAX pytree over leaf for leaf. Weights may be held in the compute
dtype: the JAX code casts ``w.astype(x.dtype)`` at every call, so holding
them cast already gives the same numbers.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.quant.core import QTensor
from repro_torch.sharding.ctx import DataShards, Shards

Params = Dict[str, Any]


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn, tree):
    """Apply ``fn`` to every leaf of a nest of dicts, lists, tuples and
    NamedTuples (a ``DecodeState``, an ``AdamWState``) and the parts of a
    sharded leaf (``sharding.ctx.Shards``, kept one) and the entries of a
    leaf cut over 'data' (``DataShards``, kept one); a ``QTensor`` maps
    over its codes and its scales (a stacked quantized bank slices like a
    plain one). A leaf is anything else: a tensor, or a value such as an
    int or None."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (Shards, DataShards)):
        return tree.like(tree_map(fn, v) for v in tree)
    if is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if isinstance(tree, QTensor):
        return QTensor(fn(tree.q), fn(tree.scale), tree.bits)
    return fn(tree)


def tree_leaves(tree) -> list:
    """The leaves of a nest in ``tree_map``'s order (dict insertion order;
    a ``QTensor`` gives its codes, then its scales)."""
    out: list = []
    tree_map(out.append, tree)
    return out


def tree_leaves_with_path(tree, prefix: str = "") -> list:
    """``[(path, leaf)]`` in ``tree_leaves`` order. A path joins JAX's key
    strings with "/": ``['key']`` for a dict entry, ``[i]`` for a list or
    tuple item, ``.field`` for a NamedTuple field (``.q`` / ``.scale`` for
    a ``QTensor``'s two parts). A leaf placed on a training mesh (a
    ``DataShards``) is one leaf: one logical tensor."""
    def sub(key):
        return f"{prefix}/{key}" if prefix else key
    if isinstance(tree, DataShards):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        items = [(f"[{k!r}]", v) for k, v in tree.items()]
    elif is_namedtuple(tree):
        items = [(f".{f}", v) for f, v in zip(tree._fields, tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(f"[{i}]", v) for i, v in enumerate(tree)]
    elif isinstance(tree, QTensor):
        items = [(".q", tree.q), (".scale", tree.scale)]
    else:
        return [(prefix, tree)]
    return [kv for key, v in items
            for kv in tree_leaves_with_path(v, sub(key))]


def tree_unflatten(tree, flat):
    """A nest shaped like ``tree`` holding ``flat``'s tensors in
    ``tree_leaves(tree)`` order."""
    it = iter(flat)
    return tree_map(lambda _: next(it), tree)


def index_tree(tree, i: int):
    """Leaf-wise ``x[i]`` — one unit out of a stacked segment (a view)."""
    return tree_map(lambda x: x[i], tree)


# ---------------------------------------------------------------------------
# seeded init (same shapes and scales as the JAX init; different numbers)
# ---------------------------------------------------------------------------
def normal_init(gen: torch.Generator, shape, std: float, dtype,
                device) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return x.mul_(std).to(dtype)


def init_norm(cfg: ModelConfig, dim: int, dtype, device) -> Params:
    """Unit scale; layernorm also a zero bias (``common.py:57``)."""
    p = {"scale": torch.ones(dim, dtype=dtype, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros(dim, dtype=dtype, device=device)
    return p


def init_linear(gen, d_in: int, d_out: int, use_bias: bool, dtype, device,
                std: Optional[float] = None) -> Params:
    std = std if std is not None else 1.0 / math.sqrt(d_in)
    p = {"w": normal_init(gen, (d_in, d_out), std, dtype, device)}
    if use_bias:
        p["b"] = torch.zeros(d_out, dtype=dtype, device=device)
    return p


def init_mlp(cfg: ModelConfig, gen, dtype, device) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    out_std = 1.0 / math.sqrt(f) / math.sqrt(2 * cfg.num_layers)
    p: Params = {"wi": init_linear(gen, d, f, cfg.use_bias, dtype, device),
                 "wo": init_linear(gen, f, d, cfg.use_bias, dtype, device,
                                   std=out_std)}
    if cfg.gated_mlp:
        p["wg"] = init_linear(gen, d, f, cfg.use_bias, dtype, device)
    return p


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
def apply_norm(cfg: ModelConfig, p: Params, x: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm or layernorm (``cfg.norm``) in fp32, output in x's dtype."""
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)
    assert cfg.norm == "rmsnorm", cfg.norm
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(ms + eps) * p["scale"].float()
    return y.to(x.dtype)


def activation_fn(name: str):
    """silu, gelu or relu; ``jax.nn.gelu`` is the tanh approximation by
    default, and so is this gelu."""
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[name]


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) of the rotary angles at ``positions`` (..., seq), each
    (..., seq, 1, head_dim / 2): what ``apply_rope`` multiplies by, made
    once for the queries and keys of one call."""
    inv = rope_freqs(head_dim, theta, positions.device)
    angles = positions[..., :, None].float() * inv
    return (torch.cos(angles)[..., :, None, :],
            torch.sin(angles)[..., :, None, :])


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float, tables=None) -> torch.Tensor:
    """Rotary embedding, half-split convention (``common.py:94-104``).
    x: (..., seq, heads, head_dim); positions: (..., seq); ``tables``:
    ``rope_tables`` of those positions, when already made."""
    cos, sin = (tables if tables is not None else
                rope_tables(positions, x.shape[-1], theta))
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


class _RoundedEinsum(torch.autograd.Function):
    """``einsum(eq, a, b)`` rounded to ``dtype``, and so are the two
    products of its backward: JAX's ``dot_general`` with
    ``preferred_element_type`` (its transpose rule keeps the type), which
    on the CPU accumulates in fp32 and rounds once."""

    @staticmethod
    def forward(ctx, eq, dtype, a, b):
        ctx.save_for_backward(a, b)
        ctx.eq, ctx.dtype = eq, dtype
        return torch.einsum(eq, a, b).to(dtype)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        with torch.enable_grad():
            a_ = a.detach().requires_grad_(True)
            b_ = b.detach().requires_grad_(True)
            out = torch.einsum(ctx.eq, a_, b_)
            ga, gb = torch.autograd.grad(out, (a_, b_), g.to(out.dtype))
        return (None, None, ga.to(ctx.dtype).to(a.dtype),
                gb.to(ctx.dtype).to(b.dtype))


def rounded_einsum(eq: str, a: torch.Tensor, b: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
    """``einsum(eq, a, b)`` in ``dtype`` as JAX's ``preferred_element_
    type`` gives it: the fp32 sum rounded once, forward and backward."""
    if a.dtype == dtype and b.dtype == dtype:
        return torch.einsum(eq, a, b)
    return _RoundedEinsum.apply(eq, dtype, a, b)


def apply_linear(p: Params, x: torch.Tensor,
                 pet: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x @ w (+ b)``. ``pet`` (JAX's ``preferred_element_type``): the
    product rounded to that dtype (``rounded_einsum``), then back to x's,
    before the bias (``ModelFlags.matmul_bf16_reduce`` passes bf16 for the
    row-parallel projections)."""
    if pet is not None:
        y = rounded_einsum("...i,io->...o", x, p["w"].to(x.dtype),
                           pet).to(x.dtype)
    else:
        y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def apply_mlp(cfg: ModelConfig, p: Params, x: torch.Tensor,
              pet: Optional[torch.dtype] = None) -> torch.Tensor:
    """Gated (``act(x wg) * x wi``) or plain (``act(x wi)``) MLP; ``pet``
    rounds the row-parallel down projection (``apply_linear``)."""
    act = activation_fn(cfg.activation)
    up = apply_linear(p["wi"], x)
    if cfg.gated_mlp:
        up = act(apply_linear(p["wg"], x)) * up
    else:
        up = act(up)
    return apply_linear(p["wo"], up, pet)


def embed_tokens(p: Params, tokens: torch.Tensor, dtype) -> torch.Tensor:
    return p["tok"].to(dtype)[tokens.long()]


def lm_head_weight(params: Params) -> torch.Tensor:
    """(d_model, vocab) — transposed embedding when tied."""
    if "lm_head" in params:
        return params["lm_head"]["w"]
    return params["embed"]["tok"].T


def with_contiguous_head(params: Params) -> Params:
    """``params`` with a tied LM head stored once as its own contiguous
    (d_model, vocab) copy of ``embed.T``. The transposed embedding is a
    strided view, which the streaming gate and verify kernels refuse; an
    engine builds this copy once, not once per step. Params with an
    ``lm_head`` entry come back as they are."""
    if "lm_head" in params:
        return params
    return dict(params, lm_head={"w": params["embed"]["tok"].T.contiguous()})
