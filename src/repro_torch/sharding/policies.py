"""Sharding policies: logical roles -> partition specs, divisibility-aware
(counterpart of ``repro/sharding/policies.py``; the same rules).

A spec is a ``Spec``: a tuple with one entry per dim, each a mesh axis name,
a tuple of axis names, or None (whole). JAX's ``PartitionSpec(*dims)`` reads
the same, so ``tuple(jax_spec) == tuple(spec)``.

Policies:
  tp_dp   — serving: weights TP over 'model', replicated over 'data'.
  tp2d    — serving, big archs: TP over 'model' and the other matrix dim
            over 'data' (with data = 1 the layout is tp_dp's).
  fsdp_tp — training: tp_dp plus ZeRO-3 over 'data'; optimizer state
            inherits the parameter spec. (Serving takes it too, as JAX's
            engine does.)

The Megatron roles: column-parallel = {wq, wk, wv, mlp-in/gate,
expert-in}, row-parallel = {wo, mlp-down, expert-down}, vocab-parallel =
{embedding, lm_head}; the MoE router is replicated (JAX's docstring lists
it as column-parallel, its rule gives ``P(None, None)``). MoE expert stacks shard the expert dim over 'data'
(EP). A dim that does not divide its mesh extent falls back to replicated
(minicpm's odd 122753 vocabulary: the embedding splits D instead).

Every function reads only shapes and ``mesh.shape``, so it takes a tree of
tensors, of meta tensors, or of anything ``np.shape`` reads.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List

import numpy as np

from repro_torch.models.common import is_namedtuple
from repro_torch.quant.core import QTensor


class Spec(tuple):
    """One leaf's partition spec (JAX's ``PartitionSpec``)."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def __repr__(self) -> str:
        return f"Spec{tuple(self)!r}"


def _axes_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        return mesh.shape[axes]
    return int(np.prod([mesh.shape[a] for a in axes]))


def _fit(mesh, dim: int, axes):
    """``axes`` if dim divides their product, else None (replicate)."""
    return axes if axes is not None and dim % _axes_size(mesh, axes) == 0 \
        else None


def _data_axes(mesh) -> Any:
    return ("pod", "data") if "pod" in mesh.shape else "data"


class _Rules:
    """Path-string driven spec assignment for one (mesh, policy)."""

    def __init__(self, mesh, policy: str):
        self.mesh = mesh
        self.policy = policy
        self.data = _data_axes(mesh)

    def _wrap(self, path: str, spec: Spec, leaf) -> Spec:
        """Stacked layer leaves carry a leading (reps,) dim -> prepend None."""
        if "segments" in path and len(spec) < np.ndim(leaf):
            return Spec(*((None,) + tuple(spec)))
        return spec

    def _second(self, dim: int):
        """The non-TP matrix dim: 'data' for tp2d/fsdp_tp if it divides."""
        if self.policy in ("tp2d", "fsdp_tp"):
            return _fit(self.mesh, dim, self.data)
        return None

    def param_spec(self, path: str, leaf) -> Spec:
        mesh = self.mesh
        shape = np.shape(leaf)
        m = "model"

        def col(din, dout):  # column-parallel (D_in, D_out-TP)
            return Spec(self._second(din), _fit(mesh, dout, m))

        def row(din, dout):  # row-parallel (D_in-TP, D_out)
            return Spec(_fit(mesh, din, m), self._second(dout))

        if path.endswith("embed/tok"):
            V, D = shape[-2:]
            v_ax = _fit(mesh, V, m)
            # odd vocabs (minicpm, internvl2): shard D over model instead;
            # never the embedding's D over 'data'
            d_ax = None if v_ax is not None else _fit(mesh, D, m)
            if self.policy == "fsdp_tp" and v_ax is None and d_ax is None:
                v_ax = _fit(mesh, V, self.data)
            return Spec(v_ax, d_ax)
        if "lm_head" in path:
            D, V = shape[-2:]
            return Spec(self._second(D), _fit(mesh, V, m))
        # --- MoE expert stacks: (E, din, dout), EP over data (within a
        # pod; when E does not divide pod x data, the single 'data' axis)
        if "moe" in path:
            def e_ax(E):
                return _fit(mesh, E, self.data) or _fit(mesh, E, "data")
            if path.endswith("router/w"):
                return self._wrap(path, Spec(None, None), leaf)
            if any(path.endswith(s) for s in ("moe/wi", "moe/wg")):
                E, D, F = shape[-3:]
                return self._wrap(
                    path, Spec(e_ax(E), None, _fit(mesh, F, m)), leaf)
            if path.endswith("moe/wo"):
                E, F, D = shape[-3:]
                return self._wrap(
                    path, Spec(e_ax(E), _fit(mesh, F, m), None), leaf)
        # --- attention ---
        if path.endswith(("wq/w", "wk/w", "wv/w")):
            din, dout = shape[-2:]
            return self._wrap(path, col(din, dout), leaf)
        if path.endswith("attn/wo/w") or path.endswith("wo/w"):
            din, dout = shape[-2:]
            return self._wrap(path, row(din, dout), leaf)
        for name in ("wq/b", "wk/b", "wv/b"):
            if path.endswith(name):
                return self._wrap(path, Spec(_fit(mesh, shape[-1], m)), leaf)
        # --- dense MLP ---
        for name in ("mlp/wi/w", "mlp/wg/w"):
            if path.endswith(name):
                din, dout = shape[-2:]
                return self._wrap(path, col(din, dout), leaf)
        if path.endswith("mlp/wo/w"):
            din, dout = shape[-2:]
            return self._wrap(path, row(din, dout), leaf)
        for name in ("mlp/wi/b", "mlp/wg/b"):
            if path.endswith(name):
                return self._wrap(path, Spec(_fit(mesh, shape[-1], m)), leaf)
        # --- RG-LRU ---
        for name in ("rec/wx/w", "rec/wy/w"):
            if path.endswith(name):
                din, dout = shape[-2:]
                return self._wrap(path, col(din, dout), leaf)
        if path.endswith("rec/wo/w"):
            din, dout = shape[-2:]
            return self._wrap(path, row(din, dout), leaf)
        for name in ("rec/wa/w", "rec/wi/w"):
            if path.endswith(name):
                # (W, W) gate matrices: TP the output dim
                din, dout = shape[-2:]
                return self._wrap(path, col(din, dout), leaf)
        for name in ("rec/wa/b", "rec/wi/b", "rec/lam", "rec/conv_w",
                     "rec/conv_b"):
            if path.endswith(name):
                return self._wrap(path, Spec(*([None] * (np.ndim(leaf) - 2)),
                                             _fit(mesh, shape[-1], m))
                                  if np.ndim(leaf) >= 1 else Spec(), leaf)
        # --- SSD (mamba2) ---
        if path.endswith("ssd/in_proj/w"):
            din, dout = shape[-2:]
            return self._wrap(path, col(din, dout), leaf)
        if path.endswith("ssd/out_proj/w"):
            din, dout = shape[-2:]
            return self._wrap(path, row(din, dout), leaf)
        # everything else (norms, small vectors, conv kernels, frontend):
        # replicate; fsdp shards the largest dim over data if it divides
        if self.policy == "fsdp_tp" and np.ndim(leaf) >= 1:
            dims = [None] * np.ndim(leaf)
            core = int(np.argmax(shape))
            if "segments" in path and np.ndim(leaf) > 1 and core == 0:
                core = 1 + int(np.argmax(shape[1:]))
            ax = _fit(self.mesh, shape[core], self.data)
            if ax is not None and shape[core] >= 1024:
                dims[core] = ax
            return Spec(*dims)
        return Spec(*([None] * np.ndim(leaf)))


def map_with_paths(tree, fn, prefix: str = ""):
    """``fn(path, leaf)`` over a nest of dicts, lists, tuples and
    NamedTuples, with JAX's path strings ("segments/0/u0/attn/wq/w"; a
    NamedTuple field is ".name", as JAX's ``GetAttrKey`` prints). A
    ``QTensor`` is a leaf."""
    def sub(key):
        return f"{prefix}/{key}" if prefix else str(key)
    if isinstance(tree, dict):
        return {k: map_with_paths(v, fn, sub(k)) for k, v in tree.items()}
    if is_namedtuple(tree):
        return type(tree)(*(map_with_paths(v, fn, sub(f".{f}"))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)) and not isinstance(tree, Spec):
        return type(tree)(map_with_paths(v, fn, sub(i))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def _replicated(leaf) -> Spec:
    return Spec(*([None] * np.ndim(leaf)))


def replicated_specs(tree) -> Any:
    return map_with_paths(tree, lambda p, l: (
        _replicated(l) if not isinstance(l, QTensor) else
        QTensor(_replicated(l.q), _replicated(l.scale), l.bits)))


def param_specs(model, mesh, policy: str, params_shape) -> Any:
    """Spec tree for model parameters (from their shapes)."""
    rules = _Rules(mesh, policy)
    return map_with_paths(params_shape, rules.param_spec)


def state_specs(mesh, policy: str, param_spec_tree, opt_shape) -> Any:
    """Optimizer state: m/v inherit the parameter spec; step replicated."""
    from repro_torch.optim.adamw import AdamWState
    return AdamWState(step=Spec(), m=param_spec_tree, v=param_spec_tree)


def batch_specs(model, mesh, batch_shape, seq_shard: bool = True) -> Any:
    """Input batch: batch dim over ('pod','data'); the sequence dim over
    'model' from 1024 tokens (Megatron sequence parallelism)."""
    data = _data_axes(mesh)

    def one(path, leaf):
        shape = np.shape(leaf)
        nd = np.ndim(leaf)
        ax = _fit(mesh, shape[0], data)
        # fall back to the single 'data' axis if (pod×data) doesn't divide
        if ax is None and not isinstance(data, str):
            ax = _fit(mesh, shape[0], "data")
        dims: List[Any] = [ax] + [None] * (nd - 1)
        if seq_shard and nd >= 2 and shape[1] >= 1024:
            dims[1] = _fit(mesh, shape[1], "model")
        return Spec(*dims)

    return map_with_paths(batch_shape, one)


def cache_specs(model, mesh, policy: str, cache_shape,
                kv_seq_shard: bool = True) -> Any:
    """KV/state caches. Attention k/v (reps, B, S, KVH, hd): B over data;
    then the first of {KVH, hd, S} that divides 'model' (S only with
    ``kv_seq_shard``, the split-KV layout). Recurrent/SSM states: B over
    data, the widest state dim over 'model'."""
    data = _data_axes(mesh)

    def one(path, leaf):
        shape = np.shape(leaf)
        nd = np.ndim(leaf)
        if path.endswith("len"):
            return Spec()
        if nd == 0:
            return Spec()
        if path.endswith("/k") or path.endswith("/v"):
            has_reps = "segments" in path and nd == 5
            off = 1 if has_reps else 0  # (B, S, KVH, hd) core
            B, S, KVH, hd = shape[off:off + 4]
            dims: List[Any] = [None] * nd
            dims[off] = _fit(mesh, B, data) or _fit(mesh, B, "data")
            if _fit(mesh, KVH, "model"):
                dims[off + 2] = "model"
            elif kv_seq_shard and _fit(mesh, S, "model"):
                dims[off + 1] = "model"
            elif _fit(mesh, hd, "model"):
                dims[off + 3] = "model"
            return Spec(*dims)
        # recurrent / conv / ssm states: (reps?, B, ...)
        off = 1 if ("segments" in path and nd >= 3) else 0
        dims = [None] * nd
        if nd > off:
            dims[off] = _fit(mesh, shape[off], data) or _fit(mesh, shape[off],
                                                             "data")
        if nd > off + 1:
            tail = int(np.argmax(shape[off + 1:])) + off + 1
            if _fit(mesh, shape[tail], "model") and shape[tail] >= 128:
                dims[tail] = "model"
        return Spec(*dims)

    return map_with_paths(cache_shape, one)


def specee_specs(model, mesh, policy: str, sw_shape) -> Any:
    """SpecEE weights: the draft layer shards like a TP block; predictors
    and the offline mask are tiny -> replicated."""
    rules = _Rules(mesh, policy if policy != "fsdp_tp" else "tp_dp")

    def one(path, leaf):
        if "draft" in path:
            return rules.param_spec(path, leaf)
        return _replicated(leaf)

    return map_with_paths(sw_shape, one)


@dataclass(frozen=True)
class NamedSharding:
    """A spec bound to its mesh (JAX's ``NamedSharding``)."""
    mesh: Any
    spec: Spec


def named(mesh, spec_tree) -> Any:
    return map_with_paths(spec_tree, lambda p, s: NamedSharding(mesh, s))
