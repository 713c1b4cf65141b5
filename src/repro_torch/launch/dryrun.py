"""Dry run on the torch meta device (counterpart of
``repro/launch/dryrun.py`` and ``repro/launch/hlo_analysis.py``): place
every (architecture x input shape) cell's arguments on a production mesh
and run one step, with no card and no data, then dump what each device
slot would hold and what the step computes and moves.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama2-7b \\
        --shape decode_32k --out dry.json
    PYTHONPATH=src python -m repro_torch.launch.dryrun --multi-pod ...

The mesh is ``launch.mesh.make_host_mesh(16, 16, "meta")``: 256 slots,
every one on the meta device, so the placement (``Engine.create(mesh=)``'s
``shard_params`` and the placed model's empty decode state for serving,
``TrainMesh.place`` and ``adamw_init`` as ``TrainLoop(mesh=)`` makes
them for training) and the step's every per-row and per-shard operation
run, but only shapes and dtypes are computed. JAX lowers and compiles the
step with XLA; the port runs it in Python on meta tensors instead:

* argument bytes per slot: walked over the placed trees, each ``Shards``
  part on its (row, shard) slot, each ``DataShards`` entry on its row, a
  whole leaf on the lead of its row (of row 0 outside a ``DataShards``).
  ``analytic_arg_bytes_per_device`` is the largest slot's;
* ``memory``: argument and output bytes by slot (the largest under JAX's
  key names, each slot beside them), and, in the place of XLA's temp
  size, the peak of live meta bytes the step made above its arguments,
  ``temp_size_in_bytes_all_slots``: a meta tensor carries no slot, so it
  sums every slot;
* ``cost.flops``: each op of the step counted by ``torch.utils.
  flop_counter``'s registry, as ``FlopCounterMode`` counts (``MetaStep``),
  every unit counted (JAX counts a scanned unit once unless ``--unroll``);
* ``collectives`` (JAX's ``collective_bytes`` keys) and
  ``collectives_exact`` (``hlo_analysis.collective_totals``' keys, by
  kind and mesh axis): ``runtime.collectives.PER_DEVICE`` over the step,
  the collectives the lead slot takes part in, each once, with its own
  result's bytes: per device, as JAX reads them from one device's
  program. A Python step runs every unit it reaches, so these are per
  executed step, which JAX works out from the HLO's trip counts; no HLO
  text exists, so ``hlo_analysis.py`` has no counterpart and no parser is
  ported. Train cells count the backward's all-reduces over 'model'
  (``collectives.count_backward_reduce``) and its 'data' collectives.
  On meta the decode step's host reads take JAX's analysis'
  answers (``core.engine.host_read``): the layer loop runs every unit and
  each exit point runs its gate and its verify;
* ``lower_s`` is the seconds to place and run on meta; ``compile_s`` is
  None.

The kernel wrappers see meta tensors and run their plain versions, so the
models take JAX's dry-run flags, which turn on no kernel. ``--multi-pod``
reads JAX's ``('pod', 'data')`` spec entries as one row axis of 2 x 16
rows, pod-major (a ``(32, 16)`` mesh); a spec that names 'pod' or 'data'
alone (the expert-parallel fallback when the experts do not divide both)
is refused (ROADMAP: multi-GPU). A degree ``sharding.serving.
check_degree`` refuses (minicpm-2b's 36 heads, mamba2-130m's 24 SSD heads
at 16) fails its cell, where JAX replicates.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import weakref
from typing import Any, Dict, List, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.config import (RunConfig, ShapeCell, applicable_shapes,
                                shape_by_name)
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.specs import input_specs
from repro_torch.models.common import is_namedtuple, tree_leaves
from repro_torch.models.model import Model, ModelFlags, build_model
from repro_torch.quant.core import QTensor
from repro_torch.runtime import collectives as coll
from repro_torch.sharding.ctx import DataShards, Shards

COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                  "collective-permute")
MULTI = "ROADMAP: multi-GPU"
POD, DATA, MODEL = 2, 16, 16       # JAX's production mesh


class _SpecMesh:
    """A mesh that is only a ``.shape`` (the specs read nothing else)."""

    def __init__(self, shape: Dict[str, int]):
        self.shape = dict(shape)


# ---------------------------------------------------------------------------
# bytes by slot
# ---------------------------------------------------------------------------
def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def walk_slots(tree, fn, path: str = "", row: int = 0) -> None:
    """``fn(path, row, shard, bytes)`` for every tensor of a placed tree:
    a ``DataShards`` entry on its row, a ``Shards`` part on its shard, any
    other tensor (a ``QTensor``'s codes and scales together) on shard 0 of
    its row. Paths are ``policies.map_with_paths``' (JAX's)."""
    def sub(key):
        return f"{path}/{key}" if path else str(key)
    if isinstance(tree, DataShards):
        for d, e in enumerate(tree):
            walk_slots(e, fn, path, d)
    elif isinstance(tree, Shards):
        for m, p in enumerate(tree):
            fn(path, row, m, _nbytes(p))
    elif isinstance(tree, QTensor):
        fn(path, row, 0, _nbytes(tree.q) + _nbytes(tree.scale))
    elif isinstance(tree, torch.Tensor):
        fn(path, row, 0, _nbytes(tree))
    elif isinstance(tree, dict):
        for k, v in tree.items():
            walk_slots(v, fn, sub(k), row)
    elif is_namedtuple(tree):
        for f, v in zip(tree._fields, tree):
            walk_slots(v, fn, sub(f".{f}"), row)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            walk_slots(v, fn, sub(i), row)


def slot_bytes(tree, D: int, P: int) -> List[List[int]]:
    """Bytes a placed tree holds on each slot, ``[row][shard]``."""
    out = [[0] * P for _ in range(D)]

    def add(_, d, m, n):
        out[d][m] += n
    walk_slots(tree, add)
    return out


_POINTWISE: Dict[Any, bool] = {}     # op -> answered by MetaStep's rule
_DTYPES: Dict[Any, torch.dtype] = {}  # (op, argument kinds) -> its dtype
_ARANGES = (torch.ops.aten.arange.default, torch.ops.aten.arange.start,
            torch.ops.aten.arange.start_step)


def _kinds(x) -> Any:
    """What of an argument decides a pointwise op's result dtype: a
    tensor's dtype and whether it is 0-d, a number's type, any other
    value itself."""
    if isinstance(x, torch.Tensor):
        return x.dtype, x.dim() == 0
    if isinstance(x, (list, tuple)):
        return tuple(_kinds(v) for v in x)
    if isinstance(x, dict):
        return tuple((k, _kinds(v)) for k, v in x.items())
    if isinstance(x, (bool, int, float, complex)):
        return type(x)
    return x


def _probe(x):
    """A one-element CPU stand-in of a meta tensor's dtype and rank (a
    0-d tensor promotes types unlike a dimensioned one)."""
    if isinstance(x, torch.Tensor):
        return torch.ones([1] * x.dim(), dtype=x.dtype)
    if isinstance(x, (list, tuple)):
        return type(x)(_probe(v) for v in x)
    return x


class MetaStep(TorchDispatchMode):
    """What one step on meta tensors computes and holds: its flops
    (``flops``: each op counted by ``torch.utils.flop_counter``'s
    registry, as ``FlopCounterMode`` counts it) and the peak of live
    tensor bytes made under the mode above the storages of ``keep`` (the
    arguments; ``peak``). Each op's outputs are counted by storage once
    while any of them lives; a view or an in-place result shares its
    input's storage and adds nothing.

    It answers the out-of-place pointwise ops on meta tensors itself:
    torch's meta kernels for them are its Python references (~0.3 ms an
    op, most of a step's time at 16 x 16 slots). The answer is an empty
    meta tensor of the inputs' broadcast shape, laid out contiguously,
    with the dtype the same op gives on one-element CPU stand-ins of the
    inputs (each of the same rank), remembered by the op and its
    arguments' dtypes, ranks and number types; no pointwise op has flops
    to count. ``arange`` over Python ints and ``cat`` are answered by
    their shape rules likewise. One mode counts both flops and bytes, for
    ``FlopCounterMode``'s own mode adds ~60 us an op."""

    def __init__(self, keep: Sequence[torch.Tensor] = ()):
        super().__init__()
        self.flops = 0
        self.skip = {t.untyped_storage()._cdata for t in keep}
        self.refs: Dict[int, int] = {}      # storage -> live tensors
        self.size: Dict[int, int] = {}      # storage -> bytes
        self.owner: Dict[int, Any] = {}     # id of a weak tensor ref ->
        #                                     (the ref, its storage)
        self.live = self.peak = 0

    def _drop(self, ref) -> None:
        key = self.owner.pop(id(ref))[1]
        n = self.refs[key] - 1
        if n:
            self.refs[key] = n
        else:
            del self.refs[key]
            self.live -= self.size.pop(key)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.skip:
            return
        if key in self.refs:
            self.refs[key] += 1
        else:
            self.refs[key] = 1
            self.size[key] = st.nbytes()
            self.live += self.size[key]
            self.peak = max(self.peak, self.live)
        ref = weakref.ref(t, self._drop)
        self.owner[id(ref)] = (ref, key)

    def _pointwise(self, func, args, kwargs):
        """The op's meta output by the fast rule above, or None where the
        rule does not apply (an in-place or ``out=`` form, a non-meta
        tensor, several outputs)."""
        fast = _POINTWISE.get(func)
        if fast is None:
            fast = _POINTWISE[func] = (
                torch.Tag.pointwise in func.tags
                and not func._schema.is_mutable
                and len(func._schema.returns) == 1)
        if not fast:
            return None
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        if not tensors or any(t.device.type != "meta" for t in tensors):
            return None
        key = (func, _kinds(args), _kinds(kwargs))
        try:
            dtype = _DTYPES.get(key)
        except TypeError:                 # an unhashable argument
            key, dtype = None, None
        if dtype is None:
            try:
                dtype = func(*_probe(args), **_probe(kwargs)).dtype
            except Exception:
                return None
            if key is not None:
                _DTYPES[key] = dtype
        nd = max(t.dim() for t in tensors)
        shape = [1] * nd
        for t in tensors:
            for i, n in enumerate(t.shape, nd - t.dim()):
                if n != 1:
                    shape[i] = n
        return torch.empty(shape, dtype=dtype, device="meta")

    @staticmethod
    def _arange_cat(func, args, kwargs):
        """``arange`` over Python ints and ``cat`` of non-empty tensors on
        meta, whose meta kernels are Python references too: the output's
        shape and dtype, or None where another case applies."""
        if func in _ARANGES and kwargs.get("device") == torch.device("meta") \
                and all(type(a) is int for a in args):
            n = len(range(*args))
            return torch.empty(n, dtype=kwargs.get("dtype") or torch.int64,
                               device="meta")
        if func is torch.ops.aten.cat.default:
            xs = args[0]
            dim = args[1] if len(args) > 1 else kwargs.get("dim", 0)
            if not xs or any(x.device.type != "meta" or x.numel() == 0
                             or x.dim() != xs[0].dim() for x in xs):
                return None
            dim %= xs[0].dim()
            shape = list(xs[0].shape)
            shape[dim] = sum(x.shape[dim] for x in xs)
            dtype = xs[0].dtype
            for x in xs[1:]:
                dtype = torch.promote_types(dtype, x.dtype)
            return torch.empty(shape, dtype=dtype, device="meta")
        return None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = self._pointwise(func, args, kwargs)
        if out is None:
            out = self._arange_cat(func, args, kwargs)
        if out is None:
            out = func(*args, **kwargs)
            count = flop_registry.get(func._overloadpacket)
            if count is not None:
                self.flops += count(*args, **kwargs, out_val=out)
        for t in (out if isinstance(out, (list, tuple)) else (out,)):
            if isinstance(t, torch.Tensor):
                self._track(t)
        return out


# ---------------------------------------------------------------------------
# the step of a cell
# ---------------------------------------------------------------------------
def dryrun_flags(run: RunConfig, cell: ShapeCell, multi_pod: bool,
                 unroll: bool, data_extent: int) -> ModelFlags:
    """JAX's dry-run ``ModelFlags`` (``repro/launch/dryrun.py:150-163``):
    remat for training, the batch pinned over the data axes, the residual
    pinned whole for dense training up to d_model 8192, smaller attention
    and CE chunks for wide models. No kernel flag."""
    wide = run.model.d_model >= 8192
    return ModelFlags(
        remat="full" if cell.kind == "train" else "none", unroll=unroll,
        act_batch_axes=("pod", "data") if multi_pod else "data",
        act_batch_extent=data_extent,
        act_pin_full=(cell.kind == "train" and run.model.moe is None
                      and run.model.d_model <= 8192),
        chunk_size=256 if wide else 512,
        ce_chunk=256 if wide else 512)


def microbatch(cell: ShapeCell, data_extent: int) -> int:
    """JAX's gradient-accumulation chunk: a 16th of the batch, at least
    one row per data row."""
    return max(cell.global_batch // 16, data_extent)


def step_fn_for(model: Model, run: RunConfig, cell: ShapeCell,
                dense_decode: bool = False, data_extent: int = DATA,
                param_pspec=None):
    """The cell's step, as JAX's ``step_fn_for``: the train step with
    gradient accumulation (``param_pspec``: the mesh's ``NamedSharding``
    tree), the prefill (an encoder's logits alone), or the serve step of
    the SpecEE or the dense strategy. ``model``: the placed engine's model
    for serving."""
    from repro_torch.api import DenseStrategy, SpecEEStrategy
    from repro_torch.train.loop import make_train_step
    if cell.kind == "train":
        tcfg = dataclasses.replace(run.train, global_batch=cell.global_batch,
                                   seq_len=cell.seq_len,
                                   microbatch=microbatch(cell, data_extent))
        return make_train_step(model, tcfg, param_pspec=param_pspec)
    if cell.kind == "prefill":
        if not model.cfg.is_decoder():
            def encoder_step(params, batch):
                logits, _, _ = model.prefill(params, batch)
                return logits
            return encoder_step

        def prefill_step(params, batch):
            logits, cache, _ = model.prefill(params, batch,
                                             max_seq=cell.seq_len + 1)
            return logits, cache
        return prefill_step
    if run.specee.enabled and not dense_decode:
        strat = SpecEEStrategy()

        def serve_step(params, sw, state):
            res, new_state = strat.step(model, params, sw, state)
            return res.tokens, new_state, res.exit_layer, res.units_run
        return serve_step
    dense = DenseStrategy()

    def dense_serve_step(params, sw, state):
        res, new_state = dense.step(model, params, sw, state)
        return res.tokens, new_state, None, res.units_run
    return dense_serve_step


def _refuse_lone_axes(specs) -> None:
    """Under --multi-pod, refuse a parameter spec entry naming 'pod' or
    'data' alone (the rows are their product). The AdamW state follows the
    params' specs; the batch, the SpecEE weights and the decode state are
    placed by the engine's own rules over the rows or whole on the lead,
    which name no lone axis."""
    from repro_torch.sharding.policies import Spec, map_with_paths

    def check(path, spec):
        if isinstance(spec, Spec) and any(ax in ("pod", "data")
                                          for ax in spec):
            raise ValueError(
                f"{path}: spec {tuple(spec)} splits over one of 'pod' and "
                f"'data' alone; the port's rows are their product ({MULTI})")
    map_with_paths(specs, check)


def place(model: Model, run: RunConfig, cell: ShapeCell, mesh, args,
          dense_decode: bool):
    """The cell's arguments placed on ``mesh`` by the code a user's run
    places them with: serving through ``Engine.create(mesh=, policy=
    run.sharding.policy)`` (its params, SpecEE weights, and the placed
    model's empty decode state), training through ``TrainMesh.place`` and
    ``adamw_init``, as ``TrainLoop(mesh=)``. The batch stays whole on the
    lead, as the engine and the train loop take it. Returns (placed args,
    the model to step, the params' ``NamedSharding`` tree or None)."""
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.sharding.policies import named
    from repro_torch.sharding.training import TrainMesh
    if cell.kind == "train":
        params, _, batch = args
        tm = TrainMesh(model, mesh)
        pspec = named(mesh, tm.specs(params))
        placed = tm.place(params, pspec)
        return (placed, adamw_init(placed), batch), model, pspec
    from repro_torch.api import Engine
    if cell.kind == "prefill":
        params, batch = args
        e = Engine.create(model, params, None, strategy="dense", mesh=mesh,
                          policy=run.sharding.policy)
        return (e.params, batch), e.model, None
    params, sw, _ = args
    specee = run.specee.enabled and not dense_decode
    e = Engine.create(model, params, sw if specee else None,
                      strategy="specee" if specee else "dense", mesh=mesh,
                      policy=run.sharding.policy)
    state = e.strategy.empty_state(e.model, e.sw, cell.global_batch,
                                   cell.seq_len, device=e.device)
    return (e.params, e.sw, state), e.model, None


def _collectives(counts: Dict[str, Dict[str, Dict[str, int]]]
                 ) -> Dict[str, Any]:
    """JAX's ``collective_bytes`` keys over one step's counts (every
    collective counted as it runs: ``entry_bytes`` the total,
    ``loop_bytes`` 0)."""
    out: Dict[str, Any] = {k: 0 for k in COLLECTIVE_OPS}
    calls = {k: 0 for k in COLLECTIVE_OPS}
    for record in counts.values():
        for kind, c in record.items():
            out[kind] += c["bytes"]
            calls[kind] += c["calls"]
    out["total_bytes"] = sum(out[k] for k in COLLECTIVE_OPS)
    out["entry_bytes"] = out["total_bytes"]
    out["loop_bytes"] = 0
    out["counts"] = calls
    return out


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             unroll: bool = False, dense_decode: bool = False, *, mesh=None,
             run: Optional[RunConfig] = None,
             cell: Optional[ShapeCell] = None) -> Dict[str, Any]:
    """One cell's dry run (the module docstring). ``mesh``: a
    ``(D, P)`` mesh of meta slots (default ``(16, 16)``, or ``(32, 16)``
    under ``multi_pod``); ``run`` and ``cell``: another config (a smoke
    one) and another cell of the same kind, for small runs."""
    run = run or get_config(arch)
    cell = cell or shape_by_name(shape_name)
    if cell.name not in [c.name for c in applicable_shapes(run.model)]:
        raise ValueError(f"{cell.name} not applicable to {arch}")
    if mesh is None:
        mesh = make_host_mesh(POD * DATA if multi_pod else DATA, MODEL,
                              "meta")
    D, P = int(mesh.shape["data"]), int(mesh.shape["model"])
    spec_mesh = (_SpecMesh({"pod": POD, "data": D // POD, "model": P})
                 if multi_pod else mesh)
    model = build_model(run, dryrun_flags(run, cell, multi_pod, unroll, D))
    t0 = time.perf_counter()
    args, pspec = input_specs(model, cell, spec_mesh,
                              dense_decode=dense_decode)
    if multi_pod:
        _refuse_lone_axes(pspec)
    placed, step_model, pspec = place(model, run, cell, mesh, args,
                                      dense_decode)
    del args
    fn = step_fn_for(step_model, run, cell, dense_decode=dense_decode,
                     data_extent=D, param_pspec=pspec)
    keep = [x for x in tree_leaves(placed) if isinstance(x, torch.Tensor)]
    coll.reset_counts()
    with MetaStep(keep) as meta:
        out = fn(*placed)
    lower_s = time.perf_counter() - t0
    counts = {ax: {k: dict(c) for k, c in rec.items()}
              for ax, rec in coll.PER_DEVICE.items()}

    units = sum(reps for _, reps in model.segments)
    loop_scale = units
    if cell.kind == "train":
        loop_scale = units * max(cell.global_batch
                                 // microbatch(cell, D), 1)
    arg_slots = slot_bytes(placed, D, P)
    if cell.kind == "decode":
        *out, units_run = out
    out_slots = slot_bytes(out, D, P)
    result: Dict[str, Any] = {
        "arch": arch, "shape": cell.name,
        "mesh": f"{POD}x{D // POD}x{P}" if multi_pod else f"{D}x{P}",
        "devices": D * P, "lower_s": round(lower_s, 2), "compile_s": None,
        "loop_scale": loop_scale, "units": units,
        "memory": {
            "argument_size_in_bytes": max(map(max, arg_slots)),
            "output_size_in_bytes": max(map(max, out_slots)),
            "temp_size_in_bytes_all_slots": meta.peak,
            "argument_size_in_bytes_per_slot": arg_slots,
            "output_size_in_bytes_per_slot": out_slots},
        "analytic_arg_bytes_per_device": max(map(max, arg_slots)),
        "analytic_arg_bytes_per_slot": arg_slots,
        "cost": {"flops": float(meta.flops)},
        "collectives": _collectives(counts),
        "collectives_exact": {
            "total_bytes": sum(c["bytes"] for rec in counts.values()
                               for c in rec.values()),
            "by_op": _collectives(counts),
            "by_axis": counts, "unknown_trips": 0},
    }
    if cell.kind == "decode":
        result["units_run"] = int(units_run)
    return result


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--assigned-only", action="store_true",
                    help="skip the llama2 paper configs")
    ap.add_argument("--unroll", action="store_true",
                    help="JAX's lowering hint; a Python step runs every "
                         "unit already")
    ap.add_argument("--dense-decode", action="store_true",
                    help="the dense baseline serve step (no SpecEE)")
    args = ap.parse_args(argv)

    archs = ([args.arch] if args.arch != "all" else
             [a for a in ARCHS if not (args.assigned_only and
                                       a.startswith("llama2"))])
    mesh_name = f"{POD}x{DATA}x{MODEL}" if args.multi_pod else \
        f"{DATA}x{MODEL}"
    results = []
    for arch in archs:
        cells = applicable_shapes(get_config(arch).model)
        names = ([args.shape] if args.shape != "all"
                 else [c.name for c in cells])
        for name in names:
            if name not in [c.name for c in cells]:
                print(f"SKIP {arch} {name} (inapplicable)", flush=True)
                continue
            print(f"=== {arch} × {name} × {mesh_name} ===", flush=True)
            try:
                r = run_cell(arch, name, args.multi_pod, unroll=args.unroll,
                             dense_decode=args.dense_decode)
                print(json.dumps(
                    {k: r.get(k) for k in ("lower_s", "units",
                                           "analytic_arg_bytes_per_device",
                                           "cost")}, default=str),
                      flush=True)
            except Exception as e:
                r = {"arch": arch, "shape": name, "error": repr(e)}
                print("FAILED:", repr(e), flush=True)
            results.append(r)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1, default=str)
        print("wrote", args.out)
    bad = [r for r in results if "error" in r]
    print(f"{len(results) - len(bad)}/{len(results)} cells ran on meta")
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
