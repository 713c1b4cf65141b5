"""Meta-tensor stand-ins for every dry-run input (counterpart of
``repro/launch/specs.py``; nothing is allocated).

``input_specs(model, cell, mesh)`` returns (fn_args, param specs) for the
step of that cell:
  train   -> (params fp32, AdamW state, batch)          for train_step
  prefill -> (params in the compute dtype, batch)        for prefill_step
  decode  -> (params in the compute dtype, SpecEE weights, decode state)
             for the serve step (SpecEE AR, or dense)

The arguments are whole tensors on the torch meta device, with the shapes
and dtypes JAX's ``jax.eval_shape`` gives (the decode state is the empty
one at ``cell.global_batch`` x ``cell.seq_len``, as JAX's
``decode_state_struct`` builds it; JAX's PRNG key is the port's integer
seed, no tensor). The param specs are ``sharding/policies.py``'s, which
are JAX's (fsdp_tp for train, the config's serving policy otherwise);
``mesh`` needs only a ``.shape``. ``launch/dryrun.py`` places the
arguments through the engine's and ``TrainLoop(mesh=)``'s own code, which
work out their own specs over the real mesh; it reads these only under
``--multi-pod``, where a spec naming 'data' alone is refused. JAX's
other spec trees (AdamW state, batch, SpecEE weights, decode state) are
not returned: no port code reads them.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.config import ShapeCell
from repro_torch.core import engine as eng
from repro_torch.data.pipeline import make_batch_specs
from repro_torch.models.common import dtype_of, tree_map
from repro_torch.models.model import Model
from repro_torch.optim.adamw import adamw_init
from repro_torch.sharding.policies import param_specs

META = torch.device("meta")


def _cast_float(tree, dtype: torch.dtype) -> Any:
    return tree_map(lambda x: x.to(dtype) if isinstance(x, torch.Tensor)
                    and x.is_floating_point() else x, tree)


def params_struct(model: Model, low_precision: bool) -> Any:
    """The model's parameters on meta: fp32 (JAX's init dtype, training's
    master weights) or, ``low_precision``, in the compute dtype."""
    params = model.init(torch.Generator().manual_seed(0), META)
    return _cast_float(params, dtype_of(model.cfg.dtype) if low_precision
                       else torch.float32)


def batch_struct(model: Model, cell: ShapeCell) -> Dict[str, torch.Tensor]:
    cfg = model.cfg
    seq = cell.seq_len
    if cfg.frontend == "vision_patches":
        seq = max(seq - cfg.frontend_tokens, 1)  # total length incl. patches
    spec = make_batch_specs(cfg, cell.global_batch, seq)
    return {k: torch.empty(shape, dtype=torch.from_numpy(
        np.zeros((), dt)).dtype, device=META)
        for k, (shape, dt) in spec.items()}


def specee_struct(model: Model) -> eng.SpecEEWeights:
    """The draft in the compute dtype, the predictors fp32 (JAX's)."""
    return eng.init_specee(model, torch.Generator().manual_seed(0), META)


def decode_state_struct(model: Model, cell: ShapeCell, sw
                        ) -> eng.DecodeState:
    """The empty decode state of ``cell.global_batch`` rows of
    ``cell.seq_len`` slots (the draft cache with SpecEE weights)."""
    return eng.empty_decode_state(model, sw, cell.global_batch,
                                  cell.seq_len, device=META)


def input_specs(model: Model, cell: ShapeCell, mesh, dense_decode=False
                ) -> Tuple[Tuple, Any]:
    """(arg trees, the params' spec tree) for this cell's step (the module
    docstring). ``dense_decode``: the dense serve step's arguments (no
    SpecEE weights: None)."""
    if cell.kind == "train":
        params = params_struct(model, low_precision=False)
        return ((params, adamw_init(params), batch_struct(model, cell)),
                param_specs(model, mesh, "fsdp_tp", params))
    params = params_struct(model, low_precision=True)
    pspec = param_specs(model, mesh, model.run.sharding.policy, params)
    if cell.kind == "prefill":
        return (params, batch_struct(model, cell)), pspec
    sw = None if dense_decode else specee_struct(model)
    return (params, sw, decode_state_struct(model, cell, sw)), pspec
