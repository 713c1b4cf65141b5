"""Training loop (counterpart of ``repro/train/loop.py``): the step builder
(gradient accumulation, remat through ``ModelFlags``, the LR schedule) and
the host loop over the data pipeline, with checkpoint/restart
(``ckpt_dir``: params, AdamW state and the pipeline's position, saved every
``checkpoint_every`` steps), a straggler monitor fed each step's time, and
a preemption guard that the launcher installs (a SIGTERM saves and stops).

Under a ``(DATA, MODEL)`` mesh (``TrainLoop(mesh=)``, ``make_train_step(
param_pspec=)``) the step is JAX's ``make_train_step`` jitted with
``launch/specs.py::input_specs``' shardings at ``fsdp_tp``: params and
AdamW state placed by the specs (``sharding/training.py``), the batch
first cut into microbatches, then each microbatch's rows split over
'data', the loss the whole microbatch's (``Model.train_loss_rows``), the
fp32 accumulators in the parameter layout (JAX's ``_pin``), and the
gradients of leaves replicated over 'data' all-reduced over the rows.
Checkpoints hold whole tensors, JAX's layout, so a run saved on one mesh
restores on another (the launcher's elastic restart).
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.config import RunConfig, TrainConfig
from repro_torch.data import DataPipeline
from repro_torch.models.common import tree_leaves, tree_unflatten
from repro_torch.models.model import Model
from repro_torch.optim import adamw_init, adamw_update, make_schedule
from repro_torch.optim.adamw import AdamWState
from repro_torch.runtime.fault import PreemptionGuard, StragglerMonitor
from repro_torch.sharding.policies import named, state_specs
from repro_torch.sharding.training import TrainMesh, mesh_of


def make_train_step(model: Model, cfg: TrainConfig, param_pspec=None
                    ) -> Callable[[Any, AdamWState, Dict[str, torch.Tensor]],
                                  Tuple[Any, AdamWState,
                                        Dict[str, torch.Tensor]]]:
    """Builds ``train_step(params, opt_state, batch) -> (params, opt_state,
    stats)``. With ``cfg.microbatch > 0`` the batch is split into chunks of
    that many rows whose gradients are summed in fp32 and averaged. The
    step reads nothing back to the host: ``stats`` (loss, lr, grad_norm)
    are 0-d tensors on the parameters' device.

    ``param_pspec``: JAX's argument, here the parameters' ``NamedSharding``
    tree (``sharding.policies.named(mesh, specs)``): the step then takes
    params and AdamW state placed on that mesh (``sharding.training.
    TrainMesh.place``) and splits each microbatch's rows over 'data'."""
    sched = make_schedule(cfg)
    mesh = mesh_of(param_pspec)
    tm = None if mesh is None else TrainMesh(model, mesh)

    def grad_fn(params, batch):
        # a leaf the loss never reads (the token embedding of an audio
        # encoder, which reads frames) gets a zero gradient, as under
        # jax.grad
        leaves = [x.detach().requires_grad_(True)
                  for x in tree_leaves(params)]
        p = tree_unflatten(params, leaves)
        if tm is None:
            loss, _ = model.train_loss(p, batch)
        else:
            loss, _ = model.train_loss_rows(p, tm.split_batch(batch), tm)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), tuple(
            torch.zeros_like(x) if g is None else g
            for x, g in zip(leaves, grads))

    def train_step(params, opt_state: AdamWState, batch):
        if cfg.microbatch and cfg.microbatch > 0:
            B = next(iter(batch.values())).shape[0]
            mb = cfg.microbatch
            assert B % mb == 0, f"batch {B} % microbatch {mb}"
            nm = B // mb
            gsum = lsum = None
            for c in range(nm):
                chunk = {k: x[c * mb:(c + 1) * mb] for k, x in batch.items()}
                loss, g = grad_fn(params, chunk)
                if gsum is None:
                    gsum = [x.float().clone() for x in g]
                    lsum = loss
                else:
                    for a, b in zip(gsum, g):
                        a.add_(b.float())
                    lsum = lsum + loss
                del g
            grads = [x / nm for x in gsum]
            loss = lsum / nm
        else:
            loss, grads = grad_fn(params, batch)
        grads = tree_unflatten(params, grads)
        if tm is not None:
            grads = tm.reduce_grads(grads)
        lr = sched(opt_state.step)
        params, opt_state, stats = adamw_update(cfg, params, grads,
                                                opt_state, lr)
        return params, opt_state, dict(stats, loss=loss, lr=lr)

    return train_step


class TrainLoop:
    """Host-side loop: the data pipeline and the train step on the
    parameters' device, checkpoints, fault handling. With ``mesh`` (a
    ``launch.mesh.Mesh``) the whole ``params`` are placed on it by JAX's
    ``fsdp_tp`` specs and the step runs over it (the module docstring);
    ``self.params`` and ``self.opt_state`` are then placed trees
    (``whole()`` joins them)."""

    def __init__(self, model: Model, run: RunConfig, params,
                 ckpt_dir: Optional[str] = None, host_id: int = 0,
                 mesh=None):
        self.model = model
        self.run = run
        self.cfg = run.train
        self.mesh = TrainMesh(model, mesh) if mesh is not None else None
        pspec = None
        if self.mesh is not None:
            pspec = named(mesh, self.mesh.specs(params))
            params = self.mesh.place(params, pspec)
        self.params = params
        self.opt_state = adamw_init(params)
        self.step_fn = make_train_step(model, self.cfg, param_pspec=pspec)
        self.pipeline = DataPipeline(model.cfg, self.cfg.global_batch,
                                     self.cfg.seq_len, seed=self.cfg.seed)
        self.device = tree_leaves(params)[0].device
        self.ckpt = (CheckpointManager(ckpt_dir,
                                       keep=self.cfg.keep_checkpoints)
                     if ckpt_dir else None)
        self.monitor = StragglerMonitor()
        self.guard = PreemptionGuard()
        self.host_id = host_id
        self.step = 0
        self.history: list = []

    # ----- fault tolerance -----
    def try_restore(self) -> bool:
        """Load the latest committed checkpoint (params, AdamW state, the
        pipeline's position) onto the parameters' device; False when there
        is none."""
        if self.ckpt is None:
            return False
        out = self.ckpt.restore_latest(
            {"params": self.params, "opt": self.opt_state})
        if out is None:
            return False
        step, tree, extra = out
        if self.mesh is not None:           # whole tensors, placed again
            tree = self.mesh.place(tree, self._specs(tree["params"]))
        self.params, self.opt_state = tree["params"], tree["opt"]
        self.step = step
        self.pipeline = DataPipeline.from_state(
            self.model.cfg, self.cfg.global_batch, self.cfg.seq_len,
            extra["data"])
        return True

    def save(self) -> None:
        """Checkpoint this step (the tensors are copied to the host before
        ``save`` returns, a placed tree as its whole tensors; the files
        are written in the background)."""
        if self.ckpt is None:
            return
        self.ckpt.save(self.step,
                       {"params": self.params, "opt": self.opt_state},
                       extra={"data": self.pipeline.state_dict()})

    def whole(self, device="cpu") -> Dict[str, Any]:
        """{"params", "opt"} as whole tensors (JAX's global arrays; under a
        mesh joined onto ``device``, else as they are)."""
        tree = {"params": self.params, "opt": self.opt_state}
        return tree if self.mesh is None else self.mesh.unplace(tree, device)

    def _specs(self, params) -> Dict[str, Any]:
        """The specs of {"params", "opt"} for whole ``params``: the
        params' and AdamW's (``state_specs``: m and v in the parameter
        layout)."""
        ps = self.mesh.specs(params)
        return {"params": ps, "opt": state_specs(self.mesh.mesh, "fsdp_tp",
                                                 ps, None)}

    def run_steps(self, n: Optional[int] = None) -> Dict[str, float]:
        """``n`` steps (default ``cfg.steps``); each step's stats, read
        back to the host, and its ``step_time`` (seconds, the stats' read
        included) go to ``history`` and the straggler monitor. Saves every
        ``checkpoint_every`` steps; after a SIGTERM the guard caught, saves
        and stops. Returns the last step's stats."""
        n = n if n is not None else self.cfg.steps
        last: Dict[str, float] = {}
        for _ in range(n):
            batch = {k: torch.as_tensor(v, device=self.device)
                     for k, v in self.pipeline.next().items()}
            t0 = time.perf_counter()
            self.params, self.opt_state, stats = self.step_fn(
                self.params, self.opt_state, batch)
            stats = {k: float(v) for k, v in stats.items()}
            dt = time.perf_counter() - t0
            self.monitor.record(self.host_id, dt)
            self.step += 1
            stats["step_time"] = dt
            self.history.append(stats)
            last = stats
            if self.ckpt and self.step % self.cfg.checkpoint_every == 0:
                self.save()
            if self.guard.should_save():
                self.save()
                break
        if self.ckpt:
            self.ckpt.wait()
        return last
