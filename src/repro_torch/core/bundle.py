"""A SpecEE bundle trained from the seed alone, in the order of the JAX
package's ``benchmarks/common.py::get_bundle``:

  1. the target, ``train_steps`` ``TrainLoop`` steps on the synthetic
     pipeline (init seed 0), so its hidden dynamics are not degenerate;
  2. the draft against the frozen target, ``draft_steps`` steps over
     ``draft_batches`` pipeline batches of 4 x ``seq`` (pipeline seed 0);
  3. features over the first ``pred_batches`` of them, then the
     predictors, ``pred_steps`` steps;
  4. offline exit counts over the first batch with ``exit_new`` new tokens
     (every predictor on) and the offline mask from them.

``chip_smoke.py`` (phase 11) and ``repro_torch.launch.serve --trained``
share this one copy. Generators are seeded 0, 1, 2 on the device, so a
device trains the same bundle every run.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.config import RunConfig
from repro_torch.core import draft_training as dt
from repro_torch.core import predictor_training as pt
from repro_torch.core import scheduler as sched_lib
from repro_torch.core.engine import SpecEEWeights
from repro_torch.data import DataPipeline
from repro_torch.models.model import ModelFlags, build_model

# offline exit counts run the AR path with the gate and attention kernels
# (on a CPU tensor every wrapper runs its plain version)
EXIT_FLAGS = ModelFlags(exit_gate_kernel=True, exit_gate_impl="kernel",
                        decode_kernel=True)


def bundle_run(arch: str = "llama2-7b", layers: int = 12) -> RunConfig:
    """get_bundle's config: ``arch``'s smoke config deepened to
    ``layers`` layers (exit dynamics need headroom)."""
    from repro_torch.configs import get_config
    run = get_config(arch).smoke()
    return dataclasses.replace(run, model=dataclasses.replace(
        run.model, num_layers=layers))


def train_bundle(run: RunConfig, device, seq: int, train_steps: int = 30,
                 draft_steps: int = 250, draft_batches: int = 8,
                 pred_batches: int = 4, pred_steps: int = 300,
                 exit_new: int = 12,
                 inspect: Optional[Callable[[str, Any], None]] = None
                 ) -> Tuple[Any, SpecEEWeights, Dict[str, Any]]:
    """Train a bundle for ``run`` on ``device``. ``inspect(what, tree)``,
    if given, sees each stage's tensors as the stage ends ("target
    training": params and AdamW's m and v; "the draft"; "the features";
    "the predictors"; "the offline mask"). Returns (params, sw, stats):
    each stage's seconds (device synchronised), losses and metrics."""
    device = torch.device(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def look(what, tree):
        if inspect is not None:
            inspect(what, tree)

    from repro_torch.train import TrainLoop
    model = build_model(run)                  # training: no kernel flag
    stats: Dict[str, Any] = {}
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=device).manual_seed(0),
                        device)
    loop = TrainLoop(model, run, params)
    loop.run_steps(train_steps)
    sync()
    params = loop.params
    look("target training", [params, loop.opt_state.m, loop.opt_state.v])
    stats["target"] = {
        "seconds": time.perf_counter() - t0,
        "losses": [h["loss"] for h in loop.history],
        "step_ms": [h["step_time"] * 1e3 for h in loop.history],
        "peak_bytes": (torch.cuda.max_memory_allocated(device)
                       if device.type == "cuda" else None)}
    del loop
    if device.type == "cuda":
        torch.cuda.empty_cache()

    pipe = DataPipeline(run.model, 4, seq, seed=0)
    batches = [torch.as_tensor(pipe.next()["tokens"], device=device)
               for _ in range(draft_batches)]
    t0 = time.perf_counter()
    draft, dm = dt.train_draft(model, params, batches,
                               torch.Generator(device=device).manual_seed(1),
                               steps=draft_steps)
    sync()
    look("the draft", draft)
    stats["draft"] = dict(dm, seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    data = pt.collect_dataset(model, params, draft, batches[:pred_batches])
    sync()
    look("the features", list(data))
    t_collect = time.perf_counter() - t0
    t0 = time.perf_counter()
    pred, pm = pt.train_predictors(
        run.specee, data, torch.Generator(device=device).manual_seed(2),
        steps=pred_steps)
    sync()
    look("the predictors", pred)
    stats["predictors"] = dict(
        pm, seconds=time.perf_counter() - t0, collect_seconds=t_collect,
        features_shape=tuple(data.features.shape),
        per_exit=data.labels.mean(dim=1).tolist())
    del data

    E = model.num_exit_points
    sw = SpecEEWeights(draft=draft, predictors=pred,
                       offline_mask=torch.ones(E, dtype=torch.bool,
                                               device=device))
    t0 = time.perf_counter()
    counts = pt.offline_exit_counts(build_model(run, EXIT_FLAGS), params, sw,
                                    batches[:1], max_new=exit_new)
    offline = sched_lib.offline_mask_from_counts(
        torch.as_tensor(counts[:-1], dtype=torch.float32, device=device),
        run.specee)
    look("the offline mask", offline)
    stats["offline"] = {"seconds": time.perf_counter() - t0,
                        "counts": counts.tolist(),
                        "mask": offline.int().tolist()}
    return params, sw._replace(offline_mask=offline), stats
