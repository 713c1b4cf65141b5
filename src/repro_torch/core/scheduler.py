"""T2 — two-level predictor scheduling (counterpart of
``repro/core/scheduler.py``): the offline top-fraction mask united with
±radius neighbourhoods of each row's last ``online_window`` exit points.
The offline mask comes from an exit histogram
(``core/predictor_training.py::offline_exit_counts``)."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.config import SpecEEConfig

SchedState = Dict[str, torch.Tensor]


def init_state(batch: int, spec: SpecEEConfig, device) -> SchedState:
    return {
        "queue": torch.full((batch, spec.online_window), -1,
                            dtype=torch.int32, device=device),
        "qpos": torch.zeros(batch, dtype=torch.int32, device=device),
    }


def offline_mask_from_counts(counts: torch.Tensor,
                             spec: SpecEEConfig) -> torch.Tensor:
    """counts: (E,) exit-frequency histogram -> (E,) bool mask of the top
    ``offline_top_frac`` share of exit points; ties go to the lower exit
    point (a stable sort, as ``jnp.argsort(..., stable=True)``)."""
    counts = torch.as_tensor(counts)
    E = counts.shape[0]
    keep = max(1, int(round(spec.offline_top_frac * E)))
    order = torch.argsort(-counts, stable=True)
    mask = torch.zeros(E, dtype=torch.bool, device=counts.device)
    mask[order[:keep]] = True
    return mask


def active_mask(state: SchedState, offline: torch.Tensor,
                spec: SpecEEConfig, num_exit_points: int) -> torch.Tensor:
    """-> (B, E) bool: which exit points run a predictor for each row."""
    queue = state["queue"]
    B = queue.shape[0]
    if not spec.schedule_enabled:
        return torch.ones(B, num_exit_points, dtype=torch.bool,
                          device=queue.device)
    pts = torch.arange(num_exit_points, device=queue.device)[None, None, :]
    q = queue[:, :, None]
    near = ((pts - q).abs() <= spec.online_radius) & (q >= 0)
    return near.any(dim=1) | offline[None, :]


def update(state: SchedState, exit_point: torch.Tensor) -> SchedState:
    """Push each row's exit point into its circular queue. exit_point: (B,)."""
    B, N = state["queue"].shape
    rows = torch.arange(B, device=exit_point.device)
    queue = state["queue"].clone()
    queue[rows, state["qpos"].long()] = exit_point.to(torch.int32)
    return {"queue": queue, "qpos": (state["qpos"] + 1) % N}


def expected_active_count(state: SchedState, offline: torch.Tensor,
                          spec: SpecEEConfig,
                          num_exit_points: int) -> torch.Tensor:
    """Mean number of active predictors per row (0-d fp32)."""
    return active_mask(state, offline, spec, num_exit_points
                       ).float().sum(dim=-1).mean()
