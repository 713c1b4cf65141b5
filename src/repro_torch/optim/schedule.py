"""LR schedules: cosine, constant and WSD (Warmup-Stable-Decay, MiniCPM's
schedule, arXiv:2404.06395 §4) — counterpart of ``repro/optim/schedule.py``.

``make_schedule(cfg)`` returns ``sched(step)``: on a Python int the rate is
a Python float, on a 0-d tensor a 0-d fp32 tensor on the step's device (the
train step reads the optimizer's step counter there without a host read).
"""
from __future__ import annotations

import math
from typing import Callable, Union

import torch

from repro_torch.config import TrainConfig

Step = Union[int, torch.Tensor]


def make_schedule(cfg: TrainConfig) -> Callable[[Step], Union[float,
                                                             torch.Tensor]]:
    peak = cfg.learning_rate
    warm = max(cfg.warmup_steps, 1)
    total = max(cfg.steps, warm + 1)
    decay_start = int(total * 0.9)          # wsd: the final ~10% decays

    def sched(step: Step):
        if isinstance(step, torch.Tensor):
            s = step.float()
            upto1, clip01, cos = (lambda x: torch.clamp(x, max=1.0),
                                  lambda x: torch.clamp(x, 0.0, 1.0),
                                  torch.cos)
        else:
            s = float(step)
            upto1, clip01, cos = (lambda x: min(1.0, x),
                                  lambda x: min(max(x, 0.0), 1.0), math.cos)
        warmup = upto1(s / warm)
        if cfg.schedule == "constant":
            return peak * warmup
        if cfg.schedule == "wsd":
            frac = clip01((s - decay_start) / max(total - decay_start, 1))
            return peak * warmup * (0.5 * (1 + cos(math.pi * frac)))
        frac = clip01((s - warm) / max(total - warm, 1))      # cosine
        return peak * warmup * (0.1 + 0.45 * (1 + cos(math.pi * frac)))
    return sched
