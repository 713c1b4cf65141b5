"""Modality frontend stubs (counterpart of ``repro/models/frontends.py``).

The transformer backbone is the deliverable; the batch carries
precomputed embeddings.
- vision_patches (internvl2): (B, P, FRONTEND_DIM) patch embeddings, a
  learned projection to d_model, prepended to the text token embeddings.
- audio_frames (hubert): frames arrive at d_model (the conv feature
  extractor is the stub); a learned linear feature projection.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import common
from repro_torch.models.common import Params

# embedding width of the (stubbed) modality encoder
FRONTEND_DIM = 1024


def init_frontend(cfg: ModelConfig, gen, dtype, device) -> Optional[Params]:
    if cfg.frontend == "vision_patches":
        return {"proj": common.init_linear(gen, FRONTEND_DIM, cfg.d_model,
                                           True, dtype, device)}
    if cfg.frontend == "audio_frames":
        return {"proj": common.init_linear(gen, cfg.d_model, cfg.d_model,
                                           True, dtype, device)}
    return None


def apply_frontend(cfg: ModelConfig, p: Params, feats: torch.Tensor,
                   dtype) -> torch.Tensor:
    """feats: (B, T, FRONTEND_DIM | d_model) -> (B, T, d_model)."""
    return common.apply_linear(p["proj"], feats.to(dtype))


def frontend_feature_dim(cfg: ModelConfig) -> int:
    return FRONTEND_DIM if cfg.frontend == "vision_patches" else cfg.d_model
